"""The port's pipeline (`paddle_tpu_torch.distributed.pipeline`) against
the JAX package's, on the CPU, as four gloo ranks.

One rank job (`paddle_tpu_torch.tools.dist_drill`'s `cpu_pp` job, 4
ranks, a hard 120 s timeout that kills every rank) runs while this
process computes the JAX references; the tests read its files:

- `PipelineParallel.train_batch`, an SGD step, with the JAX pipeline
  tests' tiny Embed/Block/Head descs at pp 4 (1F1B), with a tied
  embedding (SharedLayerDesc) at pp 4, at dp 2 x pp 2, at dp 2 x pp 2 x
  vpp 2 (interleaved), with MpBlocks at pp 2 x mp 2, and with a GPT (the
  tied embedding pipe, 4 tiny GPTBlocks, the final LN, the tied head) at
  dp 2 x pp 2, against JAX's `train_batch` with no mesh (its sequential
  accumulation) on the same numpy weights: losses rtol 1e-4, each
  stage's parameters rtol 1e-4 / atol 2e-5 (3e-5 under mp), the bars of
  JAX's tests/test_pipeline_train_batch.py;
- `eval_batch` (loss and outputs; the generators untouched), the scaler
  path, the warning when no run of layers can be pipelined,
  `fleet.distributed_model`'s wrapping, and the options that raise;
- `train_batch` under ClipGradByNorm (each tensor by its own norm, an
  mp-cut tensor's squares summed over mp, the tied weight once) at pp
  4 (tied descs) and pp 2 x mp 2 (MpBlocks), 2 SGD steps with the
  health taps at every_k 1, against JAX's sequential `train_batch` with
  the same clip and taps: losses and parameters at the bars above, the
  taps' gradient norm and loss to 1e-5 relative, the counts exactly;
- the functional executors (1F1B, interleaved) at pp 4 against the JAX
  functions at pp 1, and at pp 1 in this process; GPipe's backward at
  pp 4 (`pipeline_apply_tensors`, and `pipeline_apply` with an extra
  input) against `jax.vjp` of the sequential stage function: y and
  every gradient to 1e-5;
- the schedules alone: every rank's order runs to its end against its
  neighbours' (no deadlock), stage 0 of 1F1B holds at most pp
  micro-batches, `pipeline_schedule_model` is JAX's arithmetic, and the
  plan's signature and segmentation are JAX's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.distributed.env import MESH_AXES as JAX_MESH_AXES
from paddle_tpu.distributed.mp_layers import (ColumnParallelLinear as
                                              JaxColumn)
from paddle_tpu.distributed.mp_layers import RowParallelLinear as JaxRow
from paddle_tpu.models.gpt import GPTBlock as JaxGPTBlock
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch.distributed import pipeline as pipe
from paddle_tpu_torch.tools import dist_drill as dd

_RANKS = 4


# ---- the JAX side of the cases ---------------------------------------------------

class Embed(jnn.Layer):
    def __init__(self, vocab, d):
        super().__init__()
        self.emb = jnn.Embedding(vocab, d)

    def forward(self, ids):
        return self.emb(ids)


class Block(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.ln = jnn.LayerNorm(d)
        self.fc1 = jnn.Linear(d, 2 * d)
        self.fc2 = jnn.Linear(2 * d, d)

    def forward(self, x):
        return x + self.fc2(JF.gelu(self.fc1(self.ln(x))))


class MpBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.ln = jnn.LayerNorm(d)
        self.fc1 = JaxColumn(d, 2 * d, gather_output=False)
        self.fc2 = JaxRow(2 * d, d, input_is_parallel=True)

    def forward(self, x):
        return x + self.fc2(JF.gelu(self.fc1(self.ln(x))))


class Head(jnn.Layer):
    def __init__(self, d, vocab):
        super().__init__()
        self.ln = jnn.LayerNorm(d)
        self.proj = jnn.Linear(d, vocab)

    def forward(self, x):
        return self.proj(self.ln(x))


class EmbeddingPipe(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.wte = jnn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = jnn.Embedding(cfg.max_seq_len, cfg.hidden_size)

    def forward(self, ids):
        pos = paddle.to_tensor(np.arange(ids.shape[1])[None, :], "int64")
        return self.wte(ids) + self.wpe(pos)


def _ce(out, y):
    vocab = out.shape[-1]
    return JF.cross_entropy(paddle.reshape(out, [-1, vocab]),
                            paddle.reshape(y, [-1]))


def _jax_descs(kind, blocks):
    LD, SD = jpipe.LayerDesc, jpipe.SharedLayerDesc
    V, D = dd.PP_V, dd.PP_D
    if kind == "gpt":
        cfg = JaxGPTConfig(**dd.PP_GPT_TINY)
        return ([SD("embed", EmbeddingPipe, None, "wte.weight", cfg)]
                + [LD(JaxGPTBlock, cfg) for _ in range(blocks)]
                + [LD(jnn.LayerNorm, cfg.hidden_size),
                   SD("embed", EmbeddingPipe,
                      lambda layer, h: paddle.matmul(
                          h, layer.wte.weight, transpose_y=True),
                      "wte.weight", cfg)])
    blk = MpBlock if kind == "mp" else Block
    body = [LD(blk, D) for _ in range(blocks)]
    if kind == "tied":
        return ([SD("emb", jnn.Embedding, None, "weight", V, D)] + body
                + [SD("emb", jnn.Embedding,
                      lambda layer, h: paddle.matmul(h, layer.weight,
                                                     transpose_y=True),
                      "weight", V, D)])
    return [LD(Embed, V, D)] + body + [LD(Head, D, V)]


def _strategy(n_micro):
    s = jdist.DistributedStrategy()
    s.pipeline_configs = {"accumulate_steps": n_micro}
    return s


def _jax_model(kind, blocks, seed=0):
    m = jdist.PipelineLayer(_jax_descs(kind, blocks), loss_fn=_ce)
    weights = dd.pp_weights(m, seed)
    for n, p in m.named_parameters():
        p._value = jnp.asarray(weights[n])
    return m


def _tensors(x, y):
    return paddle.to_tensor(x, "int64"), paddle.to_tensor(y, "int64")


def _jax_train(kind, blocks, n_micro, batch, scaler=False, steps=None,
               clip=None):
    """JAX's sequential train_batch (no mesh), SGD: (losses, params);
    with `clip`, under ClipGradByNorm(clip) with the health taps at
    every_k 1: (losses, params, each step's taps)."""
    m = _jax_model(kind, blocks)
    pp = jdist.PipelineParallel(m, strategy=_strategy(n_micro))
    opt = paddle.optimizer.SGD(
        learning_rate=dd.PP_SGD_LR, parameters=m.parameters(),
        grad_clip=None if clip is None else jnn.ClipGradByNorm(clip))
    if clip is not None:
        pp.health = dict(dd.HEALTH)
    losses = []
    for k in range(dd.PP_STEPS if steps is None else steps):
        kw = {"scaler": paddle.amp.GradScaler(init_loss_scaling=1024.0)} \
            if scaler else {}
        losses.append(float(pp.train_batch(
            _tensors(*dd.pp_data(k, batch)), opt, **kw).item()))
    params = {n: np.asarray(p._value) for n, p in m.named_parameters()}
    if clip is None:
        return losses, params
    return losses, params, list(pp._health_mon.ring)


def _jax_eval():
    """After one train step on dd.pp_data(7, 8): the eval loss and
    outputs."""
    m = _jax_model("plain", 8)
    pp = jdist.PipelineParallel(m, strategy=_strategy(4))
    opt = paddle.optimizer.SGD(learning_rate=dd.PP_SGD_LR,
                               parameters=m.parameters())
    data = _tensors(*dd.pp_data(7, 8))
    pp.train_batch(data, opt)
    loss = float(pp.eval_batch(data, compute_loss=True).item())
    return loss, np.asarray(pp.eval_batch(data).numpy())


def _jax_scaler():
    m = _jax_model("plain", 8)
    pp = jdist.PipelineParallel(m, strategy=_strategy(4))
    opt = paddle.optimizer.SGD(learning_rate=dd.PP_SGD_LR,
                               parameters=m.parameters())
    loss = float(pp.train_batch(
        _tensors(*dd.pp_data(7, 8)), opt,
        scaler=paddle.amp.GradScaler(init_loss_scaling=1024.0)).item())
    return loss, {n: np.asarray(p._value) for n, p in m.named_parameters()}


def _jax_stage_fn(params, h):
    def body(c, wi):
        return jnp.tanh(c @ wi), None
    h, _ = jax.lax.scan(body, h, params)
    return h


def _jax_head_loss_fn(hp, h, y_mb):
    lp = jax.nn.log_softmax(h @ hp, -1)
    return -jnp.mean(jnp.take_along_axis(lp, y_mb[:, None], 1))


def _pp1_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1, 1),
                JAX_MESH_AXES)


def _jax_functional(ws, hw, x, y, vpp):
    """The JAX 1F1B (vpp 1) or interleaved executor at pp 1 (a one-device
    mesh passed in, never installed)."""
    mesh = _pp1_mesh()
    if vpp == 1:
        res = jpipe.pipeline_train_step_1f1b(
            _jax_stage_fn, _jax_head_loss_fn, jnp.asarray(ws),
            jnp.asarray(hw), jnp.asarray(x), jnp.asarray(y), 4, mesh=mesh)
    else:
        res = jpipe.pipeline_train_step_interleaved(
            _jax_stage_fn, _jax_head_loss_fn, jnp.asarray(ws),
            jnp.asarray(hw), jnp.asarray(x), jnp.asarray(y), 4, vpp,
            mesh=mesh)
    return [np.asarray(t) for t in res]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    job = dd.start_job("cpu_pp", str(tmp_path_factory.mktemp("cpu_pp")),
                       seed=0, timeout=120.0)
    try:
        ref, seen = {}, {}
        for tag, _, kind, blocks, _, n_micro, batch in dd.PP_CASES:
            # the schedule is the port's business: one JAX run serves
            # every case of the same model, micro-batches and batch
            key = (kind, blocks, n_micro, batch)
            if key not in seen:
                seen[key] = _jax_train(kind, blocks, n_micro, batch)
            ref[tag] = seen[key]
        for tag, _, kind, blocks, _, n_micro, batch, clip in \
                dd.PP_CLIP_CASES:
            ref[tag] = _jax_train(kind, blocks, n_micro, batch,
                                  steps=dd.PP_CLIP_STEPS, clip=clip)
            ref[f"{tag}/unclipped"] = _jax_train(
                kind, blocks, n_micro, batch, steps=dd.PP_CLIP_STEPS)
        ref["eval"] = _jax_eval()
        ref["scaler"] = _jax_scaler()
    finally:
        res = job.wait()
    return res, ref


def _rec(run, rank):
    return run[0][rank][0]


def _arr(run, rank):
    return run[0][rank][1]


# ---- the job -----------------------------------------------------------------

def test_every_rank_finished_every_case(run):
    res, _ = run
    assert sorted(res) == list(range(_RANKS))
    for rank, (rec, _) in res.items():
        assert rec["rank"] == rank and "error" not in rec


# ---- train_batch against JAX's sequential train_batch ------------------------------

_TAGS = [c[0] for c in dd.PP_CASES]


@pytest.mark.parametrize("tag", _TAGS)
def test_train_batch_losses_match_jax(run, tag):
    _, ref = run
    for rank in range(_RANKS):
        np.testing.assert_allclose(_rec(run, rank)[tag]["losses"],
                                   ref[tag][0], rtol=1e-4)


@pytest.mark.parametrize("tag", _TAGS)
def test_train_batch_parameters_match_jax(run, tag):
    """Every stage's parameters after the steps; together the stages
    hold every parameter of the model."""
    _, ref = run
    want = ref[tag][1]
    seen = set()
    atol = 3e-5 if tag.endswith("mp2") else 2e-5
    for rank in range(_RANKS):
        arr = _arr(run, rank)
        for n in _rec(run, rank)[tag]["params"]:
            np.testing.assert_allclose(arr[f"{tag}/p/{n}"], want[n],
                                       rtol=1e-4, atol=atol,
                                       err_msg=f"rank {rank} {n}")
            seen.add(n)
    assert seen == set(want)


@pytest.mark.parametrize("tag", _TAGS)
def test_each_stage_holds_only_its_blocks(run, tag):
    """The plan cut the block run into pp * vpp chunks; a stage keeps its
    chunks' blocks (and the front or tail at the ends), never another's."""
    case = {c[0]: c for c in dd.PP_CASES}[tag]
    sizes, blocks, vpp = case[1], case[3], case[4]
    pp = sizes["pp"]
    for rank in range(_RANKS):
        rec = _rec(run, rank)[tag]
        assert rec["blocks"] == blocks
        assert rec["chunks"] == [blocks // (pp * vpp)] * vpp
        held = {int(n.split(".")[1]) for n in rec["params"]}
        stage = rec["coords"]["pp"]
        mine = {1 + (l * pp + stage) * (blocks // (pp * vpp)) + j
                for l in range(vpp) for j in range(blocks // (pp * vpp))}
        ends = set()
        if stage == 0:
            ends.add(0)
        if stage == pp - 1:
            ends |= {i for i in held if i > blocks}
            if case[2] in ("tied", "gpt"):
                ends.add(0)
        assert held == mine | ends, (rank, held)


def test_tied_weight_lives_on_both_end_stages(run):
    for tag in ("pp4_tied", "pp2_gpt"):
        stages = {_rec(run, k)[tag]["coords"]["pp"]: _rec(run, k)[tag]
                  for k in range(_RANKS)}
        last = max(stages)
        assert stages[0]["tied"] >= 1 and stages[last]["tied"] >= 1
        name = "run_function.0.weight" if tag == "pp4_tied" \
            else "run_function.0.wte.weight"
        assert name in stages[0]["params"] and name in stages[last]["params"]


# ---- ClipGradByNorm and the health taps over the stages ----------------------

_CLIP_TAGS = [c[0] for c in dd.PP_CLIP_CASES]


@pytest.mark.parametrize("tag", _CLIP_TAGS)
def test_clip_by_norm_matches_jax(run, tag):
    """Losses and every stage's parameters after 2 clipped SGD steps
    against JAX's sequential train_batch with the same clip (the bars of
    the unclipped cases); the clip binds on the first step (some
    gradient's norm is above the clip and some below, so a wrong norm
    moves the parameters)."""
    _, ref = run
    want = ref[tag][1]
    # the first step's loss is the unclipped run's; the second differs
    # because the clip scaled some gradient of the first
    free = ref[f"{tag}/unclipped"]
    assert ref[tag][0][0] == free[0][0]
    assert abs(ref[tag][0][1] - free[0][1]) > 1e-4 * abs(free[0][1])
    seen = set()
    atol = 3e-5 if "mp2" in tag else 2e-5
    for rank in range(_RANKS):
        np.testing.assert_allclose(_rec(run, rank)[tag]["losses"],
                                   ref[tag][0], rtol=1e-5)
        arr = _arr(run, rank)
        for n in _rec(run, rank)[tag]["params"]:
            np.testing.assert_allclose(arr[f"{tag}/p/{n}"], want[n],
                                       rtol=1e-4, atol=atol,
                                       err_msg=f"rank {rank} {n}")
            seen.add(n)
    assert seen == set(want)


@pytest.mark.parametrize("tag", _CLIP_TAGS)
def test_pipeline_health_taps_match_jax(run, tag):
    """Each step's taps on every rank (the gradients of every stage,
    mp-cut ones summed over mp, the tied weight once) against the JAX
    sequential path's: no update ratio in either."""
    _, ref = run
    want = ref[tag][2]
    assert len(want) == dd.PP_CLIP_STEPS
    for rank in range(_RANKS):
        got = _rec(run, rank)[tag]["health"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for key in ("grad_norm", "loss"):
                assert g[key] == pytest.approx(w[key], rel=1e-5, abs=0), key
            assert g["update_ratio"] == w["update_ratio"] == 0.0
            assert (g["nan_count"], g["inf_count"]) == (
                w["nan_count"], w["inf_count"]) == (0, 0)


# ---- eval, scaler, warning, fleet, the options that raise --------------------------------

def test_eval_batch_matches_jax(run):
    _, ref = run
    jl, jout = ref["eval"]
    for rank in range(_RANKS):
        ex = _rec(run, rank)["pp_extras"]
        np.testing.assert_allclose(ex["eval_loss"], jl, rtol=1e-4)
        np.testing.assert_allclose(_arr(run, rank)["pp_extras/eval_out"],
                                   jout, rtol=1e-4, atol=2e-5)
        assert ex["rng_untouched"]


def test_scaler_path_matches_jax(run):
    _, ref = run
    jl, jp = ref["scaler"]
    for rank in range(_RANKS):
        ex = _rec(run, rank)["pp_extras"]
        np.testing.assert_allclose(ex["scaler_loss"], jl, rtol=1e-4)
        assert ex["scaler_scale"] == 1024.0
        arr = _arr(run, rank)
        for key in arr:
            if key.startswith("pp_scaler/p/"):
                n = key[len("pp_scaler/p/"):]
                np.testing.assert_allclose(arr[key], jp[n], rtol=1e-4,
                                           atol=2e-5, err_msg=n)


def test_no_plan_warns_and_trains(run):
    for rank in range(_RANKS):
        ex = _rec(run, rank)["pp_extras"]
        assert len(ex["warned"]) == 1
        assert np.isfinite(ex["warned_loss"])


def test_fleet_wraps_a_pipeline_layer(run):
    for rank in range(_RANKS):
        f = _rec(run, rank)["pp_extras"]["fleet"]
        assert f == {"wrapped": "PipelineParallel", "micro": 2,
                     "plain_kept": True, "stage": rank}


@pytest.mark.parametrize("case,item", [("pp_lint", "6.4"),
                                       ("pp_resilience", "6.3"),
                                       ("pp_apply_plan", "6.4")])
def test_unported_options_raise(run, case, item):
    msg = _rec(run, 0)["errors"][case]
    if case == "pp_resilience":
        # ported since: a checkpoint directory trains and commits a step
        assert msg == "accepted: committed [1]"
        return
    assert msg.startswith("NotImplementedError") and f"item {item}" in msg


# ---- the functional executors --------------------------------------------------------

def _fn_inputs(run):
    a = _arr(run, 0)
    return [a[f"pp_fn/inputs/{k}"] for k in ("ws", "hw", "x", "y")]


_FN_REF = {}


def _fn_ref(run, vpp):
    if vpp not in _FN_REF:
        _FN_REF[vpp] = dict(zip(("loss", "pg", "hg", "dx"),
                                _jax_functional(*_fn_inputs(run), vpp)))
    return _FN_REF[vpp]


@pytest.mark.parametrize("part", ["loss", "pg", "hg", "dx"])
@pytest.mark.parametrize("tag,vpp", [("f1b", 1), ("finter", 2)])
def test_functional_pp4_matches_jax_pp1(run, tag, vpp, part):
    """Every rank's (loss, stack grads, head grads, dx) at pp 4 against
    the JAX executor at pp 1 (one backward over the whole batch: the
    mean of the equal micro-batches' means)."""
    want = _fn_ref(run, vpp)[part]
    for rank in range(_RANKS):
        np.testing.assert_allclose(_arr(run, rank)[f"pp_fn/{tag}/{part}"],
                                   want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("vpp", [1, 2])
def test_functional_pp1_matches_jax(vpp):
    rs = np.random.RandomState(4)
    ws = (rs.randn(8, 16, 16) * 0.3).astype(np.float32)
    hw = (rs.randn(16, 5) * 0.3).astype(np.float32)
    x = rs.randn(8, 16).astype(np.float32)
    y = rs.randint(0, 5, (8,))
    want = _jax_functional(ws, hw, x, y, vpp)
    fn = pipe.pipeline_train_step_1f1b if vpp == 1 else \
        (lambda *a: pipe.pipeline_train_step_interleaved(*a, vpp))
    loss, pg, hg, dx = fn(dd.pp_stage_fn, dd.pp_head_loss_fn,
                          [torch.from_numpy(ws)], [torch.from_numpy(hw)],
                          torch.from_numpy(x), torch.from_numpy(y), 4)
    for got, w in zip((loss, pg[0], hg[0], dx), want):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=2e-5,
                                   atol=2e-6)


def test_pipeline_apply_pp1_matches_jax():
    rs = np.random.RandomState(5)
    ws = (rs.randn(4, 16, 16) * 0.3).astype(np.float32)
    x = rs.randn(8, 16).astype(np.float32)
    want = np.asarray(jpipe.pipeline_apply(
        _jax_stage_fn, jnp.asarray(ws), jnp.asarray(x), 4,
        mesh=_pp1_mesh()))
    got = pipe.pipeline_apply(dd.pp_stage_fn, [torch.from_numpy(ws)],
                              torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pipeline_apply_tensors_refuses_a_gradient():
    """It refuses no longer: at pp 1 (no mesh) the tensor wrapper is one
    differentiable call, its gradients those of `jax.vjp` of the JAX
    executor at pp 1."""
    rs = np.random.RandomState(6)
    ws = (rs.randn(4, 16, 16) * 0.3).astype(np.float32)
    x = rs.randn(8, 16).astype(np.float32)
    ct = rs.randn(8, 16).astype(np.float32)
    y, vjp = jax.vjp(lambda w, xv: jpipe.pipeline_apply(
        _jax_stage_fn, w, xv, 4, mesh=_pp1_mesh()), jnp.asarray(ws),
        jnp.asarray(x))
    gw, gx = vjp(jnp.asarray(ct))
    w = torch.from_numpy(ws).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    got = pipe.pipeline_apply_tensors(dd.pp_stage_fn, [w], xt, 4)
    (got * torch.from_numpy(ct)).sum().backward()
    for have, want in ((got.detach(), y), (w.grad, gw), (xt.grad, gx)):
        np.testing.assert_allclose(have.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _jax_gpipe_vjp(inputs, bias):
    """y and the gradients of sum(y * ct) through the sequential stage
    function (tanh(h W [+ b]) over all 8 rows), by `jax.vjp`."""
    ws, x, ct = (jnp.asarray(inputs[k]) for k in ("ws", "x", "ct"))

    def f(w, xv, b):
        def body(c, wi):
            return jnp.tanh(c @ wi + b), None
        return jax.lax.scan(body, xv, w)[0]

    b = jnp.asarray(inputs["bias"]) if bias else jnp.zeros(ws.shape[-1])
    y, vjp = jax.vjp(f, ws, x, b)
    gw, gx, gb = vjp(ct)
    out = {"y": y, "gw": gw, "gx": gx}
    if bias:
        out["gb"] = gb
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("tag,part", [
    ("gpipe", "y"), ("gpipe", "gw"), ("gpipe", "gx"), ("gpipe_b", "y"),
    ("gpipe_b", "gw"), ("gpipe_b", "gx"), ("gpipe_b", "gb")])
def test_gpipe_backward_pp4_matches_jax_vjp(run, tag, part):
    """GPipe at pp 4 (8 rows, 4 micro-batches), forward and backward,
    on every rank: y, the stack's, x's and the extra input's gradients
    against jax.vjp of the sequential stage function (pp 1), to 1e-5
    relative in the 2-norm (the micro-batches' gradients sum in another
    order than the whole batch's)."""
    a0 = _arr(run, 0)
    inputs = {k: a0[f"pp_fn/inputs/{k}"] for k in ("ws", "x", "ct", "bias")}
    want = _jax_gpipe_vjp(inputs, tag == "gpipe_b")[part]
    for rank in range(_RANKS):
        got = _arr(run, rank)[f"pp_fn/{tag}/{part}"]
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def _gpipe_dropout_masks(n_micro, rows, width):
    """The masks (scale included) that every stage drew in GPipe's
    dropout leg: all ranks seed PP_GPIPE_SEED, so micro-batch m's j-th
    row of a stage draws the generator's (m * rows + j)-th mask of
    [batch / n_micro, width]."""
    torch.manual_seed(dd.PP_GPIPE_SEED)
    return [[torch.nn.functional.dropout(
        torch.ones(8 // n_micro, width), dd.PP_GPIPE_DROPOUT).numpy()
        for _ in range(rows)] for _ in range(n_micro)]


@pytest.mark.parametrize("part", ["y", "gw", "gx"])
def test_gpipe_backward_pp4_reruns_the_forwards_dropout(run, part):
    """GPipe at pp 4 with dropout after every row: y and the gradients
    of sum(y * ct), on every rank, against jax.vjp of the sequential
    stage function (pp 1) with the masks that the forward drew, to
    1e-5 relative in the 2-norm. A rerun that drew new masks would give
    the gradients of another forward than y's."""
    a0 = _arr(run, 0)
    ws, x, ct = (a0[f"pp_fn/inputs/{k}"] for k in ("ws", "x", "ct"))
    n_micro, rows = 4, ws.shape[0] // _RANKS
    masks = _gpipe_dropout_masks(n_micro, rows, ws.shape[-1])

    def f(w, xv):
        outs = []
        for m, xm in enumerate(jnp.split(xv, n_micro)):
            h = xm
            for k in range(w.shape[0]):
                h = jnp.tanh(h @ w[k]) * masks[m][k % rows]
            outs.append(h)
        return jnp.concatenate(outs)

    y, vjp = jax.vjp(f, jnp.asarray(ws), jnp.asarray(x))
    gw, gx = vjp(jnp.asarray(ct))
    want = np.asarray({"y": y, "gw": gw, "gx": gx}[part])
    for rank in range(_RANKS):
        got = _arr(run, rank)[f"pp_fn/gpipe_drop/{part}"]
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# ---- the schedules alone -------------------------------------------------------------

def _simulate(pp, vpp, n):
    """Run every rank's `schedule` against its neighbours' as data
    arrives (a forward needs the previous virtual stage's forward, a
    backward its own forward and the next stage's backward): -> the
    most micro-batches each stage held at once, or None on a deadlock."""
    V = pp * vpp
    seqs = [pipe.schedule(pp, vpp, n, s) for s in range(pp)]
    done, pos = set(), [0] * pp
    held, peak = [0] * pp, [0] * pp
    while any(pos[s] < len(seqs[s]) for s in range(pp)):
        moved = False
        for s in range(pp):
            if pos[s] == len(seqs[s]):
                continue
            kind, l, m = seqs[s][pos[s]]
            k = l * pp + s
            if kind == "F":
                ready = k == 0 or ("F", k - 1, m) in done
            else:
                ready = ("F", k, m) in done and (
                    k == V - 1 or ("B", k + 1, m) in done)
            if ready:
                done.add((kind, k, m))
                pos[s] += 1
                held[s] += 1 if kind == "F" else -1
                peak[s] = max(peak[s], held[s])
                moved = True
        if not moved:
            return None
    assert len(done) == 2 * V * n
    return peak


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 12])
@pytest.mark.parametrize("pp", [2, 3, 4])
def test_1f1b_runs_to_its_end_with_pp_in_flight(pp, n):
    peak = _simulate(pp, 1, n)
    assert peak is not None
    assert peak[0] == min(pp, n)
    assert all(p <= pp for p in peak)


@pytest.mark.parametrize("n", [4, 8, 12])
@pytest.mark.parametrize("pp,vpp", [(2, 2), (2, 3), (4, 2)])
def test_interleaved_runs_to_its_end(pp, vpp, n):
    assert _simulate(pp, vpp, n) is not None


def test_interleaved_needs_the_micro_batches_to_divide():
    with pytest.raises(ValueError, match="divide by pp"):
        pipe.schedule(4, 2, 6, 0)


@pytest.mark.parametrize("pp,vpp,n", [(1, 1, 4), (4, 1, 8), (4, 2, 8),
                                      (8, 2, 16)])
def test_schedule_model_is_jax_arithmetic(pp, vpp, n):
    assert pipe.pipeline_schedule_model(pp, vpp, n) == \
        jpipe.pipeline_schedule_model(pp, vpp, n)


@pytest.mark.parametrize("items,parts", [(10, 4), (8, 4), (3, 2), (7, 3)])
def test_segment_layers_is_jax_arithmetic(items, parts):
    assert pipe.SegmentLayers.uniform(items, parts) == \
        jpipe.SegmentLayers.uniform(items, parts)


def test_stackable_sig_rejects_config_mismatch():
    """Two same-class blocks whose forwards differ through a scalar
    (a Dropout's rate) do not share a signature; equal ones do."""
    from paddle_tpu_torch import nn

    class DBlock(torch.nn.Module):
        def __init__(self, p):
            super().__init__()
            self.fc = nn.Linear(4, 4)
            self.drop = nn.Dropout(p)

    a, b, c = DBlock(0.1), DBlock(0.2), DBlock(0.1)
    assert pipe._stackable_sig("layer", a) != pipe._stackable_sig("layer", b)
    assert pipe._stackable_sig("layer", a) == pipe._stackable_sig("layer", c)
    assert pipe._stackable_sig("func", a) is None


def test_sequential_train_batch_without_a_mesh_matches_jax():
    """No mesh: the sequential accumulation in this process, one step of
    the tied case."""
    from paddle_tpu_torch.distributed import PipelineParallel
    from paddle_tpu_torch.optimizer import SGD
    jl, jp = _jax_train("tied", 4, 2, 4, steps=1)
    m = dd._pp_model("tied", 4, 1, 0)
    p = PipelineParallel(m, strategy=dd._strategy(2))
    loss = p.train_batch([torch.from_numpy(a) for a in dd.pp_data(0, 4)],
                         SGD(learning_rate=dd.PP_SGD_LR,
                             parameters=m.parameters()))
    np.testing.assert_allclose(float(loss), jl[0], rtol=1e-5)
    for n, t in m.named_parameters():
        np.testing.assert_allclose(t.detach().numpy(), jp[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
