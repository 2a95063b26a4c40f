"""The port's hybrid-parallel training step and its parts against the JAX
package, on the CPU, as eight gloo ranks.

One rank job (`paddle_tpu_torch.tools.dist_drill`'s `cpu` job, 8 ranks,
a hard 120 s timeout that kills every rank) runs while this process
computes the JAX references; every test below reads its files:

- a tiny GPT (2 layers, width 64, 4 heads, vocab 256, seq 32, batch 4,
  f32, weights drawn with numpy and carried in with `shard_jax_params`)
  on dp 2 x mp 2 x sp 2 for 3 AdamW steps, against the JAX `TrainStep`
  on one device with no mesh (GSPMD computes the unsharded function):
  ring and Ulysses under ZeRO-1, losses to 1e-5 relative and the
  gathered parameters to 1e-4 (the bars of test_torch_train.py); ZeRO
  0, 1 and 2 equal to 1e-6, each rank's optimizer states 1/dp of
  ZeRO-0's; a global-norm clip against JAX's clipped step;
- ring and Ulysses attention alone at sp 4 (dp 2 x sp 4), causal and
  not, forward and dq/dk/dv against the JAX `ring_attention_values` /
  `ulysses_attention_values` on a dp 2 x sp 4 virtual-device mesh, to
  1e-5, and the divisibility errors;
- the tensor-parallel layers on mp 2 against JAX's on one device,
  outputs and gradients to 1e-5;
- every collective against numpy, exactly (integer-valued inputs), and
  each axis Function's backward against its adjoint; a collective that
  never completes raises CollectiveTimeoutError at its deadline;
- the comm spans' bytes of one recorded step, by collective and axis,
  against the analytic count (the ring's forward moves 2 (sp - 1) k/v
  blocks a layer);
- the topology queries against the JAX CommunicateTopology, and
  DataParallel's averaged gradients against the full batch's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.distributed import mp_layers as jax_mp
from paddle_tpu.distributed.env import MESH_AXES as JAX_MESH_AXES
from paddle_tpu.distributed.topology import \
    CommunicateTopology as JaxTopology
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.ops.ring_attention import (ring_attention_values,
                                           ulysses_attention_values)

from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.tools import dist_drill as dd

_RANKS = 8
_STEPS = 3
_HYBRID = ("ring_z1", "ulysses_z1")
_ZERO = ("ring_z0", "ring_z1", "ring_z2")


def _jax_train(weights, clip=None, mask=False):
    """3 AdamW steps of the JAX TrainStep on one device, no mesh."""
    jm = JaxGPT(JaxGPTConfig(**dd.TINY))
    for n, p in jm.named_parameters():
        p._value = jnp.asarray(weights[n])
    jo = jax_opt.AdamW(learning_rate=dd.LR, weight_decay=dd.WD,
                       parameters=jm.parameters(),
                       grad_clip=JaxClip(clip) if clip else None)
    step = paddle.jit.TrainStep(jm, jm.loss, jo)
    ids, lbl = dd.tiny_batch(0)
    batch = [paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32")]
    if mask:
        batch.append(paddle.to_tensor(dd.tiny_mask(0)))
    losses = [float(np.asarray(step(*batch).numpy())) for _ in range(_STEPS)]
    return losses, {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _jax_ops():
    """The JAX ring and Ulysses ops on a dp 2 x sp 4 virtual-device mesh
    (built here, never installed): out and (dq, dk, dv)."""
    q, k, v, do = dd.op_inputs(0)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 1, 1, 4, 1),
                JAX_MESH_AXES)
    out = {}
    for name, fn in (("ring", ring_attention_values),
                     ("ulysses", ulysses_attention_values)):
        for causal in (True, False):
            def f(a, b, c, fn=fn, causal=causal):
                return fn(a, b, c, causal=causal, mesh=mesh)

            def fwd_bwd(a, b, c, g, f=f):
                o, vjp = jax.vjp(f, a, b, c)
                return (o,) + vjp(g)
            res = jax.jit(fwd_bwd)(*(jnp.asarray(t) for t in (q, k, v, do)))
            out[(name, causal)] = [np.asarray(t) for t in res]
    return out


def _jax_layer(layer, x, ct, params):
    for n, p in layer.named_parameters():
        p._value = jnp.asarray(params[n])
    xt = paddle.to_tensor(x)
    xt.stop_gradient = False
    out = layer(xt)
    (out * paddle.to_tensor(ct)).sum().backward()
    return (np.asarray(out._value), np.asarray(xt.grad._value),
            {n: np.asarray(p.grad._value) for n, p in layer.named_parameters()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The rank job's files, and the JAX references computed while the
    ranks run."""
    job = dd.start_job("cpu", str(tmp_path_factory.mktemp("dist_drill")),
                       seed=0, timeout=120.0)
    try:
        weights = dd.numpy_weights(GPTConfig(**dd.TINY), 0)
        ref = {"train": _jax_train(weights),
               "clip": _jax_train(weights, dd.CLIP_NORM),
               "mask": _jax_train(weights, mask=True),
               "ops": _jax_ops(), "weights": weights}
    finally:
        res = job.wait()
    return res, ref


def _rec(run, rank=0):
    return run[0][rank][0]


def _arr(run, rank=0):
    return run[0][rank][1]


# ---- the job --------------------------------------------------------------

def test_every_rank_finished_every_case(run):
    res, _ = run
    assert sorted(res) == list(range(_RANKS))
    for rank, (rec, _) in res.items():
        assert rec["rank"] == rank and rec["world"] == _RANKS
        assert "error" not in rec
        assert set(rec["case_s"]) == {c.__name__ for c in dd.CASES["cpu"]}


# ---- the hybrid step against JAX --------------------------------------------

@pytest.mark.parametrize("tag", _HYBRID)
def test_hybrid_step_losses_track_the_jax_train_step(run, tag):
    jl, _ = run[1]["train"]
    tl = _rec(run)[tag]["losses"]
    assert len(tl) == _STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("tag", _HYBRID + _ZERO[::2] + ("ring_z1_clip",
                                                       "ring_z1_mask"))
def test_every_rank_reports_the_global_loss(run, tag):
    losses = [rec[tag]["losses"] for rec, _ in run[0].values()]
    assert all(l == losses[0] for l in losses)


@pytest.mark.parametrize("tag", _HYBRID)
def test_hybrid_step_parameters_track_the_jax_parameters(run, tag):
    _, jp = run[1]["train"]
    init = run[1]["weights"]
    arr = _arr(run)
    assert sorted(n for n in arr if n.startswith(tag + "/")) == sorted(
        f"{tag}/{n}" for n in jp)
    for n, ref in jp.items():
        np.testing.assert_allclose(arr[f"{tag}/{n}"], ref, rtol=0,
                                   atol=1e-4, err_msg=n)
    # the steps moved the parameters by more than the bar somewhere
    assert max(np.abs(jp[n] - init[n]).max() for n in jp) > 2e-4


def test_ring_and_ulysses_steps_agree(run):
    a = _arr(run)
    for n in run[1]["train"][1]:
        np.testing.assert_allclose(a[f"ring_z1/{n}"], a[f"ulysses_z1/{n}"],
                                   rtol=0, atol=1e-5, err_msg=n)


# ---- ZeRO -----------------------------------------------------------------

@pytest.mark.parametrize("tag", ("ring_z0", "ring_z2"))
def test_zero_stages_give_equal_parameters(run, tag):
    a = _arr(run)
    for n in run[1]["train"][1]:
        np.testing.assert_allclose(a[f"{tag}/{n}"], a[f"ring_z1/{n}"],
                                   rtol=0, atol=1e-6, err_msg=n)
    np.testing.assert_allclose(_rec(run)[tag]["losses"],
                               _rec(run)["ring_z1"]["losses"], rtol=1e-6)


@pytest.mark.parametrize("rank", range(_RANKS))
def test_zero_states_are_one_dp_th_of_stage_zero(run, rank):
    rec = _rec(run, rank)
    full = rec["ring_z0"]["state_bytes"]
    assert full > 0
    assert 2 * rec["ring_z1"]["state_bytes"] == full
    assert 2 * rec["ring_z2"]["state_bytes"] == full


# ---- clipping ---------------------------------------------------------------

def test_global_norm_clip_tracks_the_jax_clipped_step(run):
    jl, jp = run[1]["clip"]
    np.testing.assert_allclose(_rec(run)["ring_z1_clip"]["losses"], jl,
                               rtol=1e-5, atol=0)
    arr = _arr(run)
    for n, ref in jp.items():
        np.testing.assert_allclose(arr[f"ring_z1_clip/{n}"], ref, rtol=0,
                                   atol=1e-4, err_msg=n)


def test_a_loss_mask_tracks_the_jax_masked_step(run):
    """The mask keeps a different count on each rank's piece: the share
    is over the mask's global sum (summed over sp and dp)."""
    mask = dd.tiny_mask(0)
    counts = {float(mask[b:b + 2, s:s + 16].sum())
              for b in (0, 2) for s in (0, 16)}
    assert len(counts) > 1
    jl, jp = run[1]["mask"]
    np.testing.assert_allclose(_rec(run)["ring_z1_mask"]["losses"], jl,
                               rtol=1e-5, atol=0)
    arr = _arr(run)
    for n, ref in jp.items():
        np.testing.assert_allclose(arr[f"ring_z1_mask/{n}"], ref, rtol=0,
                                   atol=1e-4, err_msg=n)
    assert abs(jl[0] - run[1]["train"][0][0]) > 1e-4


def test_the_clip_binds(run):
    """The clipped run leaves the unclipped one: the norm is counted over
    the whole model (mp-cut parameters summed over mp)."""
    _, jp = run[1]["train"]
    _, jc = run[1]["clip"]
    assert max(np.abs(jp[n] - jc[n]).max() for n in jp) > 1e-5
    a = _arr(run)
    gap = max(np.abs(a[f"ring_z1/{n}"] - a[f"ring_z1_clip/{n}"]).max()
              for n in jp)
    assert gap > 1e-5


# ---- ring and Ulysses alone -------------------------------------------------

def _assemble(run, key, shape):
    """[b, s, n, h] from every rank's piece by its (dp, sp) coordinate."""
    out = np.zeros(shape, np.float32)
    for rank, (rec, arr) in run[0].items():
        c = rec["ops/coords"]
        s = shape[1] // 4
        out[c["dp"], c["sp"] * s:(c["sp"] + 1) * s] = arr[key][0]
    return out


@pytest.mark.parametrize("name", ("ring", "ulysses"))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("what", ("out", "dq", "dk", "dv"))
def test_sequence_parallel_attention_tracks_the_jax_op(run, name, causal,
                                                        what):
    ref = run[1]["ops"][(name, causal)]
    want = ref[("out", "dq", "dk", "dv").index(what)]
    got = _assemble(run, f"ops/{name}/{int(causal)}/{what}", want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_divisibility_errors(run):
    errs = _rec(run)["errors"]
    assert errs["ulysses_heads"].startswith("ValueError: ulysses needs "
                                            "heads (2) divisible by sp (4)")
    assert errs["ring_seq"].startswith("ValueError: ring attention needs "
                                       "seq lengths (30) divisible")
    assert errs["ring_len"].startswith("ValueError")
    assert errs["shard_batch"].startswith("ValueError: shard_batch")
    assert "ulysses under mp 2" in errs["ulysses_mp"]
    assert errs["ulysses_mp"].startswith("ValueError")


def test_the_jax_ops_raise_for_the_same_shapes():
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 1, 1, 4, 1),
                JAX_MESH_AXES)
    x2 = jnp.zeros((1, 32, 2, 16))
    with pytest.raises(ValueError, match="ulysses needs heads"):
        ulysses_attention_values(x2, x2, x2, mesh=mesh)
    x30 = jnp.zeros((1, 30, 4, 16))
    with pytest.raises(ValueError, match="divisible"):
        ring_attention_values(x30, x30, x30, mesh=mesh)


# ---- the tensor-parallel layers ------------------------------------------------

@pytest.mark.parametrize("name", ("col_gather", "col_local", "row"))
def test_mp_linear_tracks_the_jax_layer(run, name):
    arr = _arr(run)
    p = f"mp/{name}/"
    w = {k[len(p) + 2:]: v for k, v in arr.items() if k.startswith(p + "w/")}
    cls = jax_mp.RowParallelLinear if name == "row" \
        else jax_mp.ColumnParallelLinear
    layer = cls(*w["weight"].shape)
    out, dx, grads = _jax_layer(layer, arr[p + "x"], arr[p + "ct"], w)
    np.testing.assert_allclose(arr[p + "out"], out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arr[p + "dx"], dx, rtol=1e-5, atol=1e-5)
    for n in w:
        np.testing.assert_allclose(arr[p + "g/" + n], grads[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_vocab_parallel_embedding_tracks_the_jax_layer(run):
    arr = _arr(run)
    layer = jax_mp.VocabParallelEmbedding(20, 16)
    layer.weight._value = jnp.asarray(arr["mp/emb/w"])
    out = layer(paddle.to_tensor(arr["mp/emb/ids"].astype(np.int32)))
    (out * paddle.to_tensor(arr["mp/emb/ct"])).sum().backward()
    np.testing.assert_allclose(arr["mp/emb/out"], np.asarray(out._value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arr["mp/emb/gw"],
                               np.asarray(layer.weight.grad._value),
                               rtol=1e-5, atol=1e-5)
    # ids outside the table were clipped, as the JAX gather clips them
    ids = arr["mp/emb/ids"]
    assert (ids < 0).any() and (ids >= 20).any()


def test_parallel_cross_entropy_tracks_the_jax_layer(run):
    arr = _arr(run)
    logits = paddle.to_tensor(arr["mp/ce/logits"])
    logits.stop_gradient = False
    loss = jax_mp.ParallelCrossEntropy()(
        logits, paddle.to_tensor(arr["mp/ce/lbl"].astype(np.int32)))
    (loss * paddle.to_tensor(arr["mp/ce/dl"])).sum().backward()
    np.testing.assert_allclose(arr["mp/ce/loss"], np.asarray(loss._value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(arr["mp/ce/glogits"],
                               np.asarray(logits.grad._value), rtol=1e-5,
                               atol=1e-5)
    assert (arr["mp/ce/lbl"] == -100).any()
    assert (arr["mp/ce/loss"][arr["mp/ce/lbl"] == -100] == 0).all()


# ---- the collectives --------------------------------------------------------

def _x(rank):
    return np.arange(6, dtype=np.float32) + 10 * rank


_ALL = sum(_x(r) for r in range(_RANKS))


@pytest.mark.parametrize("name,want", [
    ("all_reduce_sum", lambda r: _ALL),
    ("all_reduce_max", lambda r: _x(_RANKS - 1)),
    ("all_reduce_avg", lambda r: _ALL / _RANKS),
    ("broadcast", lambda r: _x(3)),
    ("all_gather", lambda r: [_x(j) for j in range(_RANKS)]),
    ("scatter", lambda r: np.full(3, 100.0 + r)),
    ("alltoall", lambda r: [np.full(3, 100.0 * j + r)
                            for j in range(_RANKS)]),
    ("recv", lambda r: _x(r - 1) if r % 2 else np.zeros(6)),
])
def test_eager_collectives_equal_numpy(run, name, want):
    for rank, (rec, _) in run[0].items():
        np.testing.assert_array_equal(np.asarray(rec["eager"][name]),
                                      np.asarray(want(rank)))


def test_reduce_gather_object_and_subgroup(run):
    res = run[0]
    np.testing.assert_array_equal(res[2][0]["eager"]["reduce"], _ALL)
    for rank, (rec, _) in res.items():
        assert rec["eager"]["all_gather_object"] == [
            {"r": j} for j in range(_RANKS)]
        if rank % 2 == 0:
            np.testing.assert_array_equal(
                rec["eager"]["subgroup_sum"],
                sum(_x(j) for j in (0, 2, 4, 6)))
        else:
            assert "subgroup_sum" not in rec["eager"]


def _rows(run, axis):
    """Rank lists of each row along `axis`, in axis order."""
    rows = {}
    for rank, (rec, _) in run[0].items():
        c = rec["axis/coords"]
        key = tuple(v for k, v in sorted(c.items()) if k != axis)
        rows.setdefault(key, {})[c[axis]] = rank
    return [[r[i] for i in sorted(r)] for r in rows.values()]


def _axis_want(name, xs, ys, i):
    """(out, grad) of member i of a row with inputs xs, cotangents ys."""
    n = len(xs)
    if name == "psum":
        return sum(xs), sum(ys)
    if name == "pmean":
        return sum(xs) / n, sum(ys) / n
    if name == "pmax":
        m = np.maximum.reduce(xs)
        return m, sum(ys) * (xs[i] == m)
    if name == "all_gather_tiled":
        return np.concatenate(xs, 1), sum(y[:, 4 * i:4 * i + 4] for y in ys)
    if name == "all_gather_stack":
        return np.stack(xs), sum(y[i] for y in ys)
    if name == "reduce_scatter":
        return sum(xs)[:, 2 * i:2 * i + 2], np.concatenate(ys, 1)
    if name == "ppermute":
        return xs[1 - i], ys[1 - i]
    if name == "ppermute_half":
        return ((np.zeros_like(xs[0]), ys[1]) if i == 0
                else (xs[0], np.zeros_like(xs[0])))
    if name == "all_to_all":
        return (np.concatenate([x[:, 2 * i:2 * i + 2] for x in xs], 0),
                np.concatenate([y[2 * i:2 * i + 2] for y in ys], 1))
    if name == "c_identity":
        return xs[i], sum(ys)
    if name == "mp_allreduce":
        return sum(xs), ys[i]
    raise KeyError(name)


_AXIS_FNS = ("psum", "pmean", "pmax", "all_gather_tiled",
             "all_gather_stack", "reduce_scatter", "ppermute",
             "ppermute_half", "all_to_all", "c_identity", "mp_allreduce")
# the true adjoints (the reference's c_identity / mp_allreduce pair is
# each other's transpose by design, held to its own rule above)
_ADJOINT = _AXIS_FNS[:-2]


@pytest.mark.parametrize("axis", ("sp", "mp"))
@pytest.mark.parametrize("name", _AXIS_FNS)
def test_axis_collectives_equal_numpy_forward_and_backward(run, axis, name):
    key = f"axis/{axis}/{name}"
    for row in _rows(run, axis):
        arrs = [_arr(run, r) for r in row]
        xs = [a[key + "/x"] for a in arrs]
        ys = [a[key + "/y"] for a in arrs]
        for i, a in enumerate(arrs):
            out, grad = _axis_want(name, xs, ys, i)
            np.testing.assert_array_equal(a[key + "/out"], out)
            np.testing.assert_array_equal(a[key + "/grad"], grad)


@pytest.mark.parametrize("axis", ("sp", "mp"))
@pytest.mark.parametrize("name", _ADJOINT)
def test_axis_backward_is_the_adjoint(run, axis, name):
    """sum_i <f(x)_i, y_i> == sum_i <x_i, f^T(y)_i> over each row."""
    key = f"axis/{axis}/{name}"
    for row in _rows(run, axis):
        arrs = [_arr(run, r) for r in row]
        lhs = sum(float((a[key + "/out"] * a[key + "/y"]).sum())
                  for a in arrs)
        rhs = sum(float((a[key + "/x"] * a[key + "/grad"]).sum())
                  for a in arrs)
        assert lhs == rhs


def test_a_collective_that_never_completes_raises_at_its_deadline(run):
    t = _rec(run)["timeout"]
    assert t["raised"] and "did not complete within 1.5s" in t["raised"]
    assert t["deadline_s"] <= t["after_s"] < t["deadline_s"] + 5.0


# ---- comm bytes -------------------------------------------------------------

def _analytic_bytes(sp_mode):
    """The step's collective payload bytes by name@axis on every rank of
    dp 2 x mp 2 x sp 2 (f32, no mask)."""
    L, d, n, V = (dd.TINY[k] for k in ("num_layers", "hidden_size",
                                       "num_heads", "vocab_size"))
    h = d // n
    dp = mp = sp = 2
    b, s, nl = dd.TINY_BATCH // dp, dd.TINY_SEQ // sp, n // mp
    T = b * s
    E = T * d * 4                      # one [b, s, d] activation
    blk = b * s * nl * h * 4           # one q/k/v/out block
    f = 4 * d
    P = (V * d // mp + dd.TINY["max_seq_len"] * d + 2 * d
         + L * (4 * d + 3 * d * d // mp + 3 * d // mp + d * d // mp + d
                + d * f // mp + f // mp + f * d // mp + d))
    want = {
        # the embedding's sum, out_proj's and fc2's (forward); qkv's,
        # fc1's and the head's inputs (backward)
        "collective.mp_allreduce@mp": (1 + 2 * L) * E,
        "collective.c_identity@mp": (1 + 2 * L) * E,
        # the row max, then the sum of exp and the target logit
        "collective.parallel_ce@mp": 4 * T + 8 * T,
        # the gradients (sum over sp, average over dp) and the loss
        "collective.all_reduce@sp": 4 * P + 4,
        "collective.all_reduce@dp": 4 * P + 4,
        # ZeRO-1: this rank's section of the parameters
        "collective.all_gather@dp": 4 * P // dp,
    }
    if sp_mode == "ring":
        # forward: sp - 1 hops of the k/v pair; backward: sp - 1 of k/v
        # and sp of the f32 dk/dv pair
        want["collective.ppermute@sp"] = L * 2 * blk * (
            (sp - 1) + (sp - 1) + sp)
    else:
        # q, k, v and out each way, forward and backward
        want["collective.all_to_all@sp"] = L * 8 * blk
    return want


@pytest.mark.parametrize("tag", _HYBRID)
@pytest.mark.parametrize("rank", (0, 5))
def test_comm_span_bytes_equal_the_analytic_count(run, tag, rank):
    assert _rec(run, rank)[f"{tag}/spans"] == _analytic_bytes(tag.split("_")[0])


def test_ring_forward_moves_two_sp_minus_one_blocks_a_layer():
    want = _analytic_bytes("ring")["collective.ppermute@sp"]
    L = dd.TINY["num_layers"]
    blk = 2 * 16 * 2 * 16 * 4
    assert want == L * blk * (2 * (2 - 1) + 2 * (2 - 1) + 2 * 2)


@pytest.mark.parametrize("tag", _HYBRID)
def test_the_step_record_carries_the_collectives(run, tag):
    rec = _rec(run)[f"{tag}/record"]
    names = {k.split("@")[0] for k in _analytic_bytes(tag.split("_")[0])}
    assert set(rec["collectives"]) == names
    assert rec["comm_ms"] > 0 and 0 < rec["comm_frac"] <= 1.0


# ---- topology and DataParallel ------------------------------------------------

@pytest.mark.parametrize("rank", range(_RANKS))
def test_topology_queries_equal_the_jax_topology(run, rank):
    topo = JaxTopology(("data", "pipe", "model", "sep"), (2, 1, 2, 2))
    t = _rec(run, rank)["topology"]
    assert t["sizes"] == [2, 2, 2, 1]
    assert t["ranks"] == list(topo.get_coord(rank))
    for name, axis in (("data", "data"), ("model", "model"),
                       ("sep", "sep")):
        row = [g for g in topo.get_comm_list(axis) if rank in g]
        assert t["groups"][name] == row[0]
    assert t["worker_index"] == rank and t["worker_num"] == _RANKS


@pytest.mark.parametrize("rank", (0, 3, 6))
def test_data_parallel_averages_the_gradients_over_dp(run, rank):
    a = _arr(run, rank)
    lin = torch.nn.Linear(8, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(a["dp/w"]))
        lin.bias.copy_(torch.from_numpy(a["dp/b"]))
    x = torch.from_numpy(a["dp/x"])
    # the two dp halves' means, averaged: the full batch's mean
    (lin(x) ** 2).mean().backward()
    np.testing.assert_allclose(a["dp/gw"], lin.weight.grad.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a["dp/gb"], lin.bias.grad.numpy(),
                               rtol=1e-6, atol=1e-7)
