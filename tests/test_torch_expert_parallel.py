"""The port's expert parallelism against the JAX package, on the CPU, as
four gloo ranks.

One rank job (`paddle_tpu_torch.tools.dist_drill`'s `cpu_ep` job, 4
ranks, a hard 120 s timeout that kills every rank) runs while this
process computes the JAX references; every test below reads its files:

- `moe_ffn_values` on dp 2 x ep 2 and ep 2 x mp 2 (capacity factor 1.0,
  so choices drop), its output, aux, z, stats and the gradients of x,
  w_gate, w_in and w_out (the cut weights gathered), against JAX's
  `_local_moe(..., ep=1, use_kernel=False)` run on each rank's token
  block with aux, z and the stats averaged (the per-shard rule of JAX's
  shard_map over ep), f32 to 1e-5;
- the tiny GPT-MoE's ShardedTrainStep on dp 2 x ep 2, dropless and
  without the aux loss (see `dist_drill.MOE_TINY`), 2 AdamW steps under
  ZeRO-1, ZeRO-2 and a global-norm clip, and 2 SGD steps (Adam's update
  hides a gradient's scale, SGD's does not), against the JAX TrainStep
  on one device: losses to 1e-5 relative, the gathered parameters to
  1e-4 (the bars of test_torch_moe.py); `shard_model` cuts w_in and
  w_out along the expert dim;
- `global_scatter` / `global_gather` over 4 ranks against the
  reference's layout, their round trip and the scatter's backward, and
  at a world of one against the JAX functions;
- the deprecated `MoELayer` on dp 2 x ep 2 against the JAX layer on one
  device, output, aux and gradients to 1e-5;
- the divisibility errors, ep with sp raising, and the topology's ep
  queries.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.distributed import dist_utils as jax_dist_utils
from paddle_tpu.distributed.moe import MoELayer as JaxMoELayer
from paddle_tpu.moe import GPTMoE as JaxGPTMoE
from paddle_tpu.moe import GPTMoEConfig as JaxGPTMoEConfig
from paddle_tpu.moe.layer import _local_moe
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip

from paddle_tpu_torch.distributed import dist_utils
from paddle_tpu_torch.moe import GPTMoE, GPTMoEConfig
from paddle_tpu_torch.tools import dist_drill as dd

_RANKS = 4
_STEPS = 2
_MESH_TAGS = ("dp2xep2", "ep2xmp2")
_FIELDS = ("out", "aux", "z", "stats", "dx", "dwg", "dwi", "dwo")


def _jax_values():
    """{(mesh tag, dp row): {field: array}}: `_local_moe` on each ep
    block of the row's tokens, the means of aux, z and stats, and the
    gradients of sum(out * ct) + a aux + b z."""
    c = dd.EP_OP
    x, ct, wg, wi, wo = dd.ep_op_inputs(0)
    ep = 2

    def f(xr, g, i, o, ctr):
        tok = xr.reshape(-1, c["d"])
        outs, auxs, zs, sts = [], [], [], []
        for b in jnp.split(tok, ep):
            res = _local_moe(b, g, i, o, num_experts=c["E"], k=2,
                             capacity_factor=c["cf"], ep=1, axis_name="ep",
                             use_kernel=False)
            for lst, v in zip((outs, auxs, zs, sts), res):
                lst.append(v)
        out = jnp.concatenate(outs).reshape(xr.shape)
        aux, z = sum(auxs) / ep, sum(zs) / ep
        stats = sum(sts) / ep
        loss = (out * ctr).sum() + c["aux"] * aux + c["z"] * z
        return loss, (out, aux, z, stats)

    g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True))
    ref = {}
    for di in (0, 1):
        (_, (out, aux, z, stats)), (dx, dwg, dwi, dwo) = g(
            *(jnp.asarray(a) for a in (x[di], wg, wi, wo, ct[di])))
        vals = dict(out=out, aux=aux, z=z, stats=stats, dx=dx, dwg=dwg,
                    dwi=dwi, dwo=dwo)
        ref[di] = {k: np.asarray(v) for k, v in vals.items()}
    return ref


def _jax_moe_train(weights, clip=None, sgd=False):
    """2 AdamW (or SGD) steps of the JAX TrainStep on one device, no
    mesh."""
    jm = JaxGPTMoE(JaxGPTMoEConfig(**dd.MOE_TINY))
    for n, p in jm.named_parameters():
        p._value = jnp.asarray(weights[n])
    if sgd:
        jo = jax_opt.SGD(learning_rate=dd.SGD_LR, parameters=jm.parameters())
    else:
        jo = jax_opt.AdamW(learning_rate=dd.LR, weight_decay=dd.WD,
                           parameters=jm.parameters(),
                           grad_clip=JaxClip(clip) if clip else None)
    step = paddle.jit.TrainStep(jm, jm.loss, jo)
    ids, lbl = dd.tiny_batch(0)
    batch = [paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32")]
    losses = [float(np.asarray(step(*batch).numpy())) for _ in range(_STEPS)]
    return losses, {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _jax_moelayer(arr, di):
    """The JAX MoELayer on one device over dp row `di`'s tokens: out,
    aux and the gradients of sum(out * ct) + aux / 2."""
    c = dd.EP_OP
    layer = JaxMoELayer(c["d"], c["f"], c["E"], k=2,
                        capacity_factor=c["cf"])
    for n, p in layer.named_parameters():
        p._value = jnp.asarray(arr[f"moelayer/w/{n}"])
    xt = paddle.to_tensor(arr["moelayer/x"][di])
    xt.stop_gradient = False
    out = layer(xt)
    aux = layer.aux_loss()
    ((out * paddle.to_tensor(arr["moelayer/ct"][di])).sum()
     + 0.5 * aux).backward()
    res = {"out": np.asarray(out._value), "aux": np.asarray(aux._value),
           "dx": np.asarray(xt.grad._value)}
    for n, p in layer.named_parameters():
        res[f"g/{n}"] = np.asarray(p.grad._value)
    return res


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The rank job's files, and the JAX references computed while the
    ranks run."""
    job = dd.start_job("cpu_ep", str(tmp_path_factory.mktemp("cpu_ep")),
                       seed=0, timeout=120.0)
    try:
        cfg = GPTMoEConfig(**dd.MOE_TINY)
        weights = dd.numpy_weights(cfg, 0, GPTMoE(cfg, device="meta"))
        ref = {"values": _jax_values(), "train": _jax_moe_train(weights),
               "clip": _jax_moe_train(weights, dd.CLIP_NORM),
               "sgd": _jax_moe_train(weights, sgd=True)}
    finally:
        res = job.wait()
    return res, ref


def _rank_rec(run, rank):
    return run[0][rank][0]


def _rank_arr(run, rank):
    return run[0][rank][1]


# ---- the job ---------------------------------------------------------------

def test_every_rank_finished_every_case(run):
    res, _ = run
    assert sorted(res) == list(range(_RANKS))
    for rank, (rec, _) in res.items():
        assert rec["rank"] == rank and "error" not in rec


# ---- moe_ffn_values at ep 2 -----------------------------------------------

@pytest.mark.parametrize("field", _FIELDS)
@pytest.mark.parametrize("mesh", _MESH_TAGS)
def test_moe_ffn_values_matches_jax_per_shard(run, mesh, field):
    """Every rank's output (its rows, all blocks gathered), aux, z,
    stats and gradients against JAX's per-block `_local_moe` of its dp
    row."""
    _, ref = run
    for rank in range(_RANKS):
        rec, arr = _rank_rec(run, rank), _rank_arr(run, rank)
        di = rec[f"ep_values/{mesh}"]["coords"]["dp"]
        got = arr[f"ep_values/{mesh}/{field}"]
        np.testing.assert_allclose(got, ref["values"][di][field], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {rank}")


def test_the_values_cases_drop_choices(run):
    """At cf 1.0 the blocks drop choices (dropped_frac > 0), so the
    capacity of each rank's block is what the comparison holds."""
    _, ref = run
    assert ref["values"][0]["stats"][1] > 0.0


# ---- the GPT-MoE step at dp 2 x ep 2 -------------------------------------------

@pytest.mark.parametrize("tag,key", [("moe_z1", "train"),
                                     ("moe_z2", "train"),
                                     ("moe_z1_clip", "clip"),
                                     ("moe_sgd", "sgd")])
def test_moe_step_matches_jax_one_device(run, tag, key):
    res, ref = run
    jl, jp = ref[key]
    for rank in range(_RANKS):
        np.testing.assert_allclose(_rank_rec(run, rank)[tag]["losses"], jl,
                                   rtol=1e-5)
    arr = _rank_arr(run, 0)
    for n, want in jp.items():
        np.testing.assert_allclose(arr[f"{tag}/{n}"], want, atol=1e-4,
                                   rtol=0, err_msg=n)


def test_moe_zero_stages_agree(run):
    arr = _rank_arr(run, 0)
    names = [k[len("moe_z1/"):] for k in arr if k.startswith("moe_z1/")]
    assert names
    for n in names:
        np.testing.assert_allclose(arr[f"moe_z2/{n}"], arr[f"moe_z1/{n}"],
                                   atol=1e-6, rtol=0, err_msg=n)


def test_shard_model_cuts_the_experts_over_ep(run):
    cuts = _rank_rec(run, 0)["moe_cuts"]
    assert sorted(cuts) == sorted(
        f"gpt.blocks.{i}.mlp.{w}" for i in range(2) for w in ("w_in",
                                                               "w_out"))
    assert all(c == [[0, "ep"]] for c in cuts.values())


def test_moe_states_are_the_ep_pieces(run):
    """Each rank's optimizer states cover its ep piece of the experts
    (ZeRO-1 over dp 2): less than a whole model's."""
    z1 = [_rank_rec(run, k)["moe_z1"]["state_bytes"] for k in range(_RANKS)]
    cfg = GPTMoEConfig(**dd.MOE_TINY)
    full = sum(p.numel() for p in GPTMoE(cfg, device="meta").parameters())
    assert all(b < 2 * 4 * full / 2 for b in z1), (z1, full)


# ---- global_scatter / global_gather ------------------------------------------------

def _scatter_model(lcs, xs, me, ne):
    """The reference's exchange in numpy: expert-major rows for rank
    `me` from every rank's bucketed rows."""
    world = len(lcs)
    out = []
    for e in range(ne):
        for src in range(world):
            starts = np.concatenate([[0], np.cumsum(lcs[src])[:-1]])
            b = me * ne + e
            out.append(xs[src][starts[b]:starts[b] + lcs[src][b]])
    return np.concatenate(out)


def test_global_scatter_delivers_the_reference_layout(run):
    lcs = [_rank_arr(run, k)["exchange/lc"] for k in range(_RANKS)]
    xs = [_rank_arr(run, k)["exchange/x"] for k in range(_RANKS)]
    for k in range(_RANKS):
        np.testing.assert_array_equal(_rank_arr(run, k)["exchange/out"],
                                      _scatter_model(lcs, xs, k, 2))


def test_global_gather_inverts_global_scatter(run):
    for k in range(_RANKS):
        a = _rank_arr(run, k)
        np.testing.assert_array_equal(a["exchange/back"], a["exchange/x"])


def test_global_scatter_backward_is_the_gather(run):
    """d sum(scatter(x) * w) / dx: each rank's w rows sent back to the
    rows of x they came from."""
    lcs = [_rank_arr(run, k)["exchange/lc"] for k in range(_RANKS)]
    for k in range(_RANKS):
        a = _rank_arr(run, k)
        # the rows of x, tagged by index, through the same exchange
        idx = [np.arange(len(_rank_arr(run, j)["exchange/x"]))[:, None]
               + 10000 * j for j in range(_RANKS)]
        tags = [_scatter_model(lcs, idx, j, 2)[:, 0] for j in range(_RANKS)]
        want = np.zeros_like(a["exchange/x"])
        for j in range(_RANKS):
            w = _rank_arr(run, j)["exchange/w"]
            for row, t in enumerate(tags[j]):
                if t // 10000 == k:
                    want[t % 10000] += w[row]
        np.testing.assert_allclose(a["exchange/dx"], want, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("fn", ["global_scatter", "global_gather"])
def test_exchange_at_world_one_matches_jax(fn):
    """One rank: the JAX global-array permutation and the port's
    exchange agree (both the identity in expert order)."""
    rs = np.random.RandomState(3)
    lc = rs.randint(0, 4, 6)
    x = rs.randn(int(lc.sum()), 5).astype(np.float32)
    want = np.asarray(getattr(jax_dist_utils, fn)(
        paddle.to_tensor(x), lc, lc).numpy())
    got = getattr(dist_utils, fn)(torch.from_numpy(x), lc, lc, group=None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exchange_checks_its_counts():
    x = torch.zeros(5, 2)
    with pytest.raises(ValueError, match="sums to"):
        dist_utils.global_scatter(x, [1, 1], [1, 1])
    with pytest.raises(ValueError, match="mismatch"):
        dist_utils.global_scatter(x, [2, 3], [5])


# ---- the deprecated MoELayer ----------------------------------------------------------

@pytest.mark.parametrize("field", ["out", "aux", "dx", "g/w_gate", "g/w_in",
                                   "g/w_out"])
def test_moelayer_at_ep2_matches_jax(run, field):
    refs = {}
    for rank in range(_RANKS):
        rec, arr = _rank_rec(run, rank), _rank_arr(run, rank)
        di = rec["moelayer"]["coords"]["dp"]
        if di not in refs:
            refs[di] = _jax_moelayer(arr, di)
        np.testing.assert_allclose(arr[f"moelayer/{field}"], refs[di][field],
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {rank}")


def test_moelayer_holds_its_ep_piece(run):
    """Each rank holds E/ep experts of w_in: the ep pieces are the two
    halves of the full weight."""
    arr = _rank_arr(run, 0)
    rec = _rank_rec(run, 0)
    E = dd.EP_OP["E"]
    assert rec["moelayer"]["local_w_in"][0] == E // 2
    pieces = arr["moelayer/w_in_pieces"]
    coords = [_rank_rec(run, k)["moelayer"]["coords"]["ep"]
              for k in range(_RANKS)]
    full = arr["moelayer/w/w_in"]
    for k, e in enumerate(coords):
        np.testing.assert_array_equal(pieces[k],
                                      full[e * E // 2:(e + 1) * E // 2])


# ---- errors and topology ---------------------------------------------------------------

@pytest.mark.parametrize("case,kind,text", [
    ("ep_tokens", "ValueError", "divisible by the 'ep' mesh axis"),
    ("ep_experts", "ValueError", "num_experts (3)"),
    ("ep_sp", "NotImplementedError", "6.6"),
])
def test_errors(run, case, kind, text):
    msg = _rank_rec(run, 0)["errors"][case]
    assert msg is not None and msg.startswith(kind) and text in msg, msg


def test_topology_answers_the_ep_axis(run):
    for k in range(_RANKS):
        t = _rank_rec(run, k)["ep_topology"]
        assert t["size"] == 2
        # mesh (dp 2, ep 2): rank = dp * 2 + ep
        assert t["rank"] == k % 2 and t["dp_rank"] == k // 2
        assert t["group"] == [k - k % 2, k - k % 2 + 1]
