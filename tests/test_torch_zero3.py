"""ZeRO-3, the offloaded sharded step and the sharded checkpoints of the
port, on the CPU, as four gloo ranks.

One rank job (`paddle_tpu_torch.tools.dist_drill`'s `cpu_zero3` job,
4 ranks, a hard 120 s timeout) runs while this process computes the JAX
reference:

- a tiny GPT (2 layers, width 64, 4 heads, vocab 256, seq 32, batch 4,
  f32, numpy weights) for 3 AdamW steps under ZeRO-3 at dp 4 and at
  dp 2 x mp 2, against the JAX `TrainStep` on one device with no mesh:
  losses to 1e-5 relative, gathered parameters to 1e-4 (PR 18's bars);
  ZeRO-3 against ZeRO-2 at dp 4 to 1e-6 (losses relative, parameters
  absolute); ZeRO-3 with remat against ZeRO-3 to 1e-6 and against JAX,
  with the all_gather bytes of every step equal (a recomputed block is
  not gathered a third time); the sharded health taps at every_k 1
  (ZeRO-3 at dp 4, and at dp 2 x mp 2) against the JAX
  `TrainStep(health=)`'s: the gradient norm, update ratio and loss to
  1e-5 relative, the NaN and Inf counts exactly; `offload=True` at
  stages 1, 2 and 3 equal to the same stage without it, exactly; between steps a rank's parameter storage is
  exactly its ZeRO-3 pieces; `optimizer.state_dict()` names every
  logical slot;
- checkpoints at dp 4 ZeRO-3 (dropout 0.1, a save every 2 steps): a run
  with preemption requested on rank 2 alone stops every rank at the
  same boundary (exit 102, step_3 committed); its resume gives the
  uninterrupted run's losses and final parameters exactly; step_4
  restored under dp 2 x mp 2 gives every logical leaf bit for bit (each
  leaf assembled on rank 0 from the pieces the ranks hold, against the
  saved one),
  the elastic record is valid, and 2 more steps at dropout 0 track the
  same steps after a direct restore at dp 4 to 1e-5; every rank's
  ledger passes the port's ledger checks and JAX's tools/trace_check.py.
"""
import os
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import optimizer as jax_opt
from paddle_tpu.telemetry import health as jax_health
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT

from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.telemetry.ledger_check import check_jsonl
from paddle_tpu_torch.tools import dist_drill as dd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RANKS = 4
_SLOTS = ("beta1_pow", "beta2_pow", "moment1", "moment2")


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """The JAX references run on one device with no mesh; a JAX test
    file run earlier in this worker may have left its global mesh
    installed (`--dist loadfile`)."""
    from paddle_tpu.distributed import env as jax_env
    prev = jax_env.current_mesh()
    jax_env.set_mesh(None)
    yield
    jax_env.set_mesh(prev)


def _jax_train(weights):
    """3 AdamW steps of the JAX TrainStep on one device, no mesh, its
    health taps at every_k 1: (losses, parameters, each step's taps)."""
    import jax.numpy as jnp
    jm = JaxGPT(JaxGPTConfig(**dd.TINY))
    for n, p in jm.named_parameters():
        p._value = jnp.asarray(weights[n])
    jo = jax_opt.AdamW(learning_rate=dd.LR, weight_decay=dd.WD,
                       parameters=jm.parameters())
    step = paddle.jit.TrainStep(jm, jm.loss, jo,
                                health=jax_health.HealthConfig(**dd.HEALTH))
    ids, lbl = dd.tiny_batch(0)
    batch = [paddle.to_tensor(ids, "int32"), paddle.to_tensor(lbl, "int32")]
    losses = [float(np.asarray(step(*batch).numpy()))
              for _ in range(dd.ZERO3_STEPS)]
    return losses, {n: np.asarray(p._value) for n, p in
                    jm.named_parameters()}, list(step.health.ring)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_drill"))
    job = dd.start_job("cpu_zero3", out, seed=0, timeout=120.0)
    try:
        weights = dd.numpy_weights(GPTConfig(**dd.TINY), 0)
        ref = {"train": _jax_train(weights), "weights": weights}
    finally:
        res = job.wait()
    return res, ref, out


def _rec(run, rank=0):
    return run[0][rank][0]


def _arr(run, rank=0):
    return run[0][rank][1]


def test_every_rank_finished_every_case(run):
    assert sorted(run[0]) == list(range(_RANKS))
    for rank, (rec, _) in run[0].items():
        assert rec["rank"] == rank and rec["world"] == _RANKS
        assert "error" not in rec
        assert set(rec["case_s"]) == {c.__name__
                                      for c in dd.CASES["cpu_zero3"]}


@pytest.mark.parametrize("rank", range(_RANKS))
def test_a_finished_step_and_its_model_are_freed(run, rank):
    """Once the leg lets go of its step, the collector frees it, its
    model and its states: ZeRO-3's gradient hooks, which the tensors
    keep where the collector cannot see them, hold the step weakly."""
    freed = _rec(run, rank)["zero3_freed"]
    assert set(freed) == set(dd.ZERO3_CPU_TAGS) and all(freed.values())


# ---- ZeRO-3 against JAX and ZeRO-2 ------------------------------------------

@pytest.mark.parametrize("tag", ("z3", "z3_mp", "z3_remat"))
def test_zero3_tracks_the_jax_train_step(run, tag):
    jl, jp, _ = run[1]["train"]
    np.testing.assert_allclose(_rec(run)[tag]["losses"], jl, rtol=1e-5,
                               atol=0)
    arr = _arr(run)
    for n, ref in jp.items():
        np.testing.assert_allclose(arr[f"{tag}/{n}"], ref, rtol=0,
                                   atol=1e-4, err_msg=n)
    init = run[1]["weights"]
    assert max(np.abs(jp[n] - init[n]).max() for n in jp) > 2e-4


@pytest.mark.parametrize("tag", ("z3", "z3_mp"))
def test_every_rank_reports_the_global_loss(run, tag):
    losses = [rec[tag]["losses"] for rec, _ in run[0].values()]
    assert all(x == losses[0] for x in losses)


def test_zero3_with_remat_equals_zero3(run):
    """Remat recomputes each block in the backward: the same numbers as
    ZeRO-3 without it (1e-6), every step's all_gather bytes the same (the
    rerun uses the gather its output's gradient made), and each block's
    flash forward and add + LayerNorm run twice a step, on the CPU as
    their plain versions (no kernel counts here)."""
    a = _arr(run)
    for n in run[1]["weights"]:
        np.testing.assert_allclose(a[f"z3_remat/{n}"], a[f"z3/{n}"], rtol=0,
                                   atol=1e-6, err_msg=n)
    cmp = _rec(run)["zero3_cmp"]["z3_remat"]
    assert cmp["vs"] == "z3" and cmp["rel"] < 1e-6
    assert max(cmp["loss_rel"]) < 1e-6
    for rec, _ in run[0].values():
        got = [st["comm"]["bytes"]["all_gather"]
               for st in rec["z3_remat"]["steps"]]
        assert got == [st["comm"]["bytes"]["all_gather"]
                       for st in rec["z3"]["steps"]]


@pytest.mark.parametrize("tag", ("z3_health", "z3_mp"))
def test_sharded_health_taps_track_the_jax_taps(run, tag):
    """Every rank's fetched stats of each step (ZeRO-3 pieces at dp 4;
    pieces of mp-cut parameters at dp 2 x mp 2) against the JAX
    TrainStep's taps on one device; the same on every rank."""
    want = run[1]["train"][2]
    assert len(want) == dd.ZERO3_STEPS
    for rec, _ in run[0].values():
        got = [st["health"] for st in rec[tag]["steps"]]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for key in ("grad_norm", "update_ratio", "loss"):
                assert g[key] == pytest.approx(w[key], rel=1e-5, abs=0), key
            assert (g["nan_count"], g["inf_count"]) == (
                w["nan_count"], w["inf_count"]) == (0, 0)
            assert g["grad_norm"] > 0 and g["update_ratio"] > 0
        assert got == [st["health"] for st in _rec(run)[tag]["steps"]]


def test_zero3_equals_zero2(run):
    a = _arr(run)
    for n in run[1]["weights"]:
        np.testing.assert_allclose(a[f"z3/{n}"], a[f"z2/{n}"], rtol=0,
                                   atol=1e-6, err_msg=n)
    np.testing.assert_allclose(_rec(run)["z3"]["losses"],
                               _rec(run)["z2"]["losses"], rtol=1e-6)
    cmp = _rec(run)["zero3_cmp"]["z3"]
    assert cmp["vs"] == "z2" and cmp["rel"] < 1e-6


@pytest.mark.parametrize("tag", ("z1_off", "z2_off", "z3_off"))
def test_offload_equals_the_same_stage_exactly(run, tag):
    cmp = _rec(run)["zero3_cmp"][tag]
    assert cmp["vs"] == tag.split("_")[0]
    assert cmp["equal"] and cmp["max_abs"] == 0.0
    assert cmp["loss_rel"] == [0.0] * dd.ZERO3_STEPS


@pytest.mark.parametrize("rank", range(_RANKS))
def test_zero3_parameter_bytes_are_the_pieces(run, rank):
    """Between steps a rank holds no parameter storage but its pieces:
    ceil(n / 4) of each parameter's n elements (the last rank's shorter),
    and AdamW's two moments of the same size."""
    want = 0
    for a in run[1]["weights"].values():
        n = a.size
        c = -(-n // _RANKS)
        want += 4 * (min((rank + 1) * c, n) - min(rank * c, n))
    for d in _rec(run, rank)["z3"]["steps"]:
        mem = d["memory"]
        assert mem["param_storage"] == 0
        assert mem["owned"] == want
        assert mem["state"] == 2 * want
    z2 = _rec(run, rank)["z2"]["steps"][-1]["memory"]
    assert z2["owned"] == 0 and z2["param_storage"] == 4 * sum(
        a.size for a in run[1]["weights"].values())
    assert z2["state"] == 2 * want


def test_state_dict_names_every_logical_slot(run):
    want = sorted(f"{n}_{s}" for n in run[1]["weights"] for s in _SLOTS)
    for rec, _ in run[0].values():
        for tag in ("z3", "z3_mp", "z2"):
            assert rec[tag]["state_dict"] == want


# ---- checkpoints -----------------------------------------------------------

def test_preemption_on_one_rank_stops_every_rank_at_one_boundary(run):
    for rec, _ in run[0].values():
        pre = rec["ckpt_preempt"]
        assert pre["exit"] == {"code": 102, "step": 3}
        assert sorted(pre["losses"], key=int) == ["0", "1", "2"]
        assert pre["steps_on_disk"] == [2, 3]


def test_resume_gives_the_uninterrupted_run_exactly(run):
    for rec, _ in run[0].values():
        base = rec["ckpt_base"]["losses"]
        res = rec["ckpt_resume"]
        assert res["resumed_via"] == "direct" and res["start"] == 3
        assert {**rec["ckpt_preempt"]["losses"], **res["losses"]} == base
        assert len(base) == dd.CKPT_CPU["steps"]
        assert res["digest"] == rec["ckpt_base"]["digest"]


def test_reshard_restores_every_leaf_bit_for_bit(run):
    rec = _rec(run)
    for tag, via in (("ckpt_direct", "direct"), ("ckpt_reshard", "reshard")):
        assert rec[f"{tag}/leaves"]["n_differ"] == 0
        assert rec[f"{tag}/leaves"]["n"] == 5 * len(run[1]["weights"]) \
            == rec[f"{tag}/leaves"]["checked"]
        for r, _ in run[0].values():
            assert r[tag]["resumed_via"] == via
            assert r[tag]["start"] == dd.CKPT_CPU["start"]


def test_the_continuation_tracks_the_direct_restore(run):
    a = _rec(run)["ckpt_reshard"]["losses"]
    b = _rec(run)["ckpt_direct"]["losses"]
    plan = dd.CKPT_CPU
    assert sorted(a) == sorted(b) == [str(plan["start"] + k)
                                      for k in range(plan["cont"])]
    np.testing.assert_allclose([a[k] for k in sorted(a)],
                               [b[k] for k in sorted(b)], rtol=1e-5, atol=0)


def test_the_elastic_record_and_the_ledgers_validate(run):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from trace_check import check_pair
    for rank, (rec, _) in run[0].items():
        (el,) = rec["ckpt_reshard"]["elastic"]
        assert el["event"] == "reshard_restore" and \
            el["step"] == dd.CKPT_CPU["start"]
        assert el["layout_from"]["dp"] == 4 and \
            el["layout_from"]["zero_stage"] == 3
        assert el["layout_to"]["dp"] == 2 and el["layout_to"]["mp"] == 2
        for leg in ("base", "drill", "ckpt_reshard"):
            path = os.path.join(run[2], f"{leg}_{rank}.jsonl")
            recs, problems = check_jsonl(path)
            assert problems == [], (leg, rank)
            assert check_pair(path)[0] == [], (leg, rank)
            if leg == "ckpt_reshard":
                assert any(r["kind"] == "elastic" for r in recs)
