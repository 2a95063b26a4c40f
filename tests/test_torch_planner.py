"""The port's planner (paddle_tpu_torch/planner/) held against the JAX
package's: the same configs and the same card figures (a ChipSpec built
here from the JAX tables) give the same chosen layout, candidate list,
rejection rule ids, projected bytes and costs; the memory arithmetic,
the calibrations and the partition rules agree; the planned mp 2 step on
two gloo ranks matches the one-process step; and the wiring into
ShardedTrainStep, PipelineParallel and the elastic coordinator."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import planner as jplanner
from paddle_tpu.cost_model import DCN_BW_BYTES as J_DCN
from paddle_tpu.cost_model import ICI_BW_BY_CHIP as J_ICI
from paddle_tpu.distributed import elastic as jax_elastic
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.moe.model import GPTMoEConfig as JGPTMoEConfig
from paddle_tpu.planner.memory import HBM_BYTES as J_HBM
from paddle_tpu.telemetry.mfu import device_peak_flops as j_peak

from paddle_tpu_torch import planner
from paddle_tpu_torch.cost_model import ChipSpec
from paddle_tpu_torch.distributed import elastic, env
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.moe.model import GPTMoE, GPTMoEConfig
from paddle_tpu_torch.telemetry.ledger_check import check_records
from paddle_tpu_torch.tools import dist_drill as dd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30


def chip(name):
    """The JAX tables' figures for `name`, as a port ChipSpec."""
    return ChipSpec(name=name, hbm_bytes=J_HBM[name],
                    peak_flops=j_peak(name), link_bw=J_ICI[name],
                    dcn_bw=J_DCN)


def configs(name):
    """(JAX config, port config) of one case."""
    if name == "moe":
        kw = dict(vocab_size=50304, hidden_size=768, num_layers=12,
                  num_heads=12, max_seq_len=1024, num_experts=8)
        return JGPTMoEConfig(**kw), GPTMoEConfig(**kw)
    preset = {"1.3b": "gpt3_1_3b", "13b": "gpt3_13b"}[name]
    return (getattr(JGPTConfig, preset)(max_seq_len=2048),
            getattr(GPTConfig, preset)(max_seq_len=2048))


def _cands(cands):
    return [(c.layout.to_dict(), c.status, (c.reason or "").split(":")[0],
             int(c.projected_hbm_bytes), c.state_report) for c in cands]


# (case, model, mesh_shape, chip, budget GiB, verify)
CASES = [
    ("1.3b_32", "1.3b", 32, "v5p", None, "sharding"),
    ("13b_dp2_mp8", "13b", {"dp": 2, "mp": 8}, "v5p", None, "sharding"),
    ("infeasible", "1.3b", 4, "v5e", 1.0, "sharding"),
    ("moe_8", "moe", 8, "v5p", None, "sharding"),
]


@pytest.mark.parametrize("case,model,mesh,chip_name,budget,verify", CASES,
                         ids=[c[0] for c in CASES])
def test_planner_parity(case, model, mesh, chip_name, budget, verify):
    jcfg, cfg = configs(model)
    kw = dict(hbm_budget=None if budget is None else int(budget * GIB),
              verify=verify)
    got = {}
    for k, fn, c, m in (("jax", jplanner.plan, chip_name, jcfg),
                        ("port", planner.plan, chip(chip_name), cfg)):
        try:
            p = fn(m, mesh, chip=c, **kw)
            got[k] = (p.layout.to_dict(), _cands(p.candidates),
                      [c_.cost for c_ in p.candidates], p)
        except (jplanner.InfeasiblePlanError,
                planner.InfeasiblePlanError) as e:
            got[k] = (str(e), _cands(e.candidates),
                      [c_.cost for c_ in e.candidates], None)
    j, t = got["jax"], got["port"]
    assert t[0] == j[0]                  # chosen layout (or the error text)
    assert t[1] == j[1]                  # layouts, status, rule ids, bytes
    assert t[2] == j[2]                  # costs: equal floats, not close
    if case == "infeasible":
        assert t[3] is None and "SH206" in t[0]
        return
    jp, tp = j[3], t[3]
    assert tp.projected_hbm_bytes == jp.projected_hbm_bytes
    assert tp.cost == jp.cost
    assert tp.summary_table() == jp.summary_table()
    assert tp.verify == jp.verify


# ---- the memory arithmetic --------------------------------------------------

def test_memory_arithmetic_parity():
    for name in ("1.3b", "13b", "moe"):
        jcfg, cfg = configs(name)
        assert planner.gpt_params(cfg) == jplanner.gpt_params(jcfg)
        for dp, mp, pp, sp, mb, zero, remat, opt in (
                (1, 1, 1, 1, 1, 1, True, "adamw"),
                (2, 4, 2, 1, 2, 2, True, "adam"),
                (4, 2, 1, 2, 1, 3, False, "sgd"),
                (8, 8, 4, 2, 4, 0, False, "lamb")):
            a = planner.gpt_memory_plan(cfg, dp, mp, pp, sp, mb, zero, remat,
                                        optimizer=opt)
            b = jplanner.gpt_memory_plan(jcfg, dp, mp, pp, sp, mb, zero,
                                         remat, optimizer=opt)
            assert vars(a) == vars(b)
        for n in (4, 8, 32):
            got = planner.search_plan(cfg, n, chip=chip("v5p"))
            want = jplanner.search_plan(jcfg, n, chip="v5p")
            assert [vars(p) for p in got] == [vars(p) for p in want]
    odd = JGPTConfig(vocab_size=50257, hidden_size=100, num_layers=6,
                     num_heads=10, max_seq_len=1000)
    podd = GPTConfig(vocab_size=50257, hidden_size=100, num_layers=6,
                     num_heads=10, max_seq_len=1000)
    for mp in (1, 2, 3, 4, 5, 8):
        for sp in (1, 2, 3, 8):
            assert planner.tp_divisibility_issues(podd, mp, sp) == \
                jplanner.tp_divisibility_issues(odd, mp, sp)


def test_calibrations_parity_with_the_clamp():
    recs = [{"kind": "compile", "hbm": {"total_bytes": m},
             "hbm_projected_bytes": p}
            for m, p in ((300, 100), (90, 100), (120, 100), (10, 100))]
    recs += [{"kind": "step"}, "junk", {"kind": "compile", "hbm": {}}]
    assert planner.calibration_from_records(recs) == \
        jplanner.calibration_from_records(recs)
    for hi_lo in ([(900.0, 1.0)], [(0.1, 1.0)], [(2.0, 1.0), (3.0, 1.0)]):
        crec = [{"kind": "commbench", "op": "psum", "time_ms": m,
                 "predicted_ms": p} for m, p in hi_lo]
        crec += [{"kind": "commbench", "op": "all_gather", "time_ms": 1.0,
                  "predicted_ms": 2.0, "event": "db_update"},
                 {"kind": "commbench", "op": "ppermute", "time_ms": 3.0,
                  "predicted_ms": None}]
        got = planner.calibration_from_comm_records(crec)
        assert got == jplanner.calibration_from_comm_records(crec)
        assert 0.5 <= got["psum"] <= 4.0 and set(got) == {"psum"}
    assert planner.calibration_from_records([]) == 1.0


# ---- the partition rules -------------------------------------------------

def test_rules_resolve_as_jax_over_the_port_models_names():
    assert planner.gpt_partition_rules() == jplanner.gpt_partition_rules()
    assert planner.gpt_moe_partition_rules() == \
        jplanner.gpt_moe_partition_rules()
    lo = planner.SpecLayout(tp_axis="tp", ep_axis="ex")
    jlo = jplanner.SpecLayout(tp_axis="tp", ep_axis="ex")
    assert planner.gpt_moe_partition_rules(lo) == \
        jplanner.gpt_moe_partition_rules(jlo)
    for name, model in (("1.3b", GPTForPretraining), ("moe", GPTMoE)):
        jcfg, cfg = configs(name)
        cfg.num_layers = jcfg.num_layers = 2
        live = [(n, tuple(p.shape)) for n, p in
                model(cfg, device="meta").named_parameters()]
        abstract = planner.abstract_params_for(cfg)
        assert [(n, p.shape) for n, p in abstract] == live
        assert [(n, p.shape) for n, p in
                jplanner.abstract_params_for(jcfg)] == live
        rules = planner.default_rules_for(cfg)
        assert rules == jplanner.default_rules_for(jcfg)
        got = planner.match_partition_rules(rules, abstract)
        assert got == jplanner.match_partition_rules(
            rules, jplanner.abstract_params_for(jcfg))
        for n, _ in live:
            assert planner.parameter_spec_from_name(n, rules=rules) == \
                jplanner.parameter_spec_from_name(n, rules=rules)
    qkv = dict(planner.gpt_abstract_params(cfg))
    assert qkv["gpt.blocks.0.attn.qkv_proj.weight"].groups == 3


def test_apply_partition_rules_keeps_the_tags_groups():
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=1,
                    num_heads=4, max_seq_len=64)
    m = GPTForPretraining(cfg, device="meta")
    attn = m.gpt.blocks[0].attn
    rules = [(r"qkv_proj\.weight$", ("mp", None)), (".*", ())]
    planner.apply_partition_rules(m, rules)         # existing tags win
    assert attn.mesh_axes["qkv_proj.weight"] == ((None, "mp"), 3)
    planner.apply_partition_rules(m, rules, overwrite=True)
    assert attn.mesh_axes["qkv_proj.weight"] == (("mp", None), 3)
    assert attn.mesh_axes["qkv_proj.bias"] == ((), 3)
    assert "mesh_axes" not in vars(attn.qkv_proj)    # the tag's owner kept
    planner.apply_partition_rules(m, planner.gpt_partition_rules(),
                                  overwrite=True)
    assert attn.mesh_axes["qkv_proj.weight"] == ((None, "mp"), 3)
    assert attn.mesh_axes["qkv_proj.bias"] == (("mp",), 3)


# ---- the planned step and the wiring -------------------------------------

def test_planned_mp2_step_matches_the_one_process_step(tmp_path):
    res = dd.run_job("cpu_plan", str(tmp_path), seed=0, timeout=120.0)
    ref = res[0][0]["plan/reference"]
    for rank in (0, 1):
        rec = res[rank][0]["plan"]
        assert rec["layout"]["mp"] == 2 and rec["layout"]["remat"]
        assert rec["qkv_tag"] == [[None, "mp"], 3]     # re-tagged, groups 3
        assert rec["lint"] == []                       # lint=True: clean
        np.testing.assert_allclose(rec["losses"], ref, rtol=1e-5)


def test_sharded_step_rejects_a_mismatched_mesh_before_tagging():
    from paddle_tpu_torch.distributed import ShardedTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=1,
                    num_heads=4, max_seq_len=64)
    p = planner.plan(cfg, mesh_shape={"dp": 2}, verify="sharding")
    m = GPTForPretraining(cfg, device="meta")
    m.gpt.blocks[0].ln1.mesh_axes = {}
    rules = [(r"ln1\.weight$", ("mp",))] + p.rules
    p.rules = rules
    with pytest.raises(ValueError, match="mesh does not match the plan"):
        ShardedTrainStep(m, m.loss, AdamW(parameters=m.parameters()),
                         mesh=planner.MeshSpec(mp=2), plan=p)
    assert m.gpt.blocks[0].ln1.mesh_axes == {}         # nothing tagged
    with pytest.raises(ValueError, match="needs 2 ranks"):
        p.build_mesh()                                  # one-process world


def test_pipeline_apply_plan_gives_2pp_micro_batches():
    from paddle_tpu_torch.distributed import PipelineLayer, PipelineParallel
    cfg = GPTConfig(vocab_size=256, hidden_size=64, num_layers=8,
                    num_heads=4, max_seq_len=64)
    p4 = planner.plan(cfg, mesh_shape={"pp": 4}, verify="sharding")
    layers = PipelineLayer([torch.nn.Linear(4, 4) for _ in range(4)],
                           loss_fn=lambda o, t: o.sum())
    pipe = PipelineParallel(layers)
    assert pipe.apply_plan(p4) is pipe
    assert (pipe._num_micro, pipe.plan) == (8, p4)
    env.set_mesh(planner.MeshSpec(pp=2))
    try:
        with pytest.raises(ValueError, match="wants pp=4 but the process "
                                             "mesh has pp=2"):
            PipelineParallel(layers).apply_plan(p4)
    finally:
        env.clear_mesh()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _replan_script(mod, reg, cfg, chip_arg):
    clk = FakeClock()
    m = mod.ElasticManager(reg, np=2, host_id="0", timeout=2.0,
                           fault_tolerance_level=1, clock=clk)
    coord = mod.ElasticCoordinator(m, model_cfg=cfg, chip=chip_arg,
                                   miss_threshold=3, clock=clk,
                                   poll_interval=0, exit_on_change=False,
                                   chips_per_host=4)
    with open(os.path.join(reg, "host-1.json"), "w") as f:
        f.write(json.dumps({"host": "1", "ts": 1.0, "np": 2}))
    coord.poll(step=1)
    for t, step in ((3.0, 2), (3.5, 3), (4.0, 4)):
        clk.t = t
        coord.poll(step=step)
    out = coord.step_boundary(step=5)
    return out, [e["event"] for e in coord.events], coord.next_layout


def test_elastic_model_cfg_replans_to_jaxs_layout(tmp_path):
    jcfg, cfg = configs("1.3b")
    got = {"jax": _replan_script(jax_elastic, str(tmp_path / "j"), jcfg,
                                 "v5p"),
           "port": _replan_script(elastic, str(tmp_path / "p"), cfg,
                                  chip("v5p"))}
    assert got["port"] == got["jax"]
    layout, events, nxt = got["port"]
    assert events[-2:] == ["replan", "relaunch"]
    assert layout == nxt and sum(v for k, v in nxt.items()
                                 if k != "zero_stage") >= 4


def test_plan_moves_no_random_stream_and_records_validate():
    from paddle_tpu_torch.planner import planner as pmod
    pmod._PROXY_CACHE.clear()
    torch.manual_seed(123)
    np.random.seed(7)
    before = (torch.get_rng_state(), np.random.get_state()[1].copy())
    _, cfg = configs("1.3b")
    p = planner.plan(cfg, 4, verify="full")
    after = (torch.get_rng_state(), np.random.get_state()[1])
    assert torch.equal(before[0], after[0])
    assert np.array_equal(before[1], after[1])
    assert p.chip == "h100" and p.hbm_budget == int(85017493504 * 0.8)
    assert p.verify["families_checked"] == ["sharding", "program",
                                            "collective_order"]
    assert (p.verify["collectives_recorded"],
            p.verify["collective_findings"]) == (0, 0)
    assert p.verify["program_ops"] > 0
    assert not any(c.findings for c in p.candidates if c.feasible)
    # the same search verified by the sharding lint alone picks the same
    assert planner.plan(cfg, 4, verify="sharding").layout == p.layout
    rec = p.to_record(measured_hbm_bytes=p.projected_hbm_bytes)
    assert check_records([rec]) == []
    bad = p.to_record(measured_hbm_bytes=2 * p.projected_hbm_bytes)
    assert any("drift" in x for x in check_records([bad]))
    assert json.loads(json.dumps(p.to_dict()))["chosen"] == \
        p.layout.to_dict()


def test_autoshard_selfcheck_runs():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.autoshard",
         "--selfcheck"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "selfcheck a OK" in out.stdout and "selfcheck b OK" in out.stdout
