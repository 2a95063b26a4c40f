"""The port's lints (paddle_tpu_torch/analysis/) against the JAX
package's: the SH rules over the same specimens (and the one standing
difference, a grouped dim cut by n * groups), the live model's tags,
the memory projection and rule coverage; each PT rule on a specimen
that fires it and on the planner's clean proxy step; the
collective-order capture fed by the port's collective spans."""
import numpy as np
import pytest
import torch

from paddle_tpu import analysis as janalysis
from paddle_tpu.analysis import collective_order as jco
from paddle_tpu.analysis import sharding_lint as jsl
from paddle_tpu.planner import MeshSpec as JMeshSpec
from paddle_tpu.planner import planner as jplanner_mod
from paddle_tpu.planner import rules as jrules

from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import collective_order as co
from paddle_tpu_torch.analysis import program_lint as pl
from paddle_tpu_torch.analysis import sharding_lint as sl
from paddle_tpu_torch.distributed import collective, env
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.planner import MeshSpec
from paddle_tpu_torch.planner import planner as planner_mod

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64)


def _ids(findings):
    return [(f.rule_id, f.severity, f.location) for f in findings]


SPECS = [  # (name, shape, axes, mesh sizes)
    ("ok", (64, 128), (None, "mp"), dict(mp=2)),
    ("rank", (64,), ("mp", None), dict(mp=2)),
    ("unknown", (64, 64), ("tp", None), dict(mp=2)),
    ("nondiv", (10, 64), ("mp", None), dict(mp=4)),
    ("dup", (64, 64), ("mp", "mp"), dict(mp=2)),
    ("tuple", (64, 64), (("dp", "mp"), None), dict(dp=2, mp=2)),
    ("size1", (10, 64), ("mp", None), dict(mp=1)),
    ("expert", (8, 64, 96), ("ep", None, "mp"), dict(ep=4, mp=2)),
]


@pytest.mark.parametrize("name,shape,axes,sizes", SPECS,
                         ids=[s[0] for s in SPECS])
def test_lint_spec_verdicts_equal_jax(name, shape, axes, sizes):
    got = sl.lint_spec(name, shape, axes, MeshSpec(**sizes))
    want = jsl.lint_spec(name, shape, axes, JMeshSpec(**sizes))
    # the verdicts (a message may name the port's consequence instead)
    assert _ids(got) == _ids(want)
    assert analysis.summarize(got) == janalysis.summarize(want)


def test_a_grouped_dim_divides_by_n_times_groups():
    # the fused qkv [d, 3d] over mp 3: JAX's 3d % 3 passes, the port cuts
    # each of q, k and v by heads, so d % 3 must hold
    mesh = dict(mp=3)
    assert jsl.lint_spec("qkv", (64, 192), (None, "mp"),
                         JMeshSpec(**mesh)) == []
    got = sl.lint_spec("qkv", (64, 192), (None, "mp"), MeshSpec(**mesh),
                       groups=3)
    assert [f.rule_id for f in got] == ["SH203"]
    assert "in each of its 3 groups" in got[0].message
    assert sl.lint_spec("qkv", (64, 192), (None, "mp"), MeshSpec(mp=2),
                        groups=3) == []


def _jax_tagged(cfg_kw, rules=None):
    from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
    named = jplanner_mod.gpt_abstract_params(JGPTConfig(**cfg_kw))
    rules = rules or jrules.gpt_partition_rules()
    return jplanner_mod._resolve_tagged(
        named, jrules.match_partition_rules(rules, named,
                                            on_miss="replicate"))


@pytest.mark.parametrize("sizes,zero", [(dict(dp=2, mp=2), 1),
                                        (dict(dp=3, mp=2), 3),
                                        (dict(dp=4, mp=4), 2),
                                        (dict(dp=2, mp=8), 3)])
def test_the_live_models_tags_lint_and_project_as_jax(sizes, zero):
    live = GPTForPretraining(GPTConfig(**TINY), device="meta")
    jnamed = _jax_tagged(TINY)
    mesh, jmesh = MeshSpec(**sizes), JMeshSpec(**sizes)
    got = sl.lint_model_sharding(live, mesh, zero_stage=zero,
                                 large_param_bytes=1)
    want = jsl.lint_model_sharding(jnamed, jmesh, zero_stage=zero,
                                   large_param_bytes=1)
    assert _ids(got) == _ids(want)
    for z in (0, 1, 2, 3):
        rep, found = sl.project_hbm(live, mesh, zero_stage=z,
                                    hbm_bytes=10 ** 5)
        jrep, jfound = jsl.project_hbm(jnamed, jmesh, zero_stage=z,
                                       hbm_bytes=10 ** 5)
        assert (rep, _ids(found)) == (jrep, _ids(jfound))
    # the cut model keeps its logical shapes
    step = type("S", (), {"model": live, "zero_stage": zero,
                          "mesh": mesh})()
    assert sl.project_train_step_hbm(step)[0] == \
        jsl.project_hbm(jnamed, jmesh, zero_stage=zero)[0]


def test_rule_coverage_equals_jax():
    rules = [(r"\bwte\.weight$", ("mp", None)), (r"\bno_such\.weight$", ()),
             (r"qkv_proj\.weight$", (None, "mp"))]
    live = GPTForPretraining(GPTConfig(**TINY), device="meta")
    jnamed = _jax_tagged(TINY)
    for sizes in (dict(mp=2), dict(dp=1)):
        got = sl.lint_partition_rules(rules, live, MeshSpec(**sizes),
                                      large_param_bytes=40000)
        want = jsl.lint_partition_rules(rules, jnamed, JMeshSpec(**sizes),
                                        large_param_bytes=40000)
        assert _ids(got) == _ids(want)
    assert {f.severity for f in got if f.rule_id == "SH208"} == {"warning"}


# ---- the program lint -----------------------------------------------------

def test_the_planners_proxy_step_is_clean():
    planner_mod._PROXY_CACHE.clear()
    rec = planner_mod._proxy_trace()["record"]
    assert rec.n_ops > 100 and rec.spans == [] and rec.moved == []
    assert pl.lint_record(rec) == []
    assert pl.lint_record(rec, mesh_axis_sizes={"dp": 1, "mp": 4}) == []


def _rules(fn, *args, state=None):
    _, rec = pl.record_step(fn, *args, state=state)
    return [f.rule_id for f in pl.lint_record(rec)], pl.lint_record(rec)


def test_pt101_fires_on_state_replaced_out_of_place():
    w = torch.nn.Parameter(torch.ones(4, 4))
    opt_state = {"moment1": torch.zeros(4, 4)}

    def step():
        with torch.no_grad():
            w.data = w.data - 0.1             # a rebind: new storage
            opt_state["moment1"].add_(1.0)    # in place

    ids, found = _rules(step, state=lambda: [("w", w)] + list(
        opt_state.items()))
    assert ids == ["PT101"] and found[0].severity == "warning"
    assert "(w)" in found[0].location and "64" not in found[0].location

    def clean():
        with torch.no_grad():
            w.sub_(0.1)
    assert _rules(clean, state=lambda: [("w", w)])[0] == []


def test_pt102_pt103_pt104_fire_on_their_specimens():
    x = torch.ones(4)
    ids, found = _rules(lambda: (x * 2).sum().item())
    assert ids == ["PT102"] and found[0].severity == "error"
    big = torch.ones(256, 256, dtype=torch.bfloat16)
    ids, found = _rules(lambda: big.float().sum())
    assert ids == ["PT103"] and found[0].severity == "warning"
    assert _rules(lambda: big[:64].float().sum())[0] == []   # under 65536
    ids, _ = _rules(lambda: x.double().sum())
    assert set(ids) == {"PT104"}
    # int64 arithmetic that never reaches an index: flagged; indices that
    # do (positions through gather and an embedding): exempt
    ids, _ = _rules(lambda: (torch.arange(4) * 3).float().sum())
    assert set(ids) == {"PT104"}
    table = torch.randn(16, 4)
    assert _rules(lambda: torch.nn.functional.embedding(
        torch.arange(4) + 1, table).sum())[0] == []
    assert _rules(lambda: table.gather(
        0, (torch.arange(4) % 3)[:, None].expand(4, 4)).sum())[0] == []


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo process group on the CPU and its mesh."""
    import torch.distributed as dist
    env.init_distributed("gloo", init_method=f"file://{tmp_path}/store",
                         world_size=1, rank=0, device="cpu")
    try:
        yield env.build_mesh()
    finally:
        env.clear_mesh()
        dist.destroy_process_group()
        env._STATE.update(backend=None, device=None, local_rank=0)


def test_pt105_pt106_and_the_capture_ride_the_collective_spans(world1):
    group = world1.get_group("dp")
    t = torch.ones(8)

    def degenerate():
        collective._all_reduce_(t, collective.ReduceOp.SUM, group,
                                axis="dp")
    ids, found = _rules(degenerate)
    assert ids == ["PT105"] and found[0].severity == "warning"
    # judged by a layout's sizes instead of the recorded group
    _, rec = pl.record_step(degenerate)
    assert pl.lint_record(rec, mesh_axis_sizes={"dp": 4}) == []

    def regather():
        out = collective._reduce_scatter([t], group, axis="dp")
        collective._all_gather(out, group, axis="dp")
    ids, found = _rules(regather)
    assert ids == ["PT105", "PT105", "PT106"]
    assert found[2].severity == "info"

    def gather_other():
        collective._reduce_scatter([t], group, axis="dp")
        collective._all_gather(t.clone(), group, axis="dp")
    assert "PT106" not in _rules(gather_other)[0]

    with co.capture(rank=0) as trace:
        regather()
    assert [(s.op, s.axis, s.shape, s.dtype) for s in trace] == [
        ("reduce_scatter", "dp", (8,), "torch.float32"),
        ("all_gather", "dp", (8,), "torch.float32")]
    assert co.verify_ranks([trace, (1, list(trace))]) == []


def test_collective_order_verdicts_equal_jax():
    def sigs(mod, rows):
        return [mod.CollectiveSig(op, ax, shape, "float32", "x.py:1")
                for op, ax, shape in rows]
    base = [("psum", "dp", (4,)), ("all_gather", "mp", (2, 8))]
    cases = [base, base[:1] + [("psum", "mp", (2, 8))], base[:1],
             base + [("ppermute", "pp", (4,))]]
    for rows in cases:
        got = co.verify_ranks([(0, sigs(co, base)), (1, sigs(co, rows))])
        want = jco.verify_ranks([(0, sigs(jco, base)),
                                 (1, sigs(jco, rows))])
        assert _ids(got) == _ids(want)
        assert [f.message.split(" — ")[0] for f in got] == \
            [f.message.split(" — ")[0] for f in want]
    with pytest.raises(RuntimeError, match="not reentrant"):
        with co.capture(), co.capture():
            pass


def test_emit_modes_as_jax():
    f = [analysis.Finding("SH203", "error", "x", "m"),
         analysis.Finding("PT104", "warning", "y", "n")]
    assert analysis.emit([], mode="strict") == []
    with pytest.warns(UserWarning, match="2 finding"):
        assert analysis.emit(f, mode=True) == f
    with pytest.raises(analysis.GraphDoctorError) as e:
        analysis.emit(f, mode="strict")
    assert [x.rule_id for x in e.value.findings] == ["SH203", "PT104"]
    assert analysis.summarize(f) == {
        "n": 2, "by_family": {"sharding": 1, "program": 1},
        "by_severity": {"error": 1, "warning": 1}}
    assert np.all([x.family != "unknown" for x in f])
