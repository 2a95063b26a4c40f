"""The port's distributed package in one process on the CPU: the parts
that need no process group, held against the JAX package, and the
launcher (one two-rank job: a failing rank takes the other down).

- `CommunicateTopology` (pure rank arithmetic, the port's own copy) and
  `DistributedStrategy` equal the JAX classes on every axis, coordinate,
  group and default; the mesh axes are JAX's;
- the GPT's `mesh_axes` tags are the JAX `_tag`s, parameter by
  parameter; `cut_piece` cuts the fused qkv by heads;
- `init_distributed` refuses what it cannot do before touching a
  process group: NCCL with more local ranks than cards, a backend it
  does not know, gloo with no device given and no card;
- ShardedTrainStep's unported options raise naming their ROADMAP item;
- with no mesh, `sequence_parallel`, ring and Ulysses attention and the
  axis collectives are the single-device functions (ring against the
  JAX op, which falls to the composed attention alike);
- the deadline error's text is the JAX one.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.distributed import collective as jax_coll
from paddle_tpu.distributed.env import MESH_AXES as JAX_MESH_AXES
from paddle_tpu.distributed.strategy import \
    DistributedStrategy as JaxStrategy
from paddle_tpu.distributed.topology import \
    CommunicateTopology as JaxTopology
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JaxGPT
from paddle_tpu.ops.ring_attention import ring_attention_values

from paddle_tpu_torch.distributed import collective, env
from paddle_tpu_torch.distributed import launch as launch_fn
from paddle_tpu_torch.distributed.sharded_train import (
    ShardedTrainStep, _tags, cut_piece, join_pieces, shard_model)
from paddle_tpu_torch.distributed.strategy import DistributedStrategy
from paddle_tpu_torch.distributed.topology import CommunicateTopology
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
from paddle_tpu_torch.ops.ring_attention import (ring_attention,
                                                 ulysses_attention)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.tools import dist_drill as dd

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TOPOLOGIES = [(("data", "pipe", "model", "sep"), (2, 1, 2, 2)),
               (("data", "pipe", "model", "sep"), (3, 2, 1, 2)),
               (("data", "model"), (4, 2)),
               (("data", "pipe", "sharding", "model"), (1, 2, 2, 3))]


# ---- topology, strategy, axes ---------------------------------------------------

@pytest.mark.parametrize("names,dims", _TOPOLOGIES)
def test_topology_equals_the_jax_topology(names, dims):
    a, b = CommunicateTopology(names, dims), JaxTopology(names, dims)
    assert a.world_size() == b.world_size()
    assert a.coordinate == b.coordinate
    assert a.get_hybrid_group_names() == b.get_hybrid_group_names()
    for r in range(a.world_size()):
        assert a.get_coord(r) == b.get_coord(r)
        assert a.get_rank(**dict(zip(names, a.get_coord(r)))) == r
    for axis, d in zip(names, dims):
        assert a.get_dim(axis) == b.get_dim(axis) == d
        assert a.get_comm_list(axis) == b.get_comm_list(axis)
        for i in range(d):
            assert a.get_axis_list(axis, i) == b.get_axis_list(axis, i)


def test_strategy_defaults_equal_the_jax_strategy():
    a, b = DistributedStrategy(), JaxStrategy()
    assert vars(a) == vars(b)
    c = a.copy()
    c.hybrid_configs["mp_degree"] = 4
    assert a.hybrid_configs["mp_degree"] == 1
    with pytest.raises(ValueError, match="fp16_allreduce"):
        a.fp16_allreduce = True
    a.fp16_allreduce = False
    assert a.fp16_allreduce is False


def test_mesh_axes_are_the_jax_axes():
    assert env.MESH_AXES == JAX_MESH_AXES


def test_env_without_a_process_group():
    assert not env.is_initialized()
    assert env.get_world_size() == 1 and env.get_rank() == 0
    assert env.current_device().type == "cpu"
    for axis in env.MESH_AXES:
        assert env.axis_size(axis) == 1 and env.axis_index(axis) == 0
    with pytest.raises(RuntimeError, match="no mesh"):
        env.axis_group("mp")


# ---- init refuses before touching a process group ---------------------------------

def test_nccl_with_more_local_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    with pytest.raises(RuntimeError, match="2 local ranks but 0 CUDA"):
        env.init_distributed(backend="nccl", init_method="file:///nowhere")
    assert not env.is_initialized()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend 'mpi'"):
        env.init_distributed(backend="mpi")
    assert not env.is_initialized()


def test_gloo_takes_no_device_by_itself(monkeypatch):
    monkeypatch.delenv("PADDLE_DEVICE_ID", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        env.init_distributed(backend="gloo", init_method="file:///nowhere")
    assert not env.is_initialized()


def test_a_rendezvous_must_be_given(monkeypatch):
    for var in ("PADDLE_DIST_INIT_METHOD", "PADDLE_TRAINER_ENDPOINTS",
                "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="no rendezvous"):
        env.init_distributed(backend="gloo", device="cpu")
    assert not env.is_initialized()


# ---- the model's tags and the cut ---------------------------------------------------

def test_gpt_tags_equal_the_jax_tags():
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=16)
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**cfg))
    want = {n: tuple(p.mesh_axes) for n, p in jm.named_parameters()
            if getattr(p, "mesh_axes", None)}
    tm = GPTForPretraining(GPTConfig(**cfg), device="meta")
    got = {full: axes for full, _, _, axes, _ in _tags(tm)}
    assert got == want
    groups = {full: g for full, _, _, _, g in _tags(tm)}
    assert {n for n, g in groups.items() if g == 3} == {
        f"gpt.blocks.{i}.attn.qkv_proj.{w}" for i in range(2)
        for w in ("weight", "bias")}


@pytest.mark.parametrize("mp", (2, 4))
def test_cut_piece_takes_each_third_by_heads(mp):
    d, n, h = 8, 4, 3
    w = torch.arange(d * 3 * n * h, dtype=torch.float32).reshape(d, 3 * n * h)
    pieces = [cut_piece(w, 1, mp, i, groups=3) for i in range(mp)]
    heads = n // mp
    for i, p in enumerate(pieces):
        want = w.reshape(d, 3, n, h)[:, :, i * heads:(i + 1) * heads]
        assert torch.equal(p, want.reshape(d, -1))
    assert torch.equal(join_pieces(pieces, 1, groups=3), w)


@pytest.mark.parametrize("dim", (0, 1))
def test_cut_and_join_contiguous(dim):
    w = torch.randn(8, 6)
    pieces = [cut_piece(w, dim, 2, i) for i in range(2)]
    assert torch.equal(torch.cat(pieces, dim), w)
    assert torch.equal(join_pieces(pieces, dim), w)
    with pytest.raises(ValueError, match="does not divide"):
        cut_piece(w, dim, 5, 0)


def test_shard_model_without_a_mesh_cuts_nothing():
    tm = GPTForPretraining(GPTConfig(vocab_size=64, hidden_size=32,
                                     num_layers=1, num_heads=4,
                                     max_seq_len=16), device="cpu")
    shapes = {n: p.shape for n, p in tm.named_parameters()}
    shard_model(tm)
    assert {n: p.shape for n, p in tm.named_parameters()} == shapes
    with pytest.raises(NotImplementedError, match="planner"):
        shard_model(tm, rules=[("qkv", (None, "mp"))])


# ---- the step's unported options ---------------------------------------------------

@pytest.mark.parametrize("kw,what", [
    (dict(zero_stage=3), "ZeRO-3"), (dict(offload=True), "offload"),
    (dict(plan=object()), "planner"), (dict(lint=True), "planner"),
    (dict(health=True), "runtime"), (dict(resilience=object()), "elastic"),
])
def test_unported_options_raise_naming_their_roadmap_item(kw, what):
    m = torch.nn.Linear(2, 2)
    if what in ("ZeRO-3", "offload", "elastic", "runtime"):
        # ported since: ZeRO-3, offload=, resilience= and health= raise
        # nothing of their own; without a mesh the step refuses
        with pytest.raises(ValueError, match="needs a mesh"):
            ShardedTrainStep(m, lambda x: x,
                             AdamW(parameters=m.parameters()), **kw)
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item 6 .*{what}"):
        ShardedTrainStep(m, lambda x: x, AdamW(parameters=m.parameters()),
                         **kw)


def test_the_step_needs_a_mesh():
    m = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedTrainStep(m, lambda x: x, AdamW(parameters=m.parameters()))


# ---- no mesh: the single-device functions ------------------------------------------

@pytest.mark.parametrize("mode", ("ring", "ulysses"))
def test_sequence_parallel_without_a_mesh_is_the_usual_model(mode):
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=16, initializer_range=0.2)
    a = GPTForPretraining(GPTConfig(**cfg), device="cpu", seed=3)
    b = GPTForPretraining(GPTConfig(**cfg, sequence_parallel=mode),
                          device="cpu", seed=3)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 16)))
    lbl = torch.roll(ids, 1, dims=1)
    la, lb = a.loss(ids, lbl), b.loss(ids, lbl)
    assert torch.equal(la, lb)
    la.backward()
    lb.backward()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p.grad, q.grad), n


@pytest.mark.parametrize("causal", (True, False))
def test_ring_without_a_mesh_is_flash_and_the_jax_op(causal):
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = ring_attention(*t, causal=causal)
    assert torch.equal(out, flash_attention_fwd(*t, causal=causal))
    assert torch.equal(ulysses_attention(*t, causal=causal), out)
    ref = np.asarray(ring_attention_values(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_axis_collectives_without_a_mesh_are_identities():
    x = torch.randn(2, 4, requires_grad=True)
    for fn in (collective.psum, collective.pmean, collective.pmax,
               collective.c_identity, collective.mp_allreduce,
               collective.reduce_scatter_axis):
        assert fn(x, "sp") is x
    assert collective.all_to_all_axis(x, "mp", 1, 0) is x
    assert collective.all_gather_axis(x, "sp", axis=1) is x
    assert collective.all_gather_axis(x, "sp", tiled=False).shape == (1, 2, 4)
    assert torch.equal(collective.ppermute(x, "sp", [(0, 0)]), x)
    assert torch.equal(collective.ppermute(x, "sp", []), torch.zeros(2, 4))


# ---- the deadline machinery --------------------------------------------------------

def test_deadline_error_text_is_the_jax_text():
    args = ("all_reduce", 2.5)
    kw = dict(axis="sp", shape=(4, 8))
    assert str(collective.CollectiveTimeoutError(*args, **kw)) == str(
        jax_coll.CollectiveTimeoutError(*args, **kw))
    assert collective.CollectiveTimeoutError.transient is True


def test_collective_deadline_scopes_and_restores():
    assert collective.set_collective_deadline(None) is None
    with collective.collective_deadline(3):
        assert collective._DEADLINE_S[0] == 3.0
        with collective.collective_deadline(None):
            assert collective._DEADLINE_S[0] is None
        assert collective._DEADLINE_S[0] == 3.0
    assert collective._DEADLINE_S[0] is None


class _Work:
    def __init__(self, fail_after=None):
        self.fail_after = fail_after
        self.timeouts = []

    def wait(self, timeout=None):
        self.timeouts.append(timeout)
        if self.fail_after is not None:
            time.sleep(self.fail_after)
            raise RuntimeError("timed out")


def test_guarded_wait_bounds_the_backend_wait():
    w = _Work()
    collective.guarded_wait("x", w)
    assert w.timeouts == [None]
    w = _Work(fail_after=0.05)
    with pytest.raises(collective.CollectiveTimeoutError, match="'x'"):
        collective.guarded_wait("x", w, deadline_s=0.05)
    assert w.timeouts[0].total_seconds() == 0.05
    # an error before the deadline is the backend's own
    w = _Work(fail_after=0.0)
    with pytest.raises(RuntimeError, match="timed out"):
        collective.guarded_wait("x", w, deadline_s=30)


def test_comm_stats_count_and_reset():
    collective.reset_comm_stats()
    with collective._comm_span("probe", torch.zeros(4, 2), nbytes=None):
        pass
    s = collective.comm_stats()
    assert s["bytes"] == {"probe": 32} and s["calls"] == {"probe": 1}
    collective.reset_comm_stats()
    assert collective.comm_stats() == {"bytes": {}, "calls": {},
                                       "staged_bytes": {}}


# ---- the drill's inputs and the launcher ----------------------------------------------

def test_drill_weights_cover_both_models():
    cfg = GPTConfig(**dd.TINY)
    w = dd.numpy_weights(cfg, 0)
    tm = GPTForPretraining(cfg, device="meta")
    assert {n: a.shape for n, a in w.items()} == {
        n: tuple(p.shape) for n, p in tm.named_parameters()}
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**dd.TINY))
    assert sorted(w) == sorted(n for n, _ in jm.named_parameters())


def test_the_drill_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dd.main([])


def test_launch_is_the_callable_and_its_module_imports():
    import importlib
    mod = importlib.import_module("paddle_tpu_torch.distributed.launch")
    assert launch_fn is mod.launch
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.distributed.launch", "--help"],
                       cwd=_ROOT, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "--ranks-per-device" in r.stdout


def test_a_failing_rank_takes_the_whole_job_down(tmp_path):
    """Rank 1 exits 3 at once; rank 0 would sleep a minute: the launcher
    kills rank 0's process group and returns 3."""
    script = tmp_path / "job.py"
    script.write_text(
        "import os, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        f"open(os.path.join({str(tmp_path)!r}, f'pid{{rank}}'), 'w')"
        ".write(str(os.getpid()))\n"
        "if rank == 1:\n"
        "    time.sleep(0.5)\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    t0 = time.perf_counter()
    rc = launch_fn(["--nproc_per_node", "2", "--timeout", "60",
                    str(script)])
    assert rc == 3
    assert time.perf_counter() - t0 < 30
    pid0 = int((tmp_path / "pid0").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid0, 0)
