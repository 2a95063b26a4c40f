"""Distributed drill: the hybrid-parallel training step and its parts,
run as rank processes through `distributed.launch`.

    python -m paddle_tpu_torch.tools.dist_drill --device cpu --tiny
    python -m paddle_tpu_torch.tools.dist_drill --job card4   # on the card

The counterpart of the JAX package's multichip dry run
(`__graft_entry__.py`, a hybrid dp x mp x sp GPT step under ZeRO-1 with
ring attention). A job is a number of ranks, a backend and a list of
cases; `run_job` (the supervisor) launches the ranks with a hard
timeout that kills every rank, and each rank writes its results to
`<out>/rank<r>.json` (numbers, launch counts, comm and staged bytes)
and `<out>/rank<r>.npz` (arrays: losses, rank 0's gathered parameters,
the pieces of the op checks), its output to `<out>/workerlog.<r>`. The
drill imports no JAX: the CPU tests hold its files against the JAX
package. Jobs:

- `cpu` (`--device cpu --tiny`, 8 ranks, gloo on the CPU): a tiny GPT
  (2 layers, width 64, 4 heads, seq 32, batch 4, weights from
  `numpy_weights`) on dp 2 x mp 2 x sp 2 for 3 AdamW steps: ring and
  Ulysses under ZeRO-1, ring under ZeRO-0 and ZeRO-2, with a
  global-norm clip and with a loss mask, one ring and one Ulysses step recorded by the
  telemetry recorder (comm spans); ring and Ulysses attention alone on
  dp 2 x sp 4, causal and not, forward and dq/dk/dv; the tensor-parallel
  layers; every collective of the eager API and the axis layer
  (forward, and the backward against the adjoint); the topology queries;
  DataParallel; the divisibility errors; and last a collective that
  never completes, under a deadline.
- `nccl1` (1 rank, NCCL, on the card): all_reduce, all_gather, alltoall
  and broadcast of CUDA tensors; ShardedTrainStep at dp = mp = sp = 1
  (ZeRO-0 and ZeRO-1) against jit.TrainStep, every loss and parameter
  compared bit for bit, in f32.
- `gloo_probe` (2 ranks sharing card 0, gloo): which collectives gloo
  carries over CUDA tensors itself (each op once on the process group,
  no staging; point-to-point last, since gloo may hand a CUDA pointer
  to the socket and abort the process).
- `card4` (4 ranks sharing card 0, gloo): GPT-3 1.3B's width (2 layers,
  seq 2048, batch 2) on mp 2 x sp 2: 3 f32 AdamW steps with ring and
  with Ulysses attention and 3 bf16-amp steps with ring, with each
  step's launch counts, ms, comm and staged bytes and peak memory (the
  last step under the telemetry recorder: its comm ms and share); then
  the bench's ringattn_128k leg (S 131072, 16 heads of 128, bf16, x =
  0.3 N(0, 1) from RandomState(0), q = k = v = x, d sum(o^2)/dx) over
  sp 4, each rank's out and dx pieces saved for the parent to check.
- `card8` (8 ranks sharing card 0, gloo): GPT-3 125M's width (2 layers,
  seq 1024, batch 4) on dp 2 x mp 2 x sp 2 with ring attention, 2 f32
  steps each under ZeRO-0, -1 and -2: the parameters and the ranks'
  optimizer-state bytes.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

__all__ = ["TINY", "JOBS", "numpy_weights", "tiny_batch", "run_job",
           "start_job"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0, initializer_range=0.02)
TINY_BATCH, TINY_SEQ = 4, 32
LR, WD = 1e-4, 0.01
CLIP_NORM = 0.05
# job -> (ranks, backend, ranks per device)
JOBS = {"cpu": (8, "gloo", 8), "nccl1": (1, "nccl", 1),
        "gloo_probe": (2, "gloo", 2), "card4": (4, "gloo", 4),
        "card8": (8, "gloo", 8)}
# the probe's collectives, point-to-point last: gloo may write a CUDA
# pointer as host memory, which aborts the process
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather", "all_to_all",
               "reduce_scatter", "reduce", "p2p")
DEADLINE_S = 120.0          # the collective deadline inside every case
TIMEOUT_PROBE_S = 1.5       # the never-completing collective's deadline
CARD_SEQ = 2048
CARD_STEPS = 3
RING_128K = dict(S=131072, heads=16, head_dim=128, amp=0.3)
ZERO_SEQ, ZERO_BATCH, ZERO_STEPS = 1024, 4, 2


# ---------------------------------------------------------------------------
# inputs, shared with the tests
# ---------------------------------------------------------------------------

def numpy_weights(cfg, seed):
    """{name: f32 ndarray} for every parameter of GPTForPretraining(cfg),
    drawn from RandomState(seed) in named_parameters() order: matrices
    N(0, std), biases N(0, std), LayerNorm scales 1 + N(0, std) (all
    nonzero, so a wrongly cut bias or scale shows)."""
    from ..models.gpt import GPTForPretraining
    rs = np.random.RandomState(seed)
    std = cfg.initializer_range
    out = {}
    for name, p in GPTForPretraining(cfg, device="meta").named_parameters():
        a = rs.randn(*p.shape).astype(np.float32) * np.float32(std)
        if ".ln" in name and name.endswith(".weight"):
            a += np.float32(1.0)
        out[name] = a
    return out


def tiny_batch(seed, batch=TINY_BATCH, seq=TINY_SEQ,
               vocab=TINY["vocab_size"]):
    rs = np.random.RandomState(seed + 1)
    ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    lbl = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    return ids, lbl


def tiny_mask(seed, batch=TINY_BATCH, seq=TINY_SEQ):
    """A loss mask (f32 0/1) that keeps a different count on every rank's
    piece, so the global token count is the mask's global sum."""
    return (np.random.RandomState(seed + 2).rand(batch, seq) > 0.3).astype(
        np.float32)


def op_inputs(seed, shape=(2, 32, 4, 16)):
    """q, k, v and the output cotangent of the attention checks."""
    rs = np.random.RandomState(seed + 7)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

class _Rank:
    """What one rank writes: numbers into `rec`, arrays into `arr`."""

    def __init__(self, job, out, seed):
        import torch
        from ..distributed import collective, env
        self.torch, self.env, self.coll = torch, env, collective
        self.job, self.out, self.seed = job, out, seed
        _, backend, _ = JOBS[job]
        if job == "cpu":
            torch.set_num_threads(1)
            self.dev = env.init_distributed(backend, device="cpu",
                                            timeout_s=DEADLINE_S)
        else:
            self.dev = env.init_distributed(backend, timeout_s=DEADLINE_S)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        collective.set_collective_deadline(DEADLINE_S)
        self.rank = env.get_rank()
        self.rec = {"rank": self.rank, "world": env.get_world_size(),
                    "device": str(self.dev)}
        self.arr = {}
        self._meshes = {}

    def mesh(self, **sizes):
        key = tuple(sorted(sizes.items()))
        if key not in self._meshes:
            self._meshes[key] = self.env.build_mesh(**sizes)
        self.env.set_mesh(self._meshes[key])
        return self._meshes[key]

    def coords(self):
        return {a: self.env.axis_index(a) for a in self.env.MESH_AXES}

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def save(self):
        with open(os.path.join(self.out, f"rank{self.rank}.json"), "w") as f:
            json.dump(self.rec, f)
        np.savez(os.path.join(self.out, f"rank{self.rank}.npz"), **self.arr)


def _launch_counts():
    from ..ops.kernel_registry import kernels
    return {k.name: k.launches for k in kernels()}


def _train(r, cfg, ids, lbl, zero_stage, steps, weights=None, seed=0,
           clip=None, amp_on=False, record_step=None, tag="", mask=None):
    """Build GPTForPretraining(cfg) on the rank's device (weights from
    `weights`, else from `seed`), cut it to the installed mesh and run
    `steps` ShardedTrainStep steps on the global batch; -> (step, model,
    per-step dicts)."""
    torch = r.torch
    from .. import amp
    from ..convert import shard_jax_params
    from ..distributed import ShardedTrainStep
    from ..distributed.collective import comm_stats, reset_comm_stats
    from ..models.gpt import GPTForPretraining
    from ..nn.clip import ClipGradByGlobalNorm
    from ..ops.kernel_registry import reset_launches
    from ..optimizer import AdamW
    model = GPTForPretraining(cfg, device=r.dev, seed=seed)
    if weights is not None:
        shard_jax_params(model, weights)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)

    def loss_fn(i, l, *m):
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return model.loss(i, l, *m)

    step = ShardedTrainStep(model, loss_fn, opt, zero_stage=zero_stage)
    batch = [torch.from_numpy(a).to(r.dev)
             for a in (ids, lbl) + (() if mask is None else (mask,))]
    per = []
    for k in range(steps):
        r.sync()
        if r.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_comm_stats()
        t0 = time.perf_counter()
        if record_step == k:
            from ..telemetry import TelemetryRecorder
            with TelemetryRecorder(rank=r.rank, track_memory=False) as rec:
                loss = float(step(*batch))
            spans = {}
            for sp in rec.spans:
                if sp.get("cat") != "collective":
                    continue
                a = sp.get("args") or {}
                key = f"{sp['name']}@{a.get('axis', '')}"
                spans[key] = spans.get(key, 0) + int(a.get("bytes", 0))
            last = rec.records[-1]
            r.rec[f"{tag}/spans"] = spans
            r.rec[f"{tag}/record"] = {
                k2: last.get(k2) for k2 in ("collectives", "comm_ms",
                                            "comm_frac")}
        else:
            loss = float(step(*batch))
        ms = (time.perf_counter() - t0) * 1e3
        d = {"loss": loss, "ms": ms, "launches": _launch_counts(),
             "comm": comm_stats()}
        if r.dev.type == "cuda":
            d["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        per.append(d)
    return step, model, per


def _gpt_case(r, tag, cfg, ids, lbl, zero_stage, steps, save_params,
              **kw):
    from ..convert import gather_params
    step, model, per = _train(r, cfg, ids, lbl, zero_stage, steps, tag=tag,
                              **kw)
    r.rec[tag] = {"losses": [d["loss"] for d in per], "steps": per,
                  "state_bytes": step.state_bytes(),
                  "coords": r.coords()}
    params = gather_params(model)
    if save_params and r.rank == 0:
        for n, a in params.items():
            r.arr[f"{tag}/{n}"] = a
    return params


def _cpu_hybrid(r):
    from ..models.gpt import GPTConfig
    r.mesh(dp=2, mp=2, sp=2)
    ids, lbl = tiny_batch(r.seed)
    for mode, zero, clip, mask in (
            ("ring", 1, None, None), ("ulysses", 1, None, None),
            ("ring", 0, None, None), ("ring", 2, None, None),
            ("ring", 1, CLIP_NORM, None), ("ring", 1, None, "mask")):
        cfg = GPTConfig(**TINY, sequence_parallel=mode)
        weights = numpy_weights(cfg, r.seed)
        tag = f"{mode}_z{zero}" + ("_clip" if clip else "") \
            + ("_mask" if mask else "")
        plain = clip is None and mask is None
        _gpt_case(r, tag, cfg, ids, lbl, zero, 3, True, weights=weights,
                  clip=clip, record_step=1 if zero == 1 and plain else None,
                  mask=tiny_mask(r.seed) if mask else None)
    # Ulysses under mp: each rank's heads (n / mp) must divide by sp
    cfg = GPTConfig(**{**TINY, "num_heads": 2}, sequence_parallel="ulysses")
    r.rec["errors"] = {"ulysses_mp": _error(lambda: _train(
        r, cfg, ids, lbl, 1, 1))}


def _error(fn):
    try:
        fn()
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _cpu_ops(r):
    """Ring and Ulysses alone on dp 2 x sp 4, causal and not."""
    torch = r.torch
    from ..distributed import shard_batch
    from ..ops.ring_attention import (ring_attention, shard_seq,
                                      ulysses_attention)
    r.mesh(dp=2, sp=4)
    q, k, v, do = op_inputs(r.seed)
    di = r.env.axis_index("dp")

    def local(a):
        return shard_seq(torch.from_numpy(a[di:di + 1]))

    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (True, False):
            ts = [local(a).requires_grad_() for a in (q, k, v)]
            out = fn(*ts, causal=causal)
            (out * local(do)).sum().backward()
            key = f"ops/{name}/{int(causal)}"
            r.arr[f"{key}/out"] = out.detach().numpy()
            for n, t in zip("qkv", ts):
                r.arr[f"{key}/d{n}"] = t.grad.numpy()
    r.rec["ops/coords"] = r.coords()
    errs = r.rec.setdefault("errors", {})
    x2 = torch.zeros(1, 8, 2, 16)
    errs["ulysses_heads"] = _error(lambda: ulysses_attention(x2, x2, x2))
    errs["ring_seq"] = _error(lambda: shard_seq(torch.zeros(1, 30, 4, 16)))
    errs["shard_batch"] = _error(lambda: shard_batch(
        [torch.zeros(3, 8)], seq_axis=True))
    errs["ring_len"] = _error(lambda: ring_attention(
        torch.zeros(1, 8, 4, 16), torch.zeros(1, 4, 4, 16),
        torch.zeros(1, 4, 4, 16)))


def _cpu_mp_layers(r):
    """The tensor-parallel layers on mp 2 from full numpy weights:
    outputs and gradients (the cut ones gathered), rank 0 saves them."""
    torch = r.torch
    from ..distributed import (ColumnParallelLinear, ParallelCrossEntropy,
                               RowParallelLinear, VocabParallelEmbedding)
    from ..distributed.collective import _all_gather, _axis
    from ..distributed.sharded_train import (join_pieces, param_cuts,
                                             shard_model)
    r.mesh(dp=2, mp=2, sp=2)
    rs = np.random.RandomState(r.seed + 11)
    f32 = np.float32

    def mk(shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(f32)

    cases = {
        "col_gather": (ColumnParallelLinear(16, 12, gather_output=True),
                       mk((4, 8, 16)), (4, 8, 12)),
        "col_local": (ColumnParallelLinear(16, 12, gather_output=False),
                      mk((4, 8, 16)), (4, 8, 12)),
        "row": (RowParallelLinear(12, 16, input_is_parallel=False),
                mk((4, 8, 12)), (4, 8, 16)),
    }
    for name, (layer, x, oshape) in cases.items():
        full = {n: mk(tuple(p.shape), 0.3) for n, p in layer.named_parameters()}
        with torch.no_grad():
            for n, p in layer.named_parameters():
                p.copy_(torch.from_numpy(full[n]))
        shard_model(layer)
        ct = mk(oshape)
        xt = torch.from_numpy(x).requires_grad_()
        out = layer(xt)
        if name == "col_local":
            # this rank's columns: its slice of the cotangent, and the
            # output gathered for the check
            i = r.env.axis_index("mp")
            loc = torch.from_numpy(ct).chunk(2, dim=-1)[i]
            (out * loc).sum().backward()
            out = torch.cat(_all_gather(out.detach(), _axis("mp")[0]),
                            dim=-1)
        else:
            (out * torch.from_numpy(ct)).sum().backward()
        grads = {}
        cuts = param_cuts(layer)
        for n, p in layer.named_parameters():
            g = p.grad
            if n in cuts:
                g = join_pieces(_all_gather(g, _axis("mp")[0]), cuts[n][0],
                                cuts[n][1])
            grads[n] = g.numpy()
        if r.rank == 0:
            r.arr[f"mp/{name}/x"] = x
            r.arr[f"mp/{name}/ct"] = ct
            r.arr[f"mp/{name}/out"] = out.detach().numpy()
            r.arr[f"mp/{name}/dx"] = xt.grad.numpy()
            for n in full:
                r.arr[f"mp/{name}/w/{n}"] = full[n]
                r.arr[f"mp/{name}/g/{n}"] = grads[n]
    # the embedding: ids in range and out of it (clipped)
    emb = VocabParallelEmbedding(20, 16)
    wfull = mk((20, 16))
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(wfull))
    shard_model(emb)
    ids = rs.randint(-2, 23, (4, 8)).astype(np.int64)
    ct = mk((4, 8, 16))
    out = emb(torch.from_numpy(ids))
    (out * torch.from_numpy(ct)).sum().backward()
    gw = join_pieces(_all_gather(emb.weight.grad, _axis("mp")[0]), 0)
    # the cross entropy over vocab-parallel logits, some labels ignored
    logits = mk((32, 20), 3.0)
    lbl = rs.randint(0, 20, (32,)).astype(np.int64)
    lbl[::7] = -100
    i = r.env.axis_index("mp")
    lt = torch.from_numpy(logits).chunk(2, dim=-1)[i].clone() \
        .requires_grad_()
    dl = mk((32,))
    loss = ParallelCrossEntropy()(lt, torch.from_numpy(lbl))
    (loss * torch.from_numpy(dl)).sum().backward()
    glog = torch.cat(_all_gather(lt.grad, _axis("mp")[0]), dim=-1)
    if r.rank == 0:
        r.arr.update({"mp/emb/w": wfull, "mp/emb/ids": ids, "mp/emb/ct": ct,
                      "mp/emb/out": out.detach().numpy(),
                      "mp/emb/gw": gw.numpy(), "mp/ce/logits": logits,
                      "mp/ce/lbl": lbl, "mp/ce/dl": dl,
                      "mp/ce/loss": loss.detach().numpy(),
                      "mp/ce/glogits": glog.numpy()})


def _cpu_collectives(r):
    """The eager API on the world and a subgroup, and the axis layer's
    Functions: integer-valued f32 inputs, so every sum is exact."""
    torch = r.torch
    from ..distributed import collective as C
    r.mesh(dp=2, mp=2, sp=2)
    me, n = r.rank, r.env.get_world_size()
    res = {}
    x = torch.arange(6, dtype=torch.float32) + 10 * me
    res["all_reduce_sum"] = C.all_reduce(x.clone()).tolist()
    res["all_reduce_max"] = C.all_reduce(x.clone(), C.ReduceOp.MAX).tolist()
    res["all_reduce_avg"] = C.all_reduce(x.clone(), C.ReduceOp.AVG).tolist()
    res["broadcast"] = C.broadcast(x.clone(), src=3).tolist()
    res["reduce"] = C.reduce(x.clone(), dst=2).tolist()
    res["all_gather"] = [t.tolist() for t in C.all_gather([], x)]
    res["all_gather_object"] = C.all_gather_object([], {"r": me})
    lst = [torch.full((3,), 100.0 * me + j) for j in range(n)]
    res["scatter"] = C.scatter(torch.zeros(3), lst, src=1).tolist()
    res["alltoall"] = [t.tolist() for t in C.alltoall(lst)]
    got = torch.zeros(6)
    if me % 2 == 0:
        C.send(x, dst=me + 1)
    else:
        C.recv(got, src=me - 1)
    res["recv"] = got.tolist()
    C.barrier()
    g = C.new_group([0, 2, 4, 6])
    if me in g.ranks:
        res["subgroup_sum"] = C.all_reduce(x.clone(), group=g).tolist()
    r.rec["eager"] = res
    # the axis layer, over sp and mp
    rs = np.random.RandomState(100 + me)
    axis_fns = {
        "psum": lambda t, a: C.psum(t, a),
        "pmean": lambda t, a: C.pmean(t, a),
        "pmax": lambda t, a: C.pmax(t, a),
        "all_gather_tiled": lambda t, a: C.all_gather_axis(t, a, axis=1),
        "all_gather_stack": lambda t, a: C.all_gather_axis(t, a, axis=0,
                                                           tiled=False),
        "reduce_scatter": lambda t, a: C.reduce_scatter_axis(t, a, axis=1),
        "ppermute": lambda t, a: C.ppermute(t, a, [(0, 1), (1, 0)]),
        "ppermute_half": lambda t, a: C.ppermute(t, a, [(0, 1)]),
        "all_to_all": lambda t, a: C.all_to_all_axis(t, a, 1, 0),
        "c_identity": lambda t, a: C.c_identity(t, a),
        "mp_allreduce": lambda t, a: C.mp_allreduce(t, a),
    }
    for axis in ("sp", "mp"):
        for name, fn in axis_fns.items():
            xa = torch.from_numpy(rs.randint(-8, 9, (2, 4)).astype(
                np.float32) + np.float32(0.25) * me).requires_grad_()
            out = fn(xa, axis)
            y = torch.from_numpy(rs.randint(-4, 5, tuple(out.shape)).astype(
                np.float32))
            (out * y).sum().backward()
            key = f"axis/{axis}/{name}"
            r.arr[f"{key}/x"] = xa.detach().numpy()
            r.arr[f"{key}/y"] = y.numpy()
            r.arr[f"{key}/out"] = out.detach().numpy()
            r.arr[f"{key}/grad"] = xa.grad.numpy()
    r.rec["axis/coords"] = r.coords()


def _cpu_topology(r):
    from ..distributed import fleet
    from ..distributed.strategy import DistributedStrategy
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2, "sep_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=s)
    dist = r.torch.distributed
    r.rec["topology"] = {
        "sizes": [hcg.get_data_parallel_world_size(),
                  hcg.get_model_parallel_world_size(),
                  hcg.get_sep_parallel_world_size(),
                  hcg.get_pipe_parallel_world_size()],
        "ranks": [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                  hcg.get_model_parallel_rank(),
                  hcg.get_sep_parallel_rank()],
        "groups": {
            "data": dist.get_process_group_ranks(
                hcg.get_data_parallel_group()),
            "model": dist.get_process_group_ranks(
                hcg.get_model_parallel_group()),
            "sep": dist.get_process_group_ranks(
                hcg.get_sep_parallel_group())},
        "worker_index": fleet.worker_index(), "worker_num": fleet.worker_num()}


def _cpu_data_parallel(r):
    """DataParallel over the mesh's dp group: each dp rank's half of a
    batch, the gradients averaged to the full batch's."""
    torch = r.torch
    from ..distributed import DataParallel
    r.mesh(dp=2, mp=2, sp=2)
    torch.manual_seed(0)
    lin = torch.nn.Linear(8, 4)
    model = DataParallel(lin)
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 8).astype(
        np.float32))
    di = r.env.axis_index("dp")
    loss = (model(x[2 * di:2 * di + 2]) ** 2).mean()
    loss.backward()
    r.arr["dp/x"] = x.numpy()
    r.arr["dp/w"] = lin.weight.detach().numpy()
    r.arr["dp/b"] = lin.bias.detach().numpy()
    r.arr["dp/gw"] = lin.weight.grad.numpy()
    r.arr["dp/gb"] = lin.bias.grad.numpy()


def _cpu_timeout(r):
    """Rank 0 all-reduces over a group whose other member never joins:
    CollectiveTimeoutError within the deadline. Runs last: the
    abandoned collective leaves that group unusable."""
    torch = r.torch
    from ..distributed import collective as C
    g = C.new_group([0, 1])
    if r.rank == 0:
        t0 = time.perf_counter()
        try:
            with C.collective_deadline(TIMEOUT_PROBE_S):
                C.all_reduce(torch.ones(4), group=g)
            r.rec["timeout"] = {"raised": None}
        except C.CollectiveTimeoutError as e:
            r.rec["timeout"] = {"raised": str(e),
                                "after_s": time.perf_counter() - t0,
                                "deadline_s": TIMEOUT_PROBE_S}
    # rank 1 stays alive (and away from g) until rank 0 has timed out
    C.barrier()


# ---- card jobs --------------------------------------------------------------

def _nccl1(r):
    """One NCCL rank on the card: the collectives against their inputs,
    then ShardedTrainStep at a mesh of ones against jit.TrainStep, bit
    for bit in f32."""
    import copy
    torch = r.torch
    from ..distributed import ShardedTrainStep, collective as C
    from ..jit import TrainStep
    from ..models.gpt import GPTConfig, GPTForPretraining
    from ..optimizer import AdamW
    dev = r.dev
    x = torch.randn(1 << 20, device=dev)
    chk = {"all_reduce": torch.equal(C.all_reduce(x.clone()), x),
           "broadcast": torch.equal(C.broadcast(x.clone(), src=0), x),
           "all_gather": torch.equal(torch.cat(C.all_gather([], x)), x),
           "alltoall": torch.equal(torch.cat(C.alltoall([x])), x)}
    r.rec["nccl_collectives"] = chk
    r.mesh(dp=1, mp=1, sp=1)
    cfg = GPTConfig.gpt3_125m(num_layers=2, max_seq_len=1024, dropout=0.0)
    base = GPTForPretraining(cfg, device=dev, seed=r.seed)
    ids, lbl = tiny_batch(r.seed, 2, 1024, cfg.vocab_size)
    tids, tlbl = (torch.from_numpy(a).to(dev) for a in (ids, lbl))
    runs = {}
    for name in ("train_step", "zero0", "zero1"):
        model = copy.deepcopy(base)
        opt = AdamW(learning_rate=LR, weight_decay=WD,
                    parameters=model.parameters())
        if name == "train_step":
            step = TrainStep(model, model.loss, opt)
        else:
            step = ShardedTrainStep(model, model.loss, opt,
                                    zero_stage=int(name[-1]))
        losses = [step(tids, tlbl) for _ in range(CARD_STEPS)]
        runs[name] = (torch.stack(losses), model)
    ref_l, ref_m = runs.pop("train_step")
    ref = dict(ref_m.named_parameters())
    out = {}
    for name, (l, m) in runs.items():
        out[name] = {
            "losses": l.tolist(),
            "losses_equal": bool(torch.equal(l, ref_l)),
            "params_equal": all(torch.equal(p, ref[n])
                                for n, p in m.named_parameters())}
    out["train_step_losses"] = ref_l.tolist()
    r.rec["size1"] = out


def _gloo_probe(r):
    """Which gloo collectives carry a CUDA tensor themselves, called on
    the process group directly (no staging), each result checked:
    {op: "ok" | "wrong result" | the error}, saved after each op, so
    that an op that aborts the process leaves the ones before it (the
    supervisor reads a missing op as an abort)."""
    torch = r.torch
    dist = torch.distributed
    n, me = r.env.get_world_size(), r.rank
    x = torch.arange(8, dtype=torch.float32, device=r.dev) + 100 * me
    total = sum(torch.arange(8, dtype=torch.float32) + 100 * k
                for k in range(n))

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return torch.equal(t.cpu(), total)

    def broadcast():
        t = x.clone()
        dist.broadcast(t, 0)
        return torch.equal(t.cpu(), torch.arange(8.0))

    def all_gather():
        outs = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(outs, x)
        return all(torch.equal(o.cpu(), torch.arange(8.0) + 100 * k)
                   for k, o in enumerate(outs))

    def all_to_all():
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        c = 8 // n
        want = torch.cat([torch.arange(8.0)[me * c:(me + 1) * c] + 100 * k
                          for k in range(n)])
        return torch.equal(out.cpu(), want)

    def reduce_scatter():
        out = torch.empty(8 // n, device=r.dev)
        dist.reduce_scatter(out, list(x.clone().chunk(n)))
        return torch.equal(out.cpu(), total.chunk(n)[me])

    def reduce():
        t = x.clone()
        dist.reduce(t, 0)
        return me != 0 or torch.equal(t.cpu(), total)

    def p2p():
        peer = me ^ 1
        got = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, got,
                                                            peer)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return torch.equal(got.cpu(), torch.arange(8.0) + 100 * peer)

    probes = {"all_reduce": all_reduce, "broadcast": broadcast,
              "all_gather": all_gather, "all_to_all": all_to_all,
              "reduce_scatter": reduce_scatter, "reduce": reduce,
              "p2p": p2p}
    out = r.rec["gloo_cuda_probe"] = {}
    for name in GLOO_PROBES:
        try:
            ok = probes[name]()
            r.sync()
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:      # noqa: BLE001 — the probe's reading
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
        r.save()
        r.coll.barrier()


def _card4(r):
    from ..models.gpt import GPTConfig
    r.mesh(dp=1, mp=2, sp=2)
    ids, lbl = tiny_batch(r.seed, 2, CARD_SEQ, 50304)
    for tag, mode, amp_on in (("ring_f32", "ring", False),
                              ("ulysses_f32", "ulysses", False),
                              ("ring_bf16", "ring", True)):
        cfg = GPTConfig.gpt3_1_3b(num_layers=2, max_seq_len=CARD_SEQ,
                                  dropout=0.0, sequence_parallel=mode)
        _gpt_case(r, tag, cfg, ids, lbl, 1, CARD_STEPS, False, seed=r.seed,
                  amp_on=amp_on, record_step=CARD_STEPS - 1)
        r.torch.cuda.empty_cache()
    _ring_128k(r)


def _ring_128k(r):
    torch = r.torch
    from ..ops.kernel_registry import reset_launches
    from ..ops.ring_attention import ring_attention, shard_seq
    r.mesh(sp=4)
    c = RING_128K
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, c["S"], c["heads"], c["head_dim"]).astype(np.float32)).to(
        r.dev, torch.bfloat16)
    x = shard_seq(x * c["amp"])

    def fwd_bwd():
        xg = x.detach().requires_grad_()
        o = ring_attention(xg, xg, xg, causal=True)
        return o, torch.autograd.grad((o.float() ** 2).sum(), xg)[0]

    r.coll.barrier()
    reset_launches()
    o, dx = fwd_bwd()
    r.sync()
    launches = _launch_counts()
    torch.save({"out": o.detach().cpu(), "dx": dx.cpu()},
               os.path.join(r.out, f"ring128k_rank{r.rank}.pt"))
    del o, dx
    # one more, timed from a barrier (the first paid the warm-up)
    r.coll.barrier()
    r.sync()
    t0 = time.perf_counter()
    fwd_bwd()
    r.sync()
    r.rec["ring128k"] = {"launches": launches,
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "sp_index": r.env.axis_index("sp"),
                         "peak_mem_gb":
                             torch.cuda.max_memory_allocated() / 2 ** 30}


def _card8(r):
    from ..models.gpt import GPTConfig
    r.mesh(dp=2, mp=2, sp=2)
    cfg = GPTConfig.gpt3_125m(num_layers=2, max_seq_len=ZERO_SEQ,
                              dropout=0.0, sequence_parallel="ring")
    ids, lbl = tiny_batch(r.seed, ZERO_BATCH, ZERO_SEQ, cfg.vocab_size)
    params = {}
    for zero in (0, 1, 2):
        params[zero] = _gpt_case(r, f"zero{zero}", cfg, ids, lbl, zero,
                                 ZERO_STEPS, False, seed=r.seed)
        r.torch.cuda.empty_cache()
    r.rec["zero_max_diff"] = {
        f"{a}_vs_{b}": max(float(np.abs(params[a][n] - params[b][n]).max())
                           for n in params[a])
        for a, b in ((1, 0), (2, 1), (2, 0))}


CASES = {"cpu": (_cpu_hybrid, _cpu_ops, _cpu_mp_layers, _cpu_collectives,
                 _cpu_topology, _cpu_data_parallel, _cpu_timeout),
         "nccl1": (_nccl1,), "gloo_probe": (_gloo_probe,),
         "card4": (_card4,), "card8": (_card8,)}


def worker(job, out, seed):
    r = _Rank(job, out, seed)
    t0 = time.perf_counter()
    try:
        for case in CASES[job]:
            case(r)
            r.rec.setdefault("case_s", {})[case.__name__] = \
                time.perf_counter() - t0
    except BaseException:
        r.rec["error"] = traceback.format_exc()
        r.save()
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    r.save()
    sys.stdout.flush()
    sys.stderr.flush()
    # a timed-out collective cannot be cancelled: leave without joining
    # its thread or tearing the process group down
    os._exit(0)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

class Job:
    """A launched job: `wait()` -> {rank: (json dict, npz dict)}; raises
    with the ranks' log tails when a rank fails or the job times out
    (every rank killed)."""

    def __init__(self, job, out, seed, timeout):
        from ..distributed.launch import (start_local_trainers,
                                          watch_local_trainers)
        self.job, self.out, self.timeout = job, out, timeout
        self.nproc, _, rpd = JOBS[job]
        os.makedirs(out, exist_ok=True)
        self._store = tempfile.mkdtemp(prefix="store_", dir=out)
        env = dict(os.environ)
        env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
        if job == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        self._watch = watch_local_trainers
        self.procs = start_local_trainers(
            self.nproc, "paddle_tpu_torch.tools.dist_drill",
            ["--worker", "--job", job, "--out", out, "--seed", str(seed)],
            base_env=env, ranks_per_device=rpd, module=True,
            store_dir=self._store, log_dir=out)
        self.t0 = time.perf_counter()

    def wait(self, allow_fail=False):
        """With `allow_fail`, a failed job returns what its ranks saved
        (ranks that saved nothing are left out) instead of raising."""
        try:
            left = self.timeout - (time.perf_counter() - self.t0)
            rc = self._watch(self.procs, timeout=max(left, 0.0))
        finally:
            shutil.rmtree(self._store, ignore_errors=True)
        self.seconds = time.perf_counter() - self.t0
        self.rc = rc
        if rc != 0 and not allow_fail:
            tails = []
            for k in range(self.nproc):
                p = os.path.join(self.out, f"workerlog.{k}")
                if os.path.exists(p):
                    with open(p, errors="replace") as f:
                        tails.append(f"--- rank {k} ---\n" + f.read()[-3000:])
            raise RuntimeError(f"dist_drill job {self.job!r} exited {rc} "
                               f"after {self.seconds:.1f} s\n"
                               + "\n".join(tails))
        res = {}
        for k in range(self.nproc):
            path = os.path.join(self.out, f"rank{k}.json")
            if rc != 0 and not os.path.exists(path):
                continue
            with open(path) as f:
                rec = json.load(f)
            with np.load(os.path.join(self.out, f"rank{k}.npz")) as z:
                arr = {n: z[n] for n in z.files}
            res[k] = (rec, arr)
        return res


def start_job(job, out, seed=0, timeout=120.0):
    """Launch `job`'s ranks (see the module docstring) writing into
    `out`; -> a Job to `wait()` on."""
    return Job(job, out, seed, timeout)


def run_job(job, out, seed=0, timeout=120.0, allow_fail=False):
    return start_job(job, out, seed, timeout).wait(allow_fail)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--job", choices=sorted(JOBS), default=None)
    ap.add_argument("--device", default=None,
                   help="'cpu' runs the cpu job; default the card's jobs")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model (the cpu job's)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.job, args.out, args.seed)
        return 0
    if args.device == "cpu" or args.tiny:
        jobs = [args.job or "cpu"]
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("dist_drill runs on the CUDA card by default "
                               "and none is available; pass --device cpu "
                               "to run on the CPU")
        jobs = [args.job] if args.job else ["nccl1", "card4", "card8"]
    out = args.out or os.path.join(_ROOT, "build", "dist_drill")
    summary = {}
    for job in jobs:
        t0 = time.perf_counter()
        res = run_job(job, os.path.join(out, job), args.seed, args.timeout)
        summary[job] = {"ranks": len(res),
                        "seconds": round(time.perf_counter() - t0, 1),
                        "losses": {k: v["losses"]
                                   for k, v in res[0][0].items()
                                   if isinstance(v, dict) and "losses" in v}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
