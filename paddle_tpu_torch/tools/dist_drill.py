"""Distributed drill: the hybrid-parallel training step and its parts,
run as rank processes through `distributed.launch`.

    python -m paddle_tpu_torch.tools.dist_drill --device cpu --tiny
    python -m paddle_tpu_torch.tools.dist_drill --job cpu_pp --device cpu
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
- `cpu_ep` (4 ranks, gloo on the CPU): `moe_ffn_values` on dp 2 x ep 2
  and ep 2 x mp 2 (outputs and the four gradients), the tiny GPT-MoE's
  ShardedTrainStep on dp 2 x ep 2 (dropless, no aux loss; AdamW under
  ZeRO-1, ZeRO-2 and a clip, and SGD), global_scatter/global_gather
  over the 4 ranks, the deprecated MoELayer at ep 2, the divisibility
  errors, ep with sp, the topology's ep queries.
- `cpu_pp` (4 ranks, gloo on the CPU): PipelineParallel.train_batch
  on each of PP_CASES (the JAX tests' tiny descs at pp 4, tied, dp 2 x
  pp 2, vpp 2, MpBlocks at pp 2 x mp 2, a tiny GPT pipe), eval_batch,
  the scaler, the no-plan warning, the options that raise, the
  functional executors at pp 4, fleet's wrapping.
- `nccl1` (1 rank, NCCL, on the card): all_reduce, all_gather, alltoall
  and broadcast of CUDA tensors; ShardedTrainStep at dp = mp = sp = 1
  (ZeRO-0 and ZeRO-1) against jit.TrainStep, every loss and parameter
  compared bit for bit, in f32.
- `gloo_probe` (2 ranks sharing card 0, gloo): which collectives gloo
  carries over CUDA tensors itself (each op once on the process group,
  no staging; point-to-point last, since gloo may hand a CUDA pointer
  to the socket and abort the process).
- `card4` (4 ranks sharing card 0, gloo): GPT-3 1.3B's width (2 layers,
  seq 2048, batch 2) on mp 2 x sp 2: f32 AdamW steps with ring
  (CARD_FCE_STEPS) and with Ulysses attention (CARD_STEPS), bf16-amp
  steps with ring (CARD_STEPS), and CARD_FCE_STEPS f32 ring steps with
  the loss under use_fused_ce (the fused CE over each rank's half of
  the vocab-parallel table), with each
  step's launch counts, ms, comm and staged bytes and peak memory (the
  last step under the telemetry recorder: its comm ms and share); then
  the bench's ringattn_128k leg (S 131072, 16 heads of 128, bf16, x =
  0.3 N(0, 1) from RandomState(0), q = k = v = x, d sum(o^2)/dx) over
  sp 4, each rank's out and dx pieces saved for the parent to check.
- `card8` (8 ranks sharing card 0, gloo): GPT-3 125M's width (2 layers,
  seq 1024, batch 4) on dp 2 x mp 2 x sp 2 with ring attention, 2 f32
  steps each under ZeRO-0, -1 and -2: the parameters and the ranks'
  optimizer-state bytes.
- `ep4` (4 ranks sharing card 0, gloo): GPT-MoE at the bench's width
  (d 768, E 8, top-2, 2 layers, 8 x 1024) on ep 4, dp 2 x ep 2 and ep 2
  x mp 2: 2 dropless f32 SGD steps against the one-process jit.TrainStep
  (rank 0 runs it first), `moe_ffn_values` at cf 1.25 against its
  blocks run alone, 2 bf16 amp steps on ep 4, one step at cf 1.25.
- `pp4` (4 ranks sharing card 0, gloo): GPT-3 1.3B's width as a
  PipelineLayer (tied embedding, 8 blocks, final LN, tied head), 8
  micro-batches of 1 x 2048: 2 f32 SGD steps each of 1F1B at pp 4,
  interleaved at pp 4 x vpp 2 and pp 2 x mp 2 against the one-process
  sequential train_batch (rank 0 runs it first and leaves its
  parameters in a file), 2 bf16 amp 1F1B steps, one 1F1B step each at 4
  and 16 micro-batches (stage 0's memory), 2 SGD steps each of 1F1B at
  pp 4 and pp 2 x mp 2 under ClipGradByNorm with the health taps
  (against the sequential run with the same clip and taps); then
  GPipe's forward and backward through the 8 blocks stacked, at pp 4,
  against the one-process gradient. The three one-process references
  (plain, clipped, GPipe) run first, side by side on ranks 0-2.
- `cpu_zero3` (4 ranks, gloo on the CPU): the tiny GPT for 3 AdamW
  steps under ZeRO-2 and ZeRO-3 at dp 4 (rank 0 saves both's gathered
  parameters), ZeRO-1, the offload of stages 1-3 against the same stage
  without it, ZeRO-3 at dp 2 x mp 2; each step's memory (a rank's
  parameter storage, ZeRO-3 pieces, state bytes) and the optimizer's
  state-dict keys; then the checkpoint legs at dp 4 ZeRO-3, dropout 0.1,
  a save every 2 steps: a baseline of 6 steps, a run with preemption
  requested on rank 2 alone before step index 2 (every rank stops at
  the boundary after step 3), its resume in the same processes, and
  step_4 restored at dp 4 and at dp 2 x mp 2 (every leaf assembled on
  rank 0 from the pieces the ranks hold against the saved one, then 2
  steps at dropout 0). Each run's ckpt records go to
  `<out>/<leg>_<rank>.jsonl`.
- `zero3_4` (4 ranks sharing card 0, gloo): GPT-3 1.3B's width x
  ZERO3_CARD_BLOCKS blocks, 4 x 2048 on dp 4: ZERO3_STEPS f32 AdamW
  steps each of ZeRO-3, ZeRO-3 with remat and ZeRO-3 with the health
  taps (against rank 0's `jit.TrainStep(health=)`), ZERO3_CARD_STEPS
  each of ZeRO-2, ZeRO-3 offloaded, ZeRO-3 under bf16 amp and ZeRO-3
  at dp 2 x mp 2 with the taps (every rank's pieces compared with
  ZeRO-3's after as many steps, the sums all-reduced); each leg's
  model is collected before the next one's is built. `zero3_8` (not
  in the smoke): ZeRO-3 with and without remat at ZERO3_DEPTH_BLOCKS
  blocks, ZERO3_CARD_STEPS steps each, every rank's memory a step.
- `ckpt4` (4 ranks sharing card 0): the checkpoint legs at 1.3B width x
  4 blocks; the preempted run really exits 102 (every rank saves its
  record and meets the others first). `ckpt4_resume` (4 ranks) resumes
  it, then restores step_4 at dp 4; `ckpt2_reshard` (2 ranks, dp 2
  ZeRO-2) and `ckpt4_reshard` (4 ranks, dp 2 x mp 2 ZeRO-3) restore
  step_4 under another layout. Their checkpoints live in `ckpt/` beside
  the jobs' output directories.
"""
import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import weakref

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
# the health taps of the health legs: every step fetched, recorded only
HEALTH = {"every_k": 1, "action": "record", "dump_on_exception": False}
HEALTH_KEYS = ("grad_norm", "update_ratio", "nan_count", "inf_count",
               "loss")
# job -> (ranks, backend, ranks per device)
JOBS = {"cpu": (8, "gloo", 8), "cpu_ep": (4, "gloo", 4),
        "cpu_pp": (4, "gloo", 4), "nccl1": (1, "nccl", 1),
        "gloo_probe": (2, "gloo", 2), "card4": (4, "gloo", 4),
        "card8": (8, "gloo", 8), "ep4": (4, "gloo", 4),
        "pp4": (4, "gloo", 4), "cpu_zero3": (4, "gloo", 4),
        "zero3_4": (4, "gloo", 4), "zero3_8": (4, "gloo", 4),
        "ckpt4": (4, "gloo", 4),
        "ckpt4_resume": (4, "gloo", 4), "ckpt2_reshard": (2, "gloo", 2),
        "ckpt4_reshard": (4, "gloo", 4)}
# the probe's collectives, point-to-point last: gloo may write a CUDA
# pointer as host memory, which aborts the process
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather", "all_to_all",
               "all_to_all_uneven", "reduce_scatter", "reduce", "p2p")
DEADLINE_S = 120.0          # the collective deadline inside every case
TIMEOUT_PROBE_S = 1.5       # the never-completing collective's deadline
CARD_SEQ = 2048
CARD_STEPS = 2
# the fused CE leg over mp and the unfused ring leg it is held against
CARD_FCE_STEPS = 3
RING_128K = dict(S=131072, heads=16, head_dim=128, amp=0.3)
ZERO_SEQ, ZERO_BATCH, ZERO_STEPS = 1024, 4, 2
# the expert-parallel cases: a tiny GPT-MoE, dropless (cf = E / k) and
# with no aux loss (its product of per-block means depends on how the
# tokens are blocked, in JAX's ep path as here, so only a run without it
# can equal the one-device step), and moe_ffn_values' inputs
MOE_TINY = dict(TINY, num_experts=4, expert_top_k=2, capacity_factor=2.0,
                aux_loss_weight=0.0, use_flash_attention=False)
EP_OP = dict(E=4, d=16, f=24, batch=2, seq=8, cf=1.0, aux=0.3, z=0.7)
EP_MESHES = ({"dp": 2, "ep": 2}, {"ep": 2, "mp": 2})
# the card's ep legs: GPT-MoE at the bench's width (bench.py:725-728),
# 2 layers, global batch 8 x 1024
EP_CARD = dict(vocab_size=50304, hidden_size=768, num_layers=2,
               num_heads=12, max_seq_len=1024, dropout=0.0, num_experts=8,
               expert_top_k=2, aux_loss_weight=0.0)
EP_CARD_BATCH, EP_CARD_SEQ, EP_CARD_STEPS = 8, 1024, 2
EP_CARD_MESHES = ({"ep": 4}, {"dp": 2, "ep": 2}, {"ep": 2, "mp": 2})
EP_DROPLESS_CF, EP_BOUND_CF = 4.0, 1.25
# the parameter checks step with SGD: Adam's update is blind to the
# scale of a tensor's gradient (m / sqrt(v)), so only SGD's shows a
# gradient that is ep or mp times off
SGD_LR = 0.1
# the pipeline cases: the JAX tests' tiny Embed/Block/Head (vocab 64,
# width 32), and a GPT pipe (tied embedding, GPTBlocks, final LN, tied
# head) at the tiny width
PP_V, PP_D = 64, 32
PP_SGD_LR = 0.1
# GPipe's dropout leg: the rate, and the seed every rank's generator
# takes before the call (so a stage's k-th draw is the same on every
# rank)
PP_GPIPE_DROPOUT, PP_GPIPE_SEED = 0.3, 77
PP_STEPS = 1
PP_GPT_TINY = dict(TINY, use_flash_attention=False)
# the card's pp legs: GPT-3 1.3B's width, 8 blocks, micro-batch 1
PP_CARD_BLOCKS, PP_CARD_ACC, PP_CARD_STEPS = 8, 8, 2


# ---------------------------------------------------------------------------
# inputs, shared with the tests
# ---------------------------------------------------------------------------

def numpy_weights(cfg, seed, model=None):
    """{name: f32 ndarray} for every parameter of GPTForPretraining(cfg)
    (or of `model`, a module), drawn from RandomState(seed) in
    named_parameters() order: matrices N(0, std), biases N(0, std),
    LayerNorm scales 1 + N(0, std) (all nonzero, so a wrongly cut bias
    or scale shows)."""
    from ..models.gpt import GPTForPretraining
    rs = np.random.RandomState(seed)
    std = cfg.initializer_range
    out = {}
    if model is None:
        model = GPTForPretraining(cfg, device="meta")
    for name, p in model.named_parameters():
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
        if job.startswith("cpu"):
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
           clip=None, amp_on=False, record_step=None, tag="", mask=None,
           model_cls=None, sgd_lr=None, offload=False, remat=False,
           health=False, fused_ce=False, after_step=None):
    """Build model_cls(cfg) (default GPTForPretraining; `remat`: with
    cfg.remat on) on the rank's device (weights from `weights`, else
    from `seed`), cut it to the installed mesh and run `steps`
    ShardedTrainStep steps on the global batch (AdamW, or SGD at
    `sgd_lr`; `health`: the taps at every_k 1, each step's stats kept;
    `fused_ce`: the loss under the use_fused_ce flag; `after_step(k,
    step)` called after step k); -> (step, model, per-step dicts)."""
    torch = r.torch
    from .. import amp
    from ..convert import shard_jax_params
    from ..distributed import ShardedTrainStep
    from ..distributed.collective import comm_stats, reset_comm_stats
    from ..models.gpt import GPTForPretraining
    from ..nn.clip import ClipGradByGlobalNorm
    from ..ops.kernel_registry import reset_launches
    from ..optimizer import SGD, AdamW
    if remat:
        cfg = type(cfg)(**{**vars(cfg), "remat": True})
    model = (model_cls or GPTForPretraining)(cfg, device=r.dev, seed=seed)
    if weights is not None:
        shard_jax_params(model, weights)
    clip = ClipGradByGlobalNorm(clip) if clip else None
    opt = SGD(learning_rate=sgd_lr, parameters=model.parameters(),
              grad_clip=clip) if sgd_lr else \
        AdamW(learning_rate=LR, weight_decay=WD,
              parameters=model.parameters(), grad_clip=clip)

    fwd = []

    def loss_fn(i, l, *m):
        # the forward's own peak (the logits live there; a step's peak
        # can lie in its update) and what it keeps for the backward; the
        # peak before it is kept, so the step's peak stays the step's
        if r.dev.type == "cuda":
            before = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"), \
                _fused_ce(fused_ce):
            loss = model.loss(i, l, *m)
        if r.dev.type == "cuda":
            fwd.append((before, torch.cuda.max_memory_allocated(),
                        torch.cuda.memory_allocated()))
        return loss

    step = ShardedTrainStep(model, loss_fn, opt, zero_stage=zero_stage,
                            offload=offload,
                            health=dict(HEALTH) if health else None)
    batch = [torch.from_numpy(a).to(r.dev)
             for a in (ids, lbl) + (() if mask is None else (mask,))]
    per = []
    for k in range(steps):
        r.sync()
        if r.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
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
             "comm": comm_stats(), "memory": step.memory()}
        if health:
            d["health"] = _stats(step.health)
        if health:
            d["tap_bytes"] = step.tap_bytes
        if r.dev.type == "cuda":
            before, fwd_peak, kept = fwd[-1]
            d["peak_mem_gb"] = max(
                before, torch.cuda.max_memory_allocated()) / 2 ** 30
            d["forward_peak_gb"] = fwd_peak / 2 ** 30
            d["start_gb"] = start / 2 ** 30
            d["after_forward_gb"] = kept / 2 ** 30
            if offload:
                d["offload_ms"] = step.offload_ms()
        per.append(d)
        if after_step is not None:
            after_step(k, step)
    return step, model, per


def _stats(monitor):
    """The last fetched health stats of `monitor` (HEALTH_KEYS)."""
    last = monitor.ring[-1]
    return {k: float(last[k]) for k in HEALTH_KEYS}


@contextlib.contextmanager
def _fused_ce(on):
    """The use_fused_ce flag set to `on` inside the block."""
    from ..flags import get_flag, set_flags
    prev = get_flag("use_fused_ce")
    set_flags({"use_fused_ce": bool(on)})
    try:
        yield
    finally:
        set_flags({"use_fused_ce": prev})


def _gpt_case(r, tag, cfg, ids, lbl, zero_stage, steps, save_params,
              **kw):
    """One `_train` run recorded under `tag` (losses, each step's
    readings, the optimizer-state bytes, the rank's coordinates); ->
    the gathered full parameters (rank 0 saves them with
    `save_params`)."""
    from ..convert import gather_params
    step, model, per = _train(r, cfg, ids, lbl, zero_stage, steps, tag=tag,
                              **kw)
    r.rec[tag] = {"losses": [d["loss"] for d in per], "steps": per,
                  "state_bytes": step.state_bytes(),
                  "coords": r.coords(),
                  "state_dict": sorted(k for k in step.optimizer.state_dict()
                                       if k != "LR_Scheduler")}
    params = gather_params(model)
    if save_params and r.rank == 0:
        for n, a in params.items():
            r.arr[f"{tag}/{n}"] = a
    del step, model
    return params


def _cpu_hybrid(r):
    from ..models.gpt import GPTConfig
    r.mesh(dp=2, mp=2, sp=2)
    ids, lbl = tiny_batch(r.seed)
    for mode, zero, clip, mask, fce in (
            ("ring", 1, None, None, False), ("ulysses", 1, None, None, False),
            ("ring", 0, None, None, False), ("ring", 2, None, None, False),
            ("ring", 1, CLIP_NORM, None, False),
            ("ring", 1, None, "mask", False), ("ring", 1, None, None, True)):
        cfg = GPTConfig(**TINY, sequence_parallel=mode)
        weights = numpy_weights(cfg, r.seed)
        tag = f"{mode}_z{zero}" + ("_clip" if clip else "") \
            + ("_mask" if mask else "") + ("_fce" if fce else "")
        plain = clip is None and mask is None and not fce
        _gpt_case(r, tag, cfg, ids, lbl, zero, 3, True, weights=weights,
                  clip=clip, record_step=1 if zero == 1 and plain else None,
                  mask=tiny_mask(r.seed) if mask else None, fused_ce=fce)
    # Ulysses under mp: each rank's heads (n / mp) must divide by sp
    cfg = GPTConfig(**{**TINY, "num_heads": 2}, sequence_parallel="ulysses")
    r.rec["errors"] = {"ulysses_mp": _error(lambda: _train(
        r, cfg, ids, lbl, 1, 1))}


def fused_ce_inputs(seed, n=24, d=16, vocab=32):
    """h [n, d], the table w [vocab, d], labels [n] (global ids, with
    the -100 padding and one id past the vocab) and the losses'
    cotangent, from RandomState(seed + 11)."""
    rs = np.random.RandomState(seed + 11)
    lbl = rs.randint(0, vocab, n).astype(np.int64)
    lbl[3], lbl[7] = -100, vocab
    return (rs.randn(n, d).astype(np.float32),
            (rs.randn(vocab, d) * 0.5).astype(np.float32), lbl,
            rs.randn(n).astype(np.float32))


def _cpu_fused_ce(r):
    """The fused linear cross entropy over a vocab-parallel table at mp 2
    (dp 4 x mp 2): each rank's losses, dh and its rows of dw."""
    torch = r.torch
    from ..ops.fused_ce import fused_linear_cross_entropy
    r.mesh(dp=4, mp=2)
    h, w, lbl, ct = fused_ce_inputs(r.seed)
    i, n = r.env.axis_index("mp"), r.env.axis_size("mp")
    rows = w.shape[0] // n
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w[i * rows:(i + 1) * rows].copy()).requires_grad_()
    loss = fused_linear_cross_entropy(ht, wt, torch.from_numpy(lbl),
                                      axis_name="mp")
    (loss * torch.from_numpy(ct)).sum().backward()
    r.arr["fce/loss"] = loss.detach().numpy()
    r.arr["fce/dh"] = ht.grad.numpy()
    r.arr["fce/dw"] = wt.grad.numpy()
    r.rec["fce"] = {"coords": r.coords(), "rows": [i * rows,
                                                   (i + 1) * rows]}


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
    from ..distributed.sharded_train import (gather_full, join_pieces,
                                             param_cuts, shard_model)
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
                g = gather_full(g, cuts[n])
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


# ---- expert parallelism (cpu_ep) -------------------------------------------

def ep_op_inputs(seed):
    """x [dp rows 2, batch, seq, d], the cotangent, w_gate, w_in, w_out
    of the moe_ffn_values checks (f32)."""
    c = EP_OP
    rs = np.random.RandomState(seed + 31)
    f32 = np.float32
    x = rs.randn(2, c["batch"], c["seq"], c["d"]).astype(f32)
    ct = rs.randn(*x.shape).astype(f32)
    wg = rs.randn(c["d"], c["E"]).astype(f32)
    wi = (rs.randn(c["E"], c["d"], c["f"]) * 0.3).astype(f32)
    wo = (rs.randn(c["E"], c["f"], c["d"]) * 0.3).astype(f32)
    return x, ct, wg, wi, wo


def _expert_cut(mesh_axes, shape):
    """The `param_cuts` value of an expert weight tagged `mesh_axes` on
    the installed mesh."""
    from ..distributed.sharded_train import _cut_dims
    return (_cut_dims("", mesh_axes, shape, None), 1, tuple(shape))


def _cpu_ep_values(r):
    """moe_ffn_values on dp 2 x ep 2 and ep 2 x mp 2: the output, aux, z,
    stats and the gradients of L = sum(out * ct) + a aux + b z (the
    expert weights' gathered to full), each rank's."""
    torch = r.torch
    from ..distributed.sharded_train import cut_full, gather_full
    from ..moe.layer import moe_ffn_values
    c = EP_OP
    x, ct, wg, wi, wo = ep_op_inputs(r.seed)
    for sizes in EP_MESHES:
        r.mesh(**sizes)
        tag = "ep_values/" + "x".join(f"{a}{n}" for a, n in sizes.items())
        di = r.env.axis_index("dp")
        cut_i = _expert_cut(("ep", None, "mp"), wi.shape)
        cut_o = _expert_cut(("ep", "mp", None), wo.shape)
        xt = torch.from_numpy(x[di]).requires_grad_()
        g = torch.from_numpy(wg).requires_grad_()
        i = cut_full(torch.from_numpy(wi), cut_i).requires_grad_()
        o = cut_full(torch.from_numpy(wo), cut_o).requires_grad_()
        out, aux, z, stats = moe_ffn_values(
            xt, g, i, o, num_experts=c["E"], k=2, capacity_factor=c["cf"])
        ((out * torch.from_numpy(ct[di])).sum() + c["aux"] * aux
         + c["z"] * z).backward()
        got = {"out": out, "aux": aux, "z": z, "stats": stats,
               "dx": xt.grad, "dwg": g.grad,
               "dwi": gather_full(i.grad, cut_i),
               "dwo": gather_full(o.grad, cut_o)}
        for k, v in got.items():
            r.arr[f"{tag}/{k}"] = v.detach().numpy()
        r.rec[tag] = {"coords": r.coords()}
    errs = r.rec.setdefault("errors", {})
    r.mesh(dp=2, ep=2)
    w = torch.zeros(4, 24), torch.zeros(4, 16, 24)
    errs["ep_tokens"] = _error(lambda: moe_ffn_values(
        torch.zeros(3, 16), torch.zeros(16, 4), w[1],
        torch.zeros(4, 24, 16), num_experts=4))
    errs["ep_experts"] = _error(lambda: moe_ffn_values(
        torch.zeros(4, 16), torch.zeros(16, 3), w[1],
        torch.zeros(3, 24, 16), num_experts=3))


def _cpu_ep_train(r):
    """The tiny GPT-MoE on dp 2 x ep 2, dropless, 2 AdamW steps (ZeRO-1
    and ZeRO-2, and with a global-norm clip) and 2 SGD steps; rank 0
    saves the gathered parameters."""
    from ..moe import GPTMoE, GPTMoEConfig
    r.mesh(dp=2, ep=2)
    cfg = GPTMoEConfig(**MOE_TINY)
    weights = numpy_weights(cfg, r.seed, GPTMoE(cfg, device="meta"))
    ids, lbl = tiny_batch(r.seed)
    for tag, zero, clip, lr in (("moe_z1", 1, None, None),
                                ("moe_z2", 2, None, None),
                                ("moe_z1_clip", 1, CLIP_NORM, None),
                                ("moe_sgd", 1, None, SGD_LR)):
        _gpt_case(r, tag, cfg, ids, lbl, zero, 2, True, weights=weights,
                  model_cls=GPTMoE, clip=clip, sgd_lr=lr)
    r.rec["moe_cuts"] = _cut_table(cfg, GPTMoE)
    # ep with sp above 1 is not ported
    r.mesh(sp=2, ep=2)
    r.rec.setdefault("errors", {})["ep_sp"] = _error(lambda: _train(
        r, GPTMoEConfig(**MOE_TINY, sequence_parallel="ring"), ids, lbl, 1,
        1, model_cls=GPTMoE))


def _cut_table(cfg, model_cls):
    """{name: [[dim, axis], ...]} of the parameters shard_model cuts on
    the installed mesh."""
    from ..distributed import shard_model
    from ..distributed.sharded_train import param_cuts
    m = shard_model(model_cls(cfg, device="meta"))
    return {n: [list(d) for d in cut[0]] for n, cut in param_cuts(m).items()}


def _cpu_ep_exchange(r):
    """global_scatter / global_gather over the 4 ranks (2 experts a
    rank), their round trip and the scatter's backward; MoELayer on
    dp 2 x ep 2 (out, aux and the gradients of sum(out * ct) + aux / 2)."""
    torch = r.torch
    from ..distributed import MoELayer
    from ..distributed.collective import _all_gather
    from ..distributed.dist_utils import global_gather, global_scatter
    from ..distributed.sharded_train import gather_full, param_cuts
    world, ne = r.env.get_world_size(), 2
    lcs = [np.random.RandomState(50 + k).randint(0, 4, world * ne)
           for k in range(world)]
    lc = lcs[r.rank]
    gc = np.array([lcs[src][r.rank * ne + e] for src in range(world)
                   for e in range(ne)])
    rows = int(lc.sum())
    x = (torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
         + 1000.0 * r.rank).requires_grad_()
    out = global_scatter(x, lc, gc)
    wgt = torch.from_numpy(np.random.RandomState(60 + r.rank).randn(
        *out.shape).astype(np.float32))
    (out * wgt).sum().backward()
    back = global_gather(out.detach(), lc, gc)
    r.arr["exchange/out"] = out.detach().numpy()
    r.arr["exchange/back"] = back.numpy()
    r.arr["exchange/x"] = x.detach().numpy()
    r.arr["exchange/dx"] = x.grad.numpy()
    r.arr["exchange/w"] = wgt.numpy()
    r.arr["exchange/lc"] = lc
    r.arr["exchange/gc"] = gc
    # the deprecated einsum layer at ep 2
    r.mesh(dp=2, ep=2)
    c = EP_OP
    layer = MoELayer(c["d"], c["f"], c["E"], k=2, capacity_factor=c["cf"])
    rs = np.random.RandomState(r.seed + 41)
    full = {n: (rs.randn(*p.shape) * 0.3).astype(np.float32)
            for n, p in layer.named_parameters()}
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.from_numpy(full[n]))
    from ..distributed import shard_model
    shard_model(layer)
    di = r.env.axis_index("dp")
    xs = rs.randn(2, c["batch"], c["seq"], c["d"]).astype(np.float32)
    ct = rs.randn(*xs.shape).astype(np.float32)
    xt = torch.from_numpy(xs[di]).requires_grad_()
    out = layer(xt)
    ((out * torch.from_numpy(ct[di])).sum() + 0.5 * layer.aux_loss()) \
        .backward()
    cuts = param_cuts(layer)
    r.arr["moelayer/out"] = out.detach().numpy()
    r.arr["moelayer/aux"] = layer.aux_loss().detach().numpy()
    r.arr["moelayer/dx"] = xt.grad.numpy()
    for n, p in layer.named_parameters():
        g = gather_full(p.grad, cuts[n]) if n in cuts else p.grad
        r.arr[f"moelayer/g/{n}"] = g.numpy()
        r.arr[f"moelayer/w/{n}"] = full[n]
    r.arr["moelayer/x"] = xs
    r.arr["moelayer/ct"] = ct
    r.rec["moelayer"] = {"coords": r.coords(),
                         "local_w_in": list(layer.w_in.shape)}
    # every rank's piece of w_in, to see the ep cut
    r.arr["moelayer/w_in_pieces"] = torch.stack(_all_gather(
        layer.w_in.detach(), None)).numpy()


def _cpu_ep_topology(r):
    from ..distributed import fleet
    from ..distributed.strategy import DistributedStrategy
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "ep_degree": 2}
    hcg = fleet.init(is_collective=True, strategy=s)
    r.rec["ep_topology"] = {
        "size": hcg.get_expert_parallel_world_size(),
        "rank": hcg.get_expert_parallel_rank(),
        "group": r.torch.distributed.get_process_group_ranks(
            hcg.get_expert_parallel_group()),
        "dp_rank": hcg.get_data_parallel_rank()}


# ---- the pipeline (cpu_pp) --------------------------------------------------

def _pp_classes():
    """The JAX pipeline tests' tiny Embed, Block, MpBlock and Head, in
    the port's layers (the blocks' gelu is the exact one, as the JAX
    tests' `F.gelu`)."""
    import torch
    from .. import nn
    from ..distributed.mp_layers import ColumnParallelLinear, \
        RowParallelLinear
    F = torch.nn.functional

    class Embed(torch.nn.Module):
        def __init__(self, vocab, d):
            super().__init__()
            self.emb = nn.Embedding(vocab, d)

        def forward(self, ids):
            return self.emb(ids)

    class Block(torch.nn.Module):
        def __init__(self, d):
            super().__init__()
            self.ln = nn.LayerNorm(d)
            self.fc1 = nn.Linear(d, 2 * d)
            self.fc2 = nn.Linear(2 * d, d)

        def forward(self, x):
            return x + self.fc2(F.gelu(self.fc1(self.ln(x))))

    class MpBlock(torch.nn.Module):
        def __init__(self, d):
            super().__init__()
            self.ln = nn.LayerNorm(d)
            self.fc1 = ColumnParallelLinear(d, 2 * d, gather_output=False)
            self.fc2 = RowParallelLinear(2 * d, d, input_is_parallel=True)

        def forward(self, x):
            return x + self.fc2(F.gelu(self.fc1(self.ln(x))))

    class Head(torch.nn.Module):
        def __init__(self, d, vocab):
            super().__init__()
            self.ln = nn.LayerNorm(d)
            self.proj = nn.Linear(d, vocab)

        def forward(self, x):
            return self.proj(self.ln(x))

    return Embed, Block, MpBlock, Head


def pp_ce(out, y):
    """The JAX tests' `_ce`: mean cross entropy over the flattened
    logits."""
    from ..nn import functional as F
    return F.cross_entropy(out.reshape(-1, out.shape[-1]), y.reshape(-1))


def pp_tied_head(layer, h):
    return h @ layer.weight.t()


def pp_descs(kind, blocks):
    """The PipelineLayer descs of a case: "plain" Embed + Block x blocks
    + Head, "tied" an Embedding shared with the head's projection, "mp"
    MpBlocks."""
    from .. import nn
    from ..distributed.pipeline import LayerDesc, SharedLayerDesc
    Embed, Block, MpBlock, Head = _pp_classes()
    blk = MpBlock if kind == "mp" else Block
    body = [LayerDesc(blk, PP_D) for _ in range(blocks)]
    if kind == "tied":
        return ([SharedLayerDesc("emb", nn.Embedding, None, "weight", PP_V,
                                 PP_D)] + body
                + [SharedLayerDesc("emb", nn.Embedding, pp_tied_head,
                                   "weight", PP_V, PP_D)])
    return [LayerDesc(Embed, PP_V, PP_D)] + body + [LayerDesc(Head, PP_D,
                                                              PP_V)]


def pp_weights(model, seed):
    """{name: f32 ndarray} for every parameter of a PipelineLayer, drawn
    from RandomState(seed) in named_parameters() order, N(0, 0.3)."""
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*p.shape) * 0.3).astype(np.float32)
            for n, p in model.named_parameters()}


def pp_data(seed, batch, seq=8, vocab=PP_V):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, (batch, seq)).astype(np.int64),
            rs.randint(0, vocab, (batch, seq)).astype(np.int64))


# the ClipGradByNorm cases, PP_CLIP_STEPS SGD steps with the health taps
# on: (tag, mesh, descs kind, blocks, vpp, micro-batches, batch, clip
# norm); each norm binds on about half of its model's tensors
PP_CLIP_STEPS = 2
PP_CLIP_CASES = (("pp4_clipn", {"pp": 4}, "tied", 8, 1, 4, 8, 2.0),
                 ("pp2_mp2_clipn", {"pp": 2, "mp": 2}, "mp", 4, 1, 2, 4,
                  0.1))
# cases: (tag, mesh, descs kind, blocks, vpp, micro-batches, batch)
PP_CASES = (("pp4", {"pp": 4}, "plain", 8, 1, 4, 8),
            ("pp4_tied", {"pp": 4}, "tied", 8, 1, 4, 8),
            ("pp2_dp2", {"dp": 2, "pp": 2}, "plain", 8, 1, 4, 16),
            ("pp2_vpp2", {"dp": 2, "pp": 2}, "plain", 8, 2, 4, 16),
            ("pp2_mp2", {"pp": 2, "mp": 2}, "mp", 4, 1, 2, 4),
            ("pp2_gpt", {"dp": 2, "pp": 2}, "gpt", 4, 1, 2, 8))


def _strategy(n_micro):
    from ..distributed.strategy import DistributedStrategy
    st = DistributedStrategy()
    st.pipeline_configs = {"accumulate_steps": n_micro}
    return st


def _pp_model(kind, blocks, vpp, seed):
    import torch
    from ..distributed.pipeline import PipelineLayer
    if kind == "gpt":
        from ..models.gpt import (GPTConfig, gpt_pipe_loss,
                                  gpt_pipeline_descs)
        cfg = GPTConfig(**PP_GPT_TINY)
        descs, loss = gpt_pipeline_descs(cfg, blocks), gpt_pipe_loss
    else:
        descs, loss = pp_descs(kind, blocks), pp_ce
    m = PipelineLayer(descs, loss_fn=loss, num_virtual_pipeline_stages=vpp)
    w = pp_weights(m, seed)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(w[n]))
    return m


def _cpu_pp_train(r):
    """train_batch on each PP_CASES mesh, PP_STEPS SGD steps, and on each
    PP_CLIP_CASES mesh, PP_CLIP_STEPS SGD steps under ClipGradByNorm with
    the health taps at every_k 1: each rank saves the losses (and each
    step's taps) and its stage's parameters (gathered over mp)."""
    torch = r.torch
    from ..distributed import PipelineParallel
    from ..distributed.sharded_train import gather_full, param_cuts
    from ..nn.clip import ClipGradByNorm
    from ..optimizer import SGD
    cases = [c + (None, PP_STEPS) for c in PP_CASES] + [
        c + (PP_CLIP_STEPS,) for c in PP_CLIP_CASES]
    for tag, sizes, kind, blocks, vpp, n_micro, batch, clip, steps in cases:
        r.mesh(**sizes)
        m = _pp_model(kind, blocks, vpp, r.seed)
        pipe = PipelineParallel(m, strategy=_strategy(n_micro))
        opt = SGD(learning_rate=PP_SGD_LR, parameters=m.parameters(),
                  grad_clip=None if clip is None else ClipGradByNorm(clip))
        if clip is not None:
            pipe.health = dict(HEALTH)
        losses, taps = [], []
        for k in range(steps):
            x, y = pp_data(r.seed + k, batch)
            losses.append(float(pipe.train_batch(
                (torch.from_numpy(x), torch.from_numpy(y)), opt)))
            if clip is not None:
                taps.append(_stats(pipe._health_mon))
        cuts = param_cuts(m)
        names = []
        for n, p in pipe.stage_parameters():
            t = gather_full(p.detach(), cuts[n]) if n in cuts else p.detach()
            r.arr[f"{tag}/p/{n}"] = t.numpy()
            names.append(n)
        plan = pipe._pipe_plan
        r.rec[tag] = {"losses": losses, "coords": r.coords(),
                      "params": names, "blocks": len(plan["blocks"]),
                      "tied": len(plan["tied"]),
                      "chunks": [len(c) for c in plan["chunks"]]}
        if clip is not None:
            r.rec[tag]["health"] = taps


def _cpu_pp_extras(r):
    """eval_batch (loss and outputs, the generators untouched), the
    scaler path, the no-plan warning, fleet's wrapping, the functional
    executors at pp 4 against their pp 1 runs, and the options that
    raise."""
    import warnings
    torch = r.torch
    from ..amp import GradScaler
    from ..distributed import PipelineParallel, fleet
    from ..distributed.pipeline import (PipelineLayer, pipeline_apply,
                                        pipeline_apply_tensors,
                                        pipeline_train_step_1f1b,
                                        pipeline_train_step_interleaved)
    from ..distributed.strategy import DistributedStrategy
    from ..optimizer import SGD
    out = r.rec["pp_extras"] = {}
    # eval_batch after a train step
    r.mesh(pp=4)
    m = _pp_model("plain", 8, 1, r.seed)
    pipe = PipelineParallel(m, strategy=_strategy(4))
    opt = SGD(learning_rate=PP_SGD_LR, parameters=m.parameters())
    x, y = (torch.from_numpy(a) for a in pp_data(r.seed + 7, 8))
    pipe.train_batch((x, y), opt)
    rng = torch.get_rng_state()
    out["eval_loss"] = float(pipe.eval_batch((x, y), compute_loss=True))
    r.arr["pp_extras/eval_out"] = pipe.eval_batch((x, y)).numpy()
    out["rng_untouched"] = bool(torch.equal(rng, torch.get_rng_state()))
    # the scaler path
    m = _pp_model("plain", 8, 1, r.seed)
    pipe = PipelineParallel(m, strategy=_strategy(4))
    opt = SGD(learning_rate=PP_SGD_LR, parameters=m.parameters())
    scaler = GradScaler(init_loss_scaling=1024.0)
    out["scaler_loss"] = float(pipe.train_batch((x, y), opt, scaler=scaler))
    for n, p in pipe.stage_parameters():
        r.arr[f"pp_scaler/p/{n}"] = p.detach().numpy()
    out["scaler_scale"] = scaler._scale
    # no run of >= pp identical layers: a warning, the sequential step
    lin = PipelineLayer([torch.nn.Linear(4, 8), torch.tanh,
                         torch.nn.Linear(8, 2)],
                        loss_fn=lambda o, t: torch.nn.functional
                        .cross_entropy(o, t))
    pipe = PipelineParallel(lin, strategy=_strategy(2))
    opt = SGD(learning_rate=PP_SGD_LR, parameters=lin.parameters())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        loss = pipe.train_batch((torch.randn(8, 4), torch.randint(0, 2, (8,))),
                                opt)
    out["warned"] = [str(w.message) for w in rec
                     if "SEQUENTIAL" in str(w.message)]
    out["warned_loss"] = float(loss)
    # the options that raise, and resilience, which trains and commits
    errs = r.rec.setdefault("errors", {})
    p2 = PipelineParallel(_pp_model("plain", 8, 1, r.seed))
    p2.lint = True
    errs["pp_lint"] = _error(lambda: p2.train_batch(
        (x, y), SGD(parameters=p2.parameters())))
    p2 = PipelineParallel(_pp_model("plain", 8, 1, r.seed))
    p2.resilience = {"checkpoint_dir": os.path.join(r.out, "pp_ckpt"),
                     "save_every": 1, "preempt": False}
    p2.train_batch((x, y), SGD(parameters=p2.parameters()))
    res = p2._resilience_manager()
    res.ckpt.drain()
    errs["pp_resilience"] = f"accepted: committed {res.ckpt.steps()}"
    res.close()
    errs["pp_apply_plan"] = _error(lambda: PipelineParallel(
        _pp_model("plain", 8, 1, r.seed)).apply_plan(object()))
    # the functional executors at pp 4 (x, y on every rank)
    rs = np.random.RandomState(r.seed + 9)
    L, D = 8, 16
    ws = torch.from_numpy((rs.randn(L, D, D) * 0.3).astype(np.float32))
    hw = torch.from_numpy((rs.randn(D, 5) * 0.3).astype(np.float32))
    xf = torch.from_numpy(rs.randn(8, D).astype(np.float32))
    yf = torch.from_numpy(rs.randint(0, 5, (8,)))
    for tag, fn in (("f1b", lambda: pipeline_train_step_1f1b(
            pp_stage_fn, pp_head_loss_fn, [ws], [hw], xf, yf, 4)),
            ("finter", lambda: pipeline_train_step_interleaved(
                pp_stage_fn, pp_head_loss_fn, [ws], [hw], xf, yf, 4, 2))):
        loss, pg, hg, dx = fn()
        r.arr[f"pp_fn/{tag}/loss"] = loss.detach().numpy()
        r.arr[f"pp_fn/{tag}/pg"] = pg[0].numpy()
        r.arr[f"pp_fn/{tag}/hg"] = hg[0].numpy()
        r.arr[f"pp_fn/{tag}/dx"] = dx.numpy()
    # GPipe forward and backward at pp 4: y = pipeline_apply_tensors(ws,
    # x) and pipeline_apply(ws, x, extra b); d sum(y * ct) on every rank
    bias = torch.from_numpy((rs.randn(D) * 0.3).astype(np.float32))
    ct = torch.from_numpy(rs.randn(8, D).astype(np.float32))
    for tag, extra in (("gpipe", ()), ("gpipe_b", (bias,))):
        w_l, x_l = ws.clone().requires_grad_(), xf.clone().requires_grad_()
        ex = [e.clone().requires_grad_() for e in extra]
        if extra:
            yv = pipeline_apply(pp_stage_fn_bias, [w_l], x_l, 4,
                                extra_inputs=tuple(ex))
        else:
            yv = pipeline_apply_tensors(pp_stage_fn, [w_l], x_l, 4)
        (yv * ct).sum().backward()
        r.arr[f"pp_fn/{tag}/y"] = yv.detach().numpy()
        r.arr[f"pp_fn/{tag}/gw"] = w_l.grad.numpy()
        r.arr[f"pp_fn/{tag}/gx"] = x_l.grad.numpy()
        if extra:
            r.arr[f"pp_fn/{tag}/gb"] = ex[0].grad.numpy()
    # with dropout: the backward's rerun draws the forward's masks
    w_l, x_l = ws.clone().requires_grad_(), xf.clone().requires_grad_()
    torch.manual_seed(PP_GPIPE_SEED)
    yv = pipeline_apply_tensors(pp_stage_fn_dropout, [w_l], x_l, 4)
    (yv * ct).sum().backward()
    r.arr["pp_fn/gpipe_drop/y"] = yv.detach().numpy()
    r.arr["pp_fn/gpipe_drop/gw"] = w_l.grad.numpy()
    r.arr["pp_fn/gpipe_drop/gx"] = x_l.grad.numpy()
    r.arr["pp_fn/inputs/bias"] = bias.numpy()
    r.arr["pp_fn/inputs/ct"] = ct.numpy()
    r.arr["pp_fn/inputs/ws"] = ws.numpy()
    r.arr["pp_fn/inputs/hw"] = hw.numpy()
    r.arr["pp_fn/inputs/x"] = xf.numpy()
    r.arr["pp_fn/inputs/y"] = yf.numpy()
    # fleet wraps a PipelineLayer under pp > 1, not a plain module
    s = DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 4, "dp_degree": 1}
    s.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=s)
    wrapped = fleet.distributed_model(_pp_model("plain", 8, 1, r.seed))
    plain = torch.nn.Linear(2, 2)
    out["fleet"] = {"wrapped": type(wrapped).__name__,
                    "micro": getattr(wrapped, "_num_micro", None),
                    "plain_kept": fleet.distributed_model(plain) is plain,
                    "stage": fleet.get_hybrid_communicate_group()
                    .get_stage_id()}


def pp_stage_fn(params, h):
    """The JAX 1F1B tests' stage: tanh(h W) over the stage's rows."""
    import torch
    for w in params[0]:
        h = torch.tanh(h @ w)
    return h


def pp_stage_fn_dropout(params, h):
    """`pp_stage_fn` with dropout (PP_GPIPE_DROPOUT) after each row."""
    import torch
    for w in params[0]:
        h = torch.nn.functional.dropout(torch.tanh(h @ w), PP_GPIPE_DROPOUT)
    return h


def pp_stage_fn_bias(params, h, b):
    """`pp_stage_fn` with an extra input: tanh(h W + b) over the rows."""
    import torch
    for w in params[0]:
        h = torch.tanh(h @ w + b)
    return h


def pp_head_loss_fn(hp, h, y_mb):
    import torch
    lp = torch.log_softmax(h @ hp[0], -1)
    return -lp.gather(1, y_mb[:, None].long()).mean()


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

    def all_to_all_uneven():
        # rank k sends k + 1 rows to each rank (n = 2)
        rows = me + 1
        src = x[:rows * n]
        out = torch.empty(sum(k + 1 for k in range(n)), device=r.dev)
        dist.all_to_all_single(out, src, output_split_sizes=[
            k + 1 for k in range(n)], input_split_sizes=[rows] * n)
        want = torch.cat([(torch.arange(8.0) + 100 * k)[
            (k + 1) * me:(k + 1) * (me + 1)] for k in range(n)])
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
              "all_to_all_uneven": all_to_all_uneven,
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
    for tag, mode, amp_on, fce in (("ring_f32", "ring", False, False),
                                   ("ulysses_f32", "ulysses", False, False),
                                   ("ring_bf16", "ring", True, False),
                                   ("ring_fce_f32", "ring", False, True)):
        cfg = GPTConfig.gpt3_1_3b(num_layers=2, max_seq_len=CARD_SEQ,
                                  dropout=0.0, sequence_parallel=mode)
        steps = CARD_FCE_STEPS if tag in ("ring_f32", "ring_fce_f32") \
            else CARD_STEPS
        _gpt_case(r, tag, cfg, ids, lbl, 1, steps, False, seed=r.seed,
                  amp_on=amp_on, record_step=steps - 1, fused_ce=fce)
        _release(r)
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
        _release(r)
    r.rec["zero_max_diff"] = {
        f"{a}_vs_{b}": max(float(np.abs(params[a][n] - params[b][n]).max())
                           for n in params[a])
        for a, b in ((1, 0), (2, 1), (2, 0))}


# ---- the card's expert-parallel and pipeline legs ---------------------------

def _release(r):
    """Free what the last leg left: its model, step and optimizer hold
    each other through their hooks, a cycle that only the collector
    frees, so `del` alone leaves them on the card; then the card's
    cached blocks go back, and the next leg's memory readings start
    from what it holds itself."""
    gc.collect()
    if r.dev.type == "cuda":
        r.torch.cuda.empty_cache()


def _peak_gb(r):
    torch = r.torch
    return torch.cuda.max_memory_allocated() / 2 ** 30 \
        if r.dev.type == "cuda" else 0.0


def _reset_step(r):
    from ..distributed.collective import reset_comm_stats
    from ..ops.kernel_registry import reset_launches
    r.sync()
    if r.dev.type == "cuda":
        r.torch.cuda.reset_peak_memory_stats()
    reset_launches()
    reset_comm_stats()


def _rel_errors(params, ref):
    """{name: ||p - ref|| / ||ref||} of full parameters (ndarrays)
    against the reference's (CPU tensors)."""
    out = {}
    for n, a in params.items():
        b = ref[n].float().numpy()
        out[n] = float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b))
                                                 or 1.0)
    return out


def _ep4(r):
    """GPT-MoE at the bench's width on ep 4, dp 2 x ep 2 and ep 2 x mp 2:
    (i) dropless f32 SGD steps against the one-process TrainStep (run on
    rank 0 first), (ii) capacity-bound moe_ffn_values against its
    block-by-block run in the same process and one step's loss, (iii)
    bf16 amp steps against the f32 ones."""
    torch = r.torch
    from ..jit import TrainStep
    from ..moe import GPTMoE, GPTMoEConfig
    from ..optimizer import SGD
    ids, lbl = tiny_batch(r.seed, EP_CARD_BATCH, EP_CARD_SEQ,
                          EP_CARD["vocab_size"])
    cfg = GPTMoEConfig(**EP_CARD, capacity_factor=EP_DROPLESS_CF)
    ref = None
    if r.rank == 0:
        r.env.set_mesh(None)
        model = GPTMoE(cfg, device=r.dev, seed=r.seed)
        step = TrainStep(model, model.loss, SGD(
            learning_rate=SGD_LR, parameters=model.parameters()))
        tids, tlbl = (torch.from_numpy(a).to(r.dev) for a in (ids, lbl))
        t0 = time.perf_counter()
        losses = [float(step(tids, tlbl)) for _ in range(EP_CARD_STEPS)]
        r.rec["ep4/reference"] = {"losses": losses,
                                  "s": time.perf_counter() - t0}
        ref = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model, step, tids, tlbl
        _release(r)
    r.coll.barrier()
    for sizes in EP_CARD_MESHES:
        r.mesh(**sizes)
        tag = "ep4/" + "x".join(f"{a}{n}" for a, n in sizes.items())
        params = _gpt_case(r, tag, cfg, ids, lbl, 1, EP_CARD_STEPS, False,
                           seed=r.seed, model_cls=GPTMoE, sgd_lr=SGD_LR)
        if ref is not None:
            rel = _rel_errors(params, ref)
            worst = max(rel, key=rel.get)
            r.rec[tag]["param_rel"] = {"max": rel[worst], "name": worst}
        del params
        _release(r)
        _ep_bound(r, tag, cfg)
    del ref
    # (iii) bf16 amp on ep 4 against the f32 run there
    r.mesh(ep=4)
    _gpt_case(r, "ep4/ep4_bf16", cfg, ids, lbl, 1, EP_CARD_STEPS, False,
              seed=r.seed, model_cls=GPTMoE, amp_on=True, sgd_lr=SGD_LR)
    # a capacity-bound step (cf 1.25), its loss finite
    _gpt_case(r, "ep4/ep4_cf1.25", GPTMoEConfig(
        **EP_CARD, capacity_factor=EP_BOUND_CF), ids, lbl, 1, 1, False,
        seed=r.seed, model_cls=GPTMoE, sgd_lr=SGD_LR)


def _ep_bound(r, tag, cfg):
    """moe_ffn_values at cf 1.25 on the installed mesh: this rank's rows
    through the experts (f32), out and dx against the same function run
    on each ep block of those rows with no mesh."""
    torch = r.torch
    from ..distributed.collective import comm_stats
    from ..distributed.sharded_train import cut_full
    from ..moe.layer import moe_ffn_values
    gen = torch.Generator(device=r.dev).manual_seed(r.seed + 5)
    d, E = cfg.hidden_size, cfg.num_experts
    f = cfg.ffn_hidden_size
    std = cfg.initializer_range

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=r.dev) * scale

    # the gate leans toward the higher experts (x has a mean of 0.5 a
    # component, column e of w_gate one of 0.0005 e), so that cf 1.25
    # drops choices
    wg = draw(d, E, scale=std) + 5e-4 * torch.arange(E, device=r.dev)
    wi, wo = draw(E, d, f, scale=std), draw(E, f, d, scale=std)
    dp = r.env.axis_size("dp")
    rows = EP_CARD_BATCH // dp
    x_all = draw(EP_CARD_BATCH, EP_CARD_SEQ, d) + 0.5
    ct_all = draw(EP_CARD_BATCH, EP_CARD_SEQ, d)
    di = r.env.axis_index("dp")
    x = x_all[di * rows:(di + 1) * rows].clone()
    ct = ct_all[di * rows:(di + 1) * rows]
    cut_i = _expert_cut(("ep", None, "mp"), wi.shape)
    cut_o = _expert_cut(("ep", "mp", None), wo.shape)
    xg = x.clone().requires_grad_()
    _reset_step(r)
    out, aux, z, stats = moe_ffn_values(
        xg, wg, cut_full(wi, cut_i).contiguous(),
        cut_full(wo, cut_o).contiguous(), num_experts=E,
        k=cfg.expert_top_k, capacity_factor=EP_BOUND_CF)
    (out * ct).sum().backward()
    r.sync()
    a2a = comm_stats()["bytes"].get("all_to_all", 0)
    ep = r.env.axis_size("ep")
    mesh = r.env.current_mesh()
    r.env.set_mesh(None)
    refs, grads = [], []
    for b, cb in zip(x.chunk(ep), ct.chunk(ep)):
        bg = b.clone().requires_grad_()
        o, _, _, _ = moe_ffn_values(bg, wg, wi, wo, num_experts=E,
                                    k=cfg.expert_top_k,
                                    capacity_factor=EP_BOUND_CF)
        (o * cb).sum().backward()
        refs.append(o.detach())
        grads.append(bg.grad)
    r.env.set_mesh(mesh)
    o_ref, g_ref = torch.cat(refs), torch.cat(grads)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    r.rec[tag]["bound"] = {"out_rel": rel(out.detach(), o_ref),
                           "dx_rel": rel(xg.grad, g_ref),
                           "dropped_frac": float(stats[1]),
                           "all_to_all_bytes_fwd_bwd": a2a}
    del x_all, ct_all, wi, wo


def init_pipe_weights(model, seed, std=0.02):
    """Seeded weights for a PipelineLayer, drawn on its device in
    named_parameters() order: LayerNorm scales 1 and shifts 0, other
    biases 0, every other tensor N(0, std)."""
    import torch
    from .. import nn
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    lns = {id(p) for m in model.modules() if isinstance(m, nn.LayerNorm)
           for p in m.parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            if id(p) in lns:
                p.fill_(1.0) if n.endswith("weight") else p.zero_()
            elif n.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=gen)


# (tag, mesh, vpp, amp, accumulate steps, steps, ClipGradByNorm with the
# health taps at every_k 1)
PP_CARD_RUNS = (("1f1b", {"pp": 4}, 1, False, PP_CARD_ACC, PP_CARD_STEPS,
                 False),
                ("interleaved", {"pp": 4}, 2, False, PP_CARD_ACC,
                 PP_CARD_STEPS, False),
                ("pp2_mp2", {"pp": 2, "mp": 2}, 1, False, PP_CARD_ACC,
                 PP_CARD_STEPS, False),
                ("1f1b_bf16", {"pp": 4}, 1, True, PP_CARD_ACC,
                 PP_CARD_STEPS, False),
                ("1f1b_acc4", {"pp": 4}, 1, False, 4, 1, False),
                ("1f1b_acc16", {"pp": 4}, 1, False, 16, 1, False),
                ("1f1b_clipn", {"pp": 4}, 1, False, PP_CARD_ACC,
                 PP_CARD_STEPS, True),
                ("pp2_mp2_clipn", {"pp": 2, "mp": 2}, 1, False, PP_CARD_ACC,
                 PP_CARD_STEPS, True))
# the card's ClipGradByNorm norm (GPT-3 1.3B width, init 0.02)
PP_CARD_CLIP = 0.05


def pp_card_config():
    from ..models.gpt import GPTConfig
    return GPTConfig.gpt3_1_3b(num_layers=PP_CARD_BLOCKS,
                               max_seq_len=CARD_SEQ, dropout=0.0)


def _pp_pipe(r, cfg, vpp):
    from ..distributed.pipeline import PipelineLayer
    from ..models.gpt import gpt_pipe_loss, gpt_pipeline_descs
    with r.torch.device(r.dev):
        m = PipelineLayer(gpt_pipeline_descs(cfg), loss_fn=gpt_pipe_loss,
                          num_virtual_pipeline_stages=vpp)
    init_pipe_weights(m, r.seed, cfg.initializer_range)
    return m


def _pp_reference(r, cfg, path, clip):
    """Rank 0: the one-process sequential train_batch (no mesh) for
    PP_CARD_STEPS SGD steps, with `clip` under ClipGradByNorm(clip) and
    the health taps at every_k 1; its parameters go to `path`. -> its
    record (losses, seconds, each step's taps)."""
    torch = r.torch
    from ..distributed import PipelineParallel
    from ..nn.clip import ClipGradByNorm
    from ..optimizer import SGD
    r.env.set_mesh(None)
    m = _pp_pipe(r, cfg, 1)
    pipe = PipelineParallel(m, strategy=_strategy(PP_CARD_ACC))
    opt = SGD(learning_rate=SGD_LR, parameters=m.parameters(),
              grad_clip=None if clip is None else ClipGradByNorm(clip))
    if clip is not None:
        pipe.health = dict(HEALTH)
    t0 = time.perf_counter()
    losses, taps = [], []
    for k in range(PP_CARD_STEPS):
        ids, lbl = tiny_batch(r.seed + k, PP_CARD_ACC, CARD_SEQ,
                              cfg.vocab_size)
        losses.append(float(pipe.train_batch(
            (torch.from_numpy(ids).to(r.dev),
             torch.from_numpy(lbl).to(r.dev)), opt)))
        if clip is not None:
            taps.append(_stats(pipe._health_mon))
    rec = {"losses": losses, "s": time.perf_counter() - t0}
    if clip is not None:
        rec["health"] = taps
    torch.save({n: p.detach().cpu() for n, p in m.named_parameters()}, path)
    del m, pipe, opt
    _release(r)
    return rec


def _pp4(r):
    """GPT-3 1.3B's width as a PipelineLayer (tied embedding, 8 blocks,
    final LN, tied head), micro-batch 1 x CARD_SEQ. First the one-process
    references, side by side, a rank each: rank 0 the sequential
    train_batch, rank 1 the same under ClipGradByNorm with the health
    taps (each leaves its parameters in a file), rank 2 the GPipe leg's
    gradient. Then 1F1B at pp 4, interleaved at pp 4 x vpp 2, pp 2 x mp
    2 (f32), 1F1B in bf16 amp, 1F1B at 4 and 16 micro-batches (memory),
    and 1F1B at pp 4 and pp 2 x mp 2 under the clip with the taps; each
    rank checks its stage's parameters against the file of its run.
    Then GPipe's forward and backward (`_pp4_gpipe`)."""
    torch = r.torch
    from .. import amp
    from ..distributed import PipelineParallel
    from ..distributed.collective import comm_stats
    from ..distributed.sharded_train import gather_full, param_cuts
    from ..nn.clip import ClipGradByNorm
    from ..optimizer import SGD
    cfg = pp_card_config()
    paths = {False: os.path.join(r.out, "pp4_reference.pt"),
             True: os.path.join(r.out, "pp4_reference_clip.pt")}
    gpipe_ref = None
    if r.rank == 0:
        r.rec["pp4/reference"] = _pp_reference(r, cfg, paths[False], None)
    elif r.rank == 1:
        r.rec["pp4/reference_clip"] = _pp_reference(r, cfg, paths[True],
                                                    PP_CARD_CLIP)
    elif r.rank == 2:
        gpipe_ref = _gpipe_reference(r, cfg)
    r.coll.barrier()
    if r.rank == 1:
        # the clip bound on some tensor: the runs' parameters differ
        a, b = (torch.load(paths[c], mmap=True) for c in (False, True))
        r.rec["pp4/reference_clip"]["tensors_changed"] = sum(
            not torch.equal(a[n], b[n]) for n in a)
        del a, b
    refs = {c: torch.load(paths[c], mmap=True) for c in (False, True)}
    for tag, sizes, vpp, amp_on, acc, steps, clip in PP_CARD_RUNS:
        r.mesh(**sizes)
        m = _pp_pipe(r, cfg, vpp)
        pipe = PipelineParallel(m, strategy=_strategy(acc))
        opt = SGD(learning_rate=SGD_LR, parameters=m.parameters(),
                  grad_clip=ClipGradByNorm(PP_CARD_CLIP) if clip else None)
        if clip:
            pipe.health = dict(HEALTH)
        per = []
        for k in range(steps):
            ids, lbl = tiny_batch(r.seed + k, acc, CARD_SEQ, cfg.vocab_size)
            batch = (torch.from_numpy(ids).to(r.dev),
                     torch.from_numpy(lbl).to(r.dev))
            r.coll.barrier()
            _reset_step(r)
            t0 = time.perf_counter()
            with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
                loss = float(pipe.train_batch(batch, opt))
            r.sync()
            per.append({"loss": loss,
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "launches": _launch_counts(), "comm": comm_stats(),
                        "peak_mem_gb": _peak_gb(r)})
            if clip:
                per[-1]["health"] = _stats(pipe._health_mon)
        rec = {"losses": [d["loss"] for d in per], "steps": per,
               "coords": r.coords(), "acc": acc, "vpp": vpp,
               "local_blocks": sum(len(c) for c in
                                   pipe._pipe_plan["chunks"])}
        if not amp_on and steps == PP_CARD_STEPS:
            ref = refs[clip]
            cuts = param_cuts(m)
            rel = {}
            for n, p in pipe.stage_parameters():
                t = gather_full(p.detach(), cuts[n]) if n in cuts \
                    else p.detach()
                rel[n] = float((t.float().cpu() - ref[n]).norm()
                               / ref[n].norm())
            worst = max(rel, key=rel.get)
            rec["param_rel"] = {"max": rel[worst], "name": worst,
                                "count": len(rel)}
        r.rec[f"pp4/{tag}"] = rec
        del m, pipe, opt
        _release(r)
    del refs
    r.coll.barrier()
    if r.rank == 0:
        for path in paths.values():
            os.remove(path)
    _pp4_gpipe(r, cfg, gpipe_ref)


def _gpipe_inputs(r, cfg):
    """The GPipe leg's inputs, the same on every rank: PP_CARD_BLOCKS
    GPT-3 1.3B-width blocks' parameters stacked (LayerNorms 1 and 0,
    biases 0, the rest N(0, init) from a generator seeded with the
    seed), x and the cotangent ct [PP_CARD_ACC, CARD_SEQ, d], and
    stage_fn (a GPTBlock run by `functional_call` over each row)."""
    torch = r.torch
    from torch.func import functional_call
    from .. import nn
    from ..models.gpt import GPTBlock
    tmpl = GPTBlock(cfg, device=r.dev)
    names = [n for n, _ in tmpl.named_parameters()]
    lns = {id(p) for mod in tmpl.modules() if isinstance(mod, nn.LayerNorm)
           for p in mod.parameters()}
    gen = torch.Generator(device=r.dev).manual_seed(r.seed + 21)
    stack = []
    for n, p in tmpl.named_parameters():
        t = torch.empty((PP_CARD_BLOCKS,) + tuple(p.shape), device=r.dev)
        if id(p) in lns:
            t.fill_(1.0) if n.endswith("weight") else t.zero_()
        elif n.endswith("bias"):
            t.zero_()
        else:
            t.normal_(0.0, cfg.initializer_range, generator=gen)
        stack.append(t)
    shape = (PP_CARD_ACC, CARD_SEQ, cfg.hidden_size)
    x = torch.randn(shape, generator=gen, device=r.dev)
    ct = torch.randn(shape, generator=gen, device=r.dev)

    def stage_fn(local, h):
        for i in range(local[0].shape[0]):
            h = functional_call(tmpl, {n: p[i] for n, p in
                                       zip(names, local)}, (h,))
        return h

    return names, [t.requires_grad_() for t in stack + [x]], ct, stage_fn


def _gpipe_reference(r, cfg):
    """The one-process gradient of sum(y * ct) through the stacked blocks
    (no mesh; the micro-batches in turn) -> [d stack..., dx]."""
    r.env.set_mesh(None)
    _, leaves, ct, stage_fn = _gpipe_inputs(r, cfg)
    for m in range(PP_CARD_ACC):
        y = stage_fn(leaves[:-1], leaves[-1][m:m + 1])
        (y * ct[m:m + 1]).sum().backward()
    return [t.grad for t in leaves]


def _pp4_gpipe(r, cfg, ref):
    """GPipe (`pipeline_apply`) forward and backward at pp 4 through
    `_gpipe_inputs`' blocks, x in PP_CARD_ACC micro-batches: d sum(y *
    ct) with respect to the stack and x on every rank. The rank that
    holds the one-process gradient `ref` (`_gpipe_reference`) holds the
    pipelined one against it; every rank keeps a fingerprint of its
    gradients (they must be the same)."""
    torch = r.torch
    from ..distributed.pipeline import pipeline_apply
    r.mesh(pp=4)
    names, leaves, ct, stage_fn = _gpipe_inputs(r, cfg)
    out = {}
    _reset_step(r)
    t0 = time.perf_counter()
    y = pipeline_apply(stage_fn, leaves[:-1], leaves[-1], PP_CARD_ACC)
    (y * ct).sum().backward()
    r.sync()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = _launch_counts()
    out["peak_mem_gb"] = _peak_gb(r)
    out["fingerprint"] = float(sum(t.grad.double().square().sum()
                                   for t in leaves))
    if ref is not None:
        rel = [float((t.grad - g).norm() / g.norm())
               for t, g in zip(leaves, ref)]
        out["grad_rel"] = {"max": max(rel), "dx": rel[-1],
                           "stack": dict(zip(names, rel[:-1]))}
    r.rec["pp4/gpipe"] = out
    del leaves, y, ct, ref
    _release(r)


# ---- ZeRO-3, offload and checkpoints ----------------------------------------

# the ZeRO-3 legs, ZERO3_STEPS steps each on the CPU; on the card
# (whose steps cross the host over gloo, ~4-10 s each) remat and the
# health taps run ZERO3_STEPS, ZeRO-3 too (its pieces after
# ZERO3_CARD_STEPS are kept for the shorter legs), the others
# ZERO3_CARD_STEPS: (tag, stage, options of `_train`, the leg whose
# pieces it is held against, at the same step); the CPU job runs every
# stage's offload, the card ZeRO-3's alone, bf16, remat and the taps
ZERO3_STEPS, ZERO3_CARD_STEPS = 3, 2
ZERO3_CARD_FULL = ("z3", "z3_remat", "z3_health")
ZERO3_LEGS = (("z2", 2, {}, None), ("z3", 3, {}, "z2"),
              ("z3_off", 3, {"offload": True}, "z3"),
              ("z1", 1, {}, "z2"), ("z1_off", 1, {"offload": True}, "z1"),
              ("z2_off", 2, {"offload": True}, "z2"),
              ("z3_bf16", 3, {"amp_on": True}, "z3"),
              ("z3_remat", 3, {"remat": True}, "z3"),
              ("z3_health", 3, {"health": True}, "z3"))
ZERO3_CPU_TAGS = ("z2", "z3", "z3_off", "z1", "z1_off", "z2_off",
                  "z3_remat", "z3_health")
ZERO3_CARD_TAGS = ("z2", "z3", "z3_off", "z3_bf16", "z3_remat", "z3_health")
# the checkpoint legs: a save every `save_every` steps, 2 kept; the
# preemption requested on rank 2 alone before step index `preempt_at`
# (every rank stops at the boundary after it); the resumed run's step
# `from` restored under other layouts and `cont` steps run at dropout 0
CKPT_KEEP, CKPT_PREEMPT_RANK, CKPT_DROPOUT = 2, 2, 0.1
# `source` names the run whose step `start` the other layouts restore:
# on the card the uninterrupted run's, so that the resume and the
# reshards run side by side
CKPT_CPU = dict(steps=6, save_every=2, preempt_at=2, start=4, cont=2,
                source="drill")
CKPT_CARD = dict(steps=3, save_every=2, preempt_at=0, start=2, cont=2,
                 source="base")
# the card's legs: GPT-3 1.3B's width cut to 2 blocks (the distributed
# phase's card4 depth), one row of 2048 a rank
ZERO3_CARD_BLOCKS, CKPT_CARD_BLOCKS = 2, 2
# the zero3_8 job (not in the smoke): ZeRO-3 with and without remat at
# 8 blocks, where remat's saving shows
ZERO3_DEPTH_BLOCKS = 8


def ckpt_batch(i, batch, seq, vocab):
    """Step i's global batch (ids, labels): a function of the step, as
    a seekable loader's would be."""
    rs = np.random.RandomState(10_000 + i)
    return (rs.randint(0, vocab, (batch, seq)).astype(np.int32),
            rs.randint(0, vocab, (batch, seq)).astype(np.int32))


def _pieces(step):
    """{name: f32 ndarray} of this rank's ZeRO pieces of the parameters
    (the flat range it owns), copied to the host."""
    return {pl.name: pl.get().float().cpu().numpy().copy()
            for pl in step._places(None) if pl.save_flat is not None}


def _piece_diff(r, pieces, ref):
    """(||p - ref|| / ||ref||, max |p - ref|, equal) over every rank's
    pieces at once (an all-reduce): the numbers a comparison of the
    gathered parameters gives."""
    t = r.torch.tensor([sum(float(np.square(pieces[n] - ref[n]).sum())
                            for n in ref),
                        sum(float(np.square(ref[n]).sum()) for n in ref),
                        sum(int((pieces[n] != ref[n]).sum()) for n in ref)],
                       dtype=r.torch.float64)
    mx = r.torch.tensor([max(float(np.abs(pieces[n] - ref[n]).max())
                             for n in ref)], dtype=r.torch.float64)
    r.coll.all_reduce(t)
    r.coll.all_reduce(mx, op=r.coll.ReduceOp.MAX)
    return float(t[0] / t[1]) ** 0.5, float(mx[0]), int(t[2]) == 0


def _zero3_cases(r, cfg, ids, lbl, weights=None, card=False):
    """ZeRO-2 and ZeRO-3 at dp 4, the offloaded stages against the same
    stage without offload, bf16 amp, remat and the health taps against
    ZeRO-3 (ZERO3_LEGS; the taps also against `_health_reference`),
    then ZeRO-3 at dp 2 x mp 2, taps on, against dp 4's losses. Every
    rank compares its pieces and the sums are all-reduced; on the CPU
    rank 0 also saves the gathered parameters of z2, z3, z3_remat and
    z3_mp."""
    from ..convert import gather_params

    def steps_of(tag):
        return ZERO3_STEPS if not card or tag in ZERO3_CARD_FULL \
            else ZERO3_CARD_STEPS

    _health_reference(r, cfg, ids, lbl, steps_of("z3_health"), weights)
    r.mesh(dp=4)
    kept, cmp = {}, {}     # kept[tag][n]: the pieces after n steps

    def leg(tag, zero, **kw):
        def snap(k, step):
            if k + 1 == ZERO3_CARD_STEPS:
                kept.setdefault(tag, {})[k + 1] = _pieces(step)
        step, model, per = _train(
            r, cfg, ids, lbl, zero, steps_of(tag), weights=weights,
            seed=r.seed, tag=tag,
            after_step=snap if tag in ("z1", "z2", "z3") else None, **kw)
        r.rec[tag] = {"losses": [d["loss"] for d in per], "steps": per,
                      "state_bytes": step.state_bytes(),
                      "coords": r.coords(),
                      "state_dict": sorted(
                          k for k in step.optimizer.state_dict()
                          if k != "LR_Scheduler")}
        if not card and tag in ("z2", "z3", "z3_remat", "z3_mp"):
            params = gather_params(model)
            if r.rank == 0:
                for n, a in params.items():
                    r.arr[f"{tag}/{n}"] = a
            del params
        return step

    def loss_rel(tag, base):
        return [abs(a - b) / abs(b) for a, b in zip(r.rec[tag]["losses"],
                                                    r.rec[base]["losses"])]

    tags = ZERO3_CARD_TAGS if card else ZERO3_CPU_TAGS
    for tag, zero, kw, base in ZERO3_LEGS:
        if tag not in tags:
            continue
        if tag == "z3_remat":
            # torch.utils.checkpoint's first call imports torch._dynamo:
            # timed here, outside the leg's first step
            t0 = time.perf_counter()
            import torch._dynamo  # noqa: F401
            r.rec["z3_remat/dynamo_import_s"] = time.perf_counter() - t0
        step = leg(tag, zero, **kw)
        params = _pieces(step)
        alive = weakref.ref(step)
        del step
        n = len(r.rec[tag]["losses"])
        if tag in ("z1", "z2", "z3"):
            kept.setdefault(tag, {})[n] = params
        if base is not None:
            # at the shorter leg's last step (ZeRO-3 after 3 against
            # ZeRO-2 after 2: its pieces after 2)
            at = min(n, len(r.rec[base]["losses"]))
            rel, mx, equal = _piece_diff(
                r, params if at == n else kept[tag][at], kept[base][at])
            cmp[tag] = {"vs": base, "loss_rel": loss_rel(tag, base),
                        "rel": rel, "max_abs": mx, "equal": equal,
                        "steps": at}
        del params
        _release(r)
        # nothing keeps a finished step (and its model and states)
        r.rec.setdefault("zero3_freed", {})[tag] = alive() is None
    r.mesh(dp=2, mp=2)
    leg("z3_mp", 3, health=True)
    cmp["z3_mp"] = {"vs": "z2", "loss_rel": loss_rel("z3_mp", "z2")}
    if r.rank == 0:
        r.rec["zero3_cmp"] = cmp


def _health_reference(r, cfg, ids, lbl, steps, weights=None):
    """Rank 0 runs `jit.TrainStep(health=)` (one process, no mesh) for
    `steps` AdamW steps on the global batch from the legs' weights
    and keeps each step's health stats under "z3_health/reference"; the
    other ranks wait at a barrier."""
    torch = r.torch
    if r.rank == 0:
        from ..convert import shard_jax_params
        from ..jit import TrainStep
        from ..models.gpt import GPTForPretraining
        from ..optimizer import AdamW
        r.env.set_mesh(None)
        model = GPTForPretraining(cfg, device=r.dev, seed=r.seed)
        if weights is not None:
            shard_jax_params(model, weights)
        opt = AdamW(learning_rate=LR, weight_decay=WD,
                    parameters=model.parameters())
        step = TrainStep(model, model.loss, opt, health=dict(HEALTH))
        batch = [torch.from_numpy(a).to(r.dev) for a in (ids, lbl)]
        stats = []
        for _ in range(steps):
            step(*batch)
            stats.append(_stats(step.health))
        r.rec["z3_health/reference"] = stats
        del model, opt, step
        _release(r)
    r.coll.barrier()


def _cpu_zero3(r):
    from ..models.gpt import GPTConfig
    cfg = GPTConfig(**TINY)
    ids, lbl = tiny_batch(r.seed)
    _zero3_cases(r, cfg, ids, lbl, weights=numpy_weights(cfg, r.seed))


def _zero3_card(r):
    from ..models.gpt import GPTConfig
    cfg = GPTConfig.gpt3_1_3b(num_layers=ZERO3_CARD_BLOCKS,
                              max_seq_len=CARD_SEQ, dropout=0.0)
    ids, lbl = tiny_batch(r.seed, 4, CARD_SEQ, cfg.vocab_size)
    _zero3_cases(r, cfg, ids, lbl, card=True)


def _zero3_depth(r):
    """ZeRO-3 and ZeRO-3 with remat, ZERO3_CARD_STEPS f32 AdamW steps
    each at dp 4, GPT-3 1.3B's width x ZERO3_DEPTH_BLOCKS blocks (the
    smoke's zero3_4 runs 2, for its time): each rank's memory a step,
    where remat pays at depth. torch._dynamo, which
    torch.utils.checkpoint imports at its first call, is imported
    first."""
    from ..models.gpt import GPTConfig
    import torch._dynamo  # noqa: F401
    cfg = GPTConfig.gpt3_1_3b(num_layers=ZERO3_DEPTH_BLOCKS,
                              max_seq_len=CARD_SEQ, dropout=0.0)
    ids, lbl = tiny_batch(r.seed, 4, cfg.max_seq_len, cfg.vocab_size)
    r.mesh(dp=4)
    for tag, kw in (("z3", {}), ("z3_remat", {"remat": True})):
        step, model, per = _train(r, cfg, ids, lbl, 3, ZERO3_CARD_STEPS,
                                  seed=r.seed, tag=tag, **kw)
        r.rec[tag] = {"losses": [d["loss"] for d in per], "steps": per}
        del step, model
        _release(r)


def _param_digest(model):
    """sha256 of the gathered parameters (a collective)."""
    import hashlib
    from ..convert import gather_params
    h = hashlib.sha256()
    for n, a in sorted(gather_params(model).items()):
        h.update(n.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _ckpt_run(r, cfg, zero, ckdir, batch_fn, steps, save_every, weights=None,
              seed=0, preempt_at=None, resume_step=None, sink=None,
              after_resume=None):
    """A ShardedTrainStep(resilience=ResilienceManager(ckdir)) run on the
    installed mesh: resume (the newest checkpoint, or `resume_step`),
    then steps up to `steps`, or up to a preemption (requested on rank
    CKPT_PREEMPT_RANK alone before step index `preempt_at`);
    `after_resume(manager)` runs between the resume and the first step.
    -> (record, step, model, manager)."""
    torch = r.torch
    from ..convert import shard_jax_params
    from ..distributed import ShardedTrainStep
    from ..models.gpt import GPTForPretraining
    from ..ops.kernel_registry import reset_launches
    from ..optimizer import AdamW
    from ..resilience import ResilienceManager
    model = GPTForPretraining(cfg, device=r.dev, seed=seed)
    if weights is not None:
        shard_jax_params(model, weights)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    res = ResilienceManager(ckdir, save_every=save_every,
                            keep_last=CKPT_KEEP, sink=sink)
    step = ShardedTrainStep(model, model.loss, opt, zero_stage=zero,
                            resilience=res)
    torch.manual_seed(1234 + r.rank)
    r.sync()
    t0 = time.perf_counter()
    start = res.resume(step=resume_step) or 0
    rec = {"start": start, "resumed_via": res.resumed_via,
           "restore_ms": (time.perf_counter() - t0) * 1e3, "losses": {},
           "ms": [], "in_flight": [], "launches": [], "exit": None}
    if after_resume is not None:
        after_resume(res)
    for i in range(start, steps):
        if preempt_at == i and r.rank == CKPT_PREEMPT_RANK:
            res.handler.request()
        batch = [torch.from_numpy(a).to(r.dev) for a in batch_fn(i)]
        pend = res.ckpt._pending
        rec["in_flight"].append(pend is not None and not pend[2].done())
        r.sync()
        reset_launches()
        t1 = time.perf_counter()
        try:
            rec["losses"][str(i)] = float(step(*batch))
        except SystemExit as e:
            rec["losses"][str(i)] = float(res.last_loss)
            rec["exit"] = {"code": e.code, "step": res.preempted_at}
            rec["launches"].append(_launch_counts())
            break
        rec["ms"].append((time.perf_counter() - t1) * 1e3)
        rec["launches"].append(_launch_counts())
    res.ckpt.drain()
    rec["records"] = [x for x in res.ckpt.records
                      if x.get("event") in ("save", "commit", "restore")]
    rec["steps_on_disk"] = res.ckpt.steps()
    return rec, step, model, res


def _leaves_check(r, res, tag):
    """Every logical leaf of the restored state against the checkpoint
    it came from, bit for bit: each rank sends rank 0 the pieces a save
    would write (`state_leaves`' places), and rank 0 assembles the live
    leaf from them and the saved one from its files
    (`assemble_leaf`)."""
    import torch.distributed as dist
    from ..distributed.checkpoint import assemble_leaf, state_leaves
    from ..resilience.ckpt import load_manifest
    src = res.ckpt.step_dir(res.resumed_from)
    saved = load_manifest(src)["leaves"]
    places = sorted(state_leaves(res.ckpt.model, res.ckpt.optimizer),
                    key=lambda pl: pl.name)
    bad = []
    for pl in places:
        flat = pl.save_flat
        mine = None
        if pl.writes and (flat is None or flat[0] < flat[1]):
            v = pl.get()
            mine = (pl.piece_meta(r.rank), r.torch.as_tensor(
                np.array(v) if pl.scalar else v.detach().cpu()))
        every = [None] * r.rec["world"] if r.rank == 0 else None
        dist.gather_object(mine, every, dst=0)
        if r.rank != 0:
            continue
        got = [x for x in every if x is not None]
        metas = [dict(m, file=str(k)) for k, (m, _) in enumerate(got)]
        live = assemble_leaf(None, {"shape": list(pl.shape),
                                    "pieces": metas},
                             load=lambda pc: got[int(pc["file"])][1])
        meta = saved.get(pl.name)
        if meta is None or meta["dtype"] != pl.meta()["dtype"] or \
                not r.torch.equal(live.reshape(pl.shape),
                                  assemble_leaf(src, meta)):
            bad.append(pl.name)
    if r.rank == 0:
        r.rec[f"{tag}/leaves"] = {"n": len(saved), "checked": len(places),
                                  "differ": bad[:8], "n_differ": len(bad)}


def _ckpt_legs(r, cfg, batch_fn, root, plan, weights=None, real_exit=False):
    """The baseline run and the run preempted on one rank (both dp 4
    ZeRO-3); with `real_exit` the preempted run leaves the process with
    the exit code, else the resume follows in this process."""
    r.mesh(dp=4)
    base, _, model, _ = _ckpt_run(
        r, cfg, 3, os.path.join(root, "base"), batch_fn, plan["steps"],
        plan["save_every"], weights=weights, seed=r.seed,
        sink=os.path.join(r.out, f"base_{r.rank}.jsonl"))
    base["digest"] = _param_digest(model)
    r.rec["ckpt_base"] = base
    del model
    pre, _, _, res = _ckpt_run(
        r, cfg, 3, os.path.join(root, "drill"), batch_fn, plan["steps"],
        plan["save_every"], weights=weights, seed=r.seed,
        preempt_at=plan["preempt_at"],
        sink=os.path.join(r.out, f"drill_{r.rank}.jsonl"))
    r.rec["ckpt_preempt"] = pre
    if real_exit and pre["exit"] is not None:
        raise SystemExit(pre["exit"]["code"])


def _ckpt_resume(r, cfg, batch_fn, root, plan):
    """Relaunch at the same layout: the stitched losses and the final
    parameters must be the baseline's."""
    r.mesh(dp=4)
    rec, _, model, _ = _ckpt_run(
        r, cfg, 3, os.path.join(root, "drill"), batch_fn, plan["steps"],
        plan["save_every"], seed=r.seed + 7,
        sink=os.path.join(r.out, f"drill_{r.rank}.jsonl"))
    rec["digest"] = _param_digest(model)
    r.rec["ckpt_resume"] = rec


def _ckpt_reshard(r, cfg0, batch_fn, root, plan, mesh, zero, tag,
                  check=True):
    """Resume step plan["start"] of the plan["source"] run under a
    layout: with `check` every logical leaf bit for bit
    (`_leaves_check`), then plan["cont"] steps at dropout 0."""
    r.mesh(**mesh)
    rec, _, _, res = _ckpt_run(
        r, cfg0, zero, os.path.join(root, plan["source"]), batch_fn,
        plan["start"] + plan["cont"], 0, seed=r.seed + 11,
        resume_step=plan["start"],
        sink=os.path.join(r.out, f"{tag}_{r.rank}.jsonl"),
        after_resume=(lambda res: _leaves_check(r, res, tag)) if check
        else None)
    rec["elastic"] = [x for x in res.ckpt.records
                      if x.get("kind") == "elastic"]
    r.rec[tag] = rec


def _cpu_ckpt(r):
    from ..models.gpt import GPTConfig
    cfg = GPTConfig(**dict(TINY, dropout=CKPT_DROPOUT))
    weights = numpy_weights(cfg, r.seed)
    root = os.path.join(r.out, "ckpt")

    def batch_fn(i):
        return ckpt_batch(i, TINY_BATCH, TINY_SEQ, TINY["vocab_size"])

    _ckpt_legs(r, cfg, batch_fn, root, CKPT_CPU, weights=weights)
    _ckpt_resume(r, cfg, batch_fn, root, CKPT_CPU)
    cfg0 = GPTConfig(**TINY)
    _ckpt_reshard(r, cfg0, batch_fn, root, CKPT_CPU, {"dp": 4}, 3,
                  "ckpt_direct")
    _ckpt_reshard(r, cfg0, batch_fn, root, CKPT_CPU, {"dp": 2, "mp": 2}, 3,
                  "ckpt_reshard")


def _ckpt_card_config(dropout=CKPT_DROPOUT):
    from ..models.gpt import GPTConfig
    return GPTConfig.gpt3_1_3b(num_layers=CKPT_CARD_BLOCKS,
                               max_seq_len=CARD_SEQ, dropout=dropout)


def _card_batch_fn(cfg):
    def batch_fn(i):
        return ckpt_batch(i, 4, CARD_SEQ, cfg.vocab_size)
    return batch_fn


def _ckpt_root(r):
    return os.path.join(os.path.dirname(os.path.abspath(r.out)), "ckpt")


def _ckpt4(r):
    cfg = _ckpt_card_config()
    _ckpt_legs(r, cfg, _card_batch_fn(cfg), _ckpt_root(r), CKPT_CARD,
               real_exit=True)


def _ckpt4_resume(r):
    cfg = _ckpt_card_config()
    root = _ckpt_root(r)
    _ckpt_resume(r, cfg, _card_batch_fn(cfg), root, CKPT_CARD)
    _release(r)
    cfg0 = _ckpt_card_config(0.0)
    _ckpt_reshard(r, cfg0, _card_batch_fn(cfg0), root, CKPT_CARD,
                  {"dp": 4}, 3, "ckpt_direct", check=False)


def _ckpt_card_reshard(r):
    cfg0 = _ckpt_card_config(0.0)
    mesh, zero = ({"dp": 2}, 2) if r.rec["world"] == 2 \
        else ({"dp": 2, "mp": 2}, 3)
    _ckpt_reshard(r, cfg0, _card_batch_fn(cfg0), _ckpt_root(r), CKPT_CARD,
                  mesh, zero, "ckpt_reshard")

CASES = {"cpu": (_cpu_hybrid, _cpu_fused_ce, _cpu_ops, _cpu_mp_layers,
                 _cpu_collectives, _cpu_topology, _cpu_data_parallel,
                 _cpu_timeout),
         "cpu_ep": (_cpu_ep_values, _cpu_ep_train, _cpu_ep_exchange,
                    _cpu_ep_topology),
         "cpu_pp": (_cpu_pp_train, _cpu_pp_extras),
         "nccl1": (_nccl1,), "gloo_probe": (_gloo_probe,),
         "card4": (_card4,), "card8": (_card8,), "ep4": (_ep4,),
         "pp4": (_pp4,), "cpu_zero3": (_cpu_zero3, _cpu_ckpt),
         "zero3_4": (_zero3_card,), "zero3_8": (_zero3_depth,),
         "ckpt4": (_ckpt4,),
         "ckpt4_resume": (_ckpt4_resume,),
         "ckpt2_reshard": (_ckpt_card_reshard,),
         "ckpt4_reshard": (_ckpt_card_reshard,)}


def worker(job, out, seed):
    r = _Rank(job, out, seed)
    t0 = time.perf_counter()
    try:
        for case in CASES[job]:
            case(r)
            r.rec.setdefault("case_s", {})[case.__name__] = \
                time.perf_counter() - t0
    except SystemExit as e:
        # a graceful preemption exit (ckpt4): every rank saves its record,
        # meets the others, then leaves with the code
        r.rec["exit_code"] = e.code
        r.save()
        r.coll.barrier()
        sys.stdout.flush()
        os._exit(int(e.code))
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
        if job.startswith("cpu"):
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
        if not jobs[0].startswith("cpu"):
            raise ValueError(f"job {jobs[0]!r} runs on the card")
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("dist_drill runs on the CUDA card by default "
                               "and none is available; pass --device cpu "
                               "to run on the CPU")
        jobs = [args.job] if args.job else ["nccl1", "card4", "card8", "ep4",
                                            "pp4"]
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
