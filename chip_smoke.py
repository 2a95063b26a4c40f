#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--init-range 0.055] [--dtype bfloat16]

Phases, each fatal on failure (a traceback and a non-zero exit, never the
ok line):

1. build   — compile every CUDA kernel of the serving path from
             paddle_tpu_torch/csrc with nvcc, all sources at once, into
             build/paddle_tpu_torch/, and print the build time;
2. kernels — hold each kernel against its plain PyTorch version on the
             card at the serving shapes of GPT-3 125M (12 heads of 64,
             block 16, 32 blocks per sequence, 16 slots, chunk 128), in
             f32 (TF32 off) and bf16, with random block tables, context
             lengths 0..511 including 0 and block edges, and chunk starts
             p0 in {0, 7, 128, 384}; then time kernel, plain version and
             one PyTorch library call (scaled_dot_product_attention over
             the gathered pages, a yardstick the port never calls) with
             CUDA events, the L2 flushed before each launch;
3. serve   — GPT-3 125M at full width, random weights from --seed (std
             --init-range), in bf16 (--dtype float32 serves in f32, which
             isolates what bf16 rounding changes), through
             ServingEngine(max_slots=16, block_size=16,
             prefill_chunk=128, max_model_len=512): 32 greedy requests of
             16..384 prompt tokens, half sharing a 96-token template, 32
             new tokens each. Every stream must complete; the launch
             counters, zeroed just before, must equal layers x decode steps
             (paged_decode) and layers x prefill chunks
             (flash_prefill_chunk); every stream is teacher-forced
             through the port's dense f32 forward on the card;
4. profile — device time by kernel over 10 full-batch decode steps
             (torch.profiler, CUDA activity only).

Prints the card's name and power limit (nvidia-smi), a JSON line with
every kernel's launches, error and times, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when CUDA is unavailable or when run
outside a checkout of the repository.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor-core bf16
                  "float32": 67e12}     # f32 outside the tensor cores

# serving shapes of GPT-3 125M in the engine configuration below
N_HEADS, HEAD_DIM, BLOCK, MAX_BLOCKS, SLOTS, CHUNK = 12, 64, 16, 32, 16, 128
CTX_EDGES = (0, 15, 16, 17, 31, 32, 255, 256, 511)
P0S = (0, 7, 128, 384)
TIMED_P0 = 128
ENGINE = dict(max_slots=SLOTS, block_size=BLOCK, prefill_chunk=CHUNK,
              max_model_len=BLOCK * MAX_BLOCKS)
# Random weights: GPT's initializer at this std. At width 768 the
# attention logits' spread grows with the square of the std: at the
# default 0.02 attention is near uniform and greedy streams repeat one
# token; from ~0.07 it is so sharp that bf16 rounding flips which keys
# win and the bf16 and f32 streams part ways. 0.055 lies between:
# streams vary and bf16 tracks f32.
INIT_RANGE = 0.055
# bf16 engine vs f32 dense forward over the same tokens, every stream:
# the engine's token must be the f32 argmax at >= 95% of positions, and
# never trail the f32 best logit by more than this many standard
# deviations of that position's logits. bf16 keeps 8 significant bits;
# where it flips a greedy choice the two logits were near-tied, while a
# wrong attention or cache moves logits by whole standard deviations.
TF_AGREE = 0.95
TF_MARGIN_STD = 0.25
# the streams must not be one token repeated, or token agreement says
# little: at most a quarter constant, >= 4 distinct tokens on average
MAX_CONSTANT_FRAC = 0.25
MIN_MEAN_DISTINCT = 4.0


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_inputs(torch, gen, dtype, dev):
    """16 slots over a 513-block arena: the context edges, an inactive
    slot (ctx 0, all-null table), the rest uniform in 0..511."""
    L = BLOCK * MAX_BLOCKS
    ctx = list(CTX_EDGES) + [0]
    ctx += torch.randint(0, L, (SLOTS - len(ctx),), generator=gen,
                         device="cpu").tolist()
    nb = SLOTS * MAX_BLOCKS + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cpu") + 1
    tables = torch.zeros((SLOTS, MAX_BLOCKS), dtype=torch.int32)
    for s, c in enumerate(ctx):
        if s == len(CTX_EDGES):
            continue                            # the inactive slot
        n = c // BLOCK + 1
        tables[s, :n] = perm[s * MAX_BLOCKS:s * MAX_BLOCKS + n]
    nh = N_HEADS * HEAD_DIM
    q = torch.randn((SLOTS, 1, nh), generator=gen, device="cpu")
    kp = torch.randn((nb, BLOCK, nh), generator=gen, device="cpu")
    vp = torch.randn((nb, BLOCK, nh), generator=gen, device="cpu")
    to = dict(device=dev, dtype=dtype)
    return (q.to(**to), kp.to(**to), vp.to(**to), tables.to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def prefill_inputs(torch, gen, dtype, dev, p0):
    nb = MAX_BLOCKS + 8
    nh = N_HEADS * HEAD_DIM
    n = (p0 + CHUNK - 1) // BLOCK + 1
    row = torch.zeros((MAX_BLOCKS,), dtype=torch.int32)
    row[:n] = (torch.randperm(nb - 1, generator=gen) + 1)[:n]
    q = torch.randn((1, CHUNK, nh), generator=gen)
    kp = torch.randn((nb, BLOCK, nh), generator=gen)
    vp = torch.randn((nb, BLOCK, nh), generator=gen)
    to = dict(device=dev, dtype=dtype)
    return q.to(**to), kp.to(**to), vp.to(**to), row.to(dev), p0


def hold(name, got, ref, tol):
    """Elementwise |got - ref| <= atol + rtol |ref|; returns max error."""
    rtol, atol = tol
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if not bool(got.isfinite().all()) or bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {err.max().item():.3e}, {int(bad.sum())} "
            f"elements outside rtol={rtol} atol={atol})")
    return err.max().item()


def median_ms(torch, fn, flush, reps=60, warmup=5):
    """Median of per-launch CUDA-event times; the L2 is overwritten
    before every launch so each reads its inputs from device memory."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_work(ctx, itemsize):
    """Bytes and operations paged_decode needs for these inputs: q, the
    ctx+1 K and V rows of every head, the table and ctx, the output."""
    L = BLOCK * MAX_BLOCKS
    nh = N_HEADS * HEAD_DIM
    keys = sum(min(int(c), L - 1) + 1 for c in ctx)
    nbytes = (2 * keys * nh + 2 * SLOTS * nh) * itemsize \
        + (SLOTS * MAX_BLOCKS + SLOTS) * 4
    return nbytes, 4 * keys * nh


def prefill_work(p0, itemsize):
    L = BLOCK * MAX_BLOCKS
    nh = N_HEADS * HEAD_DIM
    span = min(p0 + CHUNK - 1, L - 1) + 1
    pairs = sum(min(p0 + i, L - 1) + 1 for i in range(CHUNK))
    nbytes = (2 * span * nh + 2 * CHUNK * nh) * itemsize + MAX_BLOCKS * 4
    return nbytes, 4 * pairs * nh


def sdpa_decode(torch, q, kp, vp, tables, ctx):
    """Yardstick inputs: the pages gathered dense, a boolean mask."""
    L = BLOCK * MAX_BLOCKS
    S = q.shape[0]
    k = kp[tables.long()].reshape(S, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    v = vp[tables.long()].reshape(S, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    qq = q.reshape(S, 1, N_HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    mask = (torch.arange(L, device=q.device)[None, :]
            <= ctx.long()[:, None])[:, None, None, :]
    return qq, k.contiguous(), v.contiguous(), mask


def sdpa_prefill(torch, q, kp, vp, row, p0):
    L = BLOCK * MAX_BLOCKS
    k = kp[row.long()].reshape(1, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    v = vp[row.long()].reshape(1, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    qq = q.reshape(1, CHUNK, N_HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    pos = p0 + torch.arange(CHUNK, device=q.device)
    mask = (torch.arange(L, device=q.device)[None, :]
            <= pos[:, None])[None, None]
    return qq, k.contiguous(), v.contiguous(), mask


def kernels_phase(torch, seed):
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    from paddle_tpu_torch.ops.paged_attention import (
        flash_prefill_chunk, flash_prefill_plain, paged_decode_attention,
        paged_decode_plain)
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    dec, pre = get_kernel("paged_decode"), get_kernel("flash_prefill_chunk")
    errs = {}
    for dtype, dname in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
        args = decode_inputs(torch, gen, dtype, dev)
        got = paged_decode_attention(*args, N_HEADS)
        ref = paged_decode_plain(*args, N_HEADS)
        torch.cuda.synchronize()
        errs[("paged_decode", dname)] = hold(
            f"paged_decode[{dname}]", got, ref, dec.tol[dname])
        for p0 in P0S:
            pargs = prefill_inputs(torch, gen, dtype, dev, p0)
            got = flash_prefill_chunk(*pargs, N_HEADS)
            ref = flash_prefill_plain(*pargs, N_HEADS)
            torch.cuda.synchronize()
            e = hold(f"flash_prefill_chunk[{dname}, p0={p0}]", got, ref,
                     pre.tol[dname])
            key = ("flash_prefill_chunk", dname)
            errs[key] = max(errs.get(key, 0.0), e)
    for (name, dname), e in sorted(errs.items()):
        print(f"kernels: {name} {dname} max_abs_err {e:.3e} "
              f"(tol rtol, atol = {get_kernel(name).tol[dname]})")

    # timing at the serving shapes, in the engine's bf16
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    args = decode_inputs(torch, gen, torch.bfloat16, dev)
    sd = sdpa_decode(torch, *args)
    nbytes, ops = decode_work(args[4].tolist(), 2)
    rows["paged_decode"] = dict(
        ms=median_ms(torch, lambda: paged_decode_attention(*args, N_HEADS),
                     flush),
        plain_ms=median_ms(torch, lambda: paged_decode_plain(*args, N_HEADS),
                           flush),
        library_ms=median_ms(
            torch, lambda: F.scaled_dot_product_attention(
                sd[0], sd[1], sd[2], attn_mask=sd[3]), flush),
        bound=bound(nbytes, ops, "bfloat16"),
        max_abs_err=errs[("paged_decode", "bfloat16")])
    print(f"kernels: paged_decode timed at S={SLOTS}, mean ctx "
          f"{sum(args[4].tolist()) / SLOTS:.1f}: {nbytes} bytes, {ops} ops")
    for p0 in P0S:
        pargs = prefill_inputs(torch, gen, torch.bfloat16, dev, p0)
        sp = sdpa_prefill(torch, *pargs)
        nbytes, ops = prefill_work(p0, 2)
        row = dict(
            ms=median_ms(torch, lambda: flash_prefill_chunk(*pargs, N_HEADS),
                         flush),
            plain_ms=median_ms(
                torch, lambda: flash_prefill_plain(*pargs, N_HEADS), flush),
            library_ms=median_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    sp[0], sp[1], sp[2], attn_mask=sp[3]), flush),
            bound=bound(nbytes, ops, "bfloat16"),
            max_abs_err=errs[("flash_prefill_chunk", "bfloat16")])
        print(f"kernels: flash_prefill_chunk p0={p0} C={CHUNK}: "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, sdpa "
              f"{row['library_ms']:.4f}, bound {row['bound'][0]:.5f} by "
              f"{row['bound'][1]}; {nbytes} bytes, {ops} ops)")
        if p0 == TIMED_P0:
            rows["flash_prefill_chunk"] = row
    r = rows["paged_decode"]
    print(f"kernels: paged_decode: {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}, bound "
          f"{r['bound'][0]:.5f} by {r['bound'][1]})")
    del flush
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve GPT-3 125M
# ---------------------------------------------------------------------------

def make_requests(seed, vocab, n=32, template_len=96):
    import numpy as np
    rng = np.random.default_rng(seed)
    template = rng.integers(0, vocab, template_len).tolist()
    lengths = rng.integers(16, 385, n)
    prompts = []
    for i, length in enumerate(lengths):
        if i % 2 == 0:
            tail = rng.integers(0, vocab, max(int(length), template_len + 1)
                                - template_len).tolist()
            prompts.append(template + tail)
        else:
            prompts.append(rng.integers(0, vocab, int(length)).tolist())
    return prompts


def teacher_forced(torch, model, prompt, out):
    """The dense f32 forward over prompt + output; per generated token,
    whether it is the f32 argmax and how far its logit trails the best,
    in units of that position's logit standard deviation."""
    ids = torch.tensor([prompt + out], device=model.gpt.wte.weight.device)
    with torch.inference_mode():
        logits = model(ids)[0, len(prompt) - 1:len(prompt) + len(out) - 1]
    tok = torch.tensor(out, device=logits.device)
    best = logits.max(dim=-1).values
    mine = logits.gather(1, tok[:, None])[:, 0]
    trail = (best - mine) / logits.std(dim=-1)
    agree = (logits.argmax(dim=-1) == tok).float()
    return agree.tolist(), trail.tolist()


def serve_phase(torch, seed, init_range, dtype):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    model = GPTForPretraining(cfg, seed=seed)          # on the card
    eng = ServingEngine(model, **{**ENGINE, "dtype": dtype})
    # warm-up: cuBLAS handles, allocator pools, first launches
    for p in make_requests(seed + 1, cfg.vocab_size, n=2):
        eng.submit(p[:40], SamplingParams(max_new_tokens=4))
    eng.run_until_idle()
    torch.cuda.synchronize()

    prompts = make_requests(seed, cfg.vocab_size)
    step_ms = []
    decode_once = eng._decode_once

    def timed_decode():
        t = time.perf_counter()
        did = decode_once()
        if did:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return did

    eng._decode_once = timed_decode
    d0, c0 = eng.decode_steps, eng.prefill_chunks
    reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p, SamplingParams(max_new_tokens=32))
               for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels()}
    steps, chunks = eng.decode_steps - d0, eng.prefill_chunks - c0

    outs = [h.output_tokens for h in handles]
    if not all(h.finished and len(o) == 32 for h, o in zip(handles, outs)):
        raise AssertionError("serve: a stream did not complete")
    eng.pool.assert_quiesced()
    L = cfg.num_layers
    want = {"paged_decode": L * steps, "flash_prefill_chunk": L * chunks}
    if launches != want:
        raise AssertionError(f"serve: launches {launches} != layers x "
                             f"steps/chunks {want}")
    ps = eng.prefix_stats()
    if ps["hits"] == 0:
        raise AssertionError("serve: the shared template never hit the "
                             "prefix cache")
    distinct = [len(set(o)) for o in outs]
    agree, trail = [], []
    for prompt, out in zip(prompts, outs):
        a, t = teacher_forced(torch, model, prompt, out)
        agree += a
        trail += t
    rate = sum(agree) / len(agree)
    stats = dict(tokens_per_s=32 * len(prompts) / wall, wall_s=wall,
                 decode_steps=steps, prefill_chunks=chunks,
                 step_p50_ms=statistics.median(step_ms),
                 step_p99_ms=sorted(step_ms)[
                     min(len(step_ms) - 1, math.ceil(0.99 * len(step_ms)) - 1)],
                 prefix_hits=ps["hits"], tokens_saved=ps["tokens_saved"],
                 distinct_mean=sum(distinct) / len(distinct),
                 constant_streams=sum(1 for d in distinct if d == 1),
                 tf_agree=rate, tf_max_trail_std=max(trail),
                 launches=launches)
    print(f"serve[{dtype}, init {init_range}]: " + json.dumps(stats))
    if stats["constant_streams"] > MAX_CONSTANT_FRAC * len(outs) or \
            sum(distinct) / len(distinct) < MIN_MEAN_DISTINCT:
        raise AssertionError(f"serve: the streams barely vary (distinct "
                             f"tokens per stream {distinct})")
    if rate < TF_AGREE or max(trail) > TF_MARGIN_STD:
        raise AssertionError(
            f"serve: teacher-forced check failed: agreement {rate:.3f} "
            f"(need {TF_AGREE}), worst trail {max(trail):.3f} std "
            f"(limit {TF_MARGIN_STD})")
    return stats, eng, cfg.vocab_size


def profile_phase(torch, eng, vocab, seed, steps=10):
    """Device time by kernel over `steps` decode steps of a full batch,
    from torch.profiler with CUDA activity only (the profiler's own host
    cost lengthens the steps, so the busy share it gives is a floor)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import SamplingParams
    for p in make_requests(seed + 2, vocab, n=SLOTS):
        eng.submit(p[:200], SamplingParams(max_new_tokens=64))
    while eng.sched.prefilling or eng.sched.waiting:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    eng.run_until_idle()
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not dev:
        print("profile: the profiler recorded no device time (not "
              "measured)")
        return
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    print(f"profile: {steps} decode steps of {SLOTS} slots: wall "
          f"{wall_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step "
          f"(share {busy_ms / wall_ms:.3f})")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3 / steps:8.4f} "
              f"ms/step {e.count / steps:6.1f} launches/step  {e.key[:80]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-range", type=float, default=INIT_RANGE,
                    help="std of the random weights (GPT initializer)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the engine's compute dtype in the serve phase")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.kernel_registry import kernels

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    regs = kernels()
    t0 = time.perf_counter()
    _build.build([os.path.basename(k.source)[:-3] for k in regs])
    print(f"build: {len(regs)} kernels in {time.perf_counter() - t0:.1f} s")

    rows = kernels_phase(torch, args.seed)
    stats, eng, vocab = serve_phase(torch, args.seed, args.init_range,
                                    args.dtype)
    profile_phase(torch, eng, vocab, args.seed)

    out = []
    for k in regs:
        r = rows[k.name]
        out.append({"name": k.name, "route": "cuda", "source": k.source,
                    "replaces": k.replaces,
                    "launches": stats["launches"][k.name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
