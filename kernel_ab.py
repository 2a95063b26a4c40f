#!/usr/bin/env python3
"""Time this checkout's flash_fwd, paged_decode, decode_fused and
int8_matvec kernels against another checkout's, in turns, on one CUDA
card.

    python3 kernel_ab.py --base DIR [--seed 0] [--reps 60]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked from `git archive` into a directory that
.gitignore lists. Both trees' paddle_tpu_torch packages are imported
side by side (the other one under the name base_paddle_tpu_torch); each
builds its kernels into its own build/ directory. Both are called on the
same inputs:

- flash_fwd at the training shape of GPT-3 125M (batch 24, seq 1024, 12
  heads of 64, causal, bf16) and at the K2 shapes (non-causal; causal
  with sq 512 < sk 1024);
- paged_decode at a serving decode step (16 slots, ctx uniform in
  0..511 from --seed, 12 heads of 64, block 16, bf16);
- decode_fused at generate's mean step (batch 8, off 191 of a 256-key
  cache, 12 heads of 64, bf16 q) over an f32 and a bf16 cache;
- int8_matvec on GPT-3 125M's int8 head (V 51200, D 768) at 8, 16 and
  64 bf16 rows.

Each kernel's output is held against the plain version of this
checkout, then both are timed base, change, change, base (median of
--reps launches by CUDA events, the L2 flushed before each by writing
256 MB; paged_decode also with the L2 warm; decode_fused and
int8_matvec also flushed by reading 256 MB, which leaves the L2 clean,
where the write flush leaves it dirty and a kernel's reads then pay for
as many bytes written back) beside one PyTorch call on the same inputs:
scaled_dot_product_attention, and for int8_matvec the dequantized bf16
matmul and a product over an unquantized bf16 table. Prints the card's
name and power limit, one JSON line per kernel and shape, and the same
timings of one trivial launch (a one-element fill), the floor under
every number above. Exits non-zero without CUDA.
"""
import argparse
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_package(root, name):
    """The paddle_tpu_torch package under `root`, imported as `name`."""
    pkg = os.path.join(root, "paddle_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def turns(torch, cs, base, change, flush, reps, timer=None):
    """Base, change, change, base: ([base ms], [change ms])."""
    timer = timer or (lambda fn: cs.median_ms(torch, fn, flush, reps=reps))
    b0 = timer(base)
    c0 = timer(change)
    c1 = timer(change)
    b1 = timer(base)
    return [b0, b1], [c0, c1]


def clean_ms(torch, fn, src, reps=60, warmup=5):
    """Median of per-launch CUDA-event times with the L2 overwritten by
    reading `src` (256 MB) before every launch: its lines stay clean, so
    the timed kernel's reads pay for no write-back."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        src.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=60)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    mods_used = ("flash_attention", "paged_attention", "decode_attention",
                 "int8_matvec", "_build")
    new = {m: importlib.import_module(f"paddle_tpu_torch.ops.{m}")
           for m in mods_used}
    load_package(os.path.abspath(args.base), "base_paddle_tpu_torch")
    old = {m: importlib.import_module(f"base_paddle_tpu_torch.ops.{m}")
           for m in mods_used}
    for mods in (old, new):
        mods["_build"].build(["flash_attention_fwd", "paged_decode",
                              "decode_attention", "int8_matvec"])
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    n, h = cs.N_HEADS, cs.HEAD_DIM
    scale = 1.0 / math.sqrt(h)
    shapes = ((cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_SEQ, True),) \
        + cs.FLASH_K2_TIMED
    for b, sq, sk, causal in shapes:
        q, k, v, _ = cs.flash_inputs(torch, gen, torch.bfloat16, dev, b, sq,
                                     sk, n, h)
        ref = new["flash_attention"].flash_attention_fwd_plain(
            q, k, v, causal, scale)
        errs = {}
        for tag, mods in (("base", old), ("change", new)):
            out, lse = mods["flash_attention"].flash_fwd(q, k, v, causal,
                                                         scale)
            torch.cuda.synchronize()
            errs[tag] = max(cs.hold(f"flash_fwd {tag}", out, ref[0],
                                    (2e-2, 2e-2)),
                            cs.hold(f"flash_fwd lse {tag}", lse, ref[1],
                                    (2e-2, 2e-2)))
        del ref
        lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if causal:
            mask = torch.ones((sq, sk), dtype=torch.bool,
                              device=dev).tril(sk - sq)
        base_ms, change_ms = turns(
            torch, cs,
            lambda: old["flash_attention"].flash_fwd(q, k, v, causal, scale),
            lambda: new["flash_attention"].flash_fwd(q, k, v, causal, scale),
            flush, args.reps)
        if causal and sq == sk:
            sdpa = cs.median_ms(torch, lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True), flush, reps=args.reps)
        else:
            sdpa = cs.median_ms(torch, lambda: F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask), flush, reps=args.reps)
        print(json.dumps({
            "kernel": "flash_fwd", "b": b, "sq": sq, "sk": sk,
            "causal": causal, "base_ms": base_ms, "change_ms": change_ms,
            "sdpa_ms": sdpa,
            "bound_ms": cs.bound(*cs.flash_work(b, sq, sk, n, h, causal, 2,
                                                False), "bfloat16")[0],
            "max_abs_err": errs}))
        del q, k, v, lq, lk, lv

    dargs = cs.decode_inputs(torch, torch.Generator().manual_seed(
        args.seed + 3), torch.bfloat16, dev, edges=False)
    ref = new["paged_attention"].paged_decode_plain(*dargs, n)
    errs = {}
    for tag, mods in (("base", old), ("change", new)):
        got = mods["paged_attention"].paged_decode_attention(*dargs, n)
        torch.cuda.synchronize()
        errs[tag] = cs.hold(f"paged_decode {tag}", got, ref, (2e-2, 2e-2))
    sd = cs.sdpa_decode(torch, *dargs)
    row = {"kernel": "paged_decode", "ctx": dargs[4].tolist(),
           "max_abs_err": errs}
    for label, fl in (("", flush), ("warm_", None)):
        row[f"{label}base_ms"], row[f"{label}change_ms"] = turns(
            torch, cs,
            lambda: old["paged_attention"].paged_decode_attention(*dargs, n),
            lambda: new["paged_attention"].paged_decode_attention(*dargs, n),
            fl, args.reps)
        row[f"{label}sdpa_ms"] = cs.median_ms(
            torch, lambda: F.scaled_dot_product_attention(
                sd[0], sd[1], sd[2], attn_mask=sd[3]), fl, reps=args.reps)
    row["bound_ms"] = cs.bound(*cs.decode_work(dargs[4].tolist(), 2),
                               "bfloat16")[0]
    print(json.dumps(row))
    src = torch.zeros(64 * 2 ** 20, device=dev)     # 256 MB read flush

    def clean(fn):
        return clean_ms(torch, fn, src, reps=args.reps)

    # decode_fused at generate's mean step, bf16 q over an f32 and a bf16
    # cache
    gen = torch.Generator().manual_seed(args.seed + 11)
    B, off, L = cs.DEC_BATCH, cs.DEC_TIMED_OFF, cs.DEC_LEN
    q = torch.randn((B, 1, n * h), generator=gen).to(dev, torch.bfloat16)
    k32, v32 = (torch.randn((B, L, n * h), generator=gen).to(dev)
                for _ in range(2))
    sq = q.float().reshape(B, 1, n, h).transpose(1, 2)
    for k, v in ((k32, v32), (k32.to(torch.bfloat16),
                              v32.to(torch.bfloat16))):
        ref = new["decode_attention"].decode_attention_plain(q, k, v, off, n)
        errs = {}
        for tag, mods in (("base", old), ("change", new)):
            got = mods["decode_attention"].decode_attention(q, k, v, off, n)
            torch.cuda.synchronize()
            errs[tag] = cs.hold(f"decode_fused {tag}", got, ref,
                                (1e-3, 1e-3))

        def base():
            return old["decode_attention"].decode_attention(q, k, v, off, n)

        def change():
            return new["decode_attention"].decode_attention(q, k, v, off, n)
        sk, sv = (t[:, :off + 1].float().reshape(B, off + 1, n, h)
                  .transpose(1, 2) for t in (k, v))
        row = {"kernel": "decode_fused", "b": B, "off": off,
               "cache": str(k.dtype).split(".")[1], "max_abs_err": errs}
        row["base_ms"], row["change_ms"] = turns(torch, cs, base, change,
                                                 flush, args.reps)
        row["clean_base_ms"], row["clean_change_ms"] = turns(
            torch, cs, base, change, None, args.reps, timer=clean)
        row["sdpa_ms"] = cs.median_ms(
            torch, lambda: F.scaled_dot_product_attention(sq, sk, sv),
            flush, reps=args.reps)
        nbytes = 2 * B * (off + 1) * n * h * k.element_size() \
            + B * n * h * (2 + 4)
        row["bound_ms"] = cs.bound(nbytes, 4 * B * n * (off + 1) * h,
                                   "float32")[0]
        print(json.dumps(row))

    # int8_matvec over GPT-3 125M's int8 head, bf16 h
    wq = torch.randint(-127, 128, (cs.I8_V, cs.I8_D), generator=gen,
                       dtype=torch.int8).to(dev)
    sc = ((0.01 + torch.rand((cs.I8_V,), generator=gen)) * 0.01).to(dev)
    wb = torch.randn((cs.I8_V, cs.I8_D), generator=gen).to(
        dev, torch.bfloat16)
    for rows in (8, 16, 64):
        hh = torch.randn((rows, cs.I8_D), generator=gen).to(
            dev, torch.bfloat16)
        ref = new["int8_matvec"].int8_matvec_plain(hh, wq, sc)
        errs = {}
        for tag, mods in (("base", old), ("change", new)):
            got = mods["int8_matvec"].int8_matvec(hh, wq, sc)
            torch.cuda.synchronize()
            errs[tag] = cs.hold(f"int8_matvec {tag}", got, ref, (1e-4, 1e-4))

        def base():
            return old["int8_matvec"].int8_matvec(hh, wq, sc)

        def change():
            return new["int8_matvec"].int8_matvec(hh, wq, sc)

        def dequant():
            return torch.matmul(hh, wq.to(torch.bfloat16).t()) * sc

        def bf16_table():
            return torch.matmul(hh, wb.t())
        row = {"kernel": "int8_matvec", "rows": rows, "max_abs_err": errs}
        row["base_ms"], row["change_ms"] = turns(torch, cs, base, change,
                                                 flush, args.reps)
        row["clean_base_ms"], row["clean_change_ms"] = turns(
            torch, cs, base, change, None, args.reps, timer=clean)
        for name, fn in (("dequant_bf16_matmul", dequant),
                         ("bf16_table", bf16_table)):
            row[f"{name}_ms"] = cs.median_ms(torch, fn, flush,
                                             reps=args.reps)
            row[f"clean_{name}_ms"] = clean(fn)
        nbytes = cs.I8_V * cs.I8_D + rows * cs.I8_D * 2 + cs.I8_V * 4 \
            + rows * cs.I8_V * 4
        row["bound_ms"] = cs.bound(nbytes, 2 * rows * cs.I8_V * cs.I8_D,
                                   "bfloat16")[0]
        print(json.dumps(row))

    one = torch.empty(1, device=dev)
    print(json.dumps({"launch_floor_ms": cs.median_ms(
        torch, lambda: one.fill_(1.0), flush, reps=args.reps),
        "warm_launch_floor_ms": cs.median_ms(
            torch, lambda: one.fill_(1.0), None, reps=args.reps),
        "clean_launch_floor_ms": clean(lambda: one.fill_(1.0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
