#!/usr/bin/env python3
"""Time this checkout's flash_fwd and paged_decode kernels against another
checkout's, in turns, on one CUDA card.

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
  0..511 from --seed, 12 heads of 64, block 16, bf16).

Each kernel's output is held against the plain version of this
checkout, then both are timed base, change, change, base (median of
--reps launches by CUDA events, the L2 flushed before each; paged_decode
also with the L2 warm) beside scaled_dot_product_attention on the same
inputs. Prints the card's name and power limit, one JSON line per
kernel and shape, and the same timing of one trivial launch (a
one-element fill), the floor under every number above. Exits non-zero
without CUDA.
"""
import argparse
import importlib
import importlib.util
import json
import math
import os
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


def turns(torch, cs, base, change, flush, reps):
    """Base, change, change, base: ([base ms], [change ms])."""
    b0 = cs.median_ms(torch, base, flush, reps=reps)
    c0 = cs.median_ms(torch, change, flush, reps=reps)
    c1 = cs.median_ms(torch, change, flush, reps=reps)
    b1 = cs.median_ms(torch, base, flush, reps=reps)
    return [b0, b1], [c0, c1]


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
    new = {m: importlib.import_module(f"paddle_tpu_torch.ops.{m}")
           for m in ("flash_attention", "paged_attention", "_build")}
    load_package(os.path.abspath(args.base), "base_paddle_tpu_torch")
    old = {m: importlib.import_module(f"base_paddle_tpu_torch.ops.{m}")
           for m in ("flash_attention", "paged_attention", "_build")}
    for mods in (old, new):
        mods["_build"].build(["flash_attention_fwd", "paged_decode"])
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
    one = torch.empty(1, device=dev)
    print(json.dumps({"launch_floor_ms": cs.median_ms(
        torch, lambda: one.fill_(1.0), flush, reps=args.reps),
        "warm_launch_floor_ms": cs.median_ms(
            torch, lambda: one.fill_(1.0), None, reps=args.reps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
