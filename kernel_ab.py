#!/usr/bin/env python3
"""Time this checkout's kernels against another checkout's, in turns,
on one CUDA card: flash_fwd, paged_decode, decode_fused, int8_matvec,
layernorm_fused, layernorm_fwd_saved and moe_gather.

    python3 kernel_ab.py --base DIR [--seed 0] [--reps 60]
                         [--kernels flash_fwd,...,moe_gather]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked from `git archive` into a directory that
.gitignore lists. Both trees' paddle_tpu_torch packages are imported
side by side (the other one under the name base_paddle_tpu_torch); each
builds its kernels into its own build/ directory. --kernels picks the
cases (all by default). Both are called on the same inputs:

- flash_fwd at the training shape of GPT-3 125M (batch 24, seq 1024, 12
  heads of 64, causal, bf16) and at the K2 shapes (non-causal; causal
  with sq 512 < sk 1024);
- paged_decode at a serving decode step (16 slots, ctx uniform in
  0..511 from --seed, 12 heads of 64, block 16, bf16);
- decode_fused at generate's mean step (batch 8, off 191 of a 256-key
  cache, 12 heads of 64, bf16 q) over an f32 and a bf16 cache;
- int8_matvec on GPT-3 125M's int8 head (V 51200, D 768) at 8, 16 and
  64 bf16 rows;
- layernorm_fused at the residual site (`nn.fused_add_layer_norm`
  without a gradient, bf16, d 768) at 8, 16 and 128 rows: the other
  tree's kernel alone, the other tree's site and this tree's (whatever
  each launches for the pair (LayerNorm(x + r), x + r)), this tree's
  site at 1, 2, 4 and 8 rows a CTA, and F.layer_norm(x + r); then at 16
  rows in the decode step's sequence, out_proj GEMM ([16, 768] x [768,
  768]) -> the site -> fc1 GEMM ([16, 768] x [768, 3072]), both trees,
  and this tree with its programmatic dependent launch on and off; then
  the host microseconds a call of each site, each kernel wrapper, a
  torch add and one trivial launch (calls back to back, the card
  keeping up);
- layernorm_fwd_saved (K6) at the shapes its main paths give it
  (chip_smoke.LN_SAVED_PATHS: GPT-3 1.3B's 16384 and 32768 rows of 2048
  in bf16, 16384 rows with an f32 stream and a bf16 branch, GPT-3
  125M's 24576 rows of 768 the same): both trees' outputs bit for bit
  equal, this tree's carry bit for bit the sum in x's dtype; the kernel
  without the carry in both trees, and the residual site with a
  gradient's forward (FusedAddLayerNormPair: the other tree's K6 plus
  its cast where x is bf16, this tree's one launch with the carry),
  beside a device-to-device copy that moves as many bytes as the site;
- moe_gather (K12) on the router's maps at the MoE training shape
  (chip_smoke.moe_maps: 8192 tokens, E 8, k 2, C 2560, rows of 768) at
  both of its sites, the dispatch (tokens by the slot map) and the
  gather in the combine's backward (expert outputs by the flat choice
  map), in f32, and the dispatch in bf16: both trees bit for bit this
  tree's plain version, timed beside F.embedding over the zero-padded
  source and a device copy of the bytes the kernel must move (each
  distinct valid row read once, every output row written, the map
  read), every launch after a reset of the lines the kernel leaves
  marked evict_last, which outlive the flush; at the f32 dispatch also
  the first expert product timed after each tree's gather, and last the
  other tree's kernel after this one's without that reset.

Each kernel's output is held against the plain version of this
checkout, then both are timed base, change, change, base (median of
--reps launches by CUDA events, the L2 flushed before each by reading
256 MB, which leaves it clean; paged_decode and layernorm_fused also
with the L2 warm; decode_fused and int8_matvec also flushed by writing
256 MB, which leaves it dirty, so that a kernel's reads pay for as many
bytes written back) beside one PyTorch call on the same inputs:
scaled_dot_product_attention, for int8_matvec the dequantized bf16
matmul and a product over an unquantized bf16 table, for the add +
LayerNorm kernels F.layer_norm(x + r). Prints
the card's name and power limit, one JSON line per kernel and shape,
and the same timings of one trivial launch (a one-element fill), the
floor under every number above. Exits non-zero without CUDA.
"""
import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import types

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


def ab_flash_fwd(ab):
    """flash_fwd at the training shape and the K2 shapes, beside SDPA."""
    torch, cs, F, old, new, dev, flush = (ab.torch, ab.cs, ab.F, ab.old,
                                          ab.new, ab.dev, ab.flush)
    n, h = cs.N_HEADS, cs.HEAD_DIM
    gen = torch.Generator().manual_seed(ab.seed)
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
            flush, ab.reps)
        if causal and sq == sk:
            sdpa = cs.median_ms(torch, lambda: F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True), flush, reps=ab.reps)
        else:
            sdpa = cs.median_ms(torch, lambda: F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=mask), flush, reps=ab.reps)
        print(json.dumps({
            "kernel": "flash_fwd", "b": b, "sq": sq, "sk": sk,
            "causal": causal, "base_ms": base_ms, "change_ms": change_ms,
            "sdpa_ms": sdpa,
            "bound_ms": cs.bound(*cs.flash_work(b, sq, sk, n, h, causal, 2,
                                                False), "bfloat16")[0],
            "max_abs_err": errs}))
        del q, k, v, lq, lk, lv


def ab_paged_decode(ab):
    """paged_decode at a serving decode step, L2 flushed and warm."""
    torch, cs, F, old, new, dev, flush = (ab.torch, ab.cs, ab.F, ab.old,
                                          ab.new, ab.dev, ab.flush)
    n, h = cs.N_HEADS, cs.HEAD_DIM
    dargs = cs.decode_inputs(torch, torch.Generator().manual_seed(
        ab.seed + 3), torch.bfloat16, dev, edges=False)
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
            fl, ab.reps)
        row[f"{label}sdpa_ms"] = cs.median_ms(
            torch, lambda: F.scaled_dot_product_attention(
                sd[0], sd[1], sd[2], attn_mask=sd[3]), fl, reps=ab.reps)
    row["bound_ms"] = cs.bound(*cs.decode_work(dargs[4].tolist(), 2),
                               "bfloat16")[0]
    print(json.dumps(row))


def ab_decode_fused(ab):
    """decode_fused at generate's mean step, bf16 q over an f32 and a
    bf16 cache."""
    torch, cs, F, old, new, dev, flush = (ab.torch, ab.cs, ab.F, ab.old,
                                          ab.new, ab.dev, ab.flush)
    n, h = cs.N_HEADS, cs.HEAD_DIM
    gen = torch.Generator().manual_seed(ab.seed + 11)
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
                                                 flush, ab.reps)
        row["dirty_base_ms"], row["dirty_change_ms"] = turns(
            torch, cs, base, change, None, ab.reps, timer=ab.dirty)
        row["sdpa_ms"] = cs.median_ms(
            torch, lambda: F.scaled_dot_product_attention(sq, sk, sv),
            flush, reps=ab.reps)
        nbytes = 2 * B * (off + 1) * n * h * k.element_size() \
            + B * n * h * (2 + 4)
        row["bound_ms"] = cs.bound(nbytes, 4 * B * n * (off + 1) * h,
                                   "float32")[0]
        print(json.dumps(row))


def ab_int8_matvec(ab):
    """int8_matvec over GPT-3 125M's int8 head, bf16 h."""
    torch, cs, F, old, new, dev, flush = (ab.torch, ab.cs, ab.F, ab.old,
                                          ab.new, ab.dev, ab.flush)
    n, h = cs.N_HEADS, cs.HEAD_DIM
    gen = torch.Generator().manual_seed(ab.seed + 17)
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
                                                 flush, ab.reps)
        row["dirty_base_ms"], row["dirty_change_ms"] = turns(
            torch, cs, base, change, None, ab.reps, timer=ab.dirty)
        for name, fn in (("dequant_bf16_matmul", dequant),
                         ("bf16_table", bf16_table)):
            row[f"{name}_ms"] = cs.median_ms(torch, fn, flush,
                                             reps=ab.reps)
            row[f"dirty_{name}_ms"] = ab.dirty(fn)
        nbytes = cs.I8_V * cs.I8_D + rows * cs.I8_D * 2 + cs.I8_V * 4 \
            + rows * cs.I8_V * 4
        row["bound_ms"] = cs.bound(nbytes, 2 * rows * cs.I8_V * cs.I8_D,
                                   "bfloat16")[0]
        print(json.dumps(row))


# rows a CTA of the inference add + LayerNorm kernel, swept
LN_WARPS = (1, 2, 4, 8)
SEQ_SPIN = 2_000_000        # clock cycles, ~1 ms
HOST_CALLS = 2000


def ab_layernorm_fwd_saved(ab):
    """K6 at the shapes its main paths give it (chip_smoke's
    LN_SAVED_PATHS): both trees' outputs bit for bit equal and within
    the registry's tolerance of the plain version, this tree's carry bit
    for bit the sum in x's dtype; the kernel without the carry and the
    residual site's forward with a gradient (FusedAddLayerNormPair, each
    tree's own) timed in turns beside F.layer_norm(x + r) and the bytes
    bounds of each."""
    torch, cs, dev = ab.torch, ab.cs, ab.dev
    ln_old, ln_new = ab.old["layernorm"], ab.new["layernorm"]
    gen = torch.Generator().manual_seed(ab.seed + 12)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    size = {"float32": 4, "bfloat16": 2}
    for rows, d, xd, rd, wd in cs.LN_SAVED_PATHS:
        xdt = dts[xd]
        x = torch.randn((rows, d), generator=gen).to(dev, xdt)
        r = torch.randn((rows, d), generator=gen).to(dev, dts[rd])
        w = (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev, dts[wd])
        b = (0.1 * torch.randn((d,), generator=gen)).to(dev, dts[wd])
        got = ln_new.layernorm_fwd_saved(x, r, w, b)
        old = ln_old.layernorm_fwd_saved(x, r, w, b)
        ref = ln_new.layernorm_plain(x, r, w, b)
        with_carry = ln_new.layernorm_fwd_saved(x, r, w, b, carry=True)
        torch.cuda.synchronize()
        tol = ln_new.get_kernel("layernorm_fwd_saved").tol
        name = str(xdt)[6:]
        err = cs.hold(f"layernorm_fwd_saved [{rows}x{d} {name}]", got[0],
                      ref[0], tol[name])
        if not all(torch.equal(a, c) for a, c in zip(got, old)):
            raise AssertionError("layernorm_fwd_saved: the two trees' "
                                 "outputs differ")
        if not (all(cs.same_bits(torch, a, c)
                    for a, c in zip(with_carry, got))
                and cs.same_bits(torch, with_carry[3], got[1].to(xdt))):
            raise AssertionError("layernorm_fwd_saved: the carry is not "
                                 "the sum in x's dtype bit for bit, or the "
                                 "other outputs moved with it")
        del got, old, ref, with_carry
        base_ms, change_ms = turns(
            torch, cs, lambda: ln_old.layernorm_fwd_saved(x, r, w, b),
            lambda: ln_new.layernorm_fwd_saved(x, r, w, b), ab.flush,
            ab.reps)
        with torch.no_grad():
            base_site_ms, change_site_ms = turns(
                torch, cs,
                lambda: ln_old.FusedAddLayerNormPair.apply(x, r, w, b, 1e-5),
                lambda: ln_new.FusedAddLayerNormPair.apply(x, r, w, b, 1e-5),
                ab.flush, ab.reps)
        work = (rows, d, size[xd], size[rd], size[wd], True)
        # a device-to-device copy that moves the site's bytes (half read,
        # half written): the card's rate for plain streaming traffic
        site_bytes = cs.ln_work(*work, carry=xd != "float32")[0]
        src = torch.empty(site_bytes // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = cs.median_ms(torch, lambda: dst.copy_(src), ab.flush,
                               reps=ab.reps)
        del src, dst
        print(json.dumps({
            "kernel": "layernorm_fwd_saved", "rows": rows, "d": d,
            "x": xd, "residual": rd, "weight": wd, "max_abs_err": err,
            "base_ms": base_ms, "change_ms": change_ms,
            "base_site_ms": base_site_ms, "change_site_ms": change_site_ms,
            "library_ms": cs.median_ms(torch, lambda: ab.F.layer_norm(
                x + r, (d,), w, b), ab.flush, reps=ab.reps),
            "bound_ms": cs.bound(*cs.ln_work(*work), "bfloat16")[0],
            "site_bound_ms": cs.bound(site_bytes, 8 * rows * d,
                                      "bfloat16")[0],
            "copy_site_bytes_ms": copy_ms}))
        del x, r


def host_us(torch, fn, calls=HOST_CALLS, warmup=50):
    """Host microseconds a call of `fn`, which only enqueues work on the
    card: `calls` calls back to back on the host clock, synchronized
    before and after but not between (the card keeps up, so no call
    waits for it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def ab_layernorm_fused(ab):
    """K7 at the residual site as the engine runs it (no gradient, bf16,
    x the [rows, 1, 768] residual stream, r the attention output)."""
    torch, cs, F, old, new, dev, flush = (ab.torch, ab.cs, ab.F, ab.old,
                                          ab.new, ab.dev, ab.flush)
    ln_old, ln_new = old["layernorm"], new["layernorm"]
    site_old = old["nn"].fused_add_layer_norm
    site_new = new["nn"].fused_add_layer_norm
    d = cs.N_HEADS * cs.HEAD_DIM
    gen = torch.Generator().manual_seed(ab.seed + 23)
    tol = ln_new.get_kernel("layernorm_fused").tol["bfloat16"]

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(
            dev, torch.bfloat16)

    def median(fn, fl):
        return cs.median_ms(torch, fn, fl, reps=ab.reps)

    w, b = 1 + randn(d, scale=0.1), randn(d, scale=0.1)
    torch.set_grad_enabled(False)
    warps_rule = ln_new.pair_warps
    for rows in (cs.DEC_BATCH, cs.SLOTS, cs.CHUNK):
        x, r = randn(rows, 1, d), randn(rows, 1, d)
        x2, r2 = x.view(rows, d), r.view(rows, d)
        ref_y, ref_h = ln_new.layernorm_fused_pair_plain(x2, r2, w, b)
        errs, outs = {}, {}
        for tag, site in (("base", site_old), ("change", site_new)):
            outs[tag] = y, h = site(x, r, w, b)
            torch.cuda.synchronize()
            errs[tag] = cs.hold(f"layernorm_fused site {tag}",
                                y.view(rows, d), ref_y, tol)
            if not cs.same_bits(torch, h.view(rows, d), ref_h):
                raise AssertionError(f"layernorm_fused site {tag}: the "
                                     "carry is not x + r bit for bit")

        def base_k7():
            return ln_old.layernorm_fused(x2, r2, w, b)

        def base_site():
            return site_old(x, r, w, b)

        def change_site():
            return site_new(x, r, w, b)

        def library():
            return F.layer_norm(x2 + r2, (d,), w, b)
        row = {"kernel": "layernorm_fused", "rows": rows, "d": d,
               "max_abs_err": errs,
               "out_same_bits": cs.same_bits(torch, outs["base"][0],
                                             outs["change"][0])}
        for label, fl in (("", flush), ("warm_", None)):
            row[f"{label}base_site_ms"], row[f"{label}change_site_ms"] = \
                turns(torch, cs, base_site, change_site, fl, ab.reps)
            row[f"{label}base_k7_ms"] = median(base_k7, fl)
            row[f"{label}library_ms"] = median(library, fl)
            by_warps = {}
            for warps in LN_WARPS:
                ln_new.pair_warps = lambda n, k=warps: k
                try:
                    by_warps[warps] = median(change_site, fl)
                finally:
                    ln_new.pair_warps = warps_rule
            row[f"{label}change_site_ms_by_warps"] = by_warps
        row["change_warps"] = warps_rule(rows)
        row["bound_ms"] = cs.bound(*cs.ln_work(rows, d, 2, 2, 2, False,
                                               carry=True), "bfloat16")[0]
        print(json.dumps(row))

    # the decode step's sequence at 16 rows
    rows = cs.SLOTS
    a_in = randn(rows, d)
    w_out, w_fc1 = randn(d, d, scale=0.03), randn(d, 4 * d, scale=0.03)
    resid = randn(rows, 1, d)

    def sequence(site):
        def run():
            o = torch.matmul(a_in, w_out).view(rows, 1, d)
            y, h = site(resid, o, w, b)
            return torch.matmul(y, w_fc1), h
        return run

    def without_pdl(fn):
        def run():
            ln_new.PDL = False
            try:
                return fn()
            finally:
                ln_new.PDL = True
        return run
    base_seq, change_seq = sequence(site_old), sequence(site_new)
    row = {"kernel": "layernorm_fused", "rows": rows,
           "sequence": "out_proj GEMM -> site -> fc1 GEMM"}
    for label, fl in (("", flush), ("warm_", None)):
        # the card spins ~1 ms first: the host enqueues 3-4 launches
        def timer(fn, fl=fl):
            return cs.median_ms(torch, fn, fl, reps=ab.reps,
                                spin=SEQ_SPIN)
        row[f"{label}base_ms"], row[f"{label}change_ms"] = turns(
            torch, cs, base_seq, change_seq, fl, ab.reps, timer=timer)
        row[f"{label}change_no_pdl_ms"], row[f"{label}change_pdl_ms"] = \
            turns(torch, cs, without_pdl(change_seq), change_seq, fl,
                  ab.reps, timer=timer)
    print(json.dumps(row))

    # host cost a call, at 16 rows
    x, r = randn(rows, 1, d), randn(rows, 1, d)
    x2, r2 = x.view(rows, d), r.view(rows, d)
    one = torch.empty(1, device=dev)
    host = {}
    host["base_site"], host["change_site"] = turns(
        torch, cs, lambda: site_old(x, r, w, b), lambda: site_new(x, r, w, b),
        None, None, timer=lambda fn: host_us(torch, fn))
    for name, fn in (
            ("base_k7", lambda: ln_old.layernorm_fused(x2, r2, w, b)),
            ("change_pair", lambda: ln_new.layernorm_fused_pair(x2, r2, w,
                                                                b)),
            ("change_y_only", lambda: ln_new.layernorm_fused(x2, r2, w, b)),
            ("torch_add", lambda: x + r),
            ("trivial_launch", lambda: one.fill_(1.0))):
        host[name] = host_us(torch, fn)
    torch.set_grad_enabled(True)
    print(json.dumps({"kernel": "layernorm_fused", "rows": rows,
                      "host_us_per_call": host}))


def after_gather_ms(torch, gather, follow, flush, reps, reset):
    """Median of per-launch CUDA-event times of `follow(out)` launched
    straight after `out = gather()`; before each pair the L2 lines left
    marked evict_last are reset and the L2 is flushed, so `follow` sees
    the L2 as this gather alone left it."""
    times = []
    for i in range(reps + 3):
        reset()
        flush.sum()
        out = gather()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        follow(out)
        e.record()
        e.synchronize()
        if i >= 3:
            times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def ab_moe_gather(ab):
    """K12 at its two sites of the MoE training step (the dispatch and
    the gather in the combine's backward) in f32, and the dispatch in
    bf16, on the router's maps at the training shape (chip_smoke's
    moe_maps). Every launch is timed after a reset of the L2 lines the
    kernel leaves marked evict_last (they outlive the flush). At every
    site both trees bit for bit this tree's plain version, base, change,
    change, base beside F.embedding over the zero-padded source and a
    device copy of the bytes the kernel must move. At the f32 dispatch
    also the step's next launch, the first expert product, timed after
    each tree's gather in turns (what the lines a gather leaves marked
    cost it), and last the base tree after five of this tree's launches
    without the reset, then after it."""
    torch, cs, F, dev, flush = ab.torch, ab.cs, ab.F, ab.dev, ab.flush
    k_old, k_new = ab.old["moe.kernels"], ab.new["moe.kernels"]
    gen = torch.Generator().manual_seed(ab.seed + 13)
    n, C, _, comb_slot, slot_token = cs.moe_maps(torch, gen, dev)
    d = cs.N_HEADS * cs.HEAD_DIM
    tokens = torch.randn((n, d), generator=gen).to(dev)
    eo = torch.randn((slot_token.numel(), d), generator=gen).to(dev)
    sites = (("dispatch", tokens, slot_token),
             ("combine backward", eo, comb_slot.reshape(-1)),
             ("dispatch", tokens.to(torch.bfloat16), slot_token))
    reset = k_new.reset_persisting_l2

    def timed(fn):
        return cs.median_ms(torch, fn, flush, reps=ab.reps, before=reset)

    for site, src, idx in sites:
        ref = k_new.gather_plain(src, idx)
        for tag, mod in (("base", k_old), ("change", k_new)):
            got = mod.moe_gather_fwd(src, idx)
            torch.cuda.synchronize()
            if not cs.same_bits(torch, got, ref):
                raise AssertionError(f"moe_gather {tag} at the {site}: not "
                                     "bit for bit the plain version")
        del ref
        size = src.element_size()
        nbytes, distinct = cs.gather_work(torch, idx, src.shape[0], d, size)
        valid = int(((idx >= 0) & (idx < src.shape[0])).sum())
        row = {"kernel": "moe_gather", "site": site,
               "dtype": str(src.dtype)[6:], "m": idx.numel(),
               "n_src": src.shape[0], "d": d, "same_bits": True,
               "distinct_rows": distinct, "bytes": nbytes,
               "slot_order_bytes": (valid + idx.numel()) * d * size
               + idx.numel() * 4,
               "bound_ms": cs.bound(nbytes, 0, "float32")[0]}
        row["base_ms"], row["change_ms"] = turns(
            torch, cs, lambda: k_old.moe_gather_fwd(src, idx),
            lambda: k_new.moe_gather_fwd(src, idx), flush, ab.reps,
            timer=timed)
        pad = torch.cat([src, src.new_zeros((1, d))])
        row["library_ms"] = timed(lambda: F.embedding(idx, pad))
        # a device-to-device copy that moves the kernel's bytes (half
        # read, half written): the card's rate for plain streaming
        a = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        b = torch.empty_like(a)
        row["copy_bytes_ms"] = timed(lambda: b.copy_(a))
        del pad, a, b
        print(json.dumps(row))

    site, src, idx = sites[0]
    # the step's next launch after the dispatch: the first expert product
    # (grouped [E, C, d] @ w_in [E, d, 4d], f32 as the MoE layer runs it)
    E = idx.numel() // C
    w_in = torch.randn((E, d, 4 * d), generator=gen).to(dev) * d ** -0.5

    def product(out):
        torch.bmm(out.reshape(E, C, d), w_in)

    follow = [after_gather_ms(torch, lambda m=m: m.moe_gather_fwd(src, idx),
                              product, flush, ab.reps, reset)
              for m in (k_old, k_new, k_new, k_old)]
    del w_in
    # the lines this tree's kernel marks outlive the flush
    for _ in range(5):
        k_new.moe_gather_fwd(src, idx)
    then = {"base, after the change": cs.median_ms(
        torch, lambda: k_old.moe_gather_fwd(src, idx), flush, reps=ab.reps)}
    reset()
    then["base, after a reset"] = cs.median_ms(
        torch, lambda: k_old.moe_gather_fwd(src, idx), flush, reps=ab.reps)
    print(json.dumps({
        "kernel": "moe_gather", "site": site, "dtype": "float32",
        "expert_product_after_base_ms": [follow[0], follow[3]],
        "expert_product_after_change_ms": [follow[1], follow[2]],
        "then": then}))


# case -> (function, module under the package (ops. when no dot), kernel
# source)
CASES = {"flash_fwd": (ab_flash_fwd, "flash_attention",
                       "flash_attention_fwd"),
         "paged_decode": (ab_paged_decode, "paged_attention",
                          "paged_decode"),
         "decode_fused": (ab_decode_fused, "decode_attention",
                          "decode_attention"),
         "int8_matvec": (ab_int8_matvec, "int8_matvec", "int8_matvec"),
         "layernorm_fused": (ab_layernorm_fused, "layernorm",
                             "add_layer_norm"),
         "layernorm_fwd_saved": (ab_layernorm_fwd_saved, "layernorm",
                                 "add_layer_norm"),
         "moe_gather": (ab_moe_gather, "moe.kernels", "moe_kernels")}


def import_module(pkg, m):
    """Module `m` of package `pkg`: under its ops subpackage unless `m`
    names its own path."""
    return importlib.import_module(f"{pkg}.{m}" if "." in m
                                   else f"{pkg}.ops.{m}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=60)
    ap.add_argument("--kernels", default=",".join(CASES),
                    help="comma-separated cases, of " + ", ".join(CASES))
    args = ap.parse_args(argv)
    chosen = args.kernels.split(",")
    unknown = set(chosen) - set(CASES)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    mods_used = [CASES[c][1] for c in chosen] + ["_build"]
    new = {m: import_module("paddle_tpu_torch", m) for m in mods_used}
    load_package(os.path.abspath(args.base), "base_paddle_tpu_torch")
    old = {m: import_module("base_paddle_tpu_torch", m) for m in mods_used}
    for pkg, mods in (("paddle_tpu_torch", new),
                      ("base_paddle_tpu_torch", old)):
        mods["nn"] = importlib.import_module(f"{pkg}.nn.functional")
        mods["_build"].build([CASES[c][2] for c in chosen])
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())

    dev = torch.device("cuda")
    flush = cs.l2_flush(torch, dev)

    def dirty(fn):
        return cs.median_ms(torch, fn, flush, reps=args.reps, dirty=True)
    ab = types.SimpleNamespace(torch=torch, cs=cs, F=torch.nn.functional,
                               old=old, new=new, dev=dev, flush=flush,
                               reps=args.reps, seed=args.seed, dirty=dirty)
    for c in chosen:
        CASES[c][0](ab)

    one = torch.empty(1, device=dev)
    print(json.dumps({"launch_floor_ms": cs.median_ms(
        torch, lambda: one.fill_(1.0), flush, reps=args.reps),
        "warm_launch_floor_ms": cs.median_ms(
            torch, lambda: one.fill_(1.0), None, reps=args.reps),
        "dirty_launch_floor_ms": dirty(lambda: one.fill_(1.0))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
