#!/usr/bin/env python3
"""Serve the same greedy requests through this checkout's ServingEngine
and another checkout's, in turns, in one process on one CUDA card.

    python3 serve_ab.py --base DIR [--seed 0] [--rounds 3]

DIR is the root of another checkout of the repository, for example the
parent commit unpacked from `git archive` into a directory that
.gitignore lists. Both trees' paddle_tpu_torch packages are imported
side by side (the other one under the name base_paddle_tpu_torch), each
building its kernels into its own build/ directory. One GPT-3 125M (seed
--seed, init 0.055, as chip_smoke.py's serve phase) is built by this
tree and its weights loaded into the other tree's model; each tree's
engine serves it in bf16 at the serve phase's shape (16 slots, block 16,
chunk 128, max_model_len 512), stepped by run_until_idle on this thread.

Each round serves chip_smoke.py's 32 requests (32 new tokens each, all
greedy) with `chip_smoke.serve_run`, which drains the engine first, so
the prefix index is flushed and every run prefills the same chunks.
Three arms take turns: base, change, eager, eager, change, base. The
eager arm is this tree's engine with its step bodies run eagerly
(`jit._eager_steps`): the same kernels and buffers as its CUDA graphs,
launched one by one as the base tree launches them, so base against
eager isolates what the step's host code costs apart from the graphs.
Per run it reports generated tokens/s, the decode-step p50/p99 and the
prefill-chunk p50 (host clock around `_decode_once` and
`_prefill_chunk`, each ending in its host copy), and checks that every
arm gives the same tokens. Host speed on the card's machines drifts
within a call, so the turns, not single runs, are what to compare.
Then each arm runs chip_smoke.py's decode-step profile (10 full-batch
steps under torch.profiler: device ms, device launches and the host's
launch API calls a step, by category). Then `generate` at
chip_smoke.py's decode shape (batch 8, prompt 128, 128 new tokens,
greedy, bf16) for the native weights and for weight-only int8 linears
(`quantize_for_decode`, applied to both trees' models), a warm call
each, then calls in the same three-arm turns: tokens/s, the same tokens
in every arm. Beside the turns it prints the capture records of this
tree's compiled steps (CUDA graphs captured at the warm calls: family
and capture ms). Prints the card's name and power limit and one JSON
line per arm. Exits non-zero without CUDA.
"""
import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ARMS = ("base", "change", "eager", "eager", "change", "base")
HERE = os.path.dirname(os.path.abspath(__file__))


def run_arm(arm, fn):
    """`fn()` with this tree's step bodies run eagerly for the arm
    "eager"."""
    from paddle_tpu_torch.jit import _eager_steps
    with _eager_steps() if arm == "eager" else contextlib.nullcontext():
        return fn()


def generate_turns(torch, cs, args, model, base_model):
    """`generate` of both trees at the decode shape, per recipe, in turns
    -> {recipe: {arm: [tokens/s], same_tokens, capture records}}."""
    import numpy as np
    from base_paddle_tpu_torch.quant import \
        quantize_for_decode as base_quantize
    from paddle_tpu_torch.generation import capture_records
    from paddle_tpu_torch.quant import quantize_for_decode
    ids = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, model.config.vocab_size, (cs.DEC_BATCH, cs.DEC_PROMPT))).to("cuda")
    models = {"base": base_model, "change": model, "eager": model}
    out = {}
    for recipe in ("native", "wo8"):
        if recipe == "wo8":
            base_quantize(base_model)
            quantize_for_decode(model)
        streams, rates = {}, {arm: [] for arm in models}
        for arm, m in models.items():
            streams[arm] = run_arm(arm, lambda: m.generate(
                ids, max_new_tokens=cs.DEC_NEW)[0])
        for _ in range(args.rounds):
            for arm in ARMS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o, _ = run_arm(arm, lambda: models[arm].generate(
                    ids, max_new_tokens=cs.DEC_NEW))
                torch.cuda.synchronize()
                rates[arm].append(cs.DEC_BATCH * cs.DEC_NEW
                                  / (time.perf_counter() - t0))
                if not torch.equal(o, streams[arm]):
                    raise AssertionError(f"serve_ab: {arm}'s generate "
                                         "streams vary between calls")
        out[recipe] = {
            **rates, "same_tokens": all(torch.equal(streams["base"], s)
                                        for s in streams.values()),
            "median_tokens_per_s": {t: statistics.median(r)
                                    for t, r in rates.items()},
            "capture_records": [
                {k: r.get(k) for k in ("fn", "n_compiles", "compile_ms")}
                for r in capture_records(model)]}
        print(f"serve_ab generate[{recipe}]: " + json.dumps(out[recipe]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True,
                    help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from kernel_ab import load_package
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    load_package(os.path.abspath(args.base), "base_paddle_tpu_torch")
    from base_paddle_tpu_torch.models.gpt import \
        GPTForPretraining as BaseGPT
    from base_paddle_tpu_torch.serving import \
        SamplingParams as BaseSamplingParams
    from base_paddle_tpu_torch.serving import ServingEngine as BaseEngine
    print(cs.card_line())

    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=cs.INIT_RANGE)
    model = GPTForPretraining(cfg, seed=args.seed)
    base_model = BaseGPT(cfg, seed=args.seed)
    base_model.load_state_dict(model.state_dict())
    engines = {
        "base": (BaseEngine(base_model, **{**cs.ENGINE,
                                           "dtype": "bfloat16"}),
                 BaseSamplingParams),
        "change": (ServingEngine(model, **{**cs.ENGINE,
                                           "dtype": "bfloat16"}),
                   SamplingParams)}
    engines["eager"] = engines["change"]
    warm = [p[:40] for p in cs.make_requests(args.seed + 1, cfg.vocab_size,
                                             n=2)]
    for arm, (eng, sp) in engines.items():
        cs.serve_run(torch, eng, warm, new=4, eager=arm == "eager", sp=sp)
    prompts = cs.make_requests(args.seed, cfg.vocab_size)
    runs = {arm: [] for arm in engines}
    outs = {}
    for _ in range(args.rounds):
        for arm in ARMS:
            eng, sp = engines[arm]
            out, rate, steps, chunks = cs.serve_run(
                torch, eng, prompts, eager=arm == "eager", sp=sp)
            runs[arm].append((rate, statistics.median(steps),
                              cs.pct(steps, 0.99), statistics.median(chunks)))
            outs.setdefault(arm, out)
    # device time and launches of a full-batch decode step, each tree
    for arm in ("base", "change", "eager"):
        eng, sp = engines[arm]
        cs.profile_phase(torch, eng, cfg.vocab_size, args.seed,
                         sampling_params=sp, what=f" ({arm})",
                         eager=arm == "eager")
    same = all(o == outs["base"] for o in outs.values())
    gen = generate_turns(torch, cs, args, model, base_model)
    for arm, rs in runs.items():
        print(json.dumps({
            "tree": arm, "tokens_per_s": [r[0] for r in rs],
            "step_p50_ms": [r[1] for r in rs],
            "step_p99_ms": [r[2] for r in rs],
            "chunk_p50_ms": [r[3] for r in rs],
            "median_tokens_per_s": statistics.median(r[0] for r in rs),
            "median_step_p50_ms": statistics.median(r[1] for r in rs)}))
    print(json.dumps({"same_tokens": same}))
    print(json.dumps({"capture_records": [
        {k: r.get(k) for k in ("fn", "n_compiles", "compile_ms")}
        for r in engines["change"][0]._graphs.records]}))
    print(json.dumps({"generate": gen}))
    if not same:
        raise AssertionError("serve_ab: the arms' greedy streams differ")
    if not all(g["same_tokens"] for g in gen.values()):
        raise AssertionError("serve_ab: the arms' generate streams differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
