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
greedy) base, change, change, base; per run it reports generated
tokens/s and the decode-step p50/p99 (host clock around `_decode_once`,
which ends in the step's host copy), and checks that both trees give
the same tokens. Host speed on the card's machines drifts within a
call, so the turns, not single runs, are what to compare. Then each
tree's engine runs chip_smoke.py's decode-step profile (10 full-batch
steps under torch.profiler: device ms and launches a step, by
category). Prints the card's name and power limit and one JSON line per
tree. Exits non-zero without CUDA.
"""
import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def serve_once(torch, cs, eng, sp, prompts):
    """One run of `prompts` to idle: (tokens/s, step ms list, outputs)."""
    step_ms = []
    decode_once = eng._decode_once

    def timed():
        t = time.perf_counter()
        did = decode_once()
        if did:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return did

    eng._decode_once = timed
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(p, sp(max_new_tokens=32)) for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng._decode_once = decode_once
    outs = [h.output_tokens for h in handles]
    if not all(len(o) == 32 for o in outs):
        raise AssertionError("serve_ab: a stream did not complete")
    return 32 * len(prompts) / wall, step_ms, outs


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
    warm = [p[:40] for p in cs.make_requests(args.seed + 1, cfg.vocab_size,
                                             n=2)]
    for eng, sp in engines.values():
        serve_once(torch, cs, eng, sp, warm)
    prompts = cs.make_requests(args.seed, cfg.vocab_size)
    runs = {"base": [], "change": []}
    outs = {}
    for _ in range(args.rounds):
        for tree in ("base", "change", "change", "base"):
            eng, sp = engines[tree]
            rate, steps, out = serve_once(torch, cs, eng, sp, prompts)
            runs[tree].append((rate, statistics.median(steps),
                               cs.pct(steps, 0.99)))
            outs.setdefault(tree, out)
    # device time and launches of a full-batch decode step, each tree
    for tree in ("base", "change"):
        eng, sp = engines[tree]
        cs.profile_phase(torch, eng, cfg.vocab_size, args.seed,
                         sampling_params=sp, what=f" ({tree})")
    same = outs["base"] == outs["change"]
    for tree, rs in runs.items():
        print(json.dumps({
            "tree": tree, "tokens_per_s": [r[0] for r in rs],
            "step_p50_ms": [r[1] for r in rs],
            "step_p99_ms": [r[2] for r in rs],
            "median_tokens_per_s": statistics.median(r[0] for r in rs),
            "median_step_p50_ms": statistics.median(r[1] for r in rs)}))
    print(json.dumps({"same_tokens": same}))
    if not same:
        raise AssertionError("serve_ab: the trees' greedy streams differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
