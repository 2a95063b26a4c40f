"""GPT-3 13B weight-only-int8 greedy decode on one card.

    python -m paddle_tpu_torch.tools.serve_13b_w8a16

The port of tools/serve_13b_w8a16.py: GPT-3 13B at its true widths
(hidden 5120, ffn 20480, 40 layers, 40 heads of 128, vocab 50304; 12.85B
parameters) decodes greedily with int8 linears and bf16 activations
(`quant.wo8`). The recipe's steps:

 1. build the f32 model on the host, never on the card;
 2. quantize every linear on the host (`quantize_weights_int8`: int8
    codes, per-output-channel f32 scales; the embeddings stay float);
 3. cast the floating parameters to bf16, leave the buffers (the f32
    `w_scale`s) as they are, and move only this serving set to the card:
    ~12.2 GiB (12.58e9 int8 codes, the 0.48 GiB bf16 token table);
 4. `generate` greedily at batch 1: a 64-token prompt from
    RandomState(0), 64 new tokens, one warm call and one timed call.

The f32 model is 51 GB, so `build_w8a16` makes it a piece at a time (the
token and position tables, each block, the final LayerNorm): a
skeleton on the meta device, then for each piece its f32 values on the
host, drawn with `GPTForPretraining.init_parameter` from one generator
in the order of `named_parameters()`, then steps 2-3 for that piece
alone. The host holds one piece's f32 values at a time, and the values
are a whole f32 build's bit for bit (tests/test_torch_serve_13b.py
holds the two against each other). `prepare_w8a16` is steps 2-3 for a
model already built in f32 on the host.
"""
import time

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..models.gpt import GPTConfig, GPTForPretraining
from ..quant.wo8 import quantize_weights_int8

__all__ = ["config_13b", "prepare_w8a16", "build_w8a16", "serving_bytes",
           "prompt_ids", "decode", "main"]


def config_13b(**kw):
    """The recipe's configuration: GPT-3 13B, a 256-position table (which
    bounds the bf16 KV cache), no dropout, the bf16 cache dtype."""
    return GPTConfig.gpt3_13b(**{"max_seq_len": 256, "dropout": 0.0,
                                 "dtype": "bfloat16", **kw})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def prepare_w8a16(module, device=None, dtype="bfloat16", seconds=None):
    """Steps 2-3 for `module` (a model or a piece of one) in f32 on the
    host: quantize its linears, cast its floating parameters to `dtype`
    (None: kept), move it to `device` (None: the card). `seconds`, a
    dict, gains the quantize and move times. Returns the bytes moved."""
    dev = resolve_device(device)
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    quantize_weights_int8(module)
    t1 = time.perf_counter()
    cdt = None if dtype is None else resolve_dtype(dtype)
    for p in module.parameters():
        if cdt is not None and p.is_floating_point():
            p.data = p.data.to(cdt)
    module.to(dev)
    _sync(dev)
    t2 = time.perf_counter()
    seconds["quantize"] = seconds.get("quantize", 0.0) + t1 - t0
    seconds["move"] = seconds.get("move", 0.0) + t2 - t1
    return serving_bytes(module)


def serving_bytes(module):
    """The bytes of `module`'s parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


def _pieces(model):
    """(prefix, module) in the order of `model.named_parameters()`."""
    core = model.gpt
    out = [("gpt.wte", core.wte), ("gpt.wpe", core.wpe)]
    out += [(f"gpt.blocks.{i}", b) for i, b in enumerate(core.blocks)]
    out.append(("gpt.ln_f", core.ln_f))
    names = [f"{pre}.{n}" for pre, m in out for n, _ in m.named_parameters()]
    if names != [n for n, _ in model.named_parameters()]:
        raise ValueError("build_w8a16: the model's parameters are not its "
                         "pieces' in order")
    return out


@torch.no_grad()
def build_w8a16(config, seed=0, device=None, dtype="bfloat16"):
    """Steps 1-3 a piece at a time -> (GPTForPretraining on `device`,
    seconds {"build", "quantize", "move"}). The model's config is
    `config` (its dtype is the KV cache's); its weights are those of
    `prepare_w8a16(GPTForPretraining(config in f32, device="cpu",
    seed=seed))`."""
    dev = resolve_device(device)
    model = GPTForPretraining(config, device="meta", seed=seed)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    seconds = {"build": 0.0, "quantize": 0.0, "move": 0.0}
    for prefix, piece in _pieces(model):
        t0 = time.perf_counter()
        piece.to_empty(device="cpu")
        piece.float()
        for name, p in piece.named_parameters():
            model.init_parameter(f"{prefix}.{name}", p, gen)
        seconds["build"] += time.perf_counter() - t0
        prepare_w8a16(piece, dev, dtype, seconds)
    return model, seconds


def prompt_ids(vocab_size, batch=1, length=64, seed=0):
    """The recipe's prompt: RandomState(seed) draws [batch, length] ids."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randint(0, vocab_size, (batch, length)))


def decode(model, ids, max_new_tokens=64, **kw):
    """One greedy `generate` call on the model's device -> (ids, seconds),
    the card synchronized at both ends."""
    dev = next(model.parameters()).device
    ids = ids.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    out, _ = model.generate(ids, max_new_tokens=max_new_tokens,
                            device=dev, **kw)
    _sync(dev)
    return out, time.perf_counter() - t0


def main():
    """The recipe as the JAX package's tool runs it: GPT-3 13B from seed
    0 on the card, the 64-token prompt, 64 new tokens."""
    cfg = config_13b()
    t0 = time.perf_counter()
    model, seconds = build_w8a16(cfg, seed=0)
    n = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for b in model.buffers() if b.dtype == torch.int8)
    print(f"params: {n / 1e9:.3f}B; built on the host in "
          f"{seconds['build']:.1f} s, quantized in {seconds['quantize']:.1f}"
          f" s, moved {serving_bytes(model) / 2 ** 30:.2f} GiB in "
          f"{seconds['move']:.1f} s ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    ids = prompt_ids(cfg.vocab_size)
    _, first = decode(model, ids)
    print(f"first decode (capture included): {first:.2f} s", flush=True)
    _, dt = decode(model, ids)
    print(f"13B W8A16 decode: {64 / dt:.1f} tokens/s (batch 1)",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
