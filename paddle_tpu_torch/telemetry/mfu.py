"""Model FLOPs utilization — the port of paddle_tpu/telemetry/mfu.py.

Peaks are NVIDIA's data-sheet dense bf16 tensor-core rates, keyed by a
substring of `torch.cuda.get_device_name()` (longest match wins, so
"H100 PCIe" is not read as the SXM part). The train FLOPs per token is
the PaLM formula the JAX package's bench uses.
"""
__all__ = ["PEAK_FLOPS_BY_KIND", "device_peak_flops",
           "gpt_train_flops_per_token", "mfu"]

# dense bf16 FLOP/s (NVIDIA data sheets, without sparsity)
PEAK_FLOPS_BY_KIND = {
    "h100 pcie": 756e12,
    "h100": 989e12,         # SXM (the HBM3 part)
}


def device_peak_flops(kind=None):
    """Peak bf16 FLOP/s for a device name; `None` reads the current CUDA
    device. Returns None when the kind is unknown (callers then report
    no MFU rather than a made-up one)."""
    if kind is None:
        import torch
        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name()
    kind = str(kind).lower()
    for key, val in sorted(PEAK_FLOPS_BY_KIND.items(),
                           key=lambda kv: -len(kv[0])):
        if key in kind:
            return val
    return None


def gpt_train_flops_per_token(cfg, seq, n_params):
    """PaLM-style train FLOPs per token: 6N for the parameter products
    (forward 2N, backward 4N) plus 12·L·d·S for attention's score and
    value products."""
    return 6 * int(n_params) + 12 * int(cfg.num_layers) \
        * int(cfg.hidden_size) * int(seq)


def mfu(tokens_per_s, flops_per_token, peak_flops):
    """Achieved model FLOP/s over the peak; None when the peak is
    unknown."""
    if not peak_flops:
        return None
    return tokens_per_s * flops_per_token / peak_flops
