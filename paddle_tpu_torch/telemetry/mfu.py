"""Model FLOPs utilization and the card's peaks — the port of
paddle_tpu/telemetry/mfu.py.

Peaks are NVIDIA's data-sheet rates, keyed by a substring of
`torch.cuda.get_device_name()` (longest match wins, so "H100 PCIe" is
not read as the SXM part): dense bf16 tensor-core FLOP/s, float32
FLOP/s outside the tensor cores, and HBM bytes/s — the two axes of the
roofline the kernel observatory (telemetry/kernel_obs.py) places a
measured kernel on. The train FLOPs per token is the PaLM formula the
JAX package's bench uses.
"""
__all__ = ["PEAK_FLOPS_BY_KIND", "PEAK_F32_FLOPS_BY_KIND",
           "PEAK_HBM_BW_BY_KIND", "device_peak_flops", "device_peak_hbm_bw",
           "flops_drift", "gpt_train_flops_per_token", "mfu",
           "model_flops_per_token"]

# dense bf16 FLOP/s (NVIDIA data sheets, without sparsity)
PEAK_FLOPS_BY_KIND = {
    "h100 pcie": 756e12,
    "h100": 989e12,         # SXM (the HBM3 part)
}

# float32 FLOP/s outside the tensor cores (NVIDIA data sheets)
PEAK_F32_FLOPS_BY_KIND = {
    "h100 pcie": 51e12,
    "h100": 67e12,
}

# HBM bytes/s (NVIDIA data sheets)
PEAK_HBM_BW_BY_KIND = {
    "h100 pcie": 2.0e12,
    "h100": 3.35e12,
}


def _match_kind(table, kind):
    if kind is None:
        import torch
        if not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name()
    kind = str(kind).lower()
    for key, val in sorted(table.items(), key=lambda kv: -len(kv[0])):
        if key in kind:
            return val
    return None


def device_peak_flops(kind=None, dtype="bfloat16"):
    """Peak FLOP/s for a device name; `None` reads the current CUDA
    device. `dtype` "float32" gives the float32 rate, anything else the
    bf16 tensor-core rate. Returns None when the kind is unknown
    (callers then report no MFU rather than a made-up one)."""
    table = PEAK_F32_FLOPS_BY_KIND if str(dtype) in ("float32", "f32") \
        else PEAK_FLOPS_BY_KIND
    return _match_kind(table, kind)


def device_peak_hbm_bw(kind=None):
    """Peak HBM bytes/s for a device name, matched as
    `device_peak_flops` matches; None when unknown (the CPU)."""
    return _match_kind(PEAK_HBM_BW_BY_KIND, kind)


def flops_drift(compiled_flops, analytic_flops):
    """Relative drift (compiled - analytic) / analytic of a measured
    FLOP count from the analytic one; None when either side is
    missing or not positive. The health detector's `flops_drift` rule
    reads it."""
    try:
        c, a = float(compiled_flops), float(analytic_flops)
    except (TypeError, ValueError):
        return None
    if c <= 0 or a <= 0:
        return None
    return (c - a) / a


def gpt_train_flops_per_token(cfg, seq, n_params):
    """PaLM-style train FLOPs per token: 6N for the parameter products
    (forward 2N, backward 4N) plus 12·L·d·S for attention's score and
    value products."""
    return 6 * int(n_params) + 12 * int(cfg.num_layers) \
        * int(cfg.hidden_size) * int(seq)


def model_flops_per_token(n_params, num_layers=0, hidden_size=0, seq_len=0):
    """PaLM-style train FLOPs per token: 6N for the parameter matmuls
    (fwd 2N + bwd 4N) plus 12*L*H*S for self-attention score/value work
    (the JAX package's function, which the cost model prices with)."""
    return 6 * int(n_params) + 12 * int(num_layers) * int(hidden_size) \
        * int(seq_len)


def mfu(tokens_per_s, flops_per_token, peak_flops):
    """Achieved model FLOP/s over the peak; None when the peak is
    unknown."""
    if not peak_flops:
        return None
    return tokens_per_s * flops_per_token / peak_flops
