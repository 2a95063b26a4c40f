"""Cost model: the analytic per-step cost of a parallel layout, and the
measured cost of a function — the port of paddle_tpu/cost_model.py.

`estimate_layout_cost` is JAX's arithmetic verbatim, in the same order
of operations (so a layout costs the same float in both packages); only
the card's figures differ. A card is named (`chip="h100"`) or given as
a `ChipSpec` (memory bytes, peak FLOP/s, link and inter-node bytes/s).

The link table. `LINK_BW_BY_CHIP` is the aggregate per-card bandwidth
of the card's scale-up link, all links summed — the counterpart of
JAX's ICI_BW_BY_CHIP: the H100 SXM's NVLink 4, 18 links of 50 GB/s,
900e9 bytes/s (NVIDIA's H100 datasheet). `DCN_BW_BYTES` is the
inter-node link a GPU: 400 Gb/s NDR InfiniBand, 50e9 bytes/s. "gloo"
ranks move their tensors through the host, so they have no peak: the
entry is None (no roofline, as JAX's CPU backends).

`CostModel.profile_measure` / `static_cost` and
`ProgramCostModel.instruction_profile` use torch's own means: flops
from `torch.utils.flop_counter.FlopCounterMode`, bytes as the sum of
each aten op's operand and result bytes, time from CUDA events after
warm-up (the host clock on the CPU), and the per-op table from
`torch.profiler`'s key averages, standing in for XLA's cost analysis
and HLO opcode count.
"""
import time
from dataclasses import dataclass

__all__ = ["ChipSpec", "LINK_BW_BY_CHIP", "DCN_BW_BYTES", "resolve_chip",
           "device_peak_link_bw", "estimate_layout_cost",
           "layout_cost_from_config", "CostModel", "ProgramCostModel",
           "profile_op_table"]

# aggregate per-card scale-up link bandwidth (bytes/s, all links
# summed): the wire the collective estimates below divide by
LINK_BW_BY_CHIP = {
    "h100": 900e9,     # NVLink 4: 18 links x 50 GB/s (NVIDIA datasheet)
    "gloo": None,      # through the host: no peak
}
# the inter-node link a GPU (400 Gb/s NDR InfiniBand): the outer axis of
# a two-level plan crosses it
DCN_BW_BYTES = 50e9


@dataclass(frozen=True)
class ChipSpec:
    """A card's figures for the planner and the cost model: memory
    bytes, bf16 peak FLOP/s, aggregate link bytes/s and inter-node
    bytes/s."""
    name: str
    hbm_bytes: int
    peak_flops: float
    link_bw: float
    dcn_bw: float = DCN_BW_BYTES


def resolve_chip(chip):
    """A ChipSpec for `chip`: a ChipSpec as it is, or a name in the
    port's tables (planner.memory.HBM_BYTES, telemetry.mfu's peaks,
    LINK_BW_BY_CHIP); a figure missing from the tables is None."""
    if isinstance(chip, ChipSpec):
        return chip
    from .planner.memory import HBM_BYTES
    from .telemetry.mfu import device_peak_flops
    name = str(chip)
    return ChipSpec(name=name, hbm_bytes=HBM_BYTES.get(name),
                    peak_flops=device_peak_flops(name),
                    link_bw=LINK_BW_BY_CHIP.get(name), dcn_bw=DCN_BW_BYTES)


def device_peak_link_bw(kind=None):
    """Aggregate link bytes/s for a device name (None: the current CUDA
    device), longest substring of LINK_BW_BY_CHIP first; None when
    unknown (the CPU) — the bandwidth fraction is then not computable."""
    from .telemetry.mfu import _match_kind
    return _match_kind({k: v for k, v in LINK_BW_BY_CHIP.items()
                        if v is not None}, kind)


def _allreduce_wire_bytes(nbytes, n):
    """Ring all-reduce wire traffic per participant: 2(n-1)/n * bytes
    (reduce-scatter + all-gather halves). n <= 1 is free."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * float(nbytes)


def _allgather_wire_bytes(nbytes, n):
    """(n-1)/n * bytes per participant for an all-gather (or a
    reduce-scatter — same wire volume, opposite direction)."""
    if n <= 1:
        return 0.0
    return (n - 1) / n * float(nbytes)


def estimate_layout_cost(*, n_params, num_layers, hidden_size,
                         seq_len, ffn_hidden_size=None, vocab_size=None,
                         dp=1, pp=1, mp=1, sp=1, ep=1, zero_stage=1,
                         micro_batch=1, num_micro=None, chip="h100",
                         param_dtype_bytes=4, compute_dtype_bytes=2,
                         dp_over_dcn=False, peak_flops=None, ici_bw=None,
                         comm_calibration=None):
    """Analytic per-step cost of one dp x pp x mp x sp x ep layout (JAX's
    model): compute seconds from the PaLM-style FLOPs count against the
    card's bf16 peak (pipeline-bubble adjusted), plus per-collective
    link seconds for every communication the layout implies, no overlap
    assumed — an upper bound, and a fair ranking function.

    Communication model (per card, per step):
      - dp gradient all-reduce of the local param shard (ZeRO >= 2
        issues reduce-scatter + all-gather — same wire bytes); ZeRO-3
        additionally all-gathers the bf16 params in fwd AND bwd;
      - mp: 4 activation all-reduces per transformer layer;
      - sp: ring attention circulates K and V around the sp ring,
        (sp-1) hops forward, doubled for backward;
      - pp: one boundary activation send per microbatch per direction;
      - ep: token dispatch/combine all-to-all, 2 forward + 2 backward.

    `chip`: a name in the port's tables or a ChipSpec. `ici_bw` is the
    card's link bandwidth (NVLink on the H100; JAX's name kept), default
    the chip's. num_micro defaults to 2*pp. dp_over_dcn marks dp as the
    outer axis of a two-level plan (its collectives divide by the
    inter-node bandwidth). comm_calibration: {op: factor} from measured
    collectives (`planner.calibration_from_comm_records`), scaling dp
    grads + tp all-reduces (psum), the ZeRO-3 gather (all_gather), sp/pp
    hops (ppermute) and ep dispatch/combine (all_to_all); missing ops
    are 1.0.
    """
    spec = resolve_chip(chip)
    n_chips = dp * pp * mp * sp * ep
    if num_micro is None:
        num_micro = max(1, 2 * pp)
    if peak_flops is None:
        peak_flops = spec.peak_flops
    if ici_bw is None:
        ici_bw = spec.link_bw
    if not peak_flops or not ici_bw:
        raise ValueError(f"estimate_layout_cost: chip {spec.name!r} has no "
                         "peak FLOP/s or link bandwidth in the port's "
                         "tables; pass a ChipSpec")
    dp_bw = spec.dcn_bw if (dp_over_dcn and dp > 1) else ici_bw

    from .telemetry.mfu import model_flops_per_token
    tokens = dp * micro_batch * num_micro * seq_len
    total_flops = model_flops_per_token(
        n_params, num_layers=num_layers, hidden_size=hidden_size,
        seq_len=seq_len) * tokens
    compute_s = total_flops / n_chips / peak_flops
    # pipeline bubble: of (num_micro + pp - 1) schedule slots only
    # num_micro do useful work per stage
    bubble_frac = (pp - 1) / (num_micro + pp - 1) if pp > 1 else 0.0
    compute_s /= max(1e-9, 1.0 - bubble_frac)

    cal = comm_calibration or {}
    _c = lambda op: float(cal.get(op, 1.0))  # noqa: E731

    local_layers = max(1, -(-num_layers // pp))
    # per-card shard of the gradient (f32 master grads)
    grad_shard = n_params * param_dtype_bytes / (mp * pp)
    dp_grad_s = _allreduce_wire_bytes(grad_shard, dp) / dp_bw * _c("psum")
    if zero_stage >= 3:
        # bf16 param all-gather before use, fwd + bwd recompute
        gather = _allgather_wire_bytes(
            n_params * compute_dtype_bytes / (mp * pp), dp)
        dp_grad_s += 2 * gather / dp_bw * _c("all_gather")

    # activation tile entering/leaving each TP region
    act_tile = micro_batch * (seq_len // sp) * hidden_size \
        * compute_dtype_bytes
    tp_s = (4 * local_layers * num_micro *
            _allreduce_wire_bytes(act_tile, mp)) / ici_bw * _c("psum")

    # K and V blocks circulating the sp ring; each of the (sp-1) hops
    # moves the full per-device kv_tile
    kv_tile = 2 * act_tile
    sp_s = (2 * local_layers * num_micro * (sp - 1) * kv_tile
            ) / ici_bw * _c("ppermute") if sp > 1 else 0.0

    pp_s = (2 * num_micro * act_tile / ici_bw) * _c("ppermute") \
        if pp > 1 else 0.0

    ep_s = (4 * local_layers * num_micro *
            _allgather_wire_bytes(act_tile, ep)) / ici_bw \
        * _c("all_to_all") if ep > 1 else 0.0

    comm_s = dp_grad_s + tp_s + sp_s + pp_s + ep_s
    step_s = compute_s + comm_s
    return {
        "step_time_s": step_s,
        "compute_s": compute_s,
        "comm_s": comm_s,
        "dp_grad_s": dp_grad_s,
        "tp_s": tp_s,
        "sp_s": sp_s,
        "pp_s": pp_s,
        "ep_s": ep_s,
        "bubble_frac": bubble_frac,
        "tokens_per_step": tokens,
        "flops_per_chip": total_flops / n_chips,
        "comm_frac": comm_s / step_s if step_s > 0 else 0.0,
        "n_chips": n_chips,
        "num_micro": num_micro,
    }


def layout_cost_from_config(cfg, *, chip="h100", n_params=None, **layout):
    """`estimate_layout_cost` with the model dims pulled from a
    GPTConfig-shaped object (the planner's entry point)."""
    if n_params is None:
        from .planner.memory import gpt_params
        n_params = gpt_params(cfg)
    return estimate_layout_cost(
        n_params=n_params, num_layers=cfg.num_layers,
        hidden_size=cfg.hidden_size,
        ffn_hidden_size=cfg.ffn_hidden_size,
        vocab_size=cfg.vocab_size, seq_len=cfg.max_seq_len,
        chip=chip, **layout)


# ---------------------------------------------------------------------------
# measured cost of a function
# ---------------------------------------------------------------------------

def _counted(fn, args):
    """Run fn(*args) once under FlopCounterMode and an op-bytes counter:
    -> (flops, bytes accessed, result)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
            return out

    with FlopCounterMode(display=False) as fc, _Bytes() as nb:
        out = fn(*args)
    return float(fc.get_total_flops()), float(nb.total), out


def _sync(args):
    import torch
    if torch.cuda.is_available() and any(
            getattr(a, "is_cuda", False) for a in args):
        torch.cuda.synchronize()


def profile_op_table(events, top_k=20):
    """Per-op breakdown of torch.profiler key averages: count aten op
    calls by name (the port's counterpart of JAX's per-opcode HLO
    count), the most frequent `top_k` with their share."""
    counts = {}
    for e in events:
        key = getattr(e, "key", "")
        if key.startswith("aten::"):
            counts[key[6:]] = counts.get(key[6:], 0) + int(e.count)
    total = sum(counts.values())
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
    table = [{"op": op, "count": n, "share": round(n / total, 6)}
             for op, n in ranked]
    return {"n_instructions": total, "by_op": table}


class CostModel:
    """Profile a function of tensors.

    `profile_measure(fn, example_args)` returns a dict with:
      - flops (FlopCounterMode) and bytes_accessed (each aten op's
        operand and result bytes, summed), from one counted call;
      - measured mean time over `repeat` calls after `warmup` (CUDA
        events when an argument is on the card, else the host clock);
      - achieved FLOP/s and arithmetic intensity (roofline position).
    """

    def __init__(self):
        self._last = None

    def profile_measure(self, fn, example_args, warmup=2, repeat=10):
        import torch
        args = list(example_args)
        flops, bytes_accessed, _ = _counted(fn, args)
        for _ in range(warmup):
            fn(*args)
        cuda = torch.cuda.is_available() and any(
            getattr(a, "is_cuda", False) for a in args)
        if cuda:
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            for _ in range(repeat):
                fn(*args)
            t1.record()
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3 / repeat
        else:
            s = time.perf_counter()
            for _ in range(repeat):
                fn(*args)
            dt = (time.perf_counter() - s) / repeat
        result = {
            "time_s": dt,
            "flops": flops,
            "bytes_accessed": bytes_accessed,
            "achieved_flops_per_s": flops / dt if dt > 0 else 0.0,
            "arithmetic_intensity": (flops / bytes_accessed
                                     if bytes_accessed else 0.0),
        }
        self._last = result
        return result

    def static_cost(self, fn, example_args):
        """Counts only: flops and bytes accessed of one call of `fn`
        (the port runs it once under the counters)."""
        flops, bytes_accessed, _ = _counted(fn, list(example_args))
        _sync(example_args)
        return {"flops": flops, "bytes_accessed": bytes_accessed}


class ProgramCostModel(CostModel):
    """Adds a per-op breakdown of one call (torch.profiler's key
    averages) — the analog of the reference's per-op time table."""

    def instruction_profile(self, fn, example_args, top_k=20):
        import torch
        args = list(example_args)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and any(
                getattr(a, "is_cuda", False) for a in args):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            fn(*args)
            _sync(args)
        return profile_op_table(prof.key_averages(), top_k=top_k)
