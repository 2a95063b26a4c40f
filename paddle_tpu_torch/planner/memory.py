"""Hybrid-parallel memory accounting (the planner's feasibility half) —
the port of paddle_tpu/planner/memory.py.

Given a GPT config and a (dp, mp, pp, sp) mesh factorization, compute
per-card bytes for params, grads, optimizer state (ZeRO stage aware)
and live activations (remat aware), and check the plan fits a card's
memory. Pure arithmetic, JAX's verbatim, usable before any model is
built. `planner.plan()` layers the regex partition rules, the lint
battery and the cost-model ranking on top of these numbers. The card
table holds the H100 only; a `cost_model.ChipSpec` (anything carrying
`hbm_bytes`) stands for any other card.
"""
from dataclasses import dataclass, field

__all__ = ["gpt_memory_plan", "gpt_params", "MemoryPlan", "HBM_BYTES",
           "search_plan", "tp_divisibility_issues", "hbm_bytes"]

# the card's memory (bytes) for plan checks: the H100 SXM's
# torch.cuda.get_device_properties(0).total_memory as read on an NVIDIA
# H100 80GB HBM3 at a 700.00 W limit (chip_smoke.py's planner phase
# prints it beside the card's name). Every chip the cost model's link
# table prices appears here too, or plan(chip=...) fails on the budget
# lookup; `cost_model.ChipSpec` carries any other card's figures.
HBM_BYTES = {
    "h100": 85017493504,
}


@dataclass
class MemoryPlan:
    params: int
    param_bytes: int
    grad_bytes: int
    opt_bytes: int
    activation_bytes: int
    total_bytes: int
    detail: dict = field(default_factory=dict)

    def fits(self, chip="h100", headroom=0.8):
        """True if the plan fits `headroom` fraction of the chip's
        memory (the rest is left for the allocator's workspace and
        fragmentation); `chip` a name in HBM_BYTES or a ChipSpec."""
        return self.total_bytes <= hbm_bytes(chip) * headroom


def hbm_bytes(chip):
    """The memory of `chip`: a name in HBM_BYTES, or anything carrying
    `hbm_bytes` (a cost_model.ChipSpec)."""
    if hasattr(chip, "hbm_bytes"):
        return chip.hbm_bytes
    return HBM_BYTES[chip]


def gpt_params(cfg):
    """Exact parameter count of models.gpt.GPTForPretraining(cfg) —
    or, when the config carries num_experts > 0, of the GPTMoE family
    (paddle_tpu_torch.moe): the dense fc1/fc2 MLP is replaced per block
    by a [d, E] router gate and E bias-free expert pairs."""
    d, L, v, s = (cfg.hidden_size, cfg.num_layers, cfg.vocab_size,
                  cfg.max_seq_len)
    f = cfg.ffn_hidden_size
    E = int(getattr(cfg, "num_experts", 0) or 0)
    if E:
        ffn = d * E + E * (d * f) + E * (f * d)   # gate + w_in + w_out
    else:
        ffn = d * f + f + f * d + d               # fc1 (w+b) + fc2 (w+b)
    per_block = (
        3 * d * d + 3 * d          # qkv proj (w+b)
        + d * d + d                # out proj
        + ffn
        + 4 * d                    # 2 LayerNorms (g+b)
    )
    return v * d + s * d + L * per_block + 2 * d  # wte + wpe + blocks + ln_f


def gpt_memory_plan(cfg, dp=1, mp=1, pp=1, sp=1, micro_batch=1,
                    zero_stage=1, remat=True, param_dtype_bytes=4,
                    grad_dtype_bytes=4, compute_dtype_bytes=2,
                    optimizer="adamw"):
    """Per-chip HBM accounting for a 3D/4D hybrid plan.

    Model state follows the Megatron/ZeRO arithmetic: params and grads are
    sharded over mp*pp (tensor+pipeline); optimizer moments additionally
    over dp when zero_stage >= 1 (grads too at stage 2). Activations: with
    remat, each of the L/pp local layers keeps only its block-boundary
    input [micro_batch, seq/sp, d] (everything else is recomputed in
    backward); the 1F1B schedule bounds in-flight microbatches by ~2*pp,
    but its saved state is the same block-boundary inputs, so the bound
    below covers both schedules.
    """
    n_params = gpt_params(cfg)
    d, L = cfg.hidden_size, cfg.num_layers
    # worst-stage accounting: the busiest pipeline stage holds ceil(L/pp)
    # layers, so charge that stage's share of model state, not the average
    local_layers = max(1, -(-L // pp))
    stage_frac = local_layers / max(1, L)
    stage_params = int(n_params * stage_frac) if pp > 1 else n_params
    p_bytes = stage_params * param_dtype_bytes // mp
    g_bytes = stage_params * grad_dtype_bytes // mp
    if zero_stage >= 3:
        p_bytes //= dp           # stage 3: parameters dp-sharded too
    if zero_stage >= 2:
        g_bytes //= dp

    moments = 2 if optimizer.lower() in ("adam", "adamw", "lamb") else 1
    o_bytes = stage_params * 4 * moments // mp
    if zero_stage >= 1:
        o_bytes //= dp

    seq_local = cfg.max_seq_len // sp
    boundary = micro_batch * seq_local * d * compute_dtype_bytes
    # MoE (num_experts > 0): the routed FFN pushes capacity_factor * k
    # copies of each token through the expert stack, so the live FFN
    # intermediate scales by that factor relative to the dense MLP
    ffn_scale = 1.0
    E = int(getattr(cfg, "num_experts", 0) or 0)
    if E:
        ffn_scale = (float(getattr(cfg, "capacity_factor", 1.25))
                     * int(getattr(cfg, "expert_top_k", 2)))
    # materialized [mb, heads/mp, s/sp, s] softmax matrix — zero when flash
    # attention tiles it away inside the kernel
    probs = 0
    if not getattr(cfg, "use_flash_attention", True):
        probs = (micro_batch * (cfg.num_heads // max(1, mp)) * seq_local *
                 cfg.max_seq_len * compute_dtype_bytes)
    if remat:
        # 1F1B + full remat accounting: the schedule's ring buffer holds one
        # STAGE-INPUT boundary per in-flight microbatch (<= 2*pp), plus the
        # one microbatch currently in backward keeps its recompute vjp
        # residuals — local_layers block boundaries and one block's internal
        # peak (ffn intermediate [mb, s/sp, ffn/mp], plus the probs matrix
        # when flash attention is off). pp=1 degenerates to standard remat:
        # ~L boundaries + one block's internals.
        act = boundary * (2 * pp + local_layers)
        act += int(micro_batch * seq_local *
                   (cfg.ffn_hidden_size // mp) * compute_dtype_bytes
                   * 2 * ffn_scale)
        act += probs
    else:
        # ~10 tensors of [mb, s/sp, d] per layer survive to backward in a
        # transformer block without remat (post-ln, qkv, probs-proj, ffn)
        act = boundary * local_layers * 10
        act += int(micro_batch * seq_local *
                   (cfg.ffn_hidden_size // mp) * compute_dtype_bytes
                   * 2 * local_layers * ffn_scale)
        act += probs * local_layers
    # logits buffer on the last stage: [mb, s/sp, vocab/mp] in f32
    logits = micro_batch * seq_local * (cfg.vocab_size // mp) * 4

    total = p_bytes + g_bytes + o_bytes + act + logits
    return MemoryPlan(
        params=n_params,
        param_bytes=p_bytes,
        grad_bytes=g_bytes,
        opt_bytes=o_bytes,
        activation_bytes=act + logits,
        total_bytes=total,
        detail=dict(dp=dp, mp=mp, pp=pp, sp=sp, micro_batch=micro_batch,
                    zero_stage=zero_stage, remat=remat, logits_bytes=logits),
    )


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def tp_divisibility_issues(cfg, mp, sp=1):
    """Mesh-factorization divisibility constraints that the sharding
    lint (SH203) would reject on the default GPT partition rules —
    checked HERE so the candidate enumeration never proposes a layout
    the static analysis immediately kills.

    mp shards: num_heads (attention head split), hidden_size
    (row-parallel out_proj/fc2 input dim — NOT implied by the head
    split when hidden % num_heads != 0 truncates head_dim),
    ffn_hidden_size (fc1 output), vocab_size (vocab-parallel wte);
    sp shards max_seq_len. Returns a list of human-readable issue
    strings; [] means the factorization survives SH203.
    """
    issues = []
    if mp > 1:
        for dim_name, dim in (("num_heads", cfg.num_heads),
                              ("hidden_size", cfg.hidden_size),
                              ("ffn_hidden_size", cfg.ffn_hidden_size),
                              ("vocab_size", cfg.vocab_size)):
            if dim % mp:
                issues.append(f"{dim_name} {dim} % mp {mp} != 0")
    if sp > 1 and cfg.max_seq_len % sp:
        issues.append(f"max_seq_len {cfg.max_seq_len} % sp {sp} != 0")
    return issues


def search_plan(cfg, n_chips, chip="h100", micro_batch=1, zero_stage=1,
                remat=True, max_mp=8):
    """Enumerate dp x mp x pp factorizations of `n_chips` and return the
    feasible MemoryPlans sorted by per-chip bytes (reference analog: the
    human deciding sharding_configs + device_guard cuts; here the HBM
    arithmetic does it). Candidate factorizations must survive
    `tp_divisibility_issues` — the same divisibility rules SH203
    enforces, so no plan this search returns can be one the sharding
    lint rejects (hidden_size used to be unchecked: a config whose
    hidden is not a multiple of mp slipped through and the lint killed
    it at apply time). pp must divide num_layers. mp is capped
    (default 8) because TP all-reduces must stay inside one NVLink
    domain.
    Returns [] when nothing fits — the caller decides whether that
    means more chips or offload. For the full search (sp/ep axes, ZeRO
    stage sweep, cost ranking, lint verification) use
    `paddle_tpu_torch.planner.plan`.
    """
    plans = []
    for mp in _divisors(n_chips):
        if mp > max_mp or tp_divisibility_issues(cfg, mp):
            continue
        rest = n_chips // mp
        for pp in _divisors(rest):
            if cfg.num_layers % pp:
                continue
            dp = rest // pp
            plan = gpt_memory_plan(
                cfg, dp=dp, mp=mp, pp=pp, micro_batch=micro_batch,
                zero_stage=zero_stage, remat=remat)
            if plan.fits(chip):
                plans.append(plan)
    plans.sort(key=lambda p: p.total_bytes)
    return plans
