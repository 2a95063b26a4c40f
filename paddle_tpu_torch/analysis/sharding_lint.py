"""Sharding lint: the mesh and the modules' `mesh_axes` tags checked
before anything is cut — the port of paddle_tpu/analysis/sharding_lint.py.

The port tags a module, not a parameter: `module.mesh_axes` maps a
local parameter name to `(axes, groups)` (distributed/mp_layers.py,
models/gpt.py), and `sharded_train.shard_model` cuts a dim tagged with
an axis of size n into n pieces, each of `groups` equal blocks alike
(the fused qkv's q | k | v thirds are cut by heads, groups 3). The lint
reads those tags and judges divisibility as the port cuts: a dim cut
over n with g groups must divide by n * g, so SH203 on
`qkv_proj.weight` [d, 3d] checks 3d % (3 * mp) where the JAX rule
checks 3d % mp (the two differ when mp divides 3d but not d; the
planner's enumeration never proposes such an mp, since hidden_size %
mp is one of its divisibility conditions). Parameters come from a live
module (the tag of the owning module, the logical shape of a piece
`shard_model` cut), or as [(name, p)] where p carries `shape`, `dtype`,
`mesh_axes` and optionally `groups` (the planner's `AbstractParam`).

Rules (family SH):

- SH201 spec-rank        — a tag longer than the tensor's rank.
- SH202 unknown-axis     — a tag names an axis the mesh does not have.
- SH203 non-divisible    — a tagged dim does not divide by the mesh
                           axis size times the tag's groups.
- SH204 duplicate-axis   — the same mesh axis appears twice in one tag.
- SH205 replicated-under-fsdp — with ZeRO-3 intent, a large parameter
                           that no dim lets the dp axis shard.
- SH206 hbm-budget       — projected per-device bytes exceed the given
                           HBM budget (emitted by `project_hbm`).
- SH207 tuple-entry      — a multi-axis tuple entry in the tag (the
                           port cuts a dim over one axis).
- SH208 rule-coverage    — over a regex partition-rule set
                           (`planner.rules`): a dead rule, and a
                           parameter no rule matches under a sharded
                           layout (emitted by `lint_partition_rules`).

`project_hbm` reports the projected per-device bytes for params, a
same-size gradient, and the optimizer states under the given mesh and
zero stage — the JAX arithmetic (a ZeRO stage's dp share is charged as
a dim cut, as the JAX rule places it), with the port's group rule for
divisibility.
"""
import re

import numpy as np

from . import Finding, SEV_ERROR, SEV_WARNING

__all__ = ["LARGE_PARAM_BYTES", "lint_spec", "lint_model_sharding",
           "lint_partition_rules", "project_hbm", "project_train_step_hbm",
           "named_specs", "mesh_axis_sizes"]

# SH205 floor: below this a replicated parameter is not worth a finding
LARGE_PARAM_BYTES = 1 << 20


def mesh_axis_sizes(mesh):
    """{axis: size} of a torch DeviceMesh, a planner MeshSpec (or
    anything with `axis_names` and `shape[axis]`), or a dict."""
    if isinstance(mesh, dict):
        return {str(a): int(s) for a, s in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: int(mesh.size(i)) for i, a in enumerate(names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _itemsize(dtype):
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return int(dtype.itemsize)      # a torch dtype


def named_specs(model_or_named):
    """[(name, logical shape, itemsize, axes or None, groups)] of a live
    module (its modules' tags; a piece `shard_model` cut reports its
    full shape) or of [(name, p)] pairs (p's `mesh_axes` and `groups`
    attributes; a tag given as (axes, groups) is taken apart)."""
    out = []
    if hasattr(model_or_named, "named_modules"):
        # a tag may sit on an ancestor of the parameter's module (the
        # attention's "qkv_proj.weight"): key every tag by full name
        tags = {}
        for prefix, mod in model_or_named.named_modules():
            cuts = mod.__dict__.get("_mesh_cut", {})
            for local, (axes, groups) in (getattr(mod, "mesh_axes", None)
                                          or {}).items():
                full = f"{prefix}.{local}" if prefix else local
                tags[full] = (axes, groups, cuts.get(local))
        for name, p in model_or_named.named_parameters():
            axes, groups, cut = tags.get(name, (None, 1, None))
            shape = cut[2] if cut else tuple(p.shape)
            out.append((name, tuple(int(s) for s in shape),
                        _itemsize(p.dtype), axes, int(groups)))
        return out
    for name, p in model_or_named:
        axes = getattr(p, "mesh_axes", None)
        groups = int(getattr(p, "groups", 1) or 1)
        out.append((name, tuple(int(s) for s in p.shape),
                    _itemsize(getattr(p, "dtype", np.float32)), axes,
                    groups))
    return out


def lint_spec(name, shape, axes, mesh, groups=1):
    """Core per-tensor rules over a raw tag (its axes, and the groups
    each cut dim is divided into). Returns findings; an untagged tensor
    returns []."""
    findings = []
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes or ())
    sizes = mesh_axis_sizes(mesh)
    groups = int(groups or 1)
    if not axes:
        return findings
    if len(axes) > len(shape):
        findings.append(Finding(
            "SH201", SEV_ERROR, name,
            f"PartitionSpec {axes} has rank {len(axes)} but "
            f"'{name}' has rank {len(shape)} (shape {shape})",
            suggestion="the spec must have at most one entry per array "
                       "dim; trim the tag"))
        axes = axes[:len(shape)]
    seen = {}
    for i, a in enumerate(axes):
        if a is None:
            continue
        if isinstance(a, (tuple, list)):
            findings.append(Finding(
                "SH207", SEV_ERROR, name,
                f"dim {i} of '{name}' uses a multi-axis tuple entry "
                f"{tuple(a)}: the port cuts a dim over one mesh axis and "
                "would leave the tensor whole",
                suggestion="shard the dim over a single mesh axis, or "
                           "reshape so each axis gets its own dim"))
            continue
        size = sizes.get(a)
        if size is None:
            findings.append(Finding(
                "SH202", SEV_ERROR, name,
                f"spec axis {a!r} (dim {i}) is not a mesh axis "
                f"(mesh has {tuple(sizes)})",
                suggestion="tag with one of the mesh axis names or "
                           "None"))
            continue
        if a in seen:
            findings.append(Finding(
                "SH204", SEV_ERROR, name,
                f"mesh axis {a!r} appears on dims {seen[a]} and "
                f"{i} of one spec: a mesh axis may shard at most "
                "one dim",
                suggestion="drop one of the entries"))
            continue
        seen[a] = i
        if size > 1 and shape[i] % (size * groups) != 0:
            each = f" in each of its {groups} groups" if groups > 1 else ""
            findings.append(Finding(
                "SH203", SEV_ERROR, name,
                f"dim {i} of '{name}' (size {shape[i]}) is not "
                f"divisible by mesh axis {a!r} (size {size}){each}; the "
                "axis cannot cut the tensor",
                suggestion=f"pad dim {i} to a multiple of "
                           f"{size * groups} or re-tag the parameter"))
    return findings


def _shard_fraction(shape, axes, sizes, groups=1, extra_axis=None):
    """1/n factor the tag (+ an optional ZeRO extra axis) achieves: a dim
    counts when its axis is above 1 and the dim divides by the axis size
    times the groups; the extra axis takes the first untagged dim that
    divides by its size."""
    shape = tuple(int(s) for s in shape)
    axes = list(axes or ()) + [None] * (len(shape) - len(axes or ()))
    axes = axes[:len(shape)]
    denom = 1
    used = set()
    for i, a in enumerate(axes):
        size = sizes.get(a) if isinstance(a, str) else None
        if size and size > 1 and shape[i] % (size * groups) == 0 \
                and a not in used:
            denom *= size
            used.add(a)
        else:
            axes[i] = None
    if extra_axis is not None and extra_axis not in used:
        size = sizes.get(extra_axis)
        if size and size > 1:
            for i, a in enumerate(axes):
                if a is None and shape[i] % size == 0:
                    denom *= size
                    break
    return 1.0 / denom


def lint_model_sharding(model_or_named, mesh, zero_stage=0,
                        large_param_bytes=LARGE_PARAM_BYTES):
    """All per-tensor SH rules over a module's (or [(name, p)] list's)
    tags."""
    findings = []
    sizes = mesh_axis_sizes(mesh)
    for name, shape, itemsize, axes, groups in named_specs(model_or_named):
        findings.extend(lint_spec(name, shape, axes, sizes, groups))
        if zero_stage >= 3:
            nbytes = int(np.prod(shape or (1,))) * itemsize
            dp = sizes.get("dp") or 1
            if nbytes >= large_param_bytes and dp > 1 and \
                    _shard_fraction(shape, axes, sizes, groups,
                                    extra_axis="dp") == 1.0:
                findings.append(Finding(
                    "SH205", SEV_WARNING, name,
                    f"'{name}' ({nbytes / 1e6:.1f} MB) stays fully "
                    f"replicated under ZeRO-3: no dim is divisible by "
                    f"the dp axis (size {dp}), so every rank holds a "
                    "full copy",
                    suggestion="pad a dim to a multiple of the dp size "
                               "or accept the replication explicitly"))
    return findings


def lint_partition_rules(rules, model_or_named, mesh,
                         large_param_bytes=LARGE_PARAM_BYTES):
    """SH208 partition-rule coverage, both directions (JAX's rule):
    under a sharded layout a parameter no rule matches is an ERROR when
    large (a warning otherwise); a pattern matching no parameter is a
    dead rule (a warning). Scalar and size-1 parameters are exempt from
    the first direction."""
    findings = []
    named = named_specs(model_or_named)
    sizes = mesh_axis_sizes(mesh)
    sharded = any(int(s) > 1 for s in sizes.values())
    rule_hit = [False] * len(rules)
    for name, shape, itemsize, _axes, _groups in named:
        nelem = int(np.prod(shape or (1,)))
        matched = False
        for i, (pattern, _a) in enumerate(rules):
            if re.search(pattern, name):
                rule_hit[i] = True
                matched = True
        if matched or not shape or nelem <= 1:
            continue
        if sharded:
            nbytes = nelem * itemsize
            sev = SEV_ERROR if nbytes >= large_param_bytes else SEV_WARNING
            findings.append(Finding(
                "SH208", sev, name,
                f"no partition rule matches '{name}' (shape {shape}, "
                f"{nbytes / 1e6:.1f} MB): it silently falls through to "
                "fully replicated on every rank of the sharded layout",
                suggestion="add a rule for it, or an explicit "
                           "catch-all ('.*', ()) so the replication "
                           "is a recorded decision"))
    for i, ((pattern, _a), hit) in enumerate(zip(rules, rule_hit)):
        if not hit:
            findings.append(Finding(
                "SH208", SEV_WARNING, f"rule[{i}] {pattern!r}",
                f"partition rule {pattern!r} matches no parameter: a "
                "dead rule — whatever it was written to shard is not "
                "being sharded (typo'd pattern or renamed parameters)",
                suggestion="fix the pattern or delete the rule"))
    return findings


def project_hbm(model_or_named, mesh, zero_stage=0, optimizer_slots=2,
                hbm_bytes=None):
    """Projected steady-state per-device bytes for params + grads +
    optimizer states under the mesh and zero stage, plus an SH206
    finding when a budget is given and exceeded. Returns (report,
    findings)."""
    sizes = mesh_axis_sizes(mesh)
    params_b = grads_b = opt_b = total_logical = 0.0
    for _, shape, itemsize, axes, groups in named_specs(model_or_named):
        nbytes = int(np.prod(shape or (1,))) * itemsize
        total_logical += nbytes
        pfrac = _shard_fraction(shape, axes, sizes, groups,
                                extra_axis="dp" if zero_stage >= 3
                                else None)
        # ZeRO ladder: stage 1 shards optimizer states over dp, stage 2
        # additionally gradients, stage 3 additionally the params
        gfrac = _shard_fraction(shape, axes, sizes, groups,
                                extra_axis="dp" if zero_stage >= 2
                                else None)
        sfrac = _shard_fraction(shape, axes, sizes, groups,
                                extra_axis="dp" if zero_stage >= 1
                                else None)
        params_b += nbytes * pfrac
        grads_b += nbytes * gfrac
        opt_b += nbytes * sfrac * optimizer_slots
    n_devices = 1
    for s in sizes.values():
        n_devices *= int(s)
    report = {
        "n_devices": int(n_devices),
        "zero_stage": int(zero_stage),
        "logical_param_bytes": int(total_logical),
        "per_device": {
            "param_bytes": int(params_b),
            "grad_bytes": int(grads_b),
            "opt_state_bytes": int(opt_b),
            "total_bytes": int(params_b + grads_b + opt_b),
        },
    }
    findings = []
    if hbm_bytes is not None:
        report["hbm_bytes"] = int(hbm_bytes)
        if report["per_device"]["total_bytes"] > hbm_bytes:
            findings.append(Finding(
                "SH206", SEV_ERROR, "mesh",
                f"projected per-device state "
                f"{report['per_device']['total_bytes'] / 1e9:.2f} GB "
                f"exceeds the HBM budget {hbm_bytes / 1e9:.2f} GB",
                suggestion="raise zero_stage, enable offload, or grow "
                           "the mesh"))
    return report, findings


def project_train_step_hbm(step, mesh=None, optimizer_slots=2,
                           hbm_bytes=None):
    """`project_hbm` over a live trainer (jit.TrainStep or
    distributed.ShardedTrainStep: anything with a `model`, optionally a
    `mesh` and a `zero_stage`). Mesh falls back to the step's, then the
    installed one; without either the projection is the one-device
    params + grads + optimizer slots."""
    if mesh is None:
        mesh = getattr(step, "mesh", None)
    if mesh is None:
        from ..distributed import env
        mesh = env.current_mesh()
    if mesh is None:
        mesh = {"dp": 1}
    return project_hbm(step.model, mesh,
                       zero_stage=getattr(step, "zero_stage", 0),
                       optimizer_slots=optimizer_slots,
                       hbm_bytes=hbm_bytes)
