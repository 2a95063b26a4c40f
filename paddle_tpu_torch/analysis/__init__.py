"""paddle_tpu_torch.analysis — pre-flight checks of a training step: the
port of paddle_tpu/analysis/__init__.py (its three families that the
planner verifies with).

Every pass reports through one `Finding` model:

- `program_lint`     — rules over one executed step: the aten ops a
                       `TorchDispatchMode` records and the port's own
                       collective spans (state updated out of place,
                       host syncs, upcasts, 64-bit values, collectives
                       over a group of one, reduce-scatter re-gathered).
                       Rules PT1xx, one for each JAX rule JX1xx.
- `sharding_lint`    — the mesh and the modules' `mesh_axes` tags: tag
                       rank, unknown axes, divisibility (as the port
                       cuts: a grouped dim by n * groups), replication
                       under ZeRO-3, per-device HBM, rule coverage.
                       Rules SH2xx.
- `collective_order` — each rank's ordered collective signatures, taken
                       from the collective spans, compared across ranks.
                       Rules CO3xx.

Entry points: `ShardedTrainStep(lint=True)`, `PipelineParallel.lint`,
and the planner's verification (`planner.plan(verify="full")`).
"""

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

# rule-id prefix -> family name (stable: report consumers key on these)
FAMILIES = {
    "PT": "program",
    "SH": "sharding",
    "CO": "collective_order",
}


class Finding:
    """One static-analysis result. `location` is a human-readable site
    (file:line, param name, or op path); `suggestion` is the fix."""

    __slots__ = ("rule_id", "severity", "location", "message", "suggestion")

    def __init__(self, rule_id, severity, location, message, suggestion=None):
        self.rule_id = str(rule_id)
        self.severity = str(severity)
        self.location = str(location)
        self.message = str(message)
        self.suggestion = suggestion

    @property
    def family(self):
        return FAMILIES.get(self.rule_id[:2], "unknown")

    def to_dict(self):
        d = {"rule_id": self.rule_id, "severity": self.severity,
             "family": self.family, "location": self.location,
             "message": self.message}
        if self.suggestion:
            d["suggestion"] = self.suggestion
        return d

    def __repr__(self):
        return (f"[{self.rule_id}/{self.severity}] {self.location}: "
                f"{self.message}"
                + (f" (fix: {self.suggestion})" if self.suggestion else ""))


class GraphDoctorError(RuntimeError):
    """Raised in strict lint mode when a pass reports error findings."""

    def __init__(self, findings):
        self.findings = list(findings)
        super().__init__(
            "graph doctor found %d problem(s):\n%s"
            % (len(self.findings), format_findings(self.findings)))


def format_findings(findings):
    return "\n".join("  " + repr(f) for f in findings) or "  (none)"


def summarize(findings):
    """Counts per family and per severity — the report footer."""
    by_family, by_sev = {}, {}
    for f in findings:
        by_family[f.family] = by_family.get(f.family, 0) + 1
        by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
    return {"n": len(list(findings)), "by_family": by_family,
            "by_severity": by_sev}


def emit(findings, mode=True, title="graph doctor"):
    """Uniform handling for the lint hooks.

    mode True/"warn": warn (one summary warning) when findings exist;
    mode "strict": raise GraphDoctorError when any ERROR finding exists
    — the exception carries ALL findings (errors first) so the
    warning-severity ones are not lost with it. Returns the findings
    unchanged when nothing raises."""
    findings = list(findings)
    if not findings or mode is False:
        return findings
    errors = [f for f in findings if f.severity == SEV_ERROR]
    if mode == "strict" and errors:
        raise GraphDoctorError(
            errors + [f for f in findings if f.severity != SEV_ERROR])
    import warnings
    warnings.warn(f"{title}: {len(findings)} finding(s)\n"
                  + format_findings(findings), stacklevel=3)
    return findings


__all__ = [
    "Finding", "GraphDoctorError", "FAMILIES",
    "SEV_ERROR", "SEV_WARNING", "SEV_INFO",
    "format_findings", "summarize", "emit",
]
