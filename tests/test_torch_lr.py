"""The port's learning-rate schedules (paddle_tpu_torch.optimizer.lr)
against the JAX package's: each is host arithmetic on Python floats,
copied in its order of operations, so every value must be identical
(==, no tolerance) to the JAX scheduler's over 60 steps, across
`state_dict` round trips (within the port and from JAX to the port), and
for `ReduceOnPlateau` over a metric sequence in every mode."""
import math

import pytest

from paddle_tpu.optimizer import lr as jax_lr

from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr

_STEPS = 60


def _cosine(mod):
    return mod.CosineAnnealingDecay(0.5, T_max=40, eta_min=0.02)


# name -> a function of the module (jax_lr or the port's lr) making it
_SCHEDULES = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=2.0),
    "piecewise": lambda m: m.PiecewiseDecay([10, 30, 45],
                                            [0.1, 0.05, 0.01, 0.002]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, gamma=0.05),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, gamma=0.1),
    "polynomial": lambda m: m.PolynomialDecay(0.5, decay_steps=20,
                                              end_lr=0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=13, end_lr=0.01, power=1.5, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.5, warmup_steps=10,
                                              start_lr=0.0, end_lr=0.5),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        _cosine(m), warmup_steps=10, start_lr=0.001, end_lr=0.5),
    "exponential": lambda m: m.ExponentialDecay(0.5, gamma=0.93),
    "multistep": lambda m: m.MultiStepDecay(0.5, milestones=[10, 25, 40],
                                            gamma=0.5),
    "step": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.6),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.5,
                                                      lambda e: 0.97),
    "cosine": _cosine,
    "one_cycle_cos": lambda m: m.OneCycleLR(0.5, total_steps=50),
    "one_cycle_linear": lambda m: m.OneCycleLR(
        0.5, total_steps=45, divide_factor=10.0, end_learning_rate=1e-3,
        phase_pct=0.4, anneal_strategy="linear"),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.5, step_size_up=7,
                                   step_size_down=5),
    "cyclic_triangular2": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=6, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=6, mode="exp_range", exp_gamma=0.98),
    "cyclic_scale_fn": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=5, scale_fn=lambda x: 1.0 / (1.0 + 0.1 * x),
        scale_mode="iterations"),
}


def _run(sched, steps=_STEPS):
    out = []
    for _ in range(steps):
        out.append(sched())
        sched.step()
    return out


def test_every_reference_schedule_is_ported():
    ported = {n for n in lr.__all__}
    reference = {n for n, v in vars(jax_lr).items()
                 if isinstance(v, type) and issubclass(v, jax_lr.LRScheduler)}
    assert reference == ported
    assert len(ported) == 16        # the base and 15 schedules


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_values_identical_to_jax_over_sixty_steps(name):
    build = _SCHEDULES[name]
    ref, got = _run(build(jax_lr)), _run(build(lr))
    assert got == ref
    assert all(isinstance(v, float) and math.isfinite(v) for v in got)
    assert len(set(got)) > 1        # the schedule moves


@pytest.mark.parametrize("name", ["linear_warmup_cosine", "cyclic",
                                  "multiplicative", "one_cycle_cos"])
def test_state_dict_round_trips(name):
    build = _SCHEDULES[name]
    a, b = build(lr), build(lr)
    _run(a, 17)
    b.set_state_dict(a.state_dict())
    assert _run(b, 30) == _run(a, 30)
    # from the JAX scheduler's state into the port's
    j, p = build(jax_lr), build(lr)
    _run(j, 23)
    p.set_state_dict(j.state_dict())
    assert _run(p, 30) == _run(j, 30)


_METRICS = [1.0, 0.9, 0.9, 0.95, 0.91, 0.92, 0.93, 0.5, 0.5, 0.51, 0.52,
            0.53, 0.54, 0.55, 0.4, 0.4, 0.4, 0.4, 0.4, 0.41, 0.42, 0.1,
            0.1, 0.1, 0.1, 0.1, 0.1, 0.1]


@pytest.mark.parametrize("mode,threshold_mode", [
    ("min", "rel"), ("min", "abs"), ("max", "rel"), ("max", "abs")])
def test_reduce_on_plateau_follows_jax(mode, threshold_mode):
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=0.02,
              threshold_mode=threshold_mode, cooldown=1, min_lr=0.01)
    j = jax_lr.ReduceOnPlateau(0.4, **kw)
    p = lr.ReduceOnPlateau(0.4, **kw)
    metrics = _METRICS if mode == "min" else [2.0 - x for x in _METRICS]
    jl, pl = [], []
    for x in metrics:
        j.step(x)
        p.step(x)
        jl.append(j())
        pl.append(p())
    assert pl == jl
    assert len(set(pl)) > 2         # the rate was cut more than once
    p.step(None)                    # no metric: no step
    assert p.last_epoch == len(metrics) and p() == pl[-1]
    q = lr.ReduceOnPlateau(0.4, **kw)
    q.set_state_dict(p.state_dict())
    for x in metrics[:8]:
        q.step(x)
        p.step(x)
    assert q() == p() and q.best == p.best


def test_the_optimizer_reads_its_scheduler_every_step():
    sched = _SCHEDULES["linear_warmup_cosine"](lr)
    opt = SGD(learning_rate=sched, parameters=[])
    seen = []
    for _ in range(12):
        seen.append(opt.get_lr())
        sched.step()
    assert seen == _run(_SCHEDULES["linear_warmup_cosine"](lr), 12)
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    opt.set_lr_scheduler(sched)
    assert opt.get_lr() == sched()
