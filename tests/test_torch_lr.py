"""The port's LR schedulers (``paddle_tpu_torch/optimizer/lr.py``) held
to the JAX package's (``paddle_tpu/optimizer/lr.py``).

* Each of the 14 schedulers, built with the same arguments in both
  packages, gives the same rate at every one of 60 steps, to a relative
  1e-12 (both are the same Python float arithmetic); ``ReduceOnPlateau``
  steps on a metric sequence that plateaus and falls.
* ``LinearWarmup`` wraps another scheduler, as the pretraining recipe
  does.
* ``state_dict`` / ``set_state_dict`` carry a scheduler across the two
  packages and within the port.
* An optimizer reads the scheduler's value once a step as a Python
  float, and ``set_lr`` refuses a scheduler.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.optimizer import lr as tlr

torch.set_num_threads(1)

STEPS = 60
# (class name, args, kwargs): every scheduler of the JAX package
SCHEDULERS = [
    ("NoamDecay", (512, 10), dict(learning_rate=2.0)),
    ("PiecewiseDecay", ([10, 25, 40], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.5, 0.05), {}),
    ("InverseTimeDecay", (0.5, 0.1), {}),
    ("PolynomialDecay", (0.5, 30), dict(end_lr=0.01, power=2.0)),
    ("PolynomialDecay", (0.5, 13), dict(end_lr=0.01, cycle=True)),
    ("LinearWarmup", (0.3, 7, 0.0, 0.3), {}),
    ("ExponentialDecay", (0.5, 0.93), {}),
    ("MultiStepDecay", (0.5, [7, 19, 33]), dict(gamma=0.3)),
    ("StepDecay", (0.5, 9), dict(gamma=0.5)),
    ("LambdaDecay", (0.5, lambda e: 1.0 / (1 + e) ** 0.5), {}),
    ("CosineAnnealingDecay", (0.5, 20), dict(eta_min=0.01)),
    ("OneCycleLR", (0.8, 50), dict(divide_factor=20.0, phase_pct=0.25)),
    ("CyclicLR", (0.01, 0.5, 8), dict(step_size_down=5)),
    ("CyclicLR", (0.01, 0.5, 6), dict(mode="triangular2")),
    ("CyclicLR", (0.01, 0.5, 6), dict(mode="exp_range", exp_gamma=0.97)),
    ("ReduceOnPlateau", (0.5,), dict(patience=3, factor=0.5, cooldown=2,
                                     min_lr=0.02)),
]
CLASS_NAMES = sorted({c for c, _, _ in SCHEDULERS})


def _metric(i):
    """A loss that falls, plateaus for a while, then falls again."""
    return 2.0 - 0.05 * min(i, 10) - 0.05 * max(0, i - 30)


def _trace(mod, name, args, kwargs):
    sched = getattr(mod, name)(*args, **kwargs)
    out = []
    for i in range(STEPS):
        out.append(sched())
        if name == "ReduceOnPlateau":
            sched.step(_metric(i))
        else:
            sched.step()
    return out, sched


def test_every_scheduler_is_covered():
    """The table covers all 14 of the JAX package's schedulers."""
    assert len(CLASS_NAMES) == 14
    for name in CLASS_NAMES:
        assert hasattr(tlr, name) and hasattr(jlr, name)


@pytest.mark.parametrize("name,args,kwargs", SCHEDULERS,
                         ids=[f"{c}-{i}" for i, (c, _, _)
                              in enumerate(SCHEDULERS)])
def test_scheduler_matches_jax(name, args, kwargs):
    want, _ = _trace(jlr, name, args, kwargs)
    got, _ = _trace(tlr, name, args, kwargs)
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_linear_warmup_over_cosine_matches_jax():
    """The recipe's schedule: 3 warm-up steps from 0, then cosine."""
    def make(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-4, T_max=100),
                                warmup_steps=3, start_lr=0.0, end_lr=1e-4)
    want, got = make(jlr), make(tlr)
    for _ in range(STEPS):
        assert got() == pytest.approx(want(), rel=1e-12, abs=0)
        want.step()
        got.step()


@pytest.mark.parametrize("name,args,kwargs",
                         [SCHEDULERS[0], SCHEDULERS[11], SCHEDULERS[-1]],
                         ids=["noam", "cosine", "plateau"])
def test_state_round_trip(name, args, kwargs):
    """State taken after 25 steps, loaded into a fresh scheduler of either
    package, continues the same sequence (relative 1e-12)."""
    def stepped(mod, n):
        s = getattr(mod, name)(*args, **kwargs)
        for i in range(n):
            s.step(_metric(i)) if name == "ReduceOnPlateau" else s.step()
        return s

    ref = stepped(tlr, 25)
    state = ref.state_dict()
    assert set(state) == set(stepped(jlr, 25).state_dict())
    later = stepped(tlr, 30)()
    for mod in (tlr, jlr):
        fresh = getattr(mod, name)(*args, **kwargs)
        fresh.set_state_dict(dict(state))
        assert fresh() == pytest.approx(ref(), rel=1e-12, abs=0)
        if name != "ReduceOnPlateau":
            for _ in range(5):
                fresh.step()
            assert fresh() == pytest.approx(later, rel=1e-12, abs=0)


def test_optimizer_reads_the_scheduler_each_step():
    """``get_lr`` is the scheduler's Python float; ``last_step_lr`` is
    what each step applied; ``set_lr`` refuses a scheduler."""
    sched = tlr.StepDecay(0.5, 2, gamma=0.5)
    p = torch.nn.Parameter(torch.ones(3))
    opt = SGD(learning_rate=sched, parameters=[p], device="cpu")
    applied = []
    for _ in range(5):
        p.grad = torch.ones(3)
        opt.step()
        applied.append(opt.last_step_lr)
        sched.step()
    assert applied == [0.5, 0.5, 0.25, 0.25, 0.125]
    assert float(p.detach()[0]) == pytest.approx(1 - sum(applied), rel=1e-7)
    assert opt._step_count == 5
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    assert math.isclose(opt.get_lr(), sched(), rel_tol=0)
