"""Learning-rate schedules as host-side ``step -> float32`` callables
(``repro.optim.schedules``).

The reference's schedules are jnp functions of a traced step. The port
computes the learning rate on the host, as numpy float32 in the
reference's order of operations, so an optimizer step passes it to the
card by value and never waits on the device for it. A Python float in
the reference is a weak type: it is rounded to float32 where it meets
the float32 step, which ``_f32`` does here.
"""
from __future__ import annotations

import numpy as np


def _f32(x) -> np.float32:
    return np.float32(x)


def _frac(step, steps: int) -> np.float32:
    """clip(step / max(steps, 1), 0, 1) in float32."""
    t = _f32(step) / _f32(max(steps, 1))
    return _f32(min(max(t, _f32(0.0)), _f32(1.0)))


def constant_schedule(lr: float):
    def sched(step):
        return _f32(lr)
    return sched


def linear_schedule(start: float, end: float, steps: int):
    def sched(step):
        return _f32(start) + _f32(end - start) * _frac(step, steps)
    return sched


def cosine_schedule(peak: float, steps: int, floor: float = 0.0):
    def sched(step):
        t = _frac(step, steps)
        wave = _f32(1.0) + np.cos(_f32(np.pi) * t)
        return _f32(floor) + _f32(0.5 * (peak - floor)) * wave
    return sched


def warmup_cosine_schedule(peak: float, warmup: int, steps: int,
                           floor: float = 0.0):
    cos = cosine_schedule(peak, max(steps - warmup, 1), floor)

    def sched(step):
        if step < warmup:
            ramp = _f32(step) / _f32(max(warmup, 1))
            return _f32(peak) * _f32(min(ramp, _f32(1.0)))
        return _f32(cos(step - warmup))
    return sched
