"""The port's copy of ``repro.fleet.workload.make_warp``, unchanged in
behaviour: the inverse cumulative intensity that turns uniform draws
into an inhomogeneous arrival process."""
from __future__ import annotations

from typing import Callable


def make_warp(intensity: Callable[[float], float], span: float,
              grid: int = 512) -> Callable[[float], float]:
    """Build ``u -> t`` mapping uniform draws in [0, span) onto an
    inhomogeneous arrival process with the given intensity profile, by
    inverting the normalized cumulative intensity on a fixed grid (built
    once here; each call is just a binary search + interpolation).

    Deterministic (no rng draws): an arrival modulation warps the *same*
    uniform stream the default workload consumes, so switching it on
    cannot perturb any other seeded random stream.
    """
    dt = span / grid if span > 0 else 0.0
    cum = [0.0]
    for i in range(grid):
        cum.append(cum[-1] + max(0.0, intensity((i + 0.5) * dt)) * dt)
    total = cum[-1]

    def warp(u: float) -> float:
        if span <= 0:
            return 0.0
        if total <= 0.0:
            return u
        target = (u / span) * total
        # binary search the bracketing grid cell, interpolate linearly
        lo, hi = 0, grid
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if cum[mid] <= target:
                lo = mid
            else:
                hi = mid
        cell = cum[lo + 1] - cum[lo]
        frac = (target - cum[lo]) / cell if cell > 0 else 0.0
        return min(span, (lo + frac) * dt)

    return warp
