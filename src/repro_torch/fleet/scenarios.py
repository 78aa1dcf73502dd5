"""The port's copies of the serving arrival pieces of
``repro.fleet.scenarios``, unchanged in behaviour: ``ArrivalModulation``,
the arrival profiles of the ``steady``, ``diurnal`` and ``bursty``
presets (``SCENARIOS[name].arrival``, what the serve CLI's ``--arrival``
maps to), and ``request_arrivals``.  The rest of a fleet ``Scenario``
(maintenance, failure bursts, pod generations) belongs to the simulator
and is not ported, so a preset here is its arrival profile alone."""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List

from repro_torch.fleet.workload import make_warp


@dataclasses.dataclass(frozen=True)
class ArrivalModulation:
    """Multiplicative arrival-intensity profile over time.

    kinds:
      * ``uniform`` — constant intensity;
      * ``diurnal`` — ``1 + amplitude * sin(2*pi*t/period + phase)``;
      * ``bursty``  — baseline 1, plus ``gain`` inside periodic windows of
        ``burst_width`` seconds every ``burst_every`` seconds.
    """
    kind: str = "uniform"
    amplitude: float = 0.0            # diurnal: in [0, 1)
    period: float = 86400.0           # diurnal period (s)
    phase: float = -math.pi / 2       # diurnal phase (trough at t=0)
    burst_every: float = 6 * 3600.0
    burst_width: float = 1800.0
    burst_gain: float = 4.0

    def intensity(self, t: float) -> float:
        if self.kind == "diurnal":
            return 1.0 + self.amplitude * math.sin(
                2 * math.pi * t / self.period + self.phase)
        if self.kind == "bursty":
            in_burst = (t % self.burst_every) < self.burst_width
            return 1.0 + (self.burst_gain if in_burst else 0.0)
        return 1.0


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A preset's name and its arrival profile (the reference's
    ``Scenario`` less its simulator-only fields)."""
    name: str
    arrival: ArrivalModulation = ArrivalModulation()


# the reference's presets built with its modifiers' defaults:
# ``STEADY.diurnal()`` (amplitude 0.6, period 1 day) and ``STEADY.bursty()``
# (gain 4 in a 1800 s window every 6 h)
SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario("steady"),
    Scenario("diurnal", ArrivalModulation(kind="diurnal", amplitude=0.6,
                                          period=86400.0)),
    Scenario("bursty", ArrivalModulation(kind="bursty", burst_gain=4.0,
                                         burst_every=6 * 3600.0,
                                         burst_width=1800.0)),
)}


def request_arrivals(n: int, span: float, seed: int = 0,
                     arrival: ArrivalModulation = ArrivalModulation()
                     ) -> List[float]:
    """Deterministic inference-request arrival times over ``[0, span)``:
    seeded uniform draws warped through the modulation's inverse
    cumulative intensity (:func:`make_warp`), so the serve engine sees
    the fleet simulator's diurnal / bursty demand shapes.  Returned
    sorted (a queue, not a job table)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if span <= 0 and n:
        raise ValueError(f"span must be positive, got {span}")
    rng = random.Random(seed)
    us = [rng.uniform(0.0, span) for _ in range(n)]
    if arrival.kind != "uniform":
        warp = make_warp(arrival.intensity, span)
        us = [warp(u) for u in us]
    return sorted(us)
