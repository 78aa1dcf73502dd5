"""The port's copy of ``repro.fleet.scenarios``, unchanged in behaviour
(the port imports nothing of the reference package).

Declarative fleet scenarios (paper §3–§5's observed conditions).

The paper's fleet analysis draws its power from *diverse* operating
conditions — diurnal demand, scheduled maintenance, correlated failure
domains, heterogeneous hardware generations.  A :class:`Scenario` is a
frozen, declarative description of one such condition set:

  * arrival modulation (:class:`ArrivalModulation`): diurnal / bursty
    intensity profiles warped onto the workload's uniform arrival draws;
  * scheduled maintenance (:class:`MaintenanceWindow`): pods drained
    (checkpoint-resume) for a window, capacity booked as SG loss;
  * correlated failure bursts (:class:`FailureBurst`) and MTBF shocks:
    the paper's failure-domain events, beyond independent chip failures;
  * heterogeneous pod generations: per-generation peak-FLOPS factors that
    weight Program Goodput
    (``repro_torch.core.goodput.generation_pg_weights``).

Times are *fractions of the sim horizon*, so one preset scales from the
tiny golden-trace configuration to paper-scale sweeps unchanged.

Presets live in :data:`SCENARIOS`; modifiers (``diurnal()``, ``bursty()``,
``maintenance_wave()``, ``failure_storm()``, ``hetero()``) are composable —
each returns a new Scenario, so ``STEADY.diurnal().hetero()`` is itself a
valid scenario.  :func:`build_sim` turns (scenario, knobs) into a ready
``FleetSim`` with a deterministic, hermetic workload (explicit pg table;
every random stream seeded per component).
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.ledger import GoodputLedger
from repro_torch.fleet.sim import FleetSim, SimConfig
from repro_torch.fleet.workload import generate_jobs, make_warp


@dataclasses.dataclass(frozen=True)
class ArrivalModulation:
    """Multiplicative arrival-intensity profile over sim time.

    kinds:
      * ``uniform`` — constant intensity (the seed workload);
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
class MaintenanceWindow:
    """Drain ``pod`` (modulo the sim's pod count) over a horizon-relative
    window: occupants are checkpoint-migrated out, the pod is reserved."""
    pod: int
    start_frac: float
    end_frac: float

    def __post_init__(self):
        if not 0.0 <= self.start_frac < self.end_frac:
            # an inverted window would fire maint_end before maint_start
            # and leave the pod reserved until the horizon
            raise ValueError(
                f"maintenance window needs 0 <= start_frac < end_frac, "
                f"got [{self.start_frac}, {self.end_frac}]")


@dataclasses.dataclass(frozen=True)
class FailureBurst:
    """A correlated failure shock at ``at_frac`` of the horizon: each
    running job fails independently with probability ``kill_frac``."""
    at_frac: float
    kill_frac: float

    def __post_init__(self):
        if self.at_frac < 0.0 or self.kill_frac < 0.0:
            raise ValueError(
                f"failure burst needs at_frac >= 0 and kill_frac >= 0, "
                f"got at_frac={self.at_frac}, kill_frac={self.kill_frac}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named, declarative fleet condition set (see module docstring)."""
    name: str
    description: str = ""
    arrival: ArrivalModulation = ArrivalModulation()
    maintenance: Tuple[MaintenanceWindow, ...] = ()
    bursts: Tuple[FailureBurst, ...] = ()
    mtbf_factor: float = 1.0          # <1 = failure-prone period
    pod_generations: Tuple[str, ...] = ()   # cycled over pods; () = uniform
    target_load: float = 0.70

    # -- composable modifiers (each returns a new Scenario) ----------------
    def named(self, name: str, description: str = "") -> "Scenario":
        return dataclasses.replace(self, name=name,
                                   description=description or self.description)

    def _set_arrival(self, suffix: str,
                     arrival: ArrivalModulation) -> "Scenario":
        if self.arrival.kind != "uniform":
            # the single arrival slot would silently swallow the earlier
            # modulation while the name still advertised both — refuse
            raise ValueError(
                f"scenario {self.name!r} already has a "
                f"{self.arrival.kind!r} arrival modulation; compose at "
                "most one of diurnal()/bursty()")
        return dataclasses.replace(self, name=f"{self.name}+{suffix}",
                                   arrival=arrival)

    def diurnal(self, amplitude: float = 0.6,
                period: float = 86400.0) -> "Scenario":
        return self._set_arrival(
            "diurnal", ArrivalModulation(kind="diurnal",
                                         amplitude=amplitude,
                                         period=period))

    def bursty(self, gain: float = 4.0, every: float = 6 * 3600.0,
               width: float = 1800.0) -> "Scenario":
        return self._set_arrival(
            "bursty", ArrivalModulation(kind="bursty", burst_gain=gain,
                                        burst_every=every,
                                        burst_width=width))

    def maintenance_wave(self, pods: int = 2, start_frac: float = 0.35,
                         width_frac: float = 0.10,
                         stagger_frac: float = 0.12) -> "Scenario":
        """Rolling maintenance: ``pods`` staggered drain windows."""
        wins = tuple(
            MaintenanceWindow(pod=i,
                              start_frac=start_frac + i * stagger_frac,
                              end_frac=start_frac + i * stagger_frac
                              + width_frac)
            for i in range(pods))
        return dataclasses.replace(self, name=f"{self.name}+maint",
                                   maintenance=self.maintenance + wins)

    def failure_storm(self, bursts: int = 3, kill_frac: float = 0.35,
                      first_frac: float = 0.30, every_frac: float = 0.15,
                      mtbf_factor: float = 0.5) -> "Scenario":
        """Correlated failure bursts plus a fleet-wide MTBF shock."""
        shocks = tuple(
            FailureBurst(at_frac=first_frac + i * every_frac,
                         kill_frac=kill_frac)
            for i in range(bursts))
        return dataclasses.replace(self, name=f"{self.name}+storm",
                                   bursts=self.bursts + shocks,
                                   mtbf_factor=self.mtbf_factor * mtbf_factor)

    def hetero(self, generations: Tuple[str, ...] = ("tpu-v5p", "tpu-v5e",
                                                     "tpu-v4")) -> "Scenario":
        return dataclasses.replace(self, name=f"{self.name}+hetero",
                                   pod_generations=tuple(generations))

    def load(self, target_load: float) -> "Scenario":
        return dataclasses.replace(self, name=f"{self.name}+load",
                                   target_load=target_load)


# ---------------------------------------------------------------------------
# named presets (the scenario_sweep benchmark and golden traces run these)
# ---------------------------------------------------------------------------

STEADY = Scenario(
    "steady", "uniform arrivals, homogeneous fleet, base MTBF — the seed "
              "workload the repo exercised before scenarios existed")

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    STEADY,
    STEADY.diurnal().named(
        "diurnal", "day/night demand swing (paper Fig. 5 timelines)"),
    STEADY.bursty().named(
        "bursty", "batched submission spikes every 6h"),
    STEADY.maintenance_wave().named(
        "maintenance", "rolling 2-pod drain windows mid-horizon"),
    STEADY.failure_storm().named(
        "failure_storm", "3 correlated failure bursts + halved MTBF"),
    STEADY.hetero().named(
        "hetero_fleet", "v4/v5e/v5p pod generations; PG weighted by peak "
                        "FLOPS ratios"),
    STEADY.diurnal().failure_storm().hetero().named(
        "peak_week", "compound stress: diurnal load + failure storm on a "
                     "heterogeneous fleet"),
)}


# ---------------------------------------------------------------------------
# sim factory
# ---------------------------------------------------------------------------

def build_sim(scenario: Scenario, *, n_jobs: int = 200, seed: int = 0,
              n_pods: int = 8, pod_size: int = 256,
              horizon: float = 7 * 24 * 3600.0,
              placement: str = "best_fit", preemption: str = "protect_xl",
              defrag: str = "drain_for_xl", retain_intervals: bool = False,
              ledger: Optional[GoodputLedger] = None,
              pg_table: Optional[Dict[str, float]] = None,
              size_mix: Optional[Dict[str, float]] = None,
              job_mutator: Optional[Callable] = None,
              engine: str = "vectorized",
              sample_dt: Optional[float] = None,
              slice_repair_s: float = 0.0,
              controller=None) -> FleetSim:
    """A ready-to-run ``FleetSim`` for one scenario.

    Hermetic by construction: the pg table defaults to ``{}`` (per-arch PG
    then comes from the workload's seeded rng, not from whatever roofline
    artifacts happen to be on disk), so the same (scenario, seed, knobs)
    always yields a byte-identical event trace.

    ``job_mutator`` rewrites each generated ``JobSpec`` before submission
    — the hook the what-if advisor (``repro_torch.fleet.advisor``) uses to
    apply counterfactual knobs (async checkpointing, warm compile cache,
    ...) to an otherwise byte-identical workload.

    ``controller`` binds an online ``repro_torch.fleet.controller``
    ``AdaptiveController`` onto the sim (its attribution waterfall
    attaches before any event, so it must bind at build time).
    """
    cfg = SimConfig(n_pods=n_pods, pod_size=pod_size, horizon=horizon,
                    seed=seed, placement=placement, preemption=preemption,
                    defrag=defrag, retain_intervals=retain_intervals,
                    engine=engine, sample_dt=sample_dt,
                    slice_repair_s=slice_repair_s,
                    scenario=scenario)
    sim = FleetSim(cfg, ledger=ledger)
    profile = (scenario.arrival.intensity
               if scenario.arrival.kind != "uniform" else None)
    jobs = generate_jobs(n_jobs, horizon, seed=seed,
                         size_mix=size_mix,
                         pg_table={} if pg_table is None else pg_table,
                         capacity_chips=n_pods * pod_size,
                         target_load=scenario.target_load,
                         arrival_profile=profile)
    if job_mutator is not None:
        jobs = [job_mutator(j) for j in jobs]
    for j in jobs:
        sim.submit(j)
    # workload provenance, recorded into trace headers so a trace alone
    # suffices to rebuild this exact sim
    # (repro_torch.fleet.advisor.from_trace).
    # size_mix is stored as an ordered pair list: the workload's _pick
    # walks the mix in insertion order, and trace JSON sorts dict keys —
    # a round-tripped plain dict would silently reshuffle the workload
    sim.workload_info = {
        "n_jobs": n_jobs,
        "size_mix": (None if size_mix is None
                     else [[k, v] for k, v in size_mix.items()]),
        "pg_table": sorted((pg_table or {}).items()),
    }
    if controller is not None:
        controller.bind(sim)
    return sim


# Tiny configuration for the golden-trace regression suite: small enough
# that one trace is a few KB, busy enough that every phase kind appears.
GOLDEN_SEED = 1234
GOLDEN_KNOBS = dict(n_jobs=24, seed=GOLDEN_SEED, n_pods=2, pod_size=64,
                    horizon=24 * 3600.0, retain_intervals=False)
# small/medium only: with 2 pods of 64 chips every size the workload can
# draw is schedulable, so no job idles in the queue past the horizon
GOLDEN_SIZE_MIX = {"small": 0.60, "medium": 0.40}


def golden_sim(preset: str, engine: str = "vectorized") -> FleetSim:
    """The exact sim configuration behind ``tests/golden/<preset>.jsonl``.

    ``engine`` selects the event core; both engines must produce the same
    bytes (the equivalence gate in ``tests/test_torch_fleet.py``)."""
    if preset not in SCENARIOS:
        raise ValueError(f"unknown scenario preset {preset!r}; "
                         f"choose from {sorted(SCENARIOS)}")
    return build_sim(SCENARIOS[preset], size_mix=GOLDEN_SIZE_MIX,
                     engine=engine, **GOLDEN_KNOBS)


def preset_names() -> List[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# serving arrivals (the serve engine reuses the fleet arrival processes)
# ---------------------------------------------------------------------------

def request_arrivals(n: int, span: float, seed: int = 0,
                     arrival: ArrivalModulation = ArrivalModulation()
                     ) -> List[float]:
    """Deterministic inference-request arrival times over ``[0, span)``.

    Exactly the job-arrival machinery reused at serving granularity:
    seeded uniform draws warped through the modulation's inverse
    cumulative intensity (``repro_torch.fleet.workload.make_warp``), so the
    serve engine sees the same diurnal/bursty demand shapes the fleet
    simulator does — ``request_arrivals(n, span,
    arrival=SCENARIOS["bursty"].arrival)`` is the Fig. 15 serving
    condition.  Returned sorted (a queue, not a job table)."""
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
