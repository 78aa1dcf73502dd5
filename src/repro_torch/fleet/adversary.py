"""The port's copy of ``repro.fleet.adversary``, unchanged in behaviour
(the port imports nothing of the reference package).

Adversarial scenario search: find fleet conditions that break the loop.

MAD-Max-style design-space exploration under stress (PAPERS.md): instead
of scoring the controller on the 7 friendly presets, a seeded
random-restart hill-climber mutates
:class:`~repro_torch.fleet.scenarios.Scenario` parameters — burst
count/severity/timing, fleet-wide MTBF shocks, maintenance-drain
placement, arrival warp, repair-window scale — to *minimize* the
controlled fleet's MPG.  The resulting worst-case suite is
committed (``BENCH_controller.json``) and re-evaluated exactly in CI: the
controller must keep MPG at or above the best static policy's floor on
every scenario the search finds.

The search is deliberately simple and fully deterministic:

  * a **genome** is a flat dict of rounded scalars (rounded at creation,
    so a committed genome re-evaluates to the exact same floats later);
  * :func:`scenario_from` compiles a genome into a frozen ``Scenario``
    (plus the repair scale, which lives beside the scenario because
    ``slice_repair_s`` is a sim knob, not a scenario field);
  * :func:`search_worst` runs ``restarts`` independent seeded
    hill-climbs, each mutating one gene per step and keeping the mutant
    only when it strictly lowers the evaluated MPG; an evaluation cache
    keyed on the canonical genome makes revisits free.

The evaluator is injected (``evaluate(genome) -> mpg``) so the benchmark
controls the fleet scale and which arm — controlled or static — the
search attacks.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, List, Tuple

from repro_torch.fleet.scenarios import (ArrivalModulation, FailureBurst,
                                         MaintenanceWindow, Scenario)

Genome = Dict[str, object]

# gene -> (low, high) for numeric genes; categorical genes listed below.
# Bounds stay inside regions the sim treats meaningfully: burst times and
# maintenance windows inside the horizon, MTBF shocks from quarter-life
# to better-than-nominal, repair windows from 30 min to 8 h of scale.
BOUNDS: Dict[str, Tuple[float, float]] = {
    "n_bursts": (0, 4),               # int: correlated failure shocks
    "kill_frac": (0.10, 0.60),        # P(running job dies) per shock
    "first_frac": (0.10, 0.60),       # first shock, fraction of horizon
    "every_frac": (0.05, 0.30),       # shock spacing, fraction of horizon
    "mtbf_factor": (0.25, 1.50),      # fleet-wide MTBF multiplier
    "maint_pods": (0, 2),             # int: staggered drain windows
    "maint_start_frac": (0.10, 0.60),
    "maint_width_frac": (0.05, 0.25),
    "arrival_amplitude": (0.00, 0.90),   # diurnal swing
    "arrival_gain": (1.0, 8.0),          # bursty spike gain
    "repair_hours": (0.5, 8.0),          # slice_repair_s scale, hours
}
ARRIVAL_KINDS = ("uniform", "diurnal", "bursty")
_INT_GENES = ("n_bursts", "maint_pods")
_ROUND = 4


def _clamp(gene: str, value: float) -> float:
    lo, hi = BOUNDS[gene]
    v = min(hi, max(lo, value))
    if gene in _INT_GENES:
        return int(round(v))
    return round(v, _ROUND)


def random_genome(rng: random.Random) -> Genome:
    """One uniform sample of the search space (rounded, so committing the
    genome and re-evaluating it later reproduces the same scenario)."""
    g: Genome = {}
    for gene, (lo, hi) in BOUNDS.items():
        if gene in _INT_GENES:
            g[gene] = rng.randint(int(lo), int(hi))
        else:
            g[gene] = round(rng.uniform(lo, hi), _ROUND)
    g["arrival_kind"] = rng.choice(ARRIVAL_KINDS)
    return g


def mutate(genome: Genome, rng: random.Random) -> Genome:
    """Perturb exactly one gene: gaussian step for scalars (10% of the
    range), +/-1 for integer genes, re-draw for the categorical."""
    g = dict(genome)
    gene = rng.choice(sorted(g))
    if gene == "arrival_kind":
        g[gene] = rng.choice([k for k in ARRIVAL_KINDS if k != g[gene]])
    elif gene in _INT_GENES:
        lo, hi = BOUNDS[gene]
        step = rng.choice((-1, 1))
        g[gene] = int(min(hi, max(lo, g[gene] + step)))
    else:
        lo, hi = BOUNDS[gene]
        g[gene] = _clamp(gene, g[gene] + rng.gauss(0.0, 0.10 * (hi - lo)))
    return g


def genome_key(genome: Genome) -> Tuple:
    """Canonical hashable identity (the evaluation-cache key)."""
    return tuple(sorted(genome.items()))


def scenario_from(genome: Genome, name: str = "adversarial") -> Scenario:
    """Compile a genome into a frozen Scenario.  ``repair_hours`` is NOT
    encoded here — it maps to the ``slice_repair_s`` sim knob
    (``genome["repair_hours"] * 3600``), which the evaluator passes to
    ``build_sim`` alongside the scenario."""
    kind = genome["arrival_kind"]
    if kind == "diurnal":
        arrival = ArrivalModulation(kind="diurnal",
                                    amplitude=genome["arrival_amplitude"])
    elif kind == "bursty":
        arrival = ArrivalModulation(kind="bursty",
                                    burst_gain=genome["arrival_gain"])
    else:
        arrival = ArrivalModulation()
    bursts = tuple(
        FailureBurst(
            at_frac=round(min(0.95, genome["first_frac"]
                              + i * genome["every_frac"]), _ROUND),
            kill_frac=genome["kill_frac"])
        for i in range(int(genome["n_bursts"])))
    maint = tuple(
        MaintenanceWindow(
            pod=i,
            start_frac=round(min(0.90, genome["maint_start_frac"]
                                 + i * genome["maint_width_frac"]), _ROUND),
            end_frac=round(min(0.98, genome["maint_start_frac"]
                               + (i + 1) * genome["maint_width_frac"]),
                           _ROUND))
        for i in range(int(genome["maint_pods"])))
    return Scenario(name=name,
                    description="adversarially-searched worst case",
                    arrival=arrival, maintenance=maint, bursts=bursts,
                    mtbf_factor=genome["mtbf_factor"])


def search_worst(evaluate: Callable[[Genome], float], *, seed: int,
                 restarts: int = 3, steps: int = 10,
                 keep: int = 3) -> List[Dict[str, object]]:
    """Random-restart hill-climb minimizing ``evaluate(genome)``.

    Each restart draws a fresh random genome from its own seeded stream
    (``random.Random(f"{seed}:adversary:{r}")``), then takes ``steps``
    single-gene mutations, accepting only strict improvements (lower
    MPG).  Returns the ``keep`` distinct worst genomes found across all
    restarts, sorted ascending by MPG::

        [{"genome": {...}, "mpg": 0.21}, ...]
    """
    cache: Dict[Tuple, float] = {}

    def ev(g: Genome) -> float:
        k = genome_key(g)
        if k not in cache:
            cache[k] = evaluate(g)
        return cache[k]

    seen: Dict[Tuple, Genome] = {}
    for r in range(restarts):
        rng = random.Random(f"{seed}:adversary:{r}")
        cur = random_genome(rng)
        cur_mpg = ev(cur)
        seen.setdefault(genome_key(cur), cur)
        for _ in range(steps):
            cand = mutate(cur, rng)
            cand_mpg = ev(cand)
            seen.setdefault(genome_key(cand), cand)
            if cand_mpg < cur_mpg:
                cur, cur_mpg = cand, cand_mpg
    ranked = sorted(seen.values(), key=lambda g: (cache[genome_key(g)],
                                                  genome_key(g)))
    return [{"genome": g, "mpg": cache[genome_key(g)]}
            for g in ranked[:keep]]
