"""The port's copy of ``repro.fleet.advisor``, unchanged in behaviour
(the port imports nothing of the reference package).

Counterfactual what-if optimization advisor (paper §6–§7, Figs 14–15).

The attribution waterfall (``repro_torch.core.attribution``) answers *where the
goodput went*; this module answers *which fix buys the most back*.  It
takes a baseline — a scenario preset, a :class:`Scenario`, or a recorded
trace — and replays the simulator under a catalog of counterfactual
knobs, each a single optimization the paper evaluates:

  * ``async_checkpointing``     — snapshot-to-host instead of sync writes;
  * ``checkpoint_interval_daly``— re-tune the checkpoint interval to the
    Daly/Young optimum ``sqrt(2 * write_cost * slice_MTBF)``;
  * ``compile_cache_warm``      — every launch hits the AOT cache;
  * ``data_pipeline_2x``        — halve input-pipeline stall fractions;
  * ``single_controller``       — migrate multi-client jobs to the
    Pathways-style single-controller framework;
  * ``scheduler_paper_policies``— swap placement/preemption/defrag to the
    paper's policy combination;
  * ``generation_upgrade``      — upgrade every pod to the best hardware
    generation present;
  * ``elastic_resize``          — let every job restart degraded (shed
    slices / halve width) instead of queueing for its full shape;
  * ``multi_slice_gang``        — run every even-width training job as a
    2-slice gang so a failure kills one slice, not the job.

Because the workload generation is hermetic (``scenarios.build_sim``),
every counterfactual run sees the byte-identical job population with only
the knob applied — the MAD-Max/TpuGraphs-style controlled replay that
makes "recovered MPG" a defensible ranking rather than seed noise.
Sweeps inherit ``build_sim``'s default vectorized event core, and the
byte-identity equivalence gate (``tests/test_torch_fleet.py``) is what
licenses that: a what-if delta computed on the fast engine is the same
delta the reference engine would report, bit for bit.

Demand saturation: with a *finite* fixed workload, an optimization mostly
finishes the same work sooner and the saved chip-time shows up as
unallocated capacity, not extra goodput — every knob's recovered MPG
collapses toward zero.  A production fleet has a backlog (the paper's
quarter-scale fleet is demand-rich), so by default ``what_if`` oversizes
the workload to ``SATURATED_LOAD`` of capacity: freed capacity is always
re-consumed and recovered MPG measures real extra throughput.  Trace
baselines are never resized (the rebuilt sim must reproduce the recorded
footer bit-for-bit before any delta is trusted); pass ``saturate=None``
to opt a preset out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

from repro_torch.core.attribution import AttributionWaterfall
from repro_torch.core.goodput import GoodputReport
from repro_torch.fleet.generations import GENERATIONS
from repro_torch.fleet.job import JobSpec
from repro_torch.fleet.scenarios import SCENARIOS, Scenario, build_sim
from repro_torch.fleet.sim import SimConfig
from repro_torch.fleet.trace import Trace

# the fleet-wide per-chip MTBF and async-snapshot device pause the
# simulator assumes (scenario shocks scale the MTBF via
# Scenario.mtbf_factor) — read from SimConfig so a retune there cannot
# silently desynchronize the Daly-optimum knob
_SIM_DEFAULTS = SimConfig()
CHIP_MTBF = _SIM_DEFAULTS.chip_mtbf
ASYNC_SNAPSHOT_PAUSE = _SIM_DEFAULTS.async_snapshot_pause

# default demand oversizing for preset/scenario baselines (see module
# docstring): work sized to 1.5x capacity keeps every counterfactual run
# backlogged, so recovered capacity converts into measured goodput
SATURATED_LOAD = 1.5


@dataclasses.dataclass(frozen=True)
class Case:
    """One runnable counterfactual: a scenario plus build_sim kwargs and
    an optional per-job rewrite applied to the generated workload."""
    scenario: Scenario
    kwargs: Dict[str, object]
    job_mutator: Optional[Callable[[JobSpec], JobSpec]] = None

    def with_jobs(self, fn: Callable[[JobSpec], JobSpec]) -> "Case":
        prev = self.job_mutator
        chained = fn if prev is None else (lambda j: fn(prev(j)))
        return dataclasses.replace(self, job_mutator=chained)

    def with_kwargs(self, **kw) -> "Case":
        return dataclasses.replace(self, kwargs={**self.kwargs, **kw})

    def with_scenario(self, scenario: Scenario) -> "Case":
        return dataclasses.replace(self, scenario=scenario)


@dataclasses.dataclass(frozen=True)
class Knob:
    """One counterfactual optimization: name, the MPG term it targets
    (for reporting), and a Case -> Case transform.

    ``addresses`` names the waterfall loss buckets the knob can recover
    from; when the baseline shows zero chip-time in every listed bucket,
    ``what_if`` skips the resimulation outright (recovered is 0.0 by
    construction — there is nothing to recover).  ``skip_when`` is a
    structural predicate on the Case for knobs whose no-op condition is
    not a loss bucket (e.g. the policies are already the paper combo).
    An empty ``addresses`` with no predicate means always resimulate."""
    name: str
    description: str
    targets: str                      # "SG" | "RG" | "PG" (primary term)
    build: Callable[[Case], Case]
    addresses: tuple = ()             # loss-bucket names (see LOSS_BUCKETS)
    skip_when: Optional[Callable[[Case], bool]] = None


def _daly_interval(spec: JobSpec, mtbf_factor: float) -> float:
    """Daly/Young first-order optimal checkpoint interval for the job's
    slice: sqrt(2 * write_cost * slice_MTBF), clamped to [60s, 1d]."""
    slice_mtbf = CHIP_MTBF * mtbf_factor / max(1, spec.chips)
    write = (ASYNC_SNAPSHOT_PAUSE if spec.async_checkpoint
             else spec.checkpoint_write)
    return min(86400.0, max(60.0, math.sqrt(2.0 * write * slice_mtbf)))


def _best_generation(gens) -> str:
    return max(gens, key=lambda g: GENERATIONS[g].peak_flops_bf16)


def _knob_async(case: Case) -> Case:
    return case.with_jobs(
        lambda j: dataclasses.replace(j, async_checkpoint=True))


def _knob_daly(case: Case) -> Case:
    factor = case.scenario.mtbf_factor
    return case.with_jobs(lambda j: dataclasses.replace(
        j, checkpoint_interval=_daly_interval(j, factor)))


def _knob_cache(case: Case) -> Case:
    return case.with_jobs(
        lambda j: dataclasses.replace(j, compile_cache_hit=True))


def _knob_data(case: Case) -> Case:
    return case.with_jobs(lambda j: dataclasses.replace(
        j, data_stall_frac=j.data_stall_frac * 0.5))


def _knob_pathways(case: Case) -> Case:
    return case.with_jobs(
        lambda j: dataclasses.replace(j, framework="jax-pathways"))


def _knob_policies(case: Case) -> Case:
    return case.with_kwargs(placement="best_fit", preemption="protect_xl",
                            defrag="drain_for_xl")


def _knob_elastic(case: Case) -> Case:
    return case.with_jobs(lambda j: dataclasses.replace(j, elastic=True))


def _knob_gang(case: Case) -> Case:
    # widen coverage beyond the workload's default gang band: any still-
    # single-slice training job of even width splits into a 2-slice gang
    return case.with_jobs(lambda j: dataclasses.replace(j, n_slices=2)
                          if j.phase_kind == "train" and j.n_slices == 1
                          and j.chips >= 2 and j.chips % 2 == 0 else j)


def _knob_generation(case: Case) -> Case:
    gens = case.scenario.pod_generations
    if not gens:
        return case                   # already homogeneous: a no-op
    best = _best_generation(gens)
    return case.with_scenario(dataclasses.replace(
        case.scenario, name=f"{case.scenario.name}+upgrade",
        pod_generations=(best,)))


_PAPER_POLICIES = {"placement": "best_fit", "preemption": "protect_xl",
                   "defrag": "drain_for_xl"}


def _already_paper_policies(case: Case) -> bool:
    # build_sim's defaults ARE the paper combo, so an absent kwarg means
    # the knob would rebuild the byte-identical sim
    return all(case.kwargs.get(k, v) == v for k, v in
               _PAPER_POLICIES.items())


def _homogeneous_fleet(case: Case) -> bool:
    return len(set(case.scenario.pod_generations)) <= 1


KNOBS: Dict[str, Knob] = {k.name: k for k in (
    Knob("async_checkpointing",
         "async snapshot-to-host checkpoints for every job", "RG",
         _knob_async, addresses=("checkpoint_write",)),
    Knob("checkpoint_interval_daly",
         "re-tune checkpoint intervals to sqrt(2*write*MTBF)", "RG",
         _knob_daly, addresses=("checkpoint_write", "failure_rollback",
                                "preemption_rollback")),
    Knob("compile_cache_warm",
         "every launch hits the AOT compile cache", "RG", _knob_cache,
         addresses=("compile",)),
    Knob("data_pipeline_2x",
         "halve input-pipeline stall fractions", "RG", _knob_data,
         addresses=("input_stall",)),
    Knob("single_controller",
         "migrate multi-client jobs to the single-controller framework",
         "RG", _knob_pathways),
    Knob("scheduler_paper_policies",
         "swap to best-fit placement + protect-XL preemption + "
         "drain-for-XL defrag", "SG", _knob_policies,
         skip_when=_already_paper_policies),
    Knob("generation_upgrade",
         "upgrade every pod to the best hardware generation present",
         "PG", _knob_generation, skip_when=_homogeneous_fleet),
    Knob("elastic_resize",
         "restart preempted/failed jobs degraded instead of queueing "
         "for the full shape", "SG", _knob_elastic),
    Knob("multi_slice_gang",
         "run every even-width training job as a 2-slice gang "
         "(failures kill a slice, not the job)", "RG", _knob_gang),
)}


# ---------------------------------------------------------------------------
# baseline construction
# ---------------------------------------------------------------------------

def baseline_case(source: Union[str, Scenario, Trace], **kwargs) -> Case:
    """A Case from a preset name, a Scenario, or a recorded Trace."""
    if isinstance(source, Trace):
        if kwargs:
            # silently ignoring overrides would return a plausible report
            # for a configuration the caller never asked for
            raise ValueError(
                "a Trace baseline is fully determined by its recorded "
                f"header; overrides {sorted(kwargs)} cannot apply — "
                "call what_if on the preset/Scenario instead")
        return from_trace(source)
    if isinstance(source, str):
        if source not in SCENARIOS:
            raise ValueError(f"unknown scenario preset {source!r}; "
                             f"choose from {sorted(SCENARIOS)}")
        source = SCENARIOS[source]
    kwargs = dict(kwargs)
    # job_mutator is a Case field, not a build_sim kwarg, so knob mutators
    # chain onto it instead of silently replacing it
    job_mutator = kwargs.pop("job_mutator", None)
    return Case(scenario=source, kwargs=kwargs, job_mutator=job_mutator)


def from_trace(trace: Trace) -> Case:
    """Rebuild the exact sim behind a recorded trace from its header.

    Needs the workload-provenance meta that ``scenarios.build_sim``
    stamps (``workload: {n_jobs, size_mix}``) plus the scenario/policy/
    shape fields ``trace.record`` always writes.  ``what_if`` then
    verifies the rebuilt baseline reproduces the trace footer bit-for-bit
    before trusting any counterfactual delta.
    """
    meta = trace.meta
    workload = meta.get("workload")
    if not workload:
        raise ValueError(
            "trace has no workload-provenance meta (recorded before the "
            "advisor existed, or from a hand-built sim); re-record via "
            "scenarios.build_sim, or call what_if on the preset directly")
    scenario = meta.get("scenario")
    if scenario not in SCENARIOS:
        raise ValueError(f"trace scenario {scenario!r} is not a known "
                         f"preset; choose from {sorted(SCENARIOS)}")
    size_mix = workload.get("size_mix")
    pg_table = workload.get("pg_table")
    return Case(scenario=SCENARIOS[scenario], kwargs=dict(
        n_jobs=workload["n_jobs"], seed=meta["seed"],
        n_pods=meta["n_pods"], pod_size=meta["pod_size"],
        horizon=meta["horizon"], placement=meta["placement"],
        preemption=meta["preemption"], defrag=meta["defrag"],
        # older traces predate the repair-window knob; default 0 matches
        # the behaviour they were recorded under
        slice_repair_s=meta.get("slice_repair_s", 0.0),
        # pair lists preserve the insertion order the workload's size
        # picker depends on (trace JSON sorts plain dict keys)
        size_mix=dict(size_mix) if size_mix else None,
        pg_table=dict(pg_table) if pg_table else {}))


# ---------------------------------------------------------------------------
# the what-if engine
# ---------------------------------------------------------------------------

def run_case(case: Case):
    """Simulate one case on a fresh streaming ledger with an attribution
    waterfall attached; returns (sim, report, waterfall)."""
    sim = build_sim(case.scenario, job_mutator=case.job_mutator,
                    retain_intervals=False,
                    **{k: v for k, v in case.kwargs.items()
                       if k != "retain_intervals"})
    wf = AttributionWaterfall().attach(sim.ledger)
    sim.run()
    wf.assert_conserves(sim.ledger)   # every advisor run is self-checking
    return sim, sim.report(), wf


def _composition(rep: GoodputReport) -> Dict[str, float]:
    return {"SG": rep.sg, "RG": rep.rg, "PG": rep.pg, "MPG": rep.mpg}


def _should_skip(knob: Knob, case: Case,
                 base_buckets: Dict[str, float]) -> bool:
    """True when the baseline proves the knob can recover nothing: its
    structural no-op predicate holds, or every loss bucket it addresses
    holds zero chip-time."""
    if knob.skip_when is not None and knob.skip_when(case):
        return True
    if knob.addresses:
        return all(base_buckets.get(b, 0.0) == 0.0 for b in knob.addresses)
    return False


def what_if(source: Union[str, Scenario, Trace],
            knobs: Optional[List[str]] = None,
            saturate: Union[str, float, None] = "auto",
            skip_unaddressable: bool = True,
            **kwargs) -> Dict[str, object]:
    """Rank counterfactual knobs by recovered MPG on one baseline.

    Returns a JSON-ready report: the baseline MPG composition and
    attribution waterfall, plus one row per knob — its counterfactual
    composition, the recovered MPG (and per-term deltas), and the
    recovered ideal chip-time ``d_MPG * capacity`` — sorted largest
    recovery first.

    ``saturate``: target demand load for the workload ("auto" =
    ``SATURATED_LOAD`` for presets/scenarios, untouched for traces —
    see the module docstring; ``None`` = keep the scenario's own load).

    ``skip_unaddressable``: early-exit knobs whose addressable loss is
    provably zero in the baseline waterfall (or whose structural no-op
    predicate holds) instead of resimulating them — their rows report the
    baseline composition, ``recovered_mpg: 0.0``, and ``skipped: true``.
    The ranking is unchanged: a skipped knob's resimulation would rebuild
    the byte-identical sim (see ``tests/test_torch_fleet_advisor.py``).
    """
    case = baseline_case(source, **kwargs)
    if saturate == "auto":
        saturate = None if isinstance(source, Trace) else SATURATED_LOAD
    if saturate is not None:
        case = case.with_scenario(dataclasses.replace(
            case.scenario, target_load=float(saturate)))
    base_sim, base_rep, base_wf = run_case(case)
    baseline: Dict[str, object] = {
        **_composition(base_rep),
        "capacity_chip_time": base_rep.capacity_chip_time,
        "target_load": case.scenario.target_load,
        "waterfall": base_wf.report(),
    }
    if isinstance(source, Trace):
        # controlled-replay guard: the rebuilt baseline must reproduce
        # the recorded footer exactly, or the deltas mean nothing
        rebuilt = base_sim.ledger.totals()
        if rebuilt != source.totals:
            raise ValueError(
                "rebuilt baseline does not reproduce the trace footer — "
                "the trace was recorded under different simulator "
                f"behaviour\n  recorded: {source.totals}\n"
                f"  rebuilt:  {rebuilt}")
        baseline["reproduces_trace"] = True

    names = list(KNOBS) if knobs is None else list(knobs)
    base_buckets = base_wf.bucket_totals()
    rows = []
    for name in names:
        knob = KNOBS[name]
        skipped = skip_unaddressable and _should_skip(knob, case,
                                                      base_buckets)
        rep = base_rep if skipped else run_case(knob.build(case))[1]
        rows.append({
            "knob": name,
            "description": knob.description,
            "targets": knob.targets,
            **_composition(rep),
            "recovered_mpg": rep.mpg - base_rep.mpg,
            "d_sg": rep.sg - base_rep.sg,
            "d_rg": rep.rg - base_rep.rg,
            "d_pg": rep.pg - base_rep.pg,
            "recovered_ideal_chip_time":
                (rep.mpg - base_rep.mpg) * base_rep.capacity_chip_time,
            "skipped": skipped,
        })
    rows.sort(key=lambda r: (-r["recovered_mpg"], r["knob"]))
    return {"scenario": case.scenario.name,
            "baseline": baseline,
            "ranking": rows}


def knob_names() -> List[str]:
    return sorted(KNOBS)
