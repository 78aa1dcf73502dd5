"""The port's copy of ``repro.fleet.sim``, unchanged in behaviour (the
port imports nothing of the reference package).

Discrete-event fleet simulator (paper §3.2 / §5.3).

Event-driven: job arrivals, completions, chip failures, preemptions.
Per-run-segment accounting is analytic (checkpoint cycles are folded into a
productive-rate factor) so a month of fleet time with thousands of jobs
simulates in milliseconds while emitting the exact same Interval ledger the
MPG metric consumes.

Scheduler policy (paper §5.3, Fig. 16) is *pluggable* — strategy objects
from ``repro_torch.fleet.policies`` injected via ``SimConfig``; the defaults
reproduce the paper's policy:
  * topology-aware best-fit placement into buddy-allocated pod slices;
  * preemption prefers MEDIUM victims — evicting XL jobs cascades (huge
    restart cost), and SMALL jobs finish soon anyway;
  * defragmentation: when the queue head cannot fit due to fragmentation,
    small movable jobs are migrated (checkpoint-resume) to coalesce slices.

Accounting streams into a ``repro_torch.core.ledger.GoodputLedger`` (shared
across layers/clusters when one is injected); ``sim.intervals`` remains
available when ``SimConfig.retain_intervals`` is on (the default).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from collections import defaultdict
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

from repro_torch.core.goodput import (Interval, Layer, Phase,
                                      generation_pg_weights)
from repro_torch.core.ledger import GoodputLedger
from repro_torch.fleet.cluster import REPAIR_TAG, SLICE_SEP, Cluster, owner_of
from repro_torch.fleet.job import JobRuntime, JobSpec
from repro_torch.fleet.policies import (DefragPolicy, PlacementPolicy,
                                        PreemptionPolicy, resolve_defrag,
                                        resolve_placement, resolve_preemption)
from repro_torch.parallel.reshard import reshard_seconds

if TYPE_CHECKING:                     # import cycle: scenarios builds sims
    from repro_torch.fleet.scenarios import Scenario

MAINT_TAG = "__maint__"               # sentinel allocation id prefix for
                                      # drained (in-maintenance) pods

# Per-generation repair-time distributions (ROADMAP repair-realism item):
# ``SimConfig.slice_repair_s`` stays the fleet-wide *scale* knob, but the
# actual window is that scale times a lognormal multiplier drawn on the
# sim's dedicated repair stream — older generations take longer to source
# parts for and vary more; the newest generation repairs tightest.  The
# (mu, sigma) pairs are of the underlying normal, so the median multiplier
# is e**mu (~1.0: the configured scale remains the typical repair).
REPAIR_LOGNORMAL: Dict[str, Tuple[float, float]] = {
    "tpu-v4": (0.15, 0.60),
    "tpu-v5e": (0.0, 0.45),
    "tpu-v5p": (-0.10, 0.35),
}
_REPAIR_LOGNORMAL_DEFAULT = (0.0, 0.45)


@dataclasses.dataclass
class SimConfig:
    n_pods: int = 8
    pod_size: int = 256
    horizon: float = 7 * 24 * 3600.0
    chip_mtbf: float = 150.0 * 24 * 3600     # seconds per chip failure
    seed: int = 0
    xl_assembly_per_pod: float = 60.0        # PARTIAL time per extra pod
    defrag_migration_cost: float = 45.0      # seconds to move a small job
    preempt_protect_xl: bool = True          # legacy alias: False selects
                                             # the "priority_only" policy
    async_snapshot_pause: float = 1.5        # device pause per async ckpt
    aging_hours: float = 6.0                 # queue aging: +1 priority / N h
    preempt_gap: float = 1.0                 # min priority advantage to evict
    drain_cap: int = 4                       # max migrations per event
    # hardware repair window: a failed slice's chips stay out of service
    # this many seconds before returning to the allocator.  0 (default)
    # models instant replacement — the failed chips free immediately, so
    # a rigid gang's refill is usually granted on the spot.  >0 makes
    # replacement scarce: rigid gangs hold survivors idle (gang_stall)
    # while elastic gangs keep computing degraded — the resiliency trade
    # benchmarks/resilience.py measures.
    slice_repair_s: float = 0.0
    # pluggable scheduler policies (name or strategy object; see
    # repro_torch.fleet.policies for the registries)
    placement: Union[str, PlacementPolicy] = "best_fit"
    preemption: Union[str, PreemptionPolicy] = "protect_xl"
    defrag: Union[str, DefragPolicy] = "drain_for_xl"
    # accounting
    retain_intervals: bool = True            # keep raw Interval list
    ledger_window: float = 3600.0            # MPG time-series bucket (s)
    # telemetry sampling cadence (seconds); None keeps the historical
    # horizon/200 coupling — set explicitly for year-horizon runs so the
    # windowed-series resolution does not silently change with horizon
    sample_dt: Optional[float] = None
    # event-core engine: "vectorized" (default; same decisions + rng
    # streams, batched accounting and memoized scheduling) or "reference"
    # (the legacy per-event engine, the equivalence-gate baseline)
    engine: str = "vectorized"
    # fleet conditions (diurnal load, maintenance drains, failure bursts,
    # heterogeneous pod generations) — see repro_torch.fleet.scenarios
    scenario: Optional["Scenario"] = None

    def __post_init__(self):
        if self.engine not in ("reference", "vectorized"):
            raise ValueError(
                f"SimConfig.engine must be 'reference' or 'vectorized', "
                f"got {self.engine!r}")
        if self.sample_dt is not None and not self.sample_dt > 0:
            raise ValueError(
                f"SimConfig.sample_dt must be > 0, got {self.sample_dt!r}")
        if self.slice_repair_s < 0:
            raise ValueError(f"SimConfig.slice_repair_s must be >= 0, "
                             f"got {self.slice_repair_s!r}")


class FleetSim:
    def __new__(cls, cfg: SimConfig, *args, **kwargs):
        # `FleetSim(cfg)` honours cfg.engine: the vectorized subclass is
        # decision-identical (same policies, same rng streams) but runs
        # the hot path through caches and batched ledger ingest.  Explicit
        # subclass construction bypasses the dispatch.
        if cls is FleetSim and cfg.engine == "vectorized":
            from repro_torch.fleet.vectorized import VectorizedFleetSim
            return super().__new__(VectorizedFleetSim)
        return super().__new__(cls)

    def __init__(self, cfg: SimConfig, ledger: Optional[GoodputLedger] = None,
                 keep_intervals: Optional[bool] = None):
        """``keep_intervals`` overrides ``cfg.retain_intervals`` for the
        auto-created ledger — the opt-out for month-scale attribution
        runs that must stay O(1) memory (ignored when a shared ``ledger``
        is injected; its own retention setting wins)."""
        self.cfg = cfg
        self.cluster = self._make_cluster(cfg)
        self.rng = random.Random(cfg.seed)
        self.now = 0.0
        self.events: List[Tuple[float, int, str, str]] = []
        self._seq = 0
        self.jobs: Dict[str, JobRuntime] = {}
        self.queue: List[str] = []
        self.running: Dict[str, dict] = {}     # job_id -> segment info
        self.telemetry: List[dict] = []
        self._epoch: Dict[str, int] = defaultdict(int)
        self._queued_since: Dict[str, float] = {}
        # jobs whose current wait is preemption/failure-induced: that wait is
        # PARTIAL (counts against per-class SG, paper Fig. 16) rather than
        # initial QUEUED (a fleet-capacity matter, not a per-job one).
        self._requeued: set = set()
        # gang bookkeeping: live slice-allocation ids per job (single-slice
        # jobs allocate under their bare id), a monotonic per-job slice
        # counter (dead slice ids are never reused), and rigid gangs whose
        # survivors hold their allocation while waiting for a replacement
        # slice ({"t0": wait start})
        self._slices: Dict[str, List[str]] = {}
        self._slice_seq: Dict[str, int] = defaultdict(int)
        self._gang_wait: Dict[str, dict] = {}
        self._repair_seq = 0                 # monotonic repair sentinel ids
        # repair-time sampling stream (drawn only under a repair window,
        # so the default slice_repair_s=0 stays byte-identical)
        self._repair_rng = random.Random(f"{cfg.seed}:repair")
        # online adaptive controller (repro_torch.fleet.controller): None means
        # static policies for the whole run — the historical behaviour
        self.controller = None
        # fleet-wide elastic-resize override: None defers to each job's
        # spec.elastic flag; True/False is the controller forcing it
        self._elastic_override: Optional[bool] = None
        # running elastic jobs currently below their submitted shape, in
        # degradation order (a dict, not a set: iteration order must be
        # deterministic and identical across engines)
        self._degraded: Dict[str, None] = {}
        # scheduler policies (cfg.preempt_protect_xl=False is the legacy
        # spelling of the priority_only ablation)
        preemption = cfg.preemption
        if preemption == "protect_xl" and not cfg.preempt_protect_xl:
            preemption = "priority_only"
        self.placement = resolve_placement(cfg.placement)
        self.preemption = resolve_preemption(preemption)
        self.defrag = resolve_defrag(cfg.defrag)
        # scenario conditions (repro_torch.fleet.scenarios).  Randomness that a
        # scenario introduces runs on its own seeded stream so composing a
        # modifier cannot perturb the base failure/workload streams — the
        # determinism audit's per-component-rng rule.
        self.pod_generation: List[str] = ["tpu-v5e"] * cfg.n_pods
        self.pod_factor: List[float] = [1.0] * cfg.n_pods
        self._mtbf_factor = 1.0
        self._burst_rng = random.Random(f"{cfg.seed}:bursts")
        self._maint_depth: Dict[int, int] = defaultdict(int)
        scn = cfg.scenario
        if scn is not None:
            self._mtbf_factor = scn.mtbf_factor
            if scn.pod_generations:
                gens = [scn.pod_generations[i % len(scn.pod_generations)]
                        for i in range(cfg.n_pods)]
                weights = generation_pg_weights(gens)
                self.pod_generation = gens
                self.pod_factor = [weights[g] for g in gens]
            for mw in scn.maintenance:
                pid = mw.pod % cfg.n_pods
                self._push(mw.start_frac * cfg.horizon, "maint_start",
                           str(pid))
                self._push(mw.end_frac * cfg.horizon, "maint_end", str(pid))
            for idx, burst in enumerate(scn.bursts):
                self._push(burst.at_frac * cfg.horizon, "burst", str(idx))
        # accounting: one streaming ledger, optionally shared fleet-wide
        retain = (cfg.retain_intervals if keep_intervals is None
                  else keep_intervals)
        self.ledger = ledger if ledger is not None else GoodputLedger(
            window=cfg.ledger_window,
            retain_intervals=retain)
        self.ledger.add_capacity(self.capacity_chip_time)

    def _make_cluster(self, cfg: SimConfig) -> Cluster:
        """Engine hook: the vectorized engine substitutes an indexed,
        cache-backed cluster with identical allocation behaviour."""
        return Cluster(cfg.n_pods, cfg.pod_size)

    @property
    def intervals(self) -> List[Interval]:
        """The raw event stream (requires ``retain_intervals``)."""
        if self.ledger.intervals is None:
            raise AttributeError(
                "interval retention is off (SimConfig.retain_intervals="
                "False); use the streaming ledger reports instead")
        return self.ledger.intervals

    # ---- event plumbing -------------------------------------------------
    def _push(self, t: float, kind: str, payload: str):
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, payload))

    def submit(self, spec: JobSpec):
        self.jobs[spec.job_id] = JobRuntime(spec)
        self._push(spec.arrival, "arrival", spec.job_id)

    # ---- interval ledger -------------------------------------------------
    def _emit(self, job: JobRuntime, phase: Phase, t0: float, t1: float,
              layer: Layer, gen: Optional[Tuple[str, float]] = None,
              chips: Optional[int] = None):
        """``chips`` overrides the spec width for intervals narrower than
        the job (a rigid gang's surviving slices stalling on a dead one)."""
        if t1 <= t0:
            return
        s = job.spec
        segment = {
            "size_class": s.size_class, "phase_kind": s.phase_kind,
            "arch": s.arch, "framework": s.framework,
            "ckpt": "async" if s.async_checkpoint else "sync",
            "emitter": "fleet", "layer": layer.value,
        }
        pg = s.pg
        if gen is not None:
            # heterogeneous fleet: ideal time normalizes to the best
            # generation present, so STEP on a slower pod carries a lower
            # effective PG (paper §3.1 / §4.2)
            segment["generation"] = gen[0]
            pg = s.pg * gen[1]
        self.ledger.emit(job_id=s.job_id, phase=phase, t0=t0, t1=t1,
                         chips=s.chips if chips is None else chips,
                         segment=segment, pg=pg)

    def _gen_of(self, job_id: str) -> Tuple[str, float]:
        """(generation name, PG weight) of a job's current allocation;
        multi-pod and multi-slice allocations average their pods'
        weights."""
        pods: List[int] = []
        for sid in self._slices.get(job_id, ()):
            alloc = self.cluster.allocations.get(sid)
            if alloc is None:
                continue
            if alloc.pod >= 0:
                pods.append(alloc.pod)
            else:
                pods.extend(alloc.pods)
        if not pods:
            return "tpu-v5e", 1.0
        gens = {self.pod_generation[p] for p in pods}
        factor = sum(self.pod_factor[p] for p in pods) / len(pods)
        return (gens.pop() if len(gens) == 1 else "mixed"), factor

    # ---- productive-rate model -------------------------------------------
    def _rates(self, s: JobSpec) -> Tuple[float, float, float]:
        """Fractions of allocated wall time in (step, ckpt, stall)."""
        if s.async_checkpoint:
            ckpt_overhead = self.cfg.async_snapshot_pause / s.checkpoint_interval
        else:
            ckpt_overhead = s.checkpoint_write / s.checkpoint_interval
        stall = s.effective_stall()
        # floor: even a pathologically stalled job makes some progress
        step = max(0.02, 1.0 - ckpt_overhead - stall)
        stall = max(0.0, min(stall, 1.0 - step - ckpt_overhead))
        return step, ckpt_overhead, stall

    # ---- live control hooks ----------------------------------------------
    def _job_elastic(self, spec: JobSpec) -> bool:
        """Whether ``spec`` resizes elastically right now: the spec's own
        flag unless the adaptive controller forced a fleet-wide override."""
        ov = self._elastic_override
        return spec.elastic if ov is None else ov

    def set_policies(self, placement=None, preemption=None,
                     defrag=None) -> None:
        """Swap live scheduler policy objects mid-run (the adaptive
        controller's switch hook; names or strategy objects, None keeps
        the current one).  Engine subclasses re-derive policy-dependent
        caches here."""
        if placement is not None:
            self.placement = resolve_placement(placement)
        if preemption is not None:
            self.preemption = resolve_preemption(preemption)
        if defrag is not None:
            self.defrag = resolve_defrag(defrag)

    def attach_controller(self, controller) -> None:
        """Register an online adaptive controller and schedule its first
        decision boundary; the run loop hands it the sim on every timed
        ``control`` event (see ``repro_torch.fleet.controller``)."""
        self.controller = controller
        self._push(controller.decide_every_s, "control", "")

    def _control_sync(self) -> None:
        """Engine hook: bring the ledger/waterfall state current before a
        controller observation.  The reference engine emits per event, so
        there is nothing to do; the vectorized engine flushes its columnar
        buffers here so both engines decide on identical state."""

    def _on_control(self, t: float) -> None:
        self._control_sync()
        self.controller.on_boundary(self)
        nxt = t + self.controller.decide_every_s
        if nxt <= self.cfg.horizon:
            self._push(nxt, "control", "")

    # ---- scheduling ------------------------------------------------------
    def _eff_priority(self, job_id: str) -> float:
        """Priority with aging: +1 level per 6h queued (starvation guard)."""
        base = self.jobs[job_id].spec.priority
        if job_id in self._requeued:
            base += 1.0   # preempted/failed jobs resume ahead of new work
        waited = self.now - self._queued_since.get(job_id, self.now)
        return base + waited / (self.cfg.aging_hours * 3600.0)

    # ---- gang-aware allocation -------------------------------------------
    def _place(self, alloc_id: str, chips: int,
               exclude: tuple = ()):
        """Engine hook: one placement-policy allocation (the vectorized
        engine substitutes its failure-memoized variant)."""
        return self.placement.alloc(self.cluster, alloc_id, chips,
                                    exclude=exclude)

    def _alloc_job(self, job_id: str, spec: JobSpec,
                   exclude: tuple = ()) -> bool:
        """Allocate every slice of ``spec`` (one allocation under the bare
        id for single-slice jobs); rolls back on partial failure."""
        if spec.n_slices == 1:
            if self._place(job_id, spec.chips, exclude) is None:
                return False
            self._slices[job_id] = [job_id]
            return True
        per = spec.slice_chips
        ids: List[str] = []
        for _ in range(spec.n_slices):
            self._slice_seq[job_id] += 1
            sid = f"{job_id}{SLICE_SEP}{self._slice_seq[job_id]}"
            if self._place(sid, per, exclude) is None:
                for done in ids:
                    self.cluster.release(done)
                return False
            ids.append(sid)
        self._slices[job_id] = ids
        return True

    def _release_job(self, job_id: str):
        self._degraded.pop(job_id, None)
        for sid in self._slices.pop(job_id, (job_id,)):
            self.cluster.release(sid)

    def _evict_gang_wait(self, job_id: str):
        """Close a rigid gang's replacement wait: book the survivors' hold
        as hardware-layer IDLE (gang_stall), free everything, requeue."""
        w = self._gang_wait.pop(job_id)
        job = self.jobs[job_id]
        s = job.spec
        self._emit(job, Phase.IDLE, w["t0"], self.now,
                   layer=Layer.HARDWARE, chips=s.chips - s.slice_chips)
        self._release_job(job_id)
        self._queued_since[job_id] = self.now
        self._requeued.add(job_id)
        self.queue.append(job_id)

    def _refill_gangs(self, drain: tuple):
        """Try to grant each waiting rigid gang its replacement slice; on
        success the survivors' wait books as hardware-layer IDLE and the
        gang restarts from checkpoint at full width."""
        for job_id in list(self._gang_wait):
            job = self.jobs[job_id]
            s = job.spec
            exclude = drain if s.slice_chips <= self.cfg.pod_size else ()
            self._slice_seq[job_id] += 1
            sid = f"{job_id}{SLICE_SEP}{self._slice_seq[job_id]}"
            if self._place(sid, s.slice_chips, exclude) is None:
                continue
            w = self._gang_wait.pop(job_id)
            self._slices[job_id].append(sid)
            self._emit(job, Phase.IDLE, w["t0"], self.now,
                       layer=Layer.HARDWARE, chips=s.chips - s.slice_chips)
            self._start_segment(job)

    def _retire_slice(self, sid: str):
        """Free a failed slice's hardware — immediately when repair is
        instant (``slice_repair_s == 0``, byte-identical to the historical
        behaviour), otherwise held under a repair sentinel until a timed
        ``repair`` event returns the chips to the allocator.  The window
        is ``slice_repair_s`` scaled by the failed slice's generation-
        specific lognormal draw (``REPAIR_LOGNORMAL``) on the dedicated
        repair stream."""
        repair = self.cfg.slice_repair_s
        if repair <= 0:
            self.cluster.release(sid)
            return
        repair *= self._sample_repair_factor(sid)
        self._repair_seq += 1
        tag = f"{REPAIR_TAG}{self._repair_seq}"
        self.cluster.retag(sid, tag)
        self._push(self.now + repair, "repair", tag)

    def _sample_repair_factor(self, sid: str) -> float:
        """Lognormal repair-time multiplier for the generation of the
        failed slice's (first) pod; must run before the slice is retagged
        (the allocation lookup goes away with the original id)."""
        alloc = self.cluster.allocations.get(sid)
        pod = 0
        if alloc is not None:
            pod = alloc.pod if alloc.pod >= 0 else alloc.pods[0]
        mu, sigma = REPAIR_LOGNORMAL.get(self.pod_generation[pod],
                                         _REPAIR_LOGNORMAL_DEFAULT)
        return self._repair_rng.lognormvariate(mu, sigma)

    def _regrow_elastic(self, drain: tuple):
        """Grow running degraded elastic jobs back toward their submitted
        shape as capacity frees (checkpoint-restart at the wider shape,
        paying the reshard transfer back up).

        Only runs under a repair window (``slice_repair_s > 0``): with
        instant repair the failed chips free on the spot, so a degraded
        job's own dead slice would be immediately re-grantable and the
        degrade/regrow pair would collapse into restart churn — the
        requeue-time regrow in :meth:`_sched_one` already covers that
        idealized regime."""
        if self.cfg.slice_repair_s <= 0 or not self._degraded:
            return
        for job_id in list(self._degraded):
            job = self.jobs[job_id]
            s = job.spec
            exclude = drain if s.slice_chips <= self.cfg.pod_size else ()
            if job.target_slices > 1:
                # gang: re-admit slices one at a time
                grown = False
                while job.spec.n_slices < job.target_slices:
                    self._slice_seq[job_id] += 1
                    sid = f"{job_id}{SLICE_SEP}{self._slice_seq[job_id]}"
                    if self._place(sid, s.slice_chips, exclude) is None:
                        break
                    if not grown:
                        grown = True
                        self._stop_segment(job, lost=False)  # ckpt-resume
                    self._slices[job_id].append(sid)
                    k = job.spec.n_slices + 1
                    job.spec = dataclasses.replace(
                        job.spec, chips=s.slice_chips * k, n_slices=k)
                if grown:
                    self._start_segment(job)
            else:
                # halved single-slice job: place the full shape first
                # (under a scratch id, so failure leaves the job
                # untouched), then swap allocations
                tmp = f"{job_id}{SLICE_SEP}grow"
                if self._place(tmp, job.target_chips, exclude) is None:
                    continue
                self._stop_segment(job, lost=False)          # ckpt-resume
                self.cluster.release(job_id)
                self.cluster.retag(tmp, job_id)
                job.spec = dataclasses.replace(s, chips=job.target_chips)
                self._start_segment(job)
            if job.spec.chips >= job.target_chips:
                self._degraded.pop(job_id, None)

    def _slice_failure(self, job: JobRuntime, rng: random.Random):
        """A hardware failure hits one slice of ``job`` (the whole job for
        single-slice specs).  Elastic gangs shed the dead slice and restart
        in place on the survivors (paying the reshard transfer); rigid
        gangs hold the survivors and wait for a replacement slice.  The
        dead slice's chips go to repair (:meth:`_retire_slice`)."""
        s = job.spec
        job_id = s.job_id
        job.failures += 1
        self._stop_segment(job, lost=True)       # hardware rollback
        if s.n_slices > 1:
            k = rng.randrange(s.n_slices)        # which slice died
            sid = self._slices[job_id].pop(k)
            self._retire_slice(sid)
            if job.remaining <= 0:
                self._release_job(job_id)
                return
            if self._job_elastic(s):
                # degrade: reshard onto the surviving slices, in place
                job.spec = dataclasses.replace(
                    s, chips=s.slice_chips * (s.n_slices - 1),
                    n_slices=s.n_slices - 1)
                self._start_segment(job)
                self._degraded[job_id] = None
            else:
                self._gang_wait[job_id] = {"t0": self.now}
            return
        self._degraded.pop(job_id, None)
        for sid in self._slices.pop(job_id, (job_id,)):
            self._retire_slice(sid)
        if job.remaining > 0:
            self._queued_since[job_id] = self.now
            self._requeued.add(job_id)
            self.queue.append(job_id)

    def _drain_for_xl(self) -> tuple:
        """When a multi-pod job queues, reserve + drain pods chosen by the
        defrag policy (the paper's defragmentation at pod granularity)."""
        drain = tuple(self.defrag.drain_pods(self))
        migrated = 0
        for pid in drain:
            seen = set()
            for alloc_id in list(self.cluster.pod_jobs(pid)):
                if migrated >= self.cfg.drain_cap:  # churn cap per event
                    break
                job_id = owner_of(alloc_id)
                if job_id not in self.jobs or job_id in seen:
                    continue   # maintenance reservation / other gang slice
                seen.add(job_id)
                v = self.jobs[job_id]
                if job_id in self._gang_wait:
                    self._evict_gang_wait(job_id)
                    migrated += 1
                    continue
                if v.spec.chips > 64:   # migrate only small/medium
                    continue
                self._stop_segment(v, lost=False)   # checkpoint-resume
                self._release_job(job_id)
                if self._alloc_job(job_id, v.spec, exclude=drain):
                    if v.spec.init_time != self.cfg.defrag_migration_cost:
                        v.spec = dataclasses.replace(
                            v.spec, init_time=self.cfg.defrag_migration_cost)
                    # a migration restart's INIT is scheduling-induced
                    self._start_segment(v, init_layer=Layer.SCHEDULING)
                else:
                    self._queued_since[job_id] = self.now
                    self._requeued.add(job_id)
                    self.queue.append(job_id)
                migrated += 1
        return drain

    def _sched_one(self, job: JobRuntime, drain: tuple) -> bool:
        """One queued job's placement attempt; shared verbatim by both
        engines (the vectorized engine substitutes ``_place``)."""
        s = job.spec
        job_id = s.job_id
        exclude = drain if s.slice_chips <= self.cfg.pod_size else ()
        requeued = job_id in self._requeued
        elastic = self._job_elastic(s)
        # regrow: a degraded elastic job first tries its submitted shape
        # (paying the reshard transfer back up on restart)
        if requeued and elastic and s.chips < job.target_chips:
            tgt = dataclasses.replace(s, chips=job.target_chips,
                                      n_slices=job.target_slices)
            if self._alloc_job(job_id, tgt, exclude):
                job.spec = tgt
                self._start_segment(job)
                return True
        if self._alloc_job(job_id, s, exclude):
            self._start_segment(job)
            if elastic and s.chips < job.target_chips:
                self._degraded[job_id] = None
            return True
        if requeued and elastic:
            # elastic resume: a preempted/failed job restarts degraded
            # instead of waiting for the full shape (paper §3.2's
            # utilization/stability trade; work rate scales with chips) —
            # gangs shed slices, single-slice jobs halve.
            if s.n_slices > 1:
                for k in range(s.n_slices - 1, 0, -1):
                    sub = dataclasses.replace(
                        s, chips=s.slice_chips * k, n_slices=k)
                    if self._alloc_job(job_id, sub, exclude):
                        job.spec = sub
                        self._start_segment(job)
                        self._degraded[job_id] = None
                        return True
            elif 2 <= s.chips <= self.cfg.pod_size:
                half = s.chips // 2
                sub = dataclasses.replace(s, chips=half)
                if self._alloc_job(job_id, sub, exclude):
                    job.spec = sub
                    self._start_segment(job)
                    self._degraded[job_id] = None
                    return True
        # defragmentation: migrate small jobs if that frees a slice
        if self._defrag_for(job):
            if self._alloc_job(job_id, job.spec):
                self._start_segment(job)
                return True
        # preemption for high-priority arrivals
        if self._preempt_for(job):
            if self._alloc_job(job_id, job.spec):
                self._start_segment(job)
                return True
        return False

    def _try_schedule(self):
        self.queue.sort(key=lambda j: (-self._eff_priority(j),
                                       self.jobs[j].spec.arrival))
        drain = self._drain_for_xl()
        self._refill_gangs(drain)
        self._regrow_elastic(drain)
        scheduled = []
        for job_id in list(self.queue):
            if self._sched_one(self.jobs[job_id], drain):
                scheduled.append(job_id)
        for j in scheduled:
            self.queue.remove(j)

    def _defrag_for(self, job: JobRuntime) -> bool:
        """Checkpoint-migrate the defrag policy's chosen victim so a slice
        can coalesce for ``job``."""
        victim = self.defrag.migration_victim(self, job)
        if victim is None:
            return False
        v = self.jobs[victim]
        self._stop_segment(v, lost=False)     # checkpoint-resume migration
        self._release_job(victim)
        # instant re-placement elsewhere (cost charged as INIT on restart)
        if self._alloc_job(victim, v.spec):
            # repeated migrations would replace with an identical spec —
            # only rebuild when init_time actually changes
            if v.spec.init_time != self.cfg.defrag_migration_cost:
                v.spec = dataclasses.replace(
                    v.spec, init_time=self.cfg.defrag_migration_cost)
            self._start_segment(v, init_layer=Layer.SCHEDULING)
            return True
        self._queued_since[victim] = self.now
        self._requeued.add(victim)
        self.queue.append(victim)
        return True

    def _preempt_for(self, job: JobRuntime) -> bool:
        """Evict the preemption policy's victims (it guarantees they free
        enough capacity or returns None); the sim books LOST work, requeues
        them, and the caller retries placement."""
        victims = self.preemption.victims_for(self, job)
        if not victims:
            return False
        self._evict_victims(victims)
        return True

    def _evict_victims(self, victims):
        """Shared eviction bookkeeping (both engines, both victim kinds):
        running victims roll back to their checkpoint; a rigid gang caught
        mid-replacement-wait closes its stall and requeues whole."""
        for j in victims:
            v = self.jobs[j]
            if j in self._gang_wait:
                self._evict_gang_wait(j)
                v.preemptions += 1
                continue
            # preemption rollback is a scheduling-layer loss, not hardware
            self._stop_segment(v, lost=True, lost_layer=Layer.SCHEDULING)
            self._release_job(j)
            v.preemptions += 1
            self._queued_since[j] = self.now
            self._requeued.add(j)
            self.queue.append(j)

    # ---- run segments ----------------------------------------------------
    def _start_segment(self, job: JobRuntime,
                       init_layer: Optional[Layer] = None):
        """``init_layer`` attributes this start's INIT time: scheduling
        for defrag/migration restarts; otherwise compiler for a cold
        compile and framework when the AOT cache skips it."""
        s = job.spec
        t = self.now
        q0 = self._queued_since.pop(s.job_id, None)
        if q0 is not None and t > q0:
            wait_phase = (Phase.PARTIAL if s.job_id in self._requeued
                          else Phase.QUEUED)
            self._emit(job, wait_phase, q0, t, layer=Layer.SCHEDULING)
        self._requeued.discard(s.job_id)
        if init_layer is None:
            init_layer = (Layer.FRAMEWORK if s.compile_cache_hit
                          else Layer.COMPILER)
        self._epoch[s.job_id] += 1
        epoch = self._epoch[s.job_id]
        gen = self._gen_of(s.job_id)
        assembly = 0.0
        if s.size_class == "xl":
            assembly = self.cfg.xl_assembly_per_pod * (s.chips // self.cfg.pod_size)
            t += assembly
        init = s.effective_init()
        t += init
        # elastic resize: restarting at a different width re-partitions the
        # checkpointed state — the measured transfer cost (bytes moved
        # between the old and new partition assignments over DCN)
        reshard = 0.0
        if job.last_chips and job.last_chips != s.chips:
            reshard = reshard_seconds(s.arch, job.last_chips, s.chips)
            t += reshard

        step_f, ckpt_f, stall_f = self._rates(s)
        # work rate in reference chip-seconds: slower generations do
        # proportionally less of the job's work per allocated second
        wall_needed = job.remaining / (s.chips * gen[1] * step_f)
        end = t + wall_needed

        # failure sampling over the allocated slice (scenario MTBF shocks
        # scale the base rate)
        rate = s.chips / (self.cfg.chip_mtbf * self._mtbf_factor)
        t_fail = t + self.rng.expovariate(rate) if rate > 0 else math.inf

        # assembly/INIT intervals are emitted at segment *close* (clipped
        # to the stop time), so a kill that lands mid-setup — preemption,
        # maintenance drain, failure burst — cannot leave phantom
        # allocated chip-time beyond the kill (or the horizon)
        seg = {"t_sched": self.now, "assembly": assembly, "init": init,
               "init_layer": init_layer, "reshard": reshard, "t_run0": t,
               "epoch": epoch, "step_f": step_f, "ckpt_f": ckpt_f,
               "stall_f": stall_f, "gen": gen}
        self.running[s.job_id] = seg
        job.started = self.now
        if t_fail < min(end, self.cfg.horizon):
            self._push(t_fail, "failure", f"{s.job_id}:{epoch}")
        elif end <= self.cfg.horizon:
            self._push(end, "complete", f"{s.job_id}:{epoch}")
        # else: runs past horizon; closed at the end of sim

    def _stop_segment(self, job: JobRuntime, lost: bool,
                      lost_layer: Layer = Layer.HARDWARE):
        """Close the running segment at self.now, crediting work.

        ``lost_layer`` attributes the rolled-back work: hardware for
        failures (independent and burst), scheduling for preemptions."""
        s = job.spec
        seg = self.running.pop(s.job_id, None)
        if seg is None:
            return
        t0 = seg["t_run0"]
        gen = seg["gen"]
        # setup phases, clipped to the actual stop time
        t_setup = seg["t_sched"]
        if seg["assembly"] > 0:
            self._emit(job, Phase.PARTIAL, t_setup,
                       min(self.now, t_setup + seg["assembly"]),
                       layer=Layer.SCHEDULING)
            t_setup += seg["assembly"]
        if seg["init"] > 0:
            self._emit(job, Phase.INIT, t_setup,
                       min(self.now, t_setup + seg["init"]),
                       layer=seg["init_layer"], gen=gen)
            t_setup += seg["init"]
        if seg["reshard"] > 0:
            # the resize transfer runs after program bring-up (the restore
            # read IS the re-partition), before productive steps
            self._emit(job, Phase.RESHARD, t_setup,
                       min(self.now, t_setup + seg["reshard"]),
                       layer=Layer.SCHEDULING, gen=gen)
        dur = max(0.0, self.now - t0)
        step_t = dur * seg["step_f"]
        ckpt_t = dur * seg["ckpt_f"]
        stall_t = dur * seg["stall_f"]
        work_rate = s.chips * gen[1]       # reference chip-s per step-second
        work = step_t * work_rate

        # checkpoint survival: work since last checkpoint boundary is lost
        # on failure/preemption (paper §4.3 RG definition)
        cycles = int(step_t // s.checkpoint_interval)
        survived = min(work, cycles * s.checkpoint_interval * work_rate)
        if lost:
            lost_work = work - survived
            credited = survived
        else:
            lost_work = 0.0
            credited = work

        t = t0
        good_t = credited / work_rate
        lost_t = lost_work / work_rate
        self._emit(job, Phase.STEP, t, t + good_t, layer=Layer.MODEL,
                   gen=gen)
        t += good_t
        if lost_t > 0:
            self._emit(job, Phase.LOST, t, t + lost_t, layer=lost_layer,
                       gen=gen)
            t += lost_t
        if ckpt_t > 0:
            self._emit(job, Phase.CHECKPOINT, t, t + ckpt_t,
                       layer=Layer.FRAMEWORK, gen=gen)
            t += ckpt_t
        if stall_t > 0:
            self._emit(job, Phase.DATA_STALL, t, t + stall_t,
                       layer=Layer.DATA, gen=gen)
        job.remaining = max(0.0, job.remaining - credited)
        job.checkpointed += credited
        job.last_chips = s.chips

    # ---- scenario events ---------------------------------------------------
    def _begin_maintenance(self, pod_id: int):
        """Scheduled maintenance: checkpoint-drain every occupant of the
        pod, then reserve it whole under a sentinel allocation until the
        window's ``maint_end``.  The lost capacity surfaces as SG loss
        (the denominator stays fleet-wide), and drained jobs' waits are
        PARTIAL — a scheduler-induced gap, not initial queueing.

        Overlapping windows on one pod take union semantics: a depth
        counter keeps the pod reserved until the last window ends."""
        self._maint_depth[pod_id] += 1
        if self._maint_depth[pod_id] > 1:      # already under maintenance
            return
        seen = set()
        for alloc_id in list(self.cluster.pod_jobs(pod_id)):
            if alloc_id.startswith(REPAIR_TAG):
                # the maintenance window subsumes the repair: the crew
                # fixes the slice while the pod is down (the pending
                # ``repair`` event then releases a missing tag, a no-op)
                self.cluster.release(alloc_id)
                continue
            job_id = owner_of(alloc_id)
            if job_id not in self.jobs or job_id in seen:
                continue   # another pod's sentinel / other gang slice
            seen.add(job_id)
            v = self.jobs[job_id]
            if job_id in self._gang_wait:      # mid-replacement-wait gang
                self._evict_gang_wait(job_id)
                continue
            self._stop_segment(v, lost=False)  # planned: checkpoint-resume
            self._release_job(job_id)
            if v.remaining > 0:
                self._queued_since[job_id] = self.now
                self._requeued.add(job_id)
                self.queue.append(job_id)
        self.cluster.reserve_pod(pod_id, f"{MAINT_TAG}{pod_id}")
        self._try_schedule()

    def _end_maintenance(self, pod_id: int):
        self._maint_depth[pod_id] -= 1
        if self._maint_depth[pod_id] > 0:      # a later window still holds
            return
        self.cluster.release(f"{MAINT_TAG}{pod_id}")
        self._try_schedule()

    def _failure_burst(self, idx: int):
        """Correlated failure shock (power/network domain event): every
        running job fails independently with the burst's kill fraction,
        on the scenario's dedicated rng stream."""
        burst = self.cfg.scenario.bursts[idx]
        for job_id in list(self.running):
            if self._burst_rng.random() >= burst.kill_frac:
                continue
            # slice-granularity kill: the burst takes one slice of a gang
            # (the victim draw stays on the scenario's dedicated stream)
            self._slice_failure(self.jobs[job_id], self._burst_rng)
        self._try_schedule()

    # ---- event loop -------------------------------------------------------
    def run(self):
        cfg = self.cfg
        sample_dt = (cfg.sample_dt if cfg.sample_dt is not None
                     else cfg.horizon / 200)
        next_sample = 0.0
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            if t > cfg.horizon:
                break
            while next_sample <= t:
                self._sample(next_sample)
                next_sample += sample_dt
            self.now = t
            if kind == "arrival":
                self._queued_since[payload] = t
                self.queue.append(payload)
                self._try_schedule()
            elif kind == "maint_start":
                self._begin_maintenance(int(payload))
            elif kind == "maint_end":
                self._end_maintenance(int(payload))
            elif kind == "burst":
                self._failure_burst(int(payload))
            elif kind == "control":
                if self.controller is not None:
                    self._on_control(t)
            elif kind == "repair":
                # failed hardware back in service (no-op when maintenance
                # already subsumed the sentinel)
                self.cluster.release(payload)
                self._try_schedule()
            elif kind in ("complete", "failure"):
                job_id, epoch = payload.rsplit(":", 1)
                job = self.jobs[job_id]
                if self._epoch[job_id] != int(epoch) \
                        or job_id not in self.running:
                    continue   # stale event from a preempted segment
                if kind == "complete":
                    self._stop_segment(job, lost=False)
                    self._release_job(job_id)
                else:
                    # MTBF failure: slice-granularity (the victim-slice
                    # draw rides the base failure stream)
                    self._slice_failure(job, self.rng)
                self._try_schedule()
        # close still-running segments at the horizon
        self.now = cfg.horizon
        for job_id in list(self.running):
            self._stop_segment(self.jobs[job_id], lost=False)
            self._release_job(job_id)
        # rigid gangs still holding survivors book the stall to the end
        for job_id in list(self._gang_wait):
            w = self._gang_wait.pop(job_id)
            job = self.jobs[job_id]
            s = job.spec
            self._emit(job, Phase.IDLE, w["t0"], cfg.horizon,
                       layer=Layer.HARDWARE, chips=s.chips - s.slice_chips)
            self._release_job(job_id)
        return self

    def _sample(self, t: float):
        occupied = sum(self.jobs[j].spec.chips for j in self.running)
        # rigid gangs waiting on a replacement slice still hold survivors
        occupied += sum(
            self.jobs[j].spec.chips - self.jobs[j].spec.slice_chips
            for j in self._gang_wait)
        self.telemetry.append({
            "t": t,
            "occupied": occupied,
            "free": self.cluster.free_chips(),
            "queued": len(self.queue),
            "fragmentation": self.cluster.fragmentation(),
        })

    # ---- reporting ---------------------------------------------------------
    @property
    def capacity_chip_time(self) -> float:
        return self.cluster.total_chips * self.cfg.horizon

    def pg_by_job(self) -> Dict[str, float]:
        return {j: r.spec.pg for j, r in self.jobs.items()}

    def report(self):
        """Streaming MPG report — no interval list required.  When the
        ledger is shared across clusters the denominator is fleet-wide;
        pass an explicit capacity to ``ledger.report`` for a local view."""
        return self.ledger.report()
