"""The port's copy of ``repro.fleet.policies``, unchanged in behaviour
(the port imports nothing of the reference package).

Pluggable scheduler policies (paper §5.3, Fig. 16 ablations).

``FleetSim`` used to hardcode one scheduling strategy (topology-aware
best-fit, MEDIUM-victim preemption with XL protection, drain-based
defragmentation).  This module extracts the three decision points into
strategy objects injected via ``SimConfig``, so Fig. 16-style ablations
become policy sweeps instead of bool flags:

  * :class:`PlacementPolicy` — which pod a sub-pod job lands in
    (``best_fit`` / ``first_fit`` / ``spread``);
  * :class:`PreemptionPolicy` — which victims are evicted for a
    higher-priority arrival (``protect_xl`` / ``priority_only`` / ``none``);
  * :class:`DefragPolicy` — how fragmentation is repaired
    (``drain_for_xl`` / ``migrate_small`` / ``none``).

Policies only *choose* (pods to drain, victims to evict, orderings);
``FleetSim`` performs the state mutations — stop/requeue/restart book-
keeping stays in one place so the Interval ledger semantics cannot drift
between policies.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type, Union

from repro_torch.fleet.cluster import REPAIR_TAG, owner_of

# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class PlacementPolicy:
    """Orders candidate pods for a sub-pod allocation.

    ``pod_key(cluster)`` returns a sort key over ``_BuddyPod`` objects;
    the lowest-keyed candidate that fits wins.  Multi-pod (XL) jobs always
    take whole empty pods and bypass placement ordering.
    """

    name = "base"

    def pod_key(self, cluster):
        raise NotImplementedError

    def alloc(self, cluster, job_id: str, chips: int,
              exclude: Tuple[int, ...] = ()):
        return cluster.alloc(job_id, chips, exclude=exclude,
                             pod_key=self.pod_key(cluster))


class BestFitPlacement(PlacementPolicy):
    """Tightest pod first (defragmentation-friendly; the paper's default).
    Ties break toward the busier pod, concentrating load."""

    name = "best_fit"

    def pod_key(self, cluster):
        occ = getattr(cluster, "pod_occupancy", None)
        if occ is not None:   # indexed cluster: O(1) occupancy counts
            return lambda p: (p.largest_slice(), -occ(p.pod_id))
        return lambda p: (p.largest_slice(), -len(cluster.pod_jobs(p.pod_id)))


class FirstFitPlacement(PlacementPolicy):
    """Lowest pod id that fits — the no-information baseline."""

    name = "first_fit"

    def pod_key(self, cluster):
        return lambda p: p.pod_id


class SpreadPlacement(PlacementPolicy):
    """Emptiest pod first: balances load, maximizes fragmentation — the
    anti-pattern the paper's Myth 1 (capacity != availability) warns about."""

    name = "spread"

    def pod_key(self, cluster):
        return lambda p: (-p.free_chips(), p.pod_id)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


class PreemptionPolicy:
    """Chooses eviction victims for a job that cannot be placed.

    ``victims_for(sim, job)`` returns job-ids to evict (the sim performs
    the evictions and the retry alloc), or ``None`` when the policy
    declines.  ``protects_xl`` is consulted by the XL whole-pod path.
    """

    name = "base"
    protects_xl = False

    def victims_for(self, sim, job) -> Optional[List[str]]:
        raise NotImplementedError

    # -- shared helpers ----------------------------------------------------
    def _sub_pod_victims(self, sim, job, rank_fn) -> Optional[List[str]]:
        """Greedy victim pick for sub-pod jobs, ordered by ``rank_fn``."""
        eff = sim._eff_priority(job.spec.job_id)
        candidates = []
        for j in sim.running:
            v = sim.jobs[j]
            if v.spec.priority > eff - sim.cfg.preempt_gap:
                continue
            if v.preemptions >= 2:      # eviction-churn guard
                continue
            if self.protects_xl and v.spec.size_class == "xl":
                continue
            candidates.append((rank_fn(v), v.spec.chips, j))
        if not candidates:
            return None
        candidates.sort()
        victims, freed = [], 0
        for _, chips, j in candidates:
            victims.append(j)
            freed += chips
            if freed >= job.spec.chips:
                return victims
        return victims if freed >= job.spec.chips else None

    def _whole_pod_victims(self, sim, job) -> Optional[List[str]]:
        """Whole-pod eviction for multi-pod jobs: pods whose occupants are
        all evictable, cheapest displaced chips first."""
        need = -(-job.spec.chips // sim.cfg.pod_size)
        eff = sim._eff_priority(job.spec.job_id)
        usable = []
        for pod in sim.cluster.pods:
            # gang slices allocate per-slice under "<job>#s<k>"; evicting
            # any slice displaces the whole gang, so dedup to owners
            owners: List[str] = []
            for alloc_id in sim.cluster.pod_jobs(pod.pod_id):
                o = owner_of(alloc_id)
                if o not in owners:
                    owners.append(o)
            cost, ok = 0.0, True
            for j in owners:
                if j not in sim.jobs:        # maintenance reservation
                    ok = False
                    break
                v = sim.jobs[j]
                if v.spec.chips > sim.cfg.pod_size \
                        and v.spec.n_slices == 1:     # single-slice XL: immovable
                    ok = False
                    break
                if v.spec.priority >= eff:   # never displace higher priority
                    ok = False
                    break
                cost += v.spec.chips
            if ok:
                usable.append((cost, pod.pod_id, owners))
        if len(usable) < need:
            return None
        usable.sort()
        victims: List[str] = []
        for _, _, owners in usable[:need]:
            for j in owners:
                if j not in victims:         # a gang may span chosen pods
                    victims.append(j)
        return victims


class ProtectXLPreemption(PreemptionPolicy):
    """The paper's policy: never evict XL (restart cascades are ruinous),
    prefer MEDIUM victims (SMALL finish soon anyway, LARGE next)."""

    name = "protect_xl"
    protects_xl = True
    _RANK = {"medium": 0, "large": 1, "small": 2, "xl": 3}

    def victims_for(self, sim, job):
        if job.spec.chips > sim.cfg.pod_size:
            return self._whole_pod_victims(sim, job)
        return self._sub_pod_victims(
            sim, job, lambda v: self._RANK[v.spec.size_class])


class PriorityOnlyPreemption(PreemptionPolicy):
    """Pure priority ordering, no size-class protection — the ablation
    showing why unprotected XL jobs crater per-class SG (Fig. 16)."""

    name = "priority_only"
    protects_xl = False

    def victims_for(self, sim, job):
        if job.spec.chips > sim.cfg.pod_size:
            return self._whole_pod_victims(sim, job)
        return self._sub_pod_victims(
            sim, job, lambda v: (v.spec.priority, v.spec.chips))


class NoPreemption(PreemptionPolicy):
    """Arrivals wait for capacity; nothing is ever evicted."""

    name = "none"
    protects_xl = True          # vacuously: nothing is evicted

    def victims_for(self, sim, job):
        return None


# ---------------------------------------------------------------------------
# defragmentation
# ---------------------------------------------------------------------------


class DefragPolicy:
    """Repairs fragmentation.  Two hooks:

    * ``drain_pods(sim)`` — before each scheduling pass: pods to reserve
      for a queued multi-pod job (occupants get migrated out by the sim);
    * ``migration_victim(sim, job)`` — when ``job`` cannot fit: a running
      job to checkpoint-migrate so a slice coalesces, or ``None``.
    """

    name = "base"

    def drain_pods(self, sim) -> Tuple[int, ...]:
        return ()

    def migration_victim(self, sim, job) -> Optional[str]:
        return None

    # -- shared helpers ----------------------------------------------------
    @staticmethod
    def _xl_drain_target(sim) -> Tuple[int, ...]:
        """Emptiest pods covering the largest queued multi-pod job.

        Only *serviceable* pods count: pods under a maintenance
        reservation (sentinel allocations with no backing job) can be
        neither drained nor granted, and a job needing more pods than
        are currently serviceable is ignored — draining for a job that
        cannot fit would exclude every pod from scheduling and deadlock
        the fleet (found by the tiny golden-trace configs, where the
        workload can emit cluster-sized requests).

        The trigger keys on *slice* width: only jobs whose slices need
        whole pods benefit from whole-pod drains.  A gang whose slices
        are sub-pod places into fragmented pods — and respects the drain
        exclusion, so draining for it would starve its own placement.
        """
        pod_size = sim.cfg.pod_size
        reserved = getattr(sim.cluster, "reserved_pods", None)
        if reserved is None:
            # maintenance sentinels only: repair holds are sub-pod and do
            # not reserve their pod (mirrors the indexed cluster's
            # ``reserved_pods``, which tracks ``reserve_pod`` tags alone)
            reserved = {a.pod for tag, a in sim.cluster.allocations.items()
                        if owner_of(tag) not in sim.jobs and a.pod >= 0
                        and not tag.startswith(REPAIR_TAG)}
        serviceable = [p for p in sim.cluster.pods
                       if p.pod_id not in reserved]
        max_chips = len(serviceable) * pod_size
        xl_need = max((sim.jobs[j].spec.chips // pod_size
                       for j in sim.queue
                       if pod_size < sim.jobs[j].spec.slice_chips
                       and sim.jobs[j].spec.chips <= max_chips),
                      default=0)
        if xl_need == 0:
            return ()
        by_emptiness = sorted(serviceable, key=lambda p: -p.free_chips())
        return tuple(p.pod_id for p in by_emptiness[:xl_need])

    @staticmethod
    def _smallest_running(sim) -> Optional[str]:
        idx = sim.__dict__.get("_small_running")
        if idx is not None:
            # vectorized engine: chips -> {job_id: None} buckets over the
            # running "small" jobs, each bucket in running-dict insertion
            # order — the first job of the lowest non-empty bucket is the
            # same first-minimal job the full scan below would pick
            best = None
            best_chips = 0
            for c, bucket in idx.items():
                if bucket and (best is None or c < best_chips):
                    best = bucket
                    best_chips = c
            if best is None:
                return None
            return next(iter(best))
        victims = [j for j in sim.running
                   if sim.jobs[j].spec.size_class == "small"]
        if not victims:
            return None
        return min(victims, key=lambda j: sim.jobs[j].spec.chips)


class DrainForXLDefrag(DefragPolicy):
    """The paper's policy: reserve + drain pods for queued XL work, and
    migrate small jobs to make room when a sub-pod job is stuck."""

    name = "drain_for_xl"

    def drain_pods(self, sim):
        return self._xl_drain_target(sim)

    def migration_victim(self, sim, job):
        if job.spec.chips > sim.cfg.pod_size:
            return None
        return self._smallest_running(sim)


class MigrateSmallDefrag(DefragPolicy):
    """Point defragmentation only: migrate small jobs on demand, never
    drain whole pods (XL jobs must find naturally-empty pods)."""

    name = "migrate_small"

    def migration_victim(self, sim, job):
        if job.spec.chips > sim.cfg.pod_size:
            return None
        return self._smallest_running(sim)


class NoDefrag(DefragPolicy):
    """Fragmentation is never repaired — the Myth 1 baseline."""

    name = "none"


# ---------------------------------------------------------------------------
# registry / resolution
# ---------------------------------------------------------------------------

PLACEMENT_POLICIES: Dict[str, Type[PlacementPolicy]] = {
    c.name: c for c in (BestFitPlacement, FirstFitPlacement, SpreadPlacement)}
PREEMPTION_POLICIES: Dict[str, Type[PreemptionPolicy]] = {
    c.name: c for c in (ProtectXLPreemption, PriorityOnlyPreemption,
                        NoPreemption)}
DEFRAG_POLICIES: Dict[str, Type[DefragPolicy]] = {
    c.name: c for c in (DrainForXLDefrag, MigrateSmallDefrag, NoDefrag)}


def _resolve(spec, registry, kind):
    if isinstance(spec, str):
        try:
            return registry[spec]()
        except KeyError:
            raise ValueError(
                f"unknown {kind} policy {spec!r}; "
                f"choose from {sorted(registry)}") from None
    return spec


def resolve_placement(spec: Union[str, PlacementPolicy]) -> PlacementPolicy:
    return _resolve(spec, PLACEMENT_POLICIES, "placement")


def resolve_preemption(spec: Union[str, PreemptionPolicy]) -> PreemptionPolicy:
    return _resolve(spec, PREEMPTION_POLICIES, "preemption")


def resolve_defrag(spec: Union[str, DefragPolicy]) -> DefragPolicy:
    return _resolve(spec, DEFRAG_POLICIES, "defrag")


# named policy combinations (shared by the advisor's scheduler knob, the
# adaptive controller's rescue rule, and the controller benchmark): the
# paper's §5.3 scheduler vs. the no-information baseline
PAPER_COMBO: Dict[str, str] = {"placement": "best_fit",
                               "preemption": "protect_xl",
                               "defrag": "drain_for_xl"}
NAIVE_COMBO: Dict[str, str] = {"placement": "spread",
                               "preemption": "priority_only",
                               "defrag": "none"}
