"""The port's copy of ``repro.fleet.vectorized``, unchanged in behaviour
(the port imports nothing of the reference package).

Vectorized fleet-sim engine: same decisions, batched accounting.

``VectorizedFleetSim`` is the ``SimConfig(engine="vectorized")`` engine
behind ``FleetSim``'s constructor dispatch.  The equivalence gate (golden
traces byte-identical, ``ledger.totals()`` bit-for-bit — see
``tests/test_torch_fleet.py``) forbids changing *what* the simulator does:
every scheduling decision, every rng draw, and every float operation must
happen in the same order as the reference engine.  So the speed comes
from four strictly behaviour-preserving moves:

  * **columnar interval emission** — ``_emit`` appends to struct-of-array
    buffers (one interned segment dict per distinct segment shape) and
    flushes thousands of rows at a time through
    ``GoodputLedger.add_intervals``, whose accumulators receive the same
    addends in the same order as per-event ``record`` calls;
  * **cached cluster geometry** — ``_CachedPod`` keeps ``largest_slice``
    / ``free_chips`` as O(1) reads (recomputed only on alloc/release) and
    ``_IndexedCluster`` keeps per-pod occupancy counts, killing the
    O(#allocations) ``pod_jobs`` scans inside the best-fit sort key;
  * **memoized failed scheduling attempts** — within one cluster state
    (tracked by a mutation version counter), a failed sub-pod allocation
    for ``want`` chips proves every allocation of ``want' >= want`` chips
    fails too (candidate pods are filtered by ``largest_slice >= want``,
    monotone in ``want``); a failed whole-pod allocation for ``need``
    pods proves the same for ``need' >= need``; and a declined preemption
    at ``(chips, eff)`` proves every request with ``chips' >= chips`` and
    ``eff' <= eff`` is declined (the victim-candidate set only shrinks as
    ``eff`` drops, and the freed-chips requirement only grows) — so a
    long stuck queue costs O(1) per job instead of a cluster scan each;
  * **a small-job index** — ``_small_running`` mirrors the running set
    restricted to "small" jobs in insertion order, making the defrag
    policy's ``_smallest_running`` victim pick O(#small) instead of a
    full running-set scan with per-job ``size_class`` recomputation.

The memos are *failure-only*: a hit can only skip work that provably
returns ``None``; every success (which mutates the cluster) runs the real
policy code and bumps the version, invalidating all memos.  Monotonicity
only holds for the built-in policies, so the memo paths are gated on
exact policy types and fall back to the reference flow otherwise.

Randomness is untouched: the same per-component ``random.Random`` streams
draw in the same order (one ``expovariate`` per segment start), which is
what keeps the golden traces byte-identical.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.goodput import Layer, Phase
from repro_torch.fleet.cluster import (Allocation, Cluster, _BuddyPod,
                                       _round_pow2)
from repro_torch.fleet.job import JobRuntime, JobSpec
from repro_torch.fleet.policies import (BestFitPlacement, FirstFitPlacement,
                                        NoPreemption, PlacementPolicy,
                                        PriorityOnlyPreemption,
                                        ProtectXLPreemption, SpreadPlacement)
from repro_torch.fleet.sim import FleetSim, SimConfig

_FLUSH_EVERY = 8192          # buffered interval rows per ledger flush
_NO_FAIL = 1 << 62           # "no failed size recorded yet" sentinel
_POW2: Dict[int, int] = {}   # memoized _round_pow2 (few distinct sizes)

# memo soundness is proved against the shipped policies only; custom
# strategy objects (even subclasses — they may override the decision
# methods) take the reference slow path
_MEMO_PLACEMENTS = (BestFitPlacement, FirstFitPlacement, SpreadPlacement)
_MEMO_PREEMPTIONS = (ProtectXLPreemption, PriorityOnlyPreemption)


class _CachedPod(_BuddyPod):
    """Buddy pod with O(1) ``largest_slice`` / ``free_chips`` reads.

    ``free_chips`` is maintained incrementally (an allocation removes
    exactly its rounded block, a release restores it; buddy splits and
    coalesces conserve the total).  ``largest_slice`` is recomputed
    lazily on first read after a mutation — the best-fit scan and the
    defrag drain target query it millions of times per simulated month,
    but a pod mutates far less often than it is read."""

    def __init__(self, pod_id: int, size: int):
        super().__init__(pod_id, size)
        self._largest = size
        self._free = size
        self._dirty = False

    def largest_slice(self) -> int:
        if self._dirty:
            self._largest = _BuddyPod.largest_slice(self)
            self._dirty = False
        return self._largest

    def free_chips(self) -> int:
        return self._free

    def alloc(self, chips: int) -> Optional[int]:
        off = super().alloc(chips)
        if off is not None:
            self._free -= 1 << self.used[off]
            self._dirty = True
        return off

    def release(self, offset: int) -> None:
        order = self.used[offset]
        super().release(offset)
        self._free += 1 << order
        self._dirty = True


class _IndexedCluster(Cluster):
    """Cluster with cached pods, per-pod occupancy counts, and a mutation
    version counter (the scheduling-memo invalidation signal).

    ``pod_occupancy(pid)`` equals ``len(cluster.pod_jobs(pid))`` at all
    times — sub-pod allocations, whole-pod (XL) members, and maintenance
    sentinels all count one each, exactly like ``pod_jobs``."""

    def __init__(self, n_pods: int = 8, pod_size: int = 256):
        super().__init__(n_pods, pod_size)
        self.pods = [_CachedPod(i, pod_size) for i in range(n_pods)]
        self.version = 0
        self._occ = [0] * n_pods
        # maintenance sentinels are the only allocations without a backing
        # job, so this set equals the defrag policy's "reserved" pod scan
        self.reserved_pods: set = set()
        self._reserved_tags: Dict[str, int] = {}

    def pod_occupancy(self, pod_id: int) -> int:
        return self._occ[pod_id]

    def alloc(self, job_id: str, chips: int, prefer_tight: bool = True,
              exclude: Tuple[int, ...] = (),
              pod_key=None) -> Optional[Allocation]:
        a = super().alloc(job_id, chips, prefer_tight=prefer_tight,
                          exclude=exclude, pod_key=pod_key)
        if a is not None:
            self.version += 1
            if a.pod >= 0:
                self._occ[a.pod] += 1
            else:
                for pid in a.pods:
                    self._occ[pid] += 1
        return a

    def release(self, job_id: str) -> None:
        a = self.allocations.get(job_id)
        if a is None:
            return
        super().release(job_id)
        self.version += 1
        if a.pod >= 0:
            self._occ[a.pod] -= 1
        else:
            for pid in a.pods:
                self._occ[pid] -= 1
        pid = self._reserved_tags.pop(job_id, None)
        if pid is not None:
            self.reserved_pods.discard(pid)

    def reserve_pod(self, pod_id: int, tag: str) -> None:
        super().reserve_pod(pod_id, tag)
        self.version += 1
        self._occ[pod_id] += 1
        self.reserved_pods.add(pod_id)
        self._reserved_tags[tag] = pod_id


class _FastBestFit(BestFitPlacement):
    """Best-fit with the candidate scan inlined against the indexed
    cluster: one pass keeping the first pod minimizing
    ``(largest_slice, -occupancy)`` — the same pod a stable sort of the
    filtered candidate list would put first — without building the list,
    the lambda key, or the sort.  Sub-pod bookkeeping mirrors
    ``_IndexedCluster.alloc`` exactly; whole-pod (XL) requests fall back
    to the generic path, which ignores placement ordering anyway."""

    def alloc(self, cluster, job_id: str, chips: int,
              exclude: Tuple[int, ...] = ()):
        if chips > cluster.pod_size:
            return cluster.alloc(job_id, chips, exclude=exclude,
                                 pod_key=self.pod_key(cluster))
        want = _POW2.get(chips)
        if want is None:
            want = _POW2[chips] = _round_pow2(chips)
        occ = cluster._occ
        best = None
        bl = bo = 0
        for p in cluster.pods:
            # inlined _CachedPod.largest_slice (the scan reads every pod
            # on every allocation; most pods are clean most of the time)
            ls = p.largest_slice() if p._dirty else p._largest
            if ls < want or (exclude and p.pod_id in exclude):
                continue
            o = occ[p.pod_id]
            if best is None or ls < bl or (ls == bl and o > bo):
                best, bl, bo = p, ls, o
        if best is None:
            return None
        off = best.alloc(want)
        a = Allocation(job_id, best.pod_id, off, want)
        cluster.allocations[job_id] = a
        cluster.version += 1
        occ[best.pod_id] += 1
        return a


class VectorizedFleetSim(FleetSim):
    """Decision-identical fast engine (see module docstring)."""

    def __init__(self, cfg: SimConfig,
                 ledger=None, keep_intervals: Optional[bool] = None):
        # engine state must exist before super().__init__ runs the
        # _make_cluster hook and scenario setup
        self._bj: List[str] = []         # columnar emit buffers
        self._bp: List[Phase] = []
        self._b0: List[float] = []
        self._b1: List[float] = []
        self._bc: List[int] = []
        self._bg: List[float] = []
        self._bs: List[Dict[str, str]] = []
        self._seg_intern: Dict[tuple, Dict[str, str]] = {}
        # chips -> {job_id: None} buckets over running "small" jobs, each
        # bucket in running-dict insertion order (<= 8 distinct chip
        # counts, so the defrag victim pick scans buckets, not jobs)
        self._small_running: Dict[int, Dict[str, None]] = {}
        self._memo_version = -1
        self._memo_drain: Optional[tuple] = None
        self._fail_min0 = _NO_FAIL       # failed sub-pod want, exclude=()
        self._fail_min_dr = _NO_FAIL     # failed sub-pod want, exclude=drain
        self._fail_need = _NO_FAIL       # failed whole-pod need
        self._pre_fail_sub: List[Tuple[int, float]] = []
        self._pre_fail_xl: List[Tuple[int, float]] = []
        self._cand_epoch = 0             # preempt-candidate-set generation
        self._pre_sub_epoch = -1
        super().__init__(cfg, ledger, keep_intervals)
        if type(self.placement) is BestFitPlacement:
            self.placement = _FastBestFit()
        self._memo_placement = isinstance(
            self.placement, _MEMO_PLACEMENTS) and type(
            self.placement) in (_MEMO_PLACEMENTS + (_FastBestFit,))

    def _make_cluster(self, cfg: SimConfig) -> Cluster:
        return _IndexedCluster(cfg.n_pods, cfg.pod_size)

    # ---- columnar interval emission --------------------------------------
    def _emit(self, job: JobRuntime, phase: Phase, t0: float, t1: float,
              layer: Layer, gen: Optional[Tuple[str, float]] = None,
              chips: Optional[int] = None):
        if t1 <= t0:
            return
        s = job.spec
        # per-spec memo: (layer, gen) -> (interned segment dict, pg).
        # every field feeding seg/pg is immutable on a JobSpec instance,
        # and specs are only replaced wholesale (fresh instance, no memo)
        ec = s.__dict__.get("_emit_c")
        if ec is None:
            ec = s.__dict__["_emit_c"] = {}
        ent = ec.get((layer, gen))
        if ent is not None:
            seg, pg = ent
        else:
            key = (s.size_class, s.phase_kind, s.arch, s.framework,
                   s.async_checkpoint, layer.value,
                   None if gen is None else gen[0])
            seg = self._seg_intern.get(key)
            if seg is None:
                seg = {
                    "size_class": s.size_class, "phase_kind": s.phase_kind,
                    "arch": s.arch, "framework": s.framework,
                    "ckpt": "async" if s.async_checkpoint else "sync",
                    "emitter": "fleet", "layer": layer.value,
                }
                if gen is not None:
                    seg["generation"] = gen[0]
                self._seg_intern[key] = seg
            pg = s.pg
            if gen is not None:
                pg = s.pg * gen[1]
            ec[(layer, gen)] = (seg, pg)
        self._bj.append(s.job_id)
        self._bp.append(phase)
        self._b0.append(t0)
        self._b1.append(t1)
        self._bc.append(s.chips if chips is None else chips)
        self._bg.append(pg)
        self._bs.append(seg)
        if len(self._b0) >= _FLUSH_EVERY:
            self._flush()

    def _flush(self) -> None:
        if not self._b0:
            return
        self.ledger.add_intervals(self._bj, self._bp, self._b0, self._b1,
                                  self._bc, self._bg, self._bs)
        self._bj = []
        self._bp = []
        self._b0 = []
        self._b1 = []
        self._bc = []
        self._bg = []
        self._bs = []

    @property
    def intervals(self):
        self._flush()
        return FleetSim.intervals.fget(self)

    def report(self):
        self._flush()
        return super().report()

    def run(self):
        super().run()
        self._flush()
        return self

    def _control_sync(self) -> None:
        # a controller observation must see the same ledger/waterfall
        # state the reference engine would at this boundary
        self._flush()

    # ---- live policy switching -------------------------------------------
    def set_policies(self, placement=None, preemption=None,
                     defrag=None) -> None:
        super().set_policies(placement, preemption, defrag)
        # re-derive the policy-dependent fast paths, exactly as __init__
        # does, and drop every scheduling memo: facts proved against the
        # old policy objects are no longer sound (clearing memos only
        # re-runs real policy code with identical results, so the switch
        # stays decision-identical to the reference engine)
        if type(self.placement) is BestFitPlacement:
            self.placement = _FastBestFit()
        self._memo_placement = isinstance(
            self.placement, _MEMO_PLACEMENTS) and type(
            self.placement) in (_MEMO_PLACEMENTS + (_FastBestFit,))
        self._memo_version = -1
        self._memo_drain = None
        self._fail_min0 = _NO_FAIL
        self._fail_min_dr = _NO_FAIL
        self._fail_need = _NO_FAIL
        self._pre_fail_sub = []
        self._pre_fail_xl = []
        self._cand_epoch += 1
        self._pre_sub_epoch = -1

    # ---- cached productive-rate model ------------------------------------
    def _rates(self, s: JobSpec) -> Tuple[float, float, float]:
        cached = s.__dict__.get("_rates_c")
        pause = self.cfg.async_snapshot_pause
        if cached is not None and cached[0] == pause:
            return cached[1]
        r = super()._rates(s)
        s.__dict__["_rates_c"] = (pause, r)
        return r

    # ---- small-job victim index ------------------------------------------
    def _start_segment(self, job: JobRuntime,
                       init_layer: Optional[Layer] = None):
        super()._start_segment(job, init_layer)
        s = job.spec
        if s.size_class == "small":
            bucket = self._small_running.get(s.chips)
            if bucket is None:
                bucket = self._small_running[s.chips] = {}
            bucket[s.job_id] = None
        if init_layer is not Layer.SCHEDULING:
            # a defrag/drain migration (the only SCHEDULING-layer start)
            # stop+restarts the same job with the same priority / chips /
            # size_class / preemption count — candidacy-neutral for the
            # preemption memo.  Every other start can grow the victim set.
            self._cand_epoch += 1

    def _stop_segment(self, job: JobRuntime, lost: bool,
                      lost_layer: Layer = Layer.HARDWARE):
        super()._stop_segment(job, lost, lost_layer)
        s = job.spec
        bucket = self._small_running.get(s.chips)
        if bucket is not None:
            bucket.pop(s.job_id, None)

    # ---- memoized scheduling pass ----------------------------------------
    def _sync_memo(self) -> None:
        v = self.cluster.version
        if v != self._memo_version:
            self._memo_version = v
            self._fail_min0 = _NO_FAIL
            self._fail_min_dr = _NO_FAIL
            self._fail_need = _NO_FAIL
            # _pre_fail_xl scans cluster.pod_jobs -> version-keyed;
            # _pre_fail_sub never reads the cluster -> epoch-keyed below
            self._pre_fail_xl = []

    def _fast_alloc(self, job_id: str, chips: int,
                    exclude: Tuple[int, ...]) -> Optional[Allocation]:
        """``placement.alloc`` with failure memoization (sound for the
        built-in placement policies: they order candidates but never
        decline a feasible one, so failure is a pure cluster-state fact,
        monotone in the rounded request size)."""
        if not self._memo_placement:
            return self.placement.alloc(self.cluster, job_id, chips,
                                        exclude=exclude)
        if self.cluster.version != self._memo_version:
            self._sync_memo()
        if chips <= self.cfg.pod_size:
            want = _POW2.get(chips)
            if want is None:
                want = _POW2[chips] = _round_pow2(chips)
            if want >= (self._fail_min_dr if exclude else self._fail_min0):
                return None
            a = self.placement.alloc(self.cluster, job_id, chips,
                                     exclude=exclude)
            if a is None:
                if exclude:
                    if want < self._fail_min_dr:
                        self._fail_min_dr = want
                else:
                    # failing with no exclusions implies failing with any
                    if want < self._fail_min0:
                        self._fail_min0 = want
                    if want < self._fail_min_dr:
                        self._fail_min_dr = want
            return a
        need = -(-chips // self.cfg.pod_size)
        if need >= self._fail_need:
            return None
        a = self.placement.alloc(self.cluster, job_id, chips,
                                 exclude=exclude)
        if a is None and need < self._fail_need:
            self._fail_need = need
        return a

    def _place(self, alloc_id: str, chips: int, exclude: tuple = ()):
        # every slice placement (gang or single) rides the failure memo
        return self._fast_alloc(alloc_id, chips, exclude)

    def _preempt_for(self, job: JobRuntime) -> bool:
        pre = self.preemption
        tp = type(pre)
        if tp is NoPreemption:
            return False                  # victims_for is constant None
        if tp not in _MEMO_PREEMPTIONS:
            return super()._preempt_for(job)
        chips = job.spec.chips
        eff = self._eff_priority(job.spec.job_id)
        if chips > self.cfg.pod_size:
            if self.cluster.version != self._memo_version:
                self._sync_memo()
            fails = self._pre_fail_xl
        else:
            if self._pre_sub_epoch != self._cand_epoch:
                self._pre_sub_epoch = self._cand_epoch
                self._pre_fail_sub = []
            fails = self._pre_fail_sub
        for c, e in fails:
            if chips >= c and eff <= e:
                return False              # monotone failure propagation
        victims = pre.victims_for(self, job)
        if not victims:
            fails.append((chips, eff))
            return False
        self._evict_victims(victims)
        return True

    def _try_schedule(self):
        # identical control flow to FleetSim._try_schedule; the sort key
        # inlines _eff_priority with the exact same float operations
        jobs = self.jobs
        qs = self._queued_since
        req = self._requeued
        now = self.now
        aging = self.cfg.aging_hours * 3600.0
        self.queue.sort(key=lambda j: (
            -((jobs[j].spec.priority + 1.0 if j in req
               else jobs[j].spec.priority)
              + (now - qs.get(j, now)) / aging),
            jobs[j].spec.arrival))
        drain = self._drain_for_xl()
        if self.cluster.version != self._memo_version:
            self._sync_memo()
        if drain != self._memo_drain:
            # the drain-exclusion memo is only valid against one drain set
            self._memo_drain = drain
            self._fail_min_dr = _NO_FAIL
        self._refill_gangs(drain)
        self._regrow_elastic(drain)
        scheduled = []
        for job_id in list(self.queue):
            if self._sched_one(jobs[job_id], drain):
                scheduled.append(job_id)
        if scheduled:
            # remove each scheduled id's first occurrence in one pass
            # (reference does repeated queue.remove — same result)
            first = set(scheduled)
            kept = []
            for j in self.queue:
                if j in first:
                    first.discard(j)
                else:
                    kept.append(j)
            self.queue[:] = kept
