"""The port's copy of ``repro.core.ledger``, unchanged in behaviour (the port
imports nothing of the reference package).

Streaming GoodputLedger: one fleet-wide accounting sink (paper §4-§5).

The paper's central move is a *single* MPG = SG x RG x PG accounting that
spans the whole stack — scheduler, runtime, and program layers.  Before
this module each layer kept its own ``List[Interval]`` and every report
re-walked the full list; a month of fleet time at production job counts
materializes millions of intervals just to produce four numbers.

``GoodputLedger`` is an append-only event sink with O(1)-per-event
incremental accumulators:

  * aggregate allocated / productive / ideal chip-time (the MPG inputs);
  * per-phase chip-time (``rg_breakdown``, paper Fig. 10);
  * per-(segment key, segment value) sub-ledgers with their own
    denominators (``segment_report``, paper §5's Simpson's-paradox guard);
  * a windowed MPG time series (hourly/daily SG/RG/PG, the Fig. 5/11
    timeline shapes) — intervals crossing a window boundary are split
    proportionally;
  * subscriber hooks, so exporters/monitors observe the event stream
    without a second ledger.

Memory is O(#jobs + #segments + #windows), never O(#events), unless
``retain_intervals=True`` is requested for debugging/back-compat (the
legacy ``sim.intervals`` attribute).  ``repro_torch.core.goodput``'s
``compute_goodput`` / ``segment_goodput`` / ``rg_breakdown`` are thin
wrappers over a throwaway ledger, so the two paths cannot drift.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.goodput import (ALLOCATED_PHASES, PRODUCTIVE_PHASES,
                                GoodputReport, Interval, Phase)

try:                               # numpy vectorizes the per-event derived
    import numpy as _np            # quantities in add_intervals; the pure-
except ModuleNotFoundError:        # python fallback is value-identical
    _np = None

# resolved segment-accumulator lists are cached per interned segment-dict
# identity; past this many distinct dicts the caller is clearly not
# interning and caching would grow per event, so we stop inserting
_SEG_CACHE_CAP = 4096

# hot-loop classification pinned onto the Phase members themselves: the
# batched ingest path reads plain attributes instead of paying an
# enum-hash set lookup per accumulator per event
for _p in Phase:
    _p._x_alloc = _p in ALLOCATED_PHASES
    _p._x_prod = _p in PRODUCTIVE_PHASES
del _p


class IntervalBatch:
    """A columnar slice of the event stream: parallel sequences, one row
    per recorded event (zero-chip-time rows are filtered out before batch
    subscribers see them, exactly like :meth:`GoodputLedger.record`).

    ``chip_times[i]`` is precomputed ``(t1[i] - t0[i]) * chips[i]`` — the
    same IEEE operations :attr:`Interval.chip_time` performs, so consumers
    mirroring the ledger stay bit-for-bit."""

    __slots__ = ("job_ids", "phases", "t0", "t1", "chips", "pgs",
                 "segments", "chip_times")

    def __init__(self, job_ids, phases, t0, t1, chips, pgs, segments,
                 chip_times):
        self.job_ids = job_ids
        self.phases = phases
        self.t0 = t0
        self.t1 = t1
        self.chips = chips
        self.pgs = pgs
        self.segments = segments
        self.chip_times = chip_times

    def __len__(self) -> int:
        return len(self.t0)

    def intervals(self) -> List[Interval]:
        """Materialize Interval objects (for per-event consumers)."""
        return [Interval(job_id=j, phase=p, t0=a, t1=b, chips=c, segment=s)
                for j, p, a, b, c, s in zip(self.job_ids, self.phases,
                                            self.t0, self.t1, self.chips,
                                            self.segments)]


@dataclasses.dataclass
class _Acc:
    """Incremental MPG accumulator: the three chip-time sums plus the
    per-phase split (QUEUED/PARTIAL included — per-segment SG numerators,
    Fig. 16, need the waiting phases too)."""
    allocated: float = 0.0
    productive: float = 0.0
    ideal: float = 0.0
    phase: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, phase: Phase, chip_time: float, pg: float):
        self.phase[phase.value] = self.phase.get(phase.value, 0.0) + chip_time
        if phase in ALLOCATED_PHASES:
            self.allocated += chip_time
        if phase in PRODUCTIVE_PHASES:
            self.productive += chip_time
            self.ideal += chip_time * pg

    def report(self, capacity_chip_time: float) -> GoodputReport:
        sg = self.allocated / capacity_chip_time if capacity_chip_time else 0.0
        rg = self.productive / self.allocated if self.allocated else 0.0
        pg = self.ideal / self.productive if self.productive else 0.0
        return GoodputReport(sg=sg, rg=rg, pg=pg,
                             capacity_chip_time=capacity_chip_time,
                             allocated_chip_time=self.allocated,
                             productive_chip_time=self.productive,
                             ideal_chip_time=self.ideal)


class GoodputLedger:
    """Append-only goodput event sink with streaming accumulators.

    Parameters
    ----------
    capacity_chip_time:
        Fleet capacity denominator for SG.  Emitting layers call
        :meth:`add_capacity` instead when several clusters share one
        ledger; :meth:`report` also accepts an explicit override.
    window:
        Width (seconds) of the MPG time-series buckets (default: hourly).
    retain_intervals:
        Keep the raw ``Interval`` list (O(#events) memory).  Default on
        for interactive/simulator use where tests inspect the stream;
        turn off for fleet-scale runs (see ``benchmarks/ledger_scale.py``).
    """

    def __init__(self, capacity_chip_time: float = 0.0,
                 window: float = 3600.0,
                 retain_intervals: bool = True):
        self.capacity_chip_time = capacity_chip_time
        self.window = window
        self.retain_intervals = retain_intervals
        self.intervals: Optional[List[Interval]] = \
            [] if retain_intervals else None
        self.n_events = 0
        self._totals = _Acc()
        # segment key -> segment value -> accumulator
        self._segments: Dict[str, Dict[str, _Acc]] = \
            defaultdict(lambda: defaultdict(_Acc))
        # window index -> accumulator (for the SG/RG/PG time series)
        self._windows: Dict[int, _Acc] = defaultdict(_Acc)
        # job -> productive chip-time: lets report() re-weight PG with a
        # pg_by_job table supplied *after* the stream (legacy API shape)
        self._job_productive: Dict[str, float] = defaultdict(float)
        self._subscribers: List[Callable[[Interval], None]] = []
        # (per-event fn, optional batch fn) pairs — see subscribe_events
        self._event_subscribers: List[Tuple[Callable[[Interval, float], None],
                                            Optional[Callable]]] = []
        # id(segment dict) -> (dict, resolved accumulator list); the
        # batched ingest path resolves each *interned* segment dict's
        # (key, value) accumulators once instead of per event
        self._seg_acc_cache: Dict[int, Tuple[Dict[str, str], List[_Acc]]] = {}

    # ---- event ingestion --------------------------------------------------
    def subscribe(self, fn: Callable[[Interval], None]) -> None:
        """Call ``fn(interval)`` on every recorded event."""
        self._subscribers.append(fn)

    def subscribe_events(self, fn: Callable[[Interval, float], None],
                         batch_fn: Optional[Callable[["IntervalBatch"],
                                                     None]] = None) -> None:
        """Call ``fn(interval, pg)`` on every recorded event — the pg-aware
        hook trace recorders need (``repro.fleet.trace``): replaying the
        observed ``(interval, pg)`` stream reproduces this ledger's totals
        bit-for-bit.

        ``batch_fn``, when given, makes the subscriber *batch-aware*: the
        columnar ingest path (:meth:`add_intervals`) delivers one
        :class:`IntervalBatch` per flush instead of a per-event callback —
        same events, same order, no per-interval Python dispatch.  A
        subscriber without ``batch_fn`` still sees every event (the batch
        path materializes Interval objects for it)."""
        self._event_subscribers.append((fn, batch_fn))

    def add_capacity(self, chip_time: float) -> None:
        """Add an emitter's capacity to the SG denominator (multi-cluster)."""
        self.capacity_chip_time += chip_time

    def record(self, iv: Interval, pg: float = 1.0) -> None:
        """Ingest one interval; ``pg`` weights its STEP time into ideal
        chip-time (the Program Goodput of the job's compiled program)."""
        ct = iv.chip_time
        if ct <= 0.0:
            return
        self.n_events += 1
        self._totals.add(iv.phase, ct, pg)
        if iv.phase in PRODUCTIVE_PHASES:
            self._job_productive[iv.job_id] += ct
        for key, val in iv.segment.items():
            self._segments[key][val].add(iv.phase, ct, pg)
        self._add_windowed(iv.phase, iv.t0, iv.t1, iv.chips, pg)
        if self.retain_intervals:
            self.intervals.append(iv)
        for fn in self._subscribers:
            fn(iv)
        for fn, _ in self._event_subscribers:
            fn(iv, pg)

    def emit(self, job_id: str, phase: Phase, t0: float, t1: float,
             chips: int, segment: Optional[Dict[str, str]] = None,
             pg: float = 1.0) -> None:
        """Convenience constructor-and-record for emitting layers."""
        if t1 <= t0:
            return
        self.record(Interval(job_id=job_id, phase=phase, t0=t0, t1=t1,
                             chips=chips, segment=segment or {}), pg=pg)

    def extend(self, intervals: Iterable[Interval],
               pg_by_job: Optional[Dict[str, float]] = None) -> None:
        """Batch-ingest an interval stream (legacy-list compatibility)."""
        table = pg_by_job or {}
        for iv in intervals:
            self.record(iv, pg=table.get(iv.job_id, 1.0))

    def _add_windowed(self, phase: Phase, t0: float, t1: float, chips: int,
                      pg: float) -> None:
        w = self.window
        if w <= 0 or not math.isfinite(t0) or not math.isfinite(t1):
            return
        i0 = int(t0 // w)
        i1 = int(t1 // w) if t1 % w else int(t1 // w) - 1
        if i1 < i0:
            i1 = i0
        for widx in range(i0, i1 + 1):
            lo = max(t0, widx * w)
            hi = min(t1, (widx + 1) * w)
            if hi > lo:
                self._windows[widx].add(phase, (hi - lo) * chips, pg)

    def add_intervals(self, job_ids: Sequence[str], phases: Sequence[Phase],
                      t0: Sequence[float], t1: Sequence[float],
                      chips: Sequence[int], pgs: Sequence[float],
                      segments: Sequence[Dict[str, str]]) -> int:
        """Columnar batch ingest: one call for many events.

        Semantically identical to calling :meth:`record` once per row in
        order — the accumulators receive the *same addends in the same
        order*, so ``totals()`` after a batched stream is bit-for-bit
        equal to the per-event stream.  The speed comes from what batching
        makes possible without touching that order:

          * derived chip-times are computed elementwise over the whole
            batch (numpy when available; IEEE ops are identical per
            element either way);
          * (key, value) sub-ledger accumulators are resolved once per
            *interned* segment dict instead of per event;
          * batch-aware subscribers (``subscribe_events(fn, batch_fn)``)
            get one :class:`IntervalBatch` per flush; ``Interval`` objects
            are only materialized when a legacy per-event consumer (or
            ``retain_intervals``) needs them.

        Returns the number of events actually recorded (zero-chip-time
        rows are skipped, exactly like ``record``)."""
        n = len(t0)
        if n == 0:
            return 0
        if _np is not None and n >= 16:
            cts = ((_np.asarray(t1, dtype=_np.float64)
                    - _np.asarray(t0, dtype=_np.float64))
                   * _np.asarray(chips, dtype=_np.float64)).tolist()
        else:
            cts = [(b - a) * c for a, b, c in zip(t0, t1, chips)]

        totals = self._totals
        tphase = totals.phase
        segs_root = self._segments
        seg_cache = self._seg_acc_cache
        jobprod = self._job_productive
        retained = self.intervals
        per_event = (bool(self._subscribers)
                     or any(bfn is None for _, bfn in self._event_subscribers))
        need_ivs = retained is not None or per_event

        windows = self._windows
        w = self.window
        w_ok = w > 0
        isfinite = math.isfinite
        made: List[Optional[Interval]] = [] if need_ivs else None
        kept = 0
        skipped = False
        for i in range(n):
            ct = cts[i]
            if ct <= 0.0:
                skipped = True
                if need_ivs:
                    made.append(None)
                continue
            kept += 1
            ph = phases[i]
            pg = pgs[i]
            seg = segments[i]
            # ph._value_ / ph._x_alloc / ph._x_prod are plain attribute
            # reads standing in for ph.value (a DynamicClassAttribute
            # descriptor) and the ALLOCATED/PRODUCTIVE set lookups; the
            # inlined _Acc.add bodies below perform the identical float
            # operations in the identical order as acc.add(ph, ct, pg)
            pv = ph._value_
            is_alloc = ph._x_alloc
            is_prod = ph._x_prod
            tphase[pv] = tphase.get(pv, 0.0) + ct
            if is_alloc:
                totals.allocated += ct
            if is_prod:
                totals.productive += ct
                totals.ideal += ct * pg
                jobprod[job_ids[i]] += ct
            entry = seg_cache.get(id(seg))
            if entry is not None and entry[0] is seg:
                accs = entry[1]
            else:
                accs = [segs_root[k][v] for k, v in seg.items()]
                if len(seg_cache) < _SEG_CACHE_CAP:
                    seg_cache[id(seg)] = (seg, accs)
            for acc in accs:
                aph = acc.phase
                aph[pv] = aph.get(pv, 0.0) + ct
                if is_alloc:
                    acc.allocated += ct
                if is_prod:
                    acc.productive += ct
                    acc.ideal += ct * pg
            a = t0[i]
            b = t1[i]
            if w_ok and isfinite(a) and isfinite(b):
                i0 = int(a // w)
                i1 = int(b // w) if b % w else int(b // w) - 1
                if i1 <= i0:
                    # single-window fast path: same max/min clamps as
                    # _add_windowed's loop body for widx == i0
                    lo = max(a, i0 * w)
                    hi = min(b, (i0 + 1) * w)
                    if hi > lo:
                        wct = (hi - lo) * chips[i]
                        wacc = windows[i0]
                        wph = wacc.phase
                        wph[pv] = wph.get(pv, 0.0) + wct
                        if is_alloc:
                            wacc.allocated += wct
                        if is_prod:
                            wacc.productive += wct
                            wacc.ideal += wct * pg
                else:
                    self._add_windowed(ph, a, b, chips[i], pg)
            if need_ivs:
                made.append(Interval(job_id=job_ids[i], phase=ph, t0=t0[i],
                                     t1=t1[i], chips=chips[i], segment=seg))
        self.n_events += kept
        if kept == 0:
            return 0

        if need_ivs:
            kept_rows = [(iv, pgs[i]) for i, iv in enumerate(made)
                         if iv is not None]
            if retained is not None:
                retained.extend(iv for iv, _ in kept_rows)
            for fn in self._subscribers:
                for iv, _ in kept_rows:
                    fn(iv)
        batch = None
        for fn, bfn in self._event_subscribers:
            if bfn is not None:
                if batch is None:
                    batch = self._make_batch(job_ids, phases, t0, t1, chips,
                                             pgs, segments, cts, skipped)
                bfn(batch)
            else:
                for iv, pg in kept_rows:
                    fn(iv, pg)
        return kept

    def _make_batch(self, job_ids, phases, t0, t1, chips, pgs, segments,
                    cts, skipped) -> "IntervalBatch":
        if not skipped:
            return IntervalBatch(list(job_ids), list(phases), list(t0),
                                 list(t1), list(chips), list(pgs),
                                 list(segments), cts)
        keep = [i for i, ct in enumerate(cts) if ct > 0.0]
        pick = lambda seq: [seq[i] for i in keep]      # noqa: E731
        return IntervalBatch(pick(job_ids), pick(phases), pick(t0), pick(t1),
                             pick(chips), pick(pgs), pick(segments),
                             pick(cts))

    # ---- reporting --------------------------------------------------------
    def report(self, capacity_chip_time: Optional[float] = None,
               pg_by_job: Optional[Dict[str, float]] = None) -> GoodputReport:
        """Aggregate MPG report.  With ``pg_by_job``, PG is recomputed from
        the per-job productive sums (exactly the legacy ``compute_goodput``
        semantics); otherwise the streamed per-event ``pg`` weights apply."""
        cap = (self.capacity_chip_time if capacity_chip_time is None
               else capacity_chip_time)
        acc = self._totals
        if pg_by_job is not None:
            acc = _Acc(allocated=self._totals.allocated,
                       productive=self._totals.productive,
                       ideal=sum(ct * pg_by_job.get(j, 1.0)
                                 for j, ct in
                                 sorted(self._job_productive.items())))
        return acc.report(cap)

    def segment_report(self, key: str,
                       capacity_by_segment: Optional[Dict[str, float]] = None
                       ) -> Dict[str, GoodputReport]:
        """Per-segment MPG with per-segment denominators (paper §5)."""
        caps = capacity_by_segment or {}
        return {seg: acc.report(caps.get(seg, 0.0))
                for seg, acc in sorted(self._segments.get(key, {}).items())}

    def rg_breakdown(self) -> Dict[str, float]:
        """Allocated chip-time shares by phase (paper Fig. 10)."""
        out = {p.value: self._totals.phase[p.value]
               for p in Phase
               if p in ALLOCATED_PHASES and
               self._totals.phase.get(p.value, 0.0) > 0}
        total = sum(out.values()) or 1.0
        return {k: v / total for k, v in sorted(out.items())}

    def phase_chip_time(self, phase: Phase) -> float:
        """Raw chip-time sum for one phase (incl. QUEUED/PARTIAL)."""
        return self._totals.phase.get(phase.value, 0.0)

    def segment_phase_chip_time(self, key: str) -> Dict[str, Dict[str, float]]:
        """Per-segment per-phase chip-time sums — the building blocks for
        per-class SG numerators (Fig. 16: PARTIAL vs allocated by class)."""
        return {seg: dict(acc.phase)
                for seg, acc in sorted(self._segments.get(key, {}).items())}

    def series(self, capacity_chips: Optional[float] = None
               ) -> List[Dict[str, float]]:
        """Windowed SG/RG/PG/MPG time series (Fig. 5/11 timelines).

        ``capacity_chips`` sets each window's SG denominator to
        ``capacity_chips * window``; defaults to spreading the ledger's
        total capacity uniformly over the observed window span.
        """
        if not self._windows:
            return []
        idxs = sorted(self._windows)
        if capacity_chips is not None:
            win_cap = capacity_chips * self.window
        else:
            span = (idxs[-1] - idxs[0] + 1) * self.window
            win_cap = (self.capacity_chip_time * self.window / span
                       if span else 0.0)
        out = []
        for widx in idxs:
            rep = self._windows[widx].report(win_cap)
            out.append({"t0": widx * self.window,
                        "t1": (widx + 1) * self.window,
                        "sg": rep.sg, "rg": rep.rg, "pg": rep.pg,
                        "mpg": rep.mpg,
                        "allocated_chip_time": rep.allocated_chip_time,
                        "productive_chip_time": rep.productive_chip_time,
                        "ideal_chip_time": rep.ideal_chip_time})
        return out

    def tail_series(self, n_windows: int,
                    capacity_chips: float) -> List[Dict[str, float]]:
        """The most recent ``n_windows`` rows of the windowed SG/RG/PG
        series — the online controller's observation stream.  Same row
        shape as :meth:`series`, but O(n_windows) instead of walking every
        window, so a per-boundary observer stays cheap on long horizons."""
        if not self._windows or n_windows <= 0:
            return []
        idxs = sorted(self._windows)[-n_windows:]
        win_cap = capacity_chips * self.window
        out = []
        for widx in idxs:
            rep = self._windows[widx].report(win_cap)
            out.append({"t0": widx * self.window,
                        "t1": (widx + 1) * self.window,
                        "sg": rep.sg, "rg": rep.rg, "pg": rep.pg,
                        "mpg": rep.mpg,
                        "allocated_chip_time": rep.allocated_chip_time,
                        "productive_chip_time": rep.productive_chip_time,
                        "ideal_chip_time": rep.ideal_chip_time})
        return out

    def totals(self) -> Dict[str, object]:
        """The exact accumulator state a trace replay must reproduce
        bit-for-bit: event count, capacity, the three MPG chip-time sums,
        and the per-phase split.  Floats are returned unrounded (and
        serialize exactly through JSON's shortest-roundtrip repr), so
        golden-trace tests can assert ``replayed.totals() == trace.totals``
        with plain equality."""
        return {
            "n_events": self.n_events,
            "capacity_chip_time": self.capacity_chip_time,
            "allocated_chip_time": self._totals.allocated,
            "productive_chip_time": self._totals.productive,
            "ideal_chip_time": self._totals.ideal,
            "by_phase": dict(self._totals.phase),
        }

    # ---- introspection ----------------------------------------------------
    def state_size(self) -> Dict[str, int]:
        """Number of tracked accumulator entries — the memory story told by
        ``benchmarks/ledger_scale.py`` (O(state) vs O(events))."""
        return {
            "phases": len(self._totals.phase),
            "segment_keys": len(self._segments),
            "segment_cells": sum(len(v) for v in self._segments.values()),
            "windows": len(self._windows),
            "jobs": len(self._job_productive),
            "retained_intervals": len(self.intervals or ()),
        }
