"""The port's copy of ``repro.core.attribution``, unchanged in behaviour
(the port imports nothing of the reference package).

Cross-layer MPG attribution waterfall (paper §6, Figs 14–15).

"Where did the goodput go?" — the paper answers by decomposing fleet
capacity chip-time into productive time plus named losses, each charged
to the stack layer responsible (model, data, framework, compiler,
scheduling, hardware).  :class:`AttributionWaterfall` is a streaming
subscriber on a :class:`~repro_torch.core.ledger.GoodputLedger`: it keeps
O(#layers x #phases) accumulator state — never an interval list — and
maintains an *exact* partition of capacity chip-time:

    capacity = ideal + program_gap + Σ layer losses + unallocated

where ``program_gap = productive - ideal`` (the Program-Goodput gap,
charged to the model layer) and ``unallocated = capacity - allocated``
(capacity no job held, charged to the scheduling layer).  QUEUED/PARTIAL
waiting time is *demand-side* (a job waiting does not consume capacity),
so it is reported separately (``waits``) and excluded from the capacity
partition — double-counting it against capacity is the classic
conservation bug the exactness contract exists to catch.

Two levels of exactness:

  * the waterfall mirrors the ledger's float accumulators operation-for-
    operation (same event stream, same order), so
    ``assert_conserves(ledger)`` compares its totals against
    ``ledger.totals()`` with plain ``==`` — bit-for-bit;
  * every event's chip-time is *also* accumulated per (layer, phase)
    cell in exact arithmetic (integers scaled by the subnormal quantum
    ``2**-1074``, to which every finite float converts losslessly — same
    exactness as ``fractions.Fraction``, at integer-addition cost), so
    "Σ buckets == allocated" is checked with no rounding at all — a
    misrouted event cannot hide in float slack.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from repro_torch.core.goodput import (ALLOCATED_PHASES, PRODUCTIVE_PHASES,
                                      Interval, Layer, Phase, layer_of,
                                      loss_bucket)
from repro_torch.core.ledger import GoodputLedger, _Acc

# Exact accumulation representation: every finite float is an integer
# multiple of 2**-1074 (the subnormal quantum), so chip-times are stored
# as plain ints scaled by 2**_SHIFT — integer addition is exact and an
# order of magnitude cheaper than Fraction arithmetic, and converts
# losslessly to Fraction(x, 1 << _SHIFT) at the read sites.  The ideal
# sum holds products of two scaled values, hence scale 2**(2 * _SHIFT).
_SHIFT = 1074


def _exact(x: float) -> int:
    """``x`` as an integer scaled by ``2**_SHIFT`` (exact for any finite
    float: the denominator of ``as_integer_ratio`` is a power of two no
    larger than ``2**_SHIFT``)."""
    p, q = x.as_integer_ratio()
    return p << (_SHIFT + 1 - q.bit_length())


@dataclasses.dataclass(frozen=True)
class LossRow:
    """One waterfall row: chip-time lost in one (layer, phase) cell."""
    layer: str
    phase: Optional[str]       # None for the unallocated-capacity row
    bucket: str
    chip_time: float
    frac_of_capacity: float

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class AttributionWaterfall:
    """Streaming per-layer/per-phase lost-chip-time attribution.

    Attach to a ledger *before* any event is emitted (like a trace
    recorder) so the mirror accumulators see the identical stream::

        ledger = GoodputLedger(...)
        wf = AttributionWaterfall().attach(ledger)
        ...emit...
        wf.assert_conserves(ledger)       # bit-for-bit + exact partition
        report = wf.report()
    """

    def __init__(self):
        self._ledger: Optional[GoodputLedger] = None
        self.n_events = 0
        # float mirror of the ledger's aggregate accumulator — identical
        # operations in identical order, so totals compare with plain ==
        self._mirror = _Acc()
        # exact per-(layer, phase) chip-time cells (capacity partition),
        # as ints scaled by 2**_SHIFT — see module comment on _exact
        self._cells: Dict[Tuple[str, str], int] = defaultdict(int)
        # exact running totals over the same addends as the cells
        # (allocated/productive at scale 2**_SHIFT, ideal at 2**(2*_SHIFT))
        self._exact_allocated = 0
        self._exact_productive = 0
        self._exact_ideal = 0
        # demand-side waiting time (QUEUED/PARTIAL) per layer — reported,
        # not part of the capacity partition
        self._waits: Dict[Tuple[str, str], int] = defaultdict(int)
        # layer_of memo for the batched path, keyed on interned-segment
        # identity + phase (layer_of falls back to a per-phase default
        # when the segment carries no valid layer tag)
        self._layer_cache: Dict[Tuple[int, str], Tuple[dict, str]] = {}
        # pg floats repeat heavily across a stream; cache their scalings
        self._pg_exact: Dict[float, int] = {}

    # ---- ingestion --------------------------------------------------------
    def attach(self, ledger: GoodputLedger) -> "AttributionWaterfall":
        if ledger.n_events:
            raise ValueError(
                "AttributionWaterfall must attach before any event is "
                "emitted — the ledger already holds events, so the mirror "
                "accumulators could never match ledger.totals()")
        self._ledger = ledger
        ledger.subscribe_events(self.on_event, batch_fn=self.on_batch)
        return self

    def on_event(self, iv: Interval, pg: float) -> None:
        ct = iv.chip_time
        if ct <= 0.0:
            return
        self.n_events += 1
        self._mirror.add(iv.phase, ct, pg)
        layer = layer_of(iv.segment, iv.phase)
        cell = (layer.value, iv.phase.value)
        exact_ct = _exact(ct)
        if iv.phase in ALLOCATED_PHASES:
            self._cells[cell] += exact_ct
            self._exact_allocated += exact_ct
            if iv.phase in PRODUCTIVE_PHASES:
                self._exact_productive += exact_ct
                self._exact_ideal += exact_ct * _exact(pg)
        else:
            self._waits[cell] += exact_ct

    def on_batch(self, batch) -> None:
        """Columnar twin of :meth:`on_event` (the ledger's batched ingest
        delivers an ``IntervalBatch`` here): identical accumulator updates
        in identical order, so the float mirror and the exact cells match
        the per-event path bit-for-bit.  The responsible layer is resolved
        once per interned segment-dict identity, not per event."""
        mirror = self._mirror
        mphase = mirror.phase
        cells = self._cells
        waits = self._waits
        layer_cache = self._layer_cache
        pg_exact = self._pg_exact
        phases = batch.phases
        pgs = batch.pgs
        segments = batch.segments
        cts = batch.chip_times
        n = 0
        ea = ep = ei = 0     # integer sums commute exactly; fold in at end
        for i in range(len(cts)):
            ct = cts[i]
            if ct <= 0.0:
                continue
            n += 1
            ph = phases[i]
            pg = pgs[i]
            seg = segments[i]
            # inlined _Acc.add body — identical float ops, identical order
            pv = ph._value_
            mphase[pv] = mphase.get(pv, 0.0) + ct
            key = (id(seg), pv)
            entry = layer_cache.get(key)
            if entry is not None and entry[0] is seg:
                lv = entry[1]
            else:
                lv = layer_of(seg, ph).value
                if len(layer_cache) < 4096:
                    layer_cache[key] = (seg, lv)
            exact_ct = _exact(ct)
            if ph._x_alloc:
                mirror.allocated += ct
                cells[(lv, pv)] += exact_ct
                ea += exact_ct
                if ph._x_prod:
                    mirror.productive += ct
                    mirror.ideal += ct * pg
                    ep += exact_ct
                    pgx = pg_exact.get(pg)
                    if pgx is None:
                        pgx = pg_exact[pg] = _exact(pg)
                    ei += exact_ct * pgx
            else:
                waits[(lv, pv)] += exact_ct
        self._exact_allocated += ea
        self._exact_productive += ep
        self._exact_ideal += ei
        self.n_events += n

    # ---- conservation -----------------------------------------------------
    @property
    def capacity_chip_time(self) -> float:
        return self._ledger.capacity_chip_time if self._ledger else 0.0

    def conservation(self, capacity_chip_time: Optional[float] = None
                     ) -> Dict[str, bool]:
        """The exactness contract, checked with zero tolerance:

          * ``cells_partition_allocated`` — Σ (layer, phase) cells equals
            allocated chip-time in exact rational arithmetic, so a
            misrouted or dropped event cannot hide in float slack (the
            capacity identity ``ideal + gap + losses + unallocated ==
            capacity`` then holds by construction: gap, losses and
            unallocated are defined as the residuals);
          * ``capacity_covers_allocated`` — a *set* capacity is at least
            the allocated chip-time, so the derived unallocated row is
            non-negative (this is what a mis-set capacity breaks;
            vacuous when no capacity was ever registered, the
            RG-only/orchestrator use);
          * ``mirrors_ledger`` — the float mirror equals
            ``ledger.totals()`` bit-for-bit (plain ``==`` on floats).
        """
        cap = _exact(self.capacity_chip_time
                     if capacity_chip_time is None else capacity_chip_time)
        cells_total = sum(self._cells.values())
        out = {
            "cells_partition_allocated": cells_total == self._exact_allocated,
            "capacity_covers_allocated":
                cap == 0 or cap >= self._exact_allocated,
            "mirrors_ledger": (self._ledger is None
                               or self.totals_match(self._ledger)),
        }
        out["conserved"] = all(out.values())
        return out

    def totals_match(self, ledger: GoodputLedger) -> bool:
        """Bit-for-bit: the float mirror reproduces ``ledger.totals()``."""
        t = ledger.totals()
        return (self.n_events == t["n_events"]
                and self._mirror.allocated == t["allocated_chip_time"]
                and self._mirror.productive == t["productive_chip_time"]
                and self._mirror.ideal == t["ideal_chip_time"]
                and dict(self._mirror.phase) == t["by_phase"])

    def assert_conserves(self, ledger: Optional[GoodputLedger] = None
                         ) -> None:
        ledger = ledger if ledger is not None else self._ledger
        if ledger is not None and not self.totals_match(ledger):
            raise AssertionError(
                "attribution drift: waterfall mirror != ledger.totals()\n"
                f"  mirror: allocated={self._mirror.allocated!r} "
                f"productive={self._mirror.productive!r} "
                f"ideal={self._mirror.ideal!r} n={self.n_events}\n"
                f"  ledger: {ledger.totals()!r}")
        checks = self.conservation()
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"attribution conservation failed: {bad}")

    # ---- reporting --------------------------------------------------------
    def lost_chip_time(self, layer: Optional[Layer] = None,
                       phase: Optional[Phase] = None) -> float:
        """Allocated-but-unproductive chip-time, filtered by layer and/or
        phase (waiting time excluded — see module docstring)."""
        total = 0
        for (lyr, ph), ct in self._cells.items():
            if Phase(ph) in PRODUCTIVE_PHASES:
                continue
            if layer is not None and lyr != layer.value:
                continue
            if phase is not None and ph != phase.value:
                continue
            total += ct
        return float(Fraction(total, 1 << _SHIFT))

    def bucket_totals(self) -> Dict[str, float]:
        """Chip-time per named loss bucket, folding the exact (layer,
        phase) cells *and* the demand-side waits by bucket name.  Exact
        integer cells convert to floats identically on every engine, so a
        controller (or the advisor's addressable-loss early-exit) reading
        these deltas stays decision-identical across engines.  Productive
        cells and empty buckets are omitted."""
        one = 1 << _SHIFT
        out: Dict[str, float] = {}
        for cells in (self._cells, self._waits):
            for (lyr, ph), ct in sorted(cells.items()):
                phase = Phase(ph)
                if phase in PRODUCTIVE_PHASES or ct == 0:
                    continue
                bucket = loss_bucket(phase, Layer(lyr))
                out[bucket] = out.get(bucket, 0.0) + float(Fraction(ct, one))
        return out

    def report(self, capacity_chip_time: Optional[float] = None
               ) -> Dict[str, object]:
        """The waterfall, JSON-ready: capacity decomposed into ideal,
        program gap, named per-layer losses (sorted, largest first), and
        unallocated capacity; demand-side waits listed separately."""
        cap = (self.capacity_chip_time if capacity_chip_time is None
               else capacity_chip_time)
        fcap = cap if cap else 1.0
        one = 1 << _SHIFT
        rows: List[LossRow] = []
        for (lyr, ph), ct in sorted(self._cells.items()):
            phase = Phase(ph)
            if phase in PRODUCTIVE_PHASES or ct == 0:
                continue
            fct = float(Fraction(ct, one))
            rows.append(LossRow(layer=lyr, phase=ph,
                                bucket=loss_bucket(phase, Layer(lyr)),
                                chip_time=fct,
                                frac_of_capacity=fct / fcap))
        # productive is at scale 2**_SHIFT, ideal at 2**(2*_SHIFT)
        gap = float(Fraction((self._exact_productive << _SHIFT)
                             - self._exact_ideal, one * one))
        if gap:
            rows.append(LossRow(layer=Layer.MODEL.value, phase="step",
                                bucket="program_gap", chip_time=gap,
                                frac_of_capacity=gap / fcap))
        # the unallocated row only exists relative to a set capacity; on
        # a capacity-less ledger (RG-only use) it would be a meaningless
        # negative residual
        unalloc = (float(Fraction(_exact(cap) - self._exact_allocated, one))
                   if cap else 0.0)
        if unalloc:
            rows.append(LossRow(layer=Layer.SCHEDULING.value, phase=None,
                                bucket="unallocated_capacity",
                                chip_time=unalloc,
                                frac_of_capacity=unalloc / fcap))
        rows.sort(key=lambda r: (-r.chip_time, r.layer, r.bucket))
        by_layer: Dict[str, float] = defaultdict(float)
        for r in rows:
            by_layer[r.layer] += r.chip_time
        return {
            "capacity_chip_time": cap,
            "allocated_chip_time": self._mirror.allocated,
            "productive_chip_time": self._mirror.productive,
            "ideal_chip_time": self._mirror.ideal,
            "losses": [r.as_dict() for r in rows],
            "lost_by_layer": dict(sorted(by_layer.items(),
                                         key=lambda kv: -kv[1])),
            "waits": {f"{lyr}/{ph}": float(Fraction(ct, one))
                      for (lyr, ph), ct in sorted(self._waits.items())
                      if ct},
            "conservation": self.conservation(cap),
        }

    def state_size(self) -> Dict[str, int]:
        """Accumulator entries — bounded by #layers x #phases, not by
        events (the ``benchmarks/ledger_scale.py`` memory story)."""
        return {"cells": len(self._cells), "waits": len(self._waits)}


def waterfall_from_trace(trace) -> Tuple[AttributionWaterfall, GoodputLedger]:
    """Replay a recorded trace under a fresh waterfall; the replayed
    ledger reproduces the trace footer bit-for-bit, so the attribution is
    exactly the one the live run would have produced."""
    from repro_torch.fleet.trace import replay

    ledger = GoodputLedger(capacity_chip_time=trace.capacity_chip_time,
                           window=trace.window, retain_intervals=False)
    wf = AttributionWaterfall().attach(ledger)
    replay(trace, ledger=ledger)
    return wf, ledger
