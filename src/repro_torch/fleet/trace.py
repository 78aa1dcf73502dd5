"""The port's copy of ``repro.fleet.trace``, unchanged in behaviour (the
port imports nothing of the reference package).

Versioned JSONL event traces: record a run once, replay it exactly.

A trace is the cross-layer ``(Interval, pg)`` event stream observed on a
:class:`~repro_torch.core.ledger.GoodputLedger`, serialized one JSON object per
line.  Every emitter (``FleetSim`` — ``emitter: fleet``, ``Orchestrator``
— ``emitter: runtime``, the serve loop — ``emitter: serve``) tags its
segment dict with its provenance plus the responsible stack layer
(``layer:`` a ``repro_torch.core.goodput.Layer`` value), so one recorder
attached to a shared ledger captures the whole stack and replay
reconstructs per-layer sub-ledgers — and the attribution waterfall
(``repro_torch.core.attribution``) — for free.

Schema (version 1) — three line kinds, in file order:

  {"kind": "header", "version": 1, "capacity_chip_time": .., "window": ..,
   "meta": {..}}
  {"kind": "event", "job": .., "phase": "step", "t0": .., "t1": ..,
   "chips": .., "pg": .., "seg": {..}}            # one per ledger event
  {"kind": "footer", "totals": {..}}              # ledger.totals() snapshot

Versioning rules: ``TRACE_VERSION`` bumps whenever a field is renamed,
removed, or its semantics change; adding an optional field is *not* a bump
(readers ignore unknown keys).  ``loads`` refuses versions it does not
know.  The committed golden traces under ``tests/golden/`` are the
reference's and are only read here (``--verify``); ``python -m
repro_torch.fleet.trace --refresh-golden`` records the port's own into
``REFRESH_DIR`` under ``build/`` (or ``--golden-dir``), never into
``tests/golden/``.

Determinism contract: floats serialize through Python's shortest-roundtrip
repr (exact), events are written in emission order, and every random
stream in the simulator is seeded per component — so the same (scenario,
seed) produces a byte-identical trace, and ``replay(record(sim))``
reproduces the original ledger totals bit-for-bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
from typing import Dict, List, Optional

from repro_torch.core.goodput import Interval, Phase
from repro_torch.core.ledger import GoodputLedger

TRACE_VERSION = 2
_ROOT = pathlib.Path(__file__).resolve().parents[3]
GOLDEN_DIR = _ROOT / "tests" / "golden"          # read only
REFRESH_DIR = _ROOT / "build" / "golden_torch"

_JSON = dict(sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded ledger event (an Interval plus its pg weight)."""
    job_id: str
    phase: str
    t0: float
    t1: float
    chips: int
    pg: float
    segment: Dict[str, str]

    def to_interval(self) -> Interval:
        return Interval(job_id=self.job_id, phase=Phase(self.phase),
                        t0=self.t0, t1=self.t1, chips=self.chips,
                        segment=dict(self.segment))


@dataclasses.dataclass
class Trace:
    """A parsed trace: header metadata, the event stream, and the exact
    ledger totals observed at record time (the replay target)."""
    capacity_chip_time: float
    window: float
    meta: Dict[str, object]
    events: List[TraceEvent]
    totals: Dict[str, object]
    version: int = TRACE_VERSION

    # ---- serialization ---------------------------------------------------
    def dumps(self) -> str:
        lines = [json.dumps({"kind": "header", "version": self.version,
                             "capacity_chip_time": self.capacity_chip_time,
                             "window": self.window, "meta": self.meta},
                            **_JSON)]
        for ev in self.events:
            lines.append(json.dumps(
                {"kind": "event", "job": ev.job_id, "phase": ev.phase,
                 "t0": ev.t0, "t1": ev.t1, "chips": ev.chips, "pg": ev.pg,
                 "seg": ev.segment}, **_JSON))
        lines.append(json.dumps({"kind": "footer", "totals": self.totals},
                                **_JSON))
        return "\n".join(lines) + "\n"

    @classmethod
    def loads(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace")
        header = json.loads(lines[0])
        if header.get("kind") != "header":
            raise ValueError("trace must start with a header line")
        if header.get("version") != TRACE_VERSION:
            raise ValueError(
                f"unsupported trace version {header.get('version')!r} "
                f"(this reader supports {TRACE_VERSION})")
        events: List[TraceEvent] = []
        totals: Dict[str, object] = {}
        for ln in lines[1:]:
            obj = json.loads(ln)
            kind = obj.get("kind")
            if kind == "event":
                events.append(TraceEvent(
                    job_id=obj["job"], phase=obj["phase"], t0=obj["t0"],
                    t1=obj["t1"], chips=obj["chips"], pg=obj["pg"],
                    segment=obj.get("seg", {})))
            elif kind == "footer":
                totals = obj["totals"]
            else:
                raise ValueError(f"unknown trace line kind {kind!r}")
        return cls(capacity_chip_time=header["capacity_chip_time"],
                   window=header["window"], meta=header.get("meta", {}),
                   events=events, totals=totals,
                   version=header["version"])

    def dump(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.dumps())
        return path

    @classmethod
    def load(cls, path) -> "Trace":
        return cls.loads(pathlib.Path(path).read_text())


class TraceRecorder:
    """Subscribes to a ledger's pg-aware event hook and accumulates the
    stream; ``finalize`` snapshots the ledger totals into a Trace."""

    def __init__(self, meta: Optional[Dict[str, object]] = None):
        self.meta = dict(meta or {})
        self._events: List[TraceEvent] = []

    def attach(self, ledger: GoodputLedger) -> "TraceRecorder":
        ledger.subscribe_events(self._on_event, batch_fn=self._on_batch)
        return self

    def _on_event(self, iv: Interval, pg: float) -> None:
        self._events.append(TraceEvent(
            job_id=iv.job_id, phase=iv.phase.value, t0=iv.t0, t1=iv.t1,
            chips=iv.chips, pg=pg, segment=dict(iv.segment)))

    def _on_batch(self, batch) -> None:
        # columnar twin of _on_event: same TraceEvents in the same order
        # (segment dicts are copied — the sim interns and reuses them)
        self._events.extend(TraceEvent(
            job_id=j, phase=ph.value, t0=a, t1=b, chips=c, pg=pg,
            segment=dict(seg))
            for j, ph, a, b, c, pg, seg in zip(
                batch.job_ids, batch.phases, batch.t0, batch.t1,
                batch.chips, batch.pgs, batch.segments))

    def finalize(self, ledger: GoodputLedger) -> Trace:
        return Trace(capacity_chip_time=ledger.capacity_chip_time,
                     window=ledger.window, meta=self.meta,
                     events=self._events, totals=ledger.totals())


def record(sim, meta: Optional[Dict[str, object]] = None) -> Trace:
    """Run ``sim`` under a recorder and return the trace.

    The recorder must observe the stream from the first event, so the
    sim's ledger has to be empty — attach-then-run.  For cross-layer
    traces (orchestrator / serve emitting into the same ledger), attach a
    :class:`TraceRecorder` to the shared ledger directly.
    """
    if sim.ledger.n_events:
        raise ValueError(
            "record(sim) must attach before any event is emitted; the "
            "sim's ledger already holds events — build a fresh sim (or "
            "attach a TraceRecorder to the shared ledger up front)")
    cfg = sim.cfg
    info: Dict[str, object] = {
        "seed": cfg.seed, "n_pods": cfg.n_pods, "pod_size": cfg.pod_size,
        "horizon": cfg.horizon,
        "scenario": cfg.scenario.name if cfg.scenario else None,
        "placement": sim.placement.name, "preemption": sim.preemption.name,
        "defrag": sim.defrag.name,
        "slice_repair_s": cfg.slice_repair_s,
    }
    # workload provenance (set by scenarios.build_sim): with it, a trace
    # alone rebuilds the exact sim — the advisor's counterfactual entry
    # point (repro_torch.fleet.advisor.from_trace)
    workload = getattr(sim, "workload_info", None)
    if workload is not None:
        info["workload"] = workload
    info.update(meta or {})
    rec = TraceRecorder(meta=info).attach(sim.ledger)
    sim.run()
    return rec.finalize(sim.ledger)


def replay(trace: Trace, ledger: Optional[GoodputLedger] = None
           ) -> GoodputLedger:
    """Feed a trace's events through a ledger in recorded order.

    With a fresh default ledger this reproduces the recorded totals
    bit-for-bit (identical float operations in identical order); pass an
    existing ledger to merge several traces into one fleet-wide view.
    """
    if ledger is None:
        ledger = GoodputLedger(capacity_chip_time=trace.capacity_chip_time,
                               window=trace.window, retain_intervals=False)
    for ev in trace.events:
        ledger.record(ev.to_interval(), pg=ev.pg)
    return ledger


def verify(trace: Trace) -> Dict[str, object]:
    """Replay a trace and check the footer totals reproduce exactly.

    Returns the replayed totals; raises ``ValueError`` on any drift —
    the golden-trace regression condition.
    """
    got = replay(trace).totals()
    if got != trace.totals:
        raise ValueError(
            "replay drift: totals do not reproduce the recorded footer\n"
            f"  recorded: {trace.totals}\n  replayed: {got}")
    return got


# ---------------------------------------------------------------------------
# CLI: golden-trace maintenance
# ---------------------------------------------------------------------------

def refresh_golden(golden_dir=REFRESH_DIR) -> List[pathlib.Path]:
    """Re-record every scenario preset's golden trace into
    ``golden_dir``; refuses the committed ``GOLDEN_DIR``."""
    from repro_torch.fleet.scenarios import SCENARIOS, golden_sim

    golden_dir = pathlib.Path(golden_dir)
    if golden_dir.resolve() == GOLDEN_DIR.resolve():
        raise ValueError(f"{GOLDEN_DIR} holds the committed golden "
                         "traces and is only read; name another "
                         "directory")
    written = []
    for name in sorted(SCENARIOS):
        trace = record(golden_sim(name))
        written.append(trace.dump(golden_dir / f"{name}.jsonl"))
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="record / verify / refresh goodput event traces")
    ap.add_argument("--refresh-golden", action="store_true",
                    help="re-record <golden-dir>/<preset>.jsonl for "
                         "every scenario preset")
    ap.add_argument("--golden-dir", default=str(REFRESH_DIR))
    ap.add_argument("--verify", nargs="+", metavar="TRACE",
                    help="replay trace file(s) and check footer totals "
                         "reproduce exactly")
    ap.add_argument("--record", metavar="PRESET",
                    help="record one scenario preset (golden-sized sim)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path for --record")
    args = ap.parse_args(argv)

    if args.refresh_golden:
        for p in refresh_golden(args.golden_dir):
            print(f"wrote {p}")
        return
    if args.verify:
        for path in args.verify:
            verify(Trace.load(path))
            print(f"ok {path}")
        return
    if args.record:
        from repro_torch.fleet.scenarios import golden_sim

        trace = record(golden_sim(args.record))
        out = args.out or f"{args.record}.jsonl"
        print(f"wrote {trace.dump(out)} ({len(trace.events)} events)")
        return
    ap.error("choose one of --refresh-golden / --verify / --record")


if __name__ == "__main__":
    main()
