"""Serving cells: the program's continuous engine (``serve/engine.py``)
over its batched paged executor (``serve/batched_executor.py``), driven
so that the engine's clock is the wall clock.

The engine runs in virtual time: it advances its clock by the cost each
executor operation returns, and jumps it to the next arrival when idle.
:class:`WallClock` wraps the executor so that the two agree: before an
operation it sleeps until the wall clock reaches the engine's clock
(the next arrival), and it returns as the operation's cost the wall time
since the previous one ended, so the engine's own host work between
operations is counted too.  Every token the engine stamps is then a
wall-clock time, counted from the window's opening.  At the first
operation that would start after the window closes, it raises
:class:`WindowClosed`: the requests keep what the window gave them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from portbench.trace import Tracer, label


class WindowClosed(Exception):
    pass


@dataclasses.dataclass
class Op:
    kind: str                    # "prefill" or "decode"
    t0: float                    # seconds after the window opened
    t1: float
    lengths: List[int]           # prompt lengths, or the rows' KV lengths


class WallClock:
    """The executor seen by the engine: real operations, wall-clock costs."""

    def __init__(self, inner, width: int):
        self.inner = inner
        self.width = width
        self.engine = None
        self.origin = time.perf_counter()
        self.close = float("inf")
        self.ops: List[Op] = []
        self.tracer: Optional[Tracer] = None
        self._between = None

    def now(self) -> float:
        return time.perf_counter() - self.origin

    def open(self, close: float, tracer: Optional[Tracer] = None) -> None:
        self.origin = time.perf_counter()
        self.close = close
        self.ops = []
        self.tracer = tracer

    def _begin(self) -> float:
        if self._between is not None:
            self._between.__exit__(None, None, None)
            self._between = None
        wait = self.engine.t - self.now()
        if wait > 0:
            with label("wait_arrival"):
                time.sleep(wait)
        now = self.now()
        if now >= self.close:
            raise WindowClosed
        if self.tracer is not None:
            self.tracer.before(now)
        return self.now()

    def _end(self, kind: str, t0: float, lengths: List[int]) -> float:
        t1 = self.now()
        self.ops.append(Op(kind, t0, t1, lengths))
        if self.tracer is not None:
            self.tracer.after(t1, clock=self.now)
        self._between = label("engine")
        self._between.__enter__()
        return t1

    def prefill(self, reqs):
        t0 = self._begin()
        with label("prefill"):
            toks, _ = self.inner.prefill(reqs)
        t1 = self._end("prefill", t0, [r.prompt_len for r in reqs])
        return toks, t1 - self.engine.t

    def decode(self, reqs):
        t0 = self._begin()
        kv = self.inner.kv
        lengths = [kv.seq_len(r.rid) for r in reqs]
        with label("decode"):
            toks, _ = self.inner.decode(reqs)
        t1 = self._end("decode", t0, lengths)
        return toks, t1 - self.engine.t

    def release(self, req) -> None:
        self.inner.release(req)

    def finish(self) -> None:
        if self._between is not None:
            self._between.__exit__(None, None, None)
            self._between = None
        if self.tracer is not None:
            self.tracer.after(self.now(), force=True)


@dataclasses.dataclass
class Window:
    """What one measured window gave."""
    seconds: float
    requests: list               # the engine's ServeRequest objects
    ops: List[Op]
    prefills: int                # requests prefilled in the window
    captures: int                # prefill graphs captured in the window
    decode_steps: int


class ServeBench:
    """One executor and its engine, built once; windows run on it."""

    def __init__(self, cfg, mix: dict, weights, device):
        from repro_torch.serve.batched_executor import TorchBatchedExecutor

        eng = mix["engine"]
        self.n_slots, self.max_len = eng["n_slots"], eng["max_len"]
        self.ex = TorchBatchedExecutor(cfg, self.max_len, self.n_slots,
                                       device=device, params=weights)
        self.clock = WallClock(self.ex, self.n_slots)
        self.cfg = cfg

    def _requests(self, reqs):
        from repro_torch.serve.engine import ServeRequest

        return [ServeRequest(rid=r.rid, prompt_len=len(r.prompt),
                             max_new=r.max_new, t_submit=r.t_due,
                             prompt=r.prompt) for r in reqs]

    def run(self, reqs, seconds: float,
            tracer: Optional[Tracer] = None) -> Window:
        """The engine over ``reqs`` (``traffic.Request``s) until the
        window of ``seconds`` closes; every request's state is then freed
        from the executor and the allocator."""
        from repro_torch.core.ledger import GoodputLedger
        from repro_torch.serve.engine import ContinuousServeEngine

        served = self._requests(reqs)
        engine = ContinuousServeEngine(self.n_slots, self.clock,
                                       kv_cache=self.ex.kv,
                                       ledger=GoodputLedger(window=60.0),
                                       arch=self.cfg.name)
        self.clock.engine = engine
        before = (self.ex.prefills, self.ex.prefill_graph_stats()["captures"],
                  self.ex.decode_steps)
        self.clock.open(seconds, tracer)
        try:
            engine.run(served)
        except WindowClosed:
            pass
        finally:
            self.clock.finish()
            self._free(served)
        stats = self.ex.prefill_graph_stats()
        return Window(seconds, served, self.clock.ops,
                      self.ex.prefills - before[0],
                      int(stats["captures"]) - before[1],
                      self.ex.decode_steps - before[2])

    def _free(self, served) -> None:
        for r in served:
            if r.rid in self.ex.rows:
                self.ex.release(r)
            try:
                self.ex.kv.free(r.rid)
            except KeyError:
                pass

    def warm(self, reqs) -> None:
        """Run ``reqs`` to their end, untimed: the decode graph's replays,
        a first prefill capture (which warms the side stream up) and the
        engine's paths."""
        self.run(reqs, float("inf"))


def in_window(w: Window) -> List[Op]:
    return [op for op in w.ops if op.t1 <= w.seconds]


def _every(t0: float, t1: float) -> bool:
    return True


def first_token_waits(w: Window, keep=_every) -> List[float]:
    """Each due request's wait from its due time to its first token, or
    to the window's close where it has none by then; ``keep(start, end)``
    chooses the waits by their span (a traced run's, those that do not
    overlap the profiler)."""
    out = []
    for r in w.requests:
        if r.t_submit >= w.seconds:
            continue
        first = r.token_times[0] if r.token_times else None
        end = (first if first is not None and first <= w.seconds
               else w.seconds)
        if keep(r.t_submit, end):
            out.append(end - r.t_submit)
    return out


def token_gaps(w: Window, keep=_every) -> List[float]:
    """Every gap between two consecutive output tokens of one request,
    both inside the window (``keep`` as above)."""
    out = []
    for r in w.requests:
        ts = [t for t in r.token_times if t <= w.seconds]
        out.extend(b - a for a, b in zip(ts, ts[1:]) if keep(a, b))
    return out


def tokens_done(w: Window) -> int:
    """Prompt tokens prefilled and output tokens generated in the window
    (a prefill's prompt and first token count when the prefill ends in
    it)."""
    n = 0
    for r in w.requests:
        ts = [t for t in r.token_times if t <= w.seconds]
        if ts:
            n += r.prompt_len + len(ts)
    return n


def finished(w: Window) -> list:
    """Requests whose every output token came in the window."""
    return [r for r in w.requests
            if len(r.out_tokens) == r.max_new and r.token_times
            and r.token_times[-1] <= w.seconds]


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))

