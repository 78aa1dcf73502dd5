"""The traced run's profile: ``torch.profiler`` over a sub-window of the
measured window, started and stopped between two operations of the
harness, so the operations inside it are whole.

``Trace`` reads the device's busy time (the union of every kernel, copy
and set on the card), each kernel's time by name, and where the device
sat idle: each gap between device activity is named by the harness's
own host range (``portbench.*`` ``record_function`` labels) that holds
its midpoint.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def label(name: str):
    """A host range the trace names idle gaps by."""
    return torch.profiler.record_function(f"portbench.{name}")


class Tracer:
    """Profiles from the first operation that starts at or after
    ``start`` until the first that ends at or after ``stop`` (seconds on
    the harness's window clock)."""

    def __init__(self, start: float, stop: float):
        self.start, self.stop = start, stop
        self.prof = None
        self.t0 = self.t1 = self.t_resumed = None
        self._done = None
        self._trace: Optional["Trace"] = None

    def before(self, now: float) -> None:
        if self.prof is None and self._done is None and now >= self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.t0 = now

    def after(self, now: float, force: bool = False,
              clock=None) -> None:
        """Stop at or after ``stop``; ``clock`` reads the window's clock
        once the profiler has stopped (its own cost ends there)."""
        if self.prof is not None and (now >= self.stop or force):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.t1 = now
            self.t_resumed = clock() if clock is not None else now
            self._done, self.prof = self.prof, None

    @property
    def trace(self) -> Optional["Trace"]:
        """The profile, read once the window is over."""
        if self._trace is None and self._done is not None:
            self._trace = Trace(self._done, self.t1 - self.t0)
            self._done = None
        return self._trace

    def outside(self, t0: float, t1: float) -> bool:
        """Whether an operation on [t0, t1] ran with no profiler on and
        none of its stopping."""
        return (self.t0 is None or t1 <= self.t0
                or (self.t_resumed is not None and t0 >= self.t_resumed))

    def inside(self, t0: float, t1: float) -> bool:
        """Whether an operation on [t0, t1] lies in the traced span."""
        return (self.t0 is not None and self.t1 is not None
                and t0 >= self.t0 and t1 <= self.t1)


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start loads and sets
    up CUPTI, which takes seconds, and belongs to set-up."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The profile's events, read from its Chrome trace (written by the
    profiler itself, read back once and deleted: far quicker than its
    Python event tree)."""

    def __init__(self, prof, window_s: float):
        t = time.perf_counter()
        self.window_s = window_s
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            a = float(e["ts"]) / 1e6
            b = a + float(e.get("dur", 0)) / 1e6
            if cat in DEVICE_CATS:
                self.device.append((a, b, name))
            elif cat == "user_annotation" and name.startswith("portbench."):
                self.host.append((a, b, name[len("portbench."):]))
        busy = _union([(a, b) for a, b, _ in self.device])
        self.busy_s = sum(b - a for a, b in busy)
        self._busy = busy
        self.read_s = time.perf_counter() - t

    def kernel_s(self, names: Iterable[str]) -> float:
        """Device seconds of the kernels whose name holds one of
        ``names`` as a whole identifier."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(b - a for a, b, n in self.device if pat.search(n))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for a, b, name in self.device:
            key = name[:96]
            by[key] = by.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between device activity inside the
        traced span, each named by the host range around its midpoint."""
        gaps = []
        if self.host:
            lo = min(a for a, _, _ in self.host)
            hi = max(b for _, b, _ in self.host)
            edges = [(lo, lo)] + self._busy + [(hi, hi)]
        else:
            edges = self._busy
        for (_, e0), (s1, _) in zip(edges, edges[1:]):
            if s1 > e0:
                gaps.append((s1 - e0, (e0 + s1) / 2))
        gaps.sort(reverse=True)
        out = []
        for length, mid in gaps[:n]:
            held = [(b - a, name) for a, b, name in self.host
                    if a <= mid <= b]
            out.append([min(held)[1] if held else "outside portbench ranges",
                        length])
        return out

    def summary(self) -> dict:
        """How much the profile holds (a check of the trace itself)."""
        span = (max(b for _, b, _ in self.host) - min(a for a, _, _ in self.host)
                if self.host else 0.0)
        return {"device_events": len(self.device),
                "host_ranges": len(self.host), "host_span_s": span,
                "read_s": self.read_s}

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}
