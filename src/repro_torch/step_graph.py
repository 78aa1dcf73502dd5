"""A step over static buffers, run as a captured CUDA graph or called
directly: the one capture path of the port's compiled steps, the decode
step (``serve/decode_graph.py``) and the train step
(``launch/strategy.py``), the counterparts of the reference's
``jax.jit``.

A step is a function of a dict of static tensors (``buffers``): it reads
its inputs there and writes its outputs there, in place, so the same
addresses serve every call.  The caller fills the inputs with ``copy_``
before a call and reads the outputs after it.

The implementation choice (``decode_impl``, ``step_impl``) follows the
kernels' ``impl`` idiom:

* ``"auto"``: the graph when ``device`` is CUDA, a direct call on the CPU;
* ``"graph"``: the graph, and ``ValueError`` on the CPU;
* ``"eager"``: a direct call on any device (the graph's comparison).

There is no fallback: a CUDA step in ``"auto"`` is captured or the
constructor raises, and nothing is caught.

Capture follows PyTorch's recipe: a side stream waits on the current
one, ``warmup`` calls (``WARMUP`` by default) run on it outside the
capture (they make what a first call makes: paged attention's per-stream
ticket array, the kernel libraries, cuBLAS's per-stream workspace, the
allocator's blocks), then the step is captured on that same stream, so
the graph keeps that stream's state.  A graph captured on a side stream
where a step of the same kernels has already run (the prefill graphs
after an owner's first, ``serve/prefill_graph.py``) may pass
``warmup=0``: what a first call makes is there already.  Work the step
runs in autograd's backward is captured too: autograd runs each backward
node on its forward's stream.  Replays run on the current stream; the
side stream gets no work after the capture, and the current stream
waits for it once, so every replay is ordered after the warm-up.  A replay launches nothing from Python, so
the kernel wrappers' ``LAUNCHES`` counters see only the ``calls``
(warm-ups, capture, eager calls): the kernels a run really launched are
``calls`` plus ``replays`` times those of one step.

Tensors the step allocates come, inside the capture, from the graph's
memory pool; a replay rewrites them.  Nothing but ``buffers`` may be read
after a replay.  The step must read no tensor on the host and copy none
from it: a synchronisation inside a capture raises.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch

IMPLS = ("auto", "graph", "eager")
# calls before the capture: PyTorch's recipe asks for a few, so every
# lazy first-call effect (allocations, library loads, the paged
# kernel's per-stream tickets) happens outside it
WARMUP = 2


def resolve_impl(impl: str, device: torch.device, option: str) -> str:
    """"graph" or "eager" for a step on ``device``; ``option`` names the
    argument in the errors."""
    if impl not in IMPLS:
        raise ValueError(f"unknown {option} {impl!r}; one of {IMPLS}")
    if impl == "auto":
        return "graph" if device.type == "cuda" else "eager"
    if impl == "graph" and device.type != "cuda":
        raise ValueError(f"{option}='graph' needs a CUDA device, got "
                         f"{device}")
    return impl


class StepGraph:
    """``step(buffers)`` captured once and replayed, or called directly.

    ``stream`` and ``pool`` let several graphs share one side stream and
    one memory pool (the per-slot executor's entries); by default each
    graph has its own.  ``warmup`` is the number of direct calls before
    the capture.  Counts: ``captures`` (0 or 1), ``replays``, ``calls``
    (direct calls of ``step``), ``capture_s`` (wall seconds of the
    warm-up and the capture) and ``capture_bytes`` (device memory the
    capture reserved: the graph's share of its pool)."""

    def __init__(self, step: Callable[[Dict[str, Any]], None],
                 buffers: Dict[str, Any], device: torch.device,
                 impl: str = "auto",
                 stream: Optional["torch.cuda.Stream"] = None,
                 pool=None, option: str = "impl", warmup: int = WARMUP):
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        self.step = step
        self.buffers = buffers
        self.mode = resolve_impl(impl, device, option)
        self.captures = self.replays = self.calls = 0
        self.capture_s = 0.0
        self.capture_bytes = 0
        self.graph = None
        self.warmup = warmup
        if self.mode == "graph":
            self._capture(device, stream, pool)

    def _call(self) -> None:
        self.step(self.buffers)
        self.calls += 1

    def _capture(self, device, stream, pool) -> None:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(device)
        side = stream if stream is not None else torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                self._call()
        # torch.cuda.graph empties the allocator's cache on entry; doing it
        # first makes the reserved bytes' growth the graph's own segments
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        # no garbage collection inside the capture: one may free what an
        # unreachable executor held (its graphs, pinned host buffers) with
        # CUDA calls that end the capture (cudaErrorStreamCaptureInvalidated,
        # seen once in a card test run); the garbage waits until after it
        collecting = gc.isenabled()
        gc.disable()
        try:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=side):
                self._call()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        self.capture_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_s = time.perf_counter() - t0
        self.captures = 1

    def __call__(self) -> None:
        """One step: a replay on the current stream, or a direct call."""
        if self.graph is None:
            self._call()
        else:
            self.graph.replay()
            self.replays += 1


def graph_stats(graphs: Iterable[StepGraph]) -> Dict[str, float]:
    """Summed counts of ``graphs``: captures, replays, direct calls of the
    step, capture seconds and capture bytes."""
    graphs = list(graphs)
    return {k: sum(getattr(g, k) for g in graphs)
            for k in ("captures", "replays", "calls", "capture_s",
                      "capture_bytes")}
