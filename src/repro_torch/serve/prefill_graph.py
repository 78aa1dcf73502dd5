"""Prefills over static buffers, one captured CUDA graph per input shape:
the port's counterpart of the reference's ``jax.jit`` prefill, which
compiles once per prompt length (``repro.serve.batched_executor``,
``repro.serve.jax_executor``, and the static ``Server``'s group prefill
in ``repro.launch.serve``).

:class:`PrefillGraphs` maps an input shape, ``(batch, prompt_len)``, to
a :class:`~repro_torch.step_graph.StepGraph` of its owner's prefill step
over that shape's static buffers.  On a miss it builds the buffers, lets
the caller fill the inputs, captures the step and replays it; on a hit
it lets the caller fill the inputs and replays.  The step reads its
inputs from the buffers and writes its outputs into tensors allocated
outside every capture (the buffers, or the owner's static caches), so no
tensor a capture allocates is read after a replay.

The capture, the ``"auto"`` / ``"graph"`` / ``"eager"`` choice and the
rules a step keeps are ``repro_torch.step_graph``'s, here named
``prefill_impl``: "auto" captures on CUDA and calls the step directly,
through the same buffers, on the CPU; "graph" raises on the CPU.  There
is no fallback: a shape whose capture fails raises, and nothing runs it
eagerly instead.

Every graph of one owner captures on one side stream into one memory
pool (the owner may pass the stream and pool its decode graphs use), and
the graphs replay one after another on the current stream, so they may
reuse each other's intermediates.  The first capture runs ``WARMUP``
direct calls before it; the later ones run none, since the side stream
has run the prefill's kernels by then, so a new length costs about one
eager prefill (the capture issues the step once) plus the graph's
instantiation and one replay.

At most ``max_graphs`` graphs are kept (default
``MAX_PREFILL_GRAPHS``); a new shape past that evicts the least recently
used one, whose graph object is dropped then, and is captured like any
other: no shape runs eagerly on the graph path.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.step_graph import (WARMUP, StepGraph, graph_stats,
                                    resolve_impl)

MAX_PREFILL_GRAPHS = 32


def resolve_prefill_impl(prefill_impl: str, device: torch.device) -> str:
    """"graph" or "eager" for a prefill on ``device``."""
    return resolve_impl(prefill_impl, device, "prefill_impl")


class PrefillGraphs:
    """``step(buffers)`` captured once per input shape and replayed.

    ``make_buffers(shape)`` returns a new shape's static buffers, inputs
    and any outputs the owner does not hold itself.  :meth:`__call__`
    takes the shape and ``fill(buffers)``, which copies one prefill's
    inputs in; it runs the prefill and returns the buffers, whose
    outputs the caller reads (or copies out) before the next call.

    Counts (:meth:`stats`): ``graph_stats``' over every graph made,
    evicted ones included, and ``evictions``."""

    def __init__(self, step: Callable[[Dict[str, Any]], None],
                 make_buffers: Callable[[Tuple[int, int]], Dict[str, Any]],
                 device: torch.device, prefill_impl: str = "auto",
                 stream: Optional["torch.cuda.Stream"] = None, pool=None,
                 max_graphs: int = MAX_PREFILL_GRAPHS):
        if max_graphs < 1:
            raise ValueError(f"max_prefill_graphs must be >= 1, got "
                             f"{max_graphs}")
        self.mode = resolve_prefill_impl(prefill_impl, device)
        self.device = device
        self.max_graphs = max_graphs
        self._step = step
        self._make_buffers = make_buffers
        self._stream, self._pool = stream, pool
        if self.mode == "graph" and stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        self._graphs: "OrderedDict[Tuple[int, int], StepGraph]" = \
            OrderedDict()
        self._evicted = dict(graph_stats([]))
        self.evictions = 0
        self._made = 0

    def __call__(self, shape: Tuple[int, int],
                 fill: Callable[[Dict[str, Any]], None]) -> Dict[str, Any]:
        graph = self._graphs.get(shape)
        if graph is not None:
            self._graphs.move_to_end(shape)
            fill(graph.buffers)
            graph()
            return graph.buffers
        if len(self._graphs) >= self.max_graphs:
            _, old = self._graphs.popitem(last=False)
            for k, v in graph_stats([old]).items():
                self._evicted[k] += v
            self.evictions += 1
            del old
        buffers = self._make_buffers(shape)
        fill(buffers)
        # the first capture warms the side stream up; later ones need not
        graph = StepGraph(self._step, buffers, self.device, self.mode,
                          self._stream, self._pool, option="prefill_impl",
                          warmup=0 if self._made else WARMUP)
        self._made += 1
        self._graphs[shape] = graph
        graph()
        return buffers

    def count(self) -> int:
        """Captured graphs kept now: at most ``max_graphs``, 0 on the
        eager path."""
        return sum(g.captures for g in self._graphs.values())

    def stats(self) -> Dict[str, float]:
        """Summed counts of every graph made (:func:`graph_stats`), and
        ``evictions``."""
        live = graph_stats(self._graphs.values())
        return {**{k: self._evicted[k] + v for k, v in live.items()},
                "evictions": self.evictions}


def copy_inputs(buffers: Dict[str, Any], arrays: Dict[str, Any],
                device: torch.device) -> None:
    """Copy each numpy array of ``arrays`` into the static buffer of its
    name: on CUDA a non-blocking copy from a pinned host copy made here.
    A fresh pinned tensor per call, which PyTorch's pinned allocator
    keeps until its copy has run, so the caller may fill the same buffers
    for the next prefill before the device reaches this one."""
    for name, a in arrays.items():
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        buffers[name].copy_(t, non_blocking=True)
