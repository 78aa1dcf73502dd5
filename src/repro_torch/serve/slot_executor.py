"""Per-slot real-model executor for the continuous engine (the port's
``repro.serve.jax_executor.JaxSlotExecutor``).

Each live request owns a batch-1 decode cache of its own, so no row of
one request's cache couples to another's.  This is the executor of the
families whose decode state has no place in a block table — the hybrid
(RG-LRU + local attention) and ssm (RWKV-6) families, enc-dec (the
encoder's states) and vlm, and attention windows narrower than
``max_len`` — as the reference's ``run_continuous_server`` decides
(``model.supports_paged_decode``).  The stubbed front ends take zero
inputs, as the reference's executor builds them: one static batch-1
buffer of ``frames`` (enc-dec) or ``patches`` (vlm) in the compute
dtype, made here, outside every capture, that every prefill reads.

The reference compiles the per-slot step once (``jax.jit`` of
``decode_fn``).  The port keeps a pool of *entries*, each a static
batch-1 cache (``init_cache``'s layout, which is the prefill cache's),
a static token and the step captured over them as a CUDA graph
(:class:`~repro_torch.serve.decode_graph.DecodeGraph`; a direct call on
the CPU or with ``decode_impl="eager"``).  Given ``n_slots`` (as
``make_executor`` gives it), the executor makes its ``n_slots`` entries
when it is built, each warmed up and captured on its zeroed cache, so no
capture lands in a request's time to first token; without it the pool
grows in the prefill that first finds no free entry, to as many entries
as requests were ever live at once.  A prefill copies the request's
prefill cache into a free entry, every leaf, a leaf of another shape or
dtype raising; ``release`` returns the entry to the free list.  A step
writes the cache in place (``decode_step_inplace``) and its argmax into
the token, the next step's input.

The reference jits its batch-1 prefill, compiled once per prompt
length; the port captures it once per length
(:class:`~repro_torch.serve.prefill_graph.PrefillGraphs`,
``prefill_impl``): static tokens (1, s) in, filled by a non-blocking copy
from pinned host memory, the cache written into one static *landing*
cache (``init_cache(cfg, 1, max_len)``'s layout, shared by every length)
and the argmax into a static token; the landing cache is then copied
into the request's entry, outside the graph.

All graphs — the entries' and the prefills' — capture on one side stream
into one memory pool: their replays run one after another on the
current stream, never together, and nothing a capture allocates is read
after its replay (a step's inputs and outputs are static tensors), so
the graphs may reuse each other's intermediates.  The pool costs about
one step's intermediates, not one per graph.

``prefill`` and ``decode`` issue every slot's work, then read all the
slots' tokens in one device-to-host copy, which synchronises the device
once before the clock is read, so the measured cost is the device time
of all the slots and not N host round-trips.  The clock is read once at
the start and once at the end of each call (``TickClock`` in the tests,
``time.monotonic`` for real runs), as the reference reads it.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.compute_params import serving_params
from repro_torch.serve.decode_graph import DecodeGraph, resolve_decode_impl
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.prefill_graph import (MAX_PREFILL_GRAPHS,
                                             PrefillGraphs, copy_inputs,
                                             resolve_prefill_impl)
from repro_torch.step_graph import graph_stats
from repro_torch.tree import copy_tree_


# the prefill's inputs a buffer set may hold
FEEDS = ("tokens", "frames", "patches")


def slot_kv_cache(max_len: int, n_slots: int) -> PagedKVCache:
    """The engine's allocator beside a per-slot executor, sized as the
    reference's CLI sizes it: blocks of min(128, max_len) tokens, enough
    for every slot at ``max_len``.  The executor keeps no KV in it; the
    engine books admission and growth against it."""
    block_tokens = min(128, max_len)
    need_blocks = -(-max_len // block_tokens)
    return PagedKVCache(n_blocks=n_slots * need_blocks,
                        block_tokens=block_tokens)


def greedy_step(decode, params, b) -> None:
    """The captured step of a static cache (a per-slot entry's, or the
    static server's at its full batch): the tokens ``b["tok"]`` and the
    cache ``b["cache"]`` in, the cache updated in place and the argmax
    in ``b["tok"]``.  A free function over what it reads, so a graph
    holds no reference back to its owner."""
    logits = decode(params, b["tok"], b["cache"])
    b["tok"].copy_(torch.argmax(logits, -1))


def cache_prefill_step(prefill, params, b) -> None:
    """The captured prefill into a static cache (the per-slot executor's
    landing cache, or the static server's decode cache at its full
    batch): the tokens ``b["tokens"]`` (and the stub front end's
    ``b["frames"]`` or ``b["patches"]``, where the buffers hold one) in,
    the prefill cache copied into ``b["cache"]`` and the argmax into
    ``b["tok"]``.  A free function, as :func:`greedy_step` is."""
    logits, cache = prefill(params, {k: b[k] for k in FEEDS if k in b})
    copy_tree_(b["cache"], cache, "cache")
    b["tok"].copy_(torch.argmax(logits, -1))


class TorchSlotExecutor:
    """Batch-1 prefill and decode per request over the real model.

    The model runs on ``serving_params``, the weights cast to the compute
    dtype once (:func:`~repro_torch.models.compute_params.compute_params`).
    ``params=None`` draws random params from a ``torch.Generator`` on the
    executor's device seeded with 0 and keeps only their cast tree
    (``self.params`` is None), so the raw fp32 weights do not stay on the
    card beside it; a given tree (e.g. ``params_from_numpy`` of the
    reference's) stays ``self.params``, as it is.
    ``attn_impl`` and ``gmm_impl`` select flash attention and the experts'
    grouped matmul: "auto" = the kernels on CUDA, the plain versions on the
    CPU (the recurrence kernels always run as "auto"); ``decode_impl`` the
    entries' step and ``prefill_impl`` the prefill's graphs, at most
    ``max_prefill_graphs`` of them: "auto" = a CUDA graph on CUDA, a
    direct call on the CPU (:mod:`~repro_torch.serve.decode_graph`,
    :mod:`~repro_torch.serve.prefill_graph`).  ``n_slots``, where given,
    is the number of entries made here.
    """

    def __init__(self, cfg, max_len: int,
                 clock: Callable[[], float] = time.monotonic,
                 attn_impl: str = "auto", device=None, params=None,
                 gmm_impl: str = "auto", decode_impl: str = "auto",
                 prefill_impl: str = "auto",
                 max_prefill_graphs: int = MAX_PREFILL_GRAPHS,
                 n_slots: Optional[int] = None):
        self.cfg = cfg
        self.max_len = max_len
        self.n_slots = n_slots
        self.clock = clock
        self.device = resolve_device(device)
        self._decode_mode = resolve_decode_impl(decode_impl, self.device)
        prefill_mode = resolve_prefill_impl(prefill_impl, self.device)
        # the tree the model runs on: weights cast to the compute dtype
        # once here, not on every call (bit-identical results)
        self.params = params
        self.serving_params = serving_params(cfg, params, self.device)
        self._prefill = model.prefill_fn(cfg, max_len=max_len,
                                         attn_impl=attn_impl,
                                         gmm_impl=gmm_impl)
        self._decode = model.decode_inplace_fn(cfg, gmm_impl=gmm_impl,
                                               attn_impl=attn_impl)
        # the entries: every one made, the free ones, and each live
        # request's entry with its static cache and token
        self._pool: List[DecodeGraph] = []
        self._spare: List[DecodeGraph] = []
        self._entries: Dict[int, DecodeGraph] = {}
        self._caches: Dict[int, dict] = {}
        self._tok: Dict[int, torch.Tensor] = {}
        # one side stream and one memory pool for every capture
        self._stream = self._mempool = None
        if "graph" in (self._decode_mode, prefill_mode):
            self._stream = torch.cuda.Stream(self.device)
            self._mempool = torch.cuda.graph_pool_handle()
        # the prefill graphs' landing cache and token, shared by every
        # prompt length
        with torch.inference_mode():
            self._frontend = model.frontend_inputs(cfg, 1, self.device)
            self._landing = {
                "cache": model.init_cache(cfg, 1, max_len, self.device),
                "tok": torch.zeros((1,), dtype=torch.int64,
                                   device=self.device)}
            self._prefills = PrefillGraphs(
                functools.partial(cache_prefill_step, self._prefill,
                                  self.serving_params),
                self._prefill_buffers, self.device, prefill_mode,
                self._stream, self._mempool, max_prefill_graphs)
            for _ in range(n_slots or 0):
                self._spare.append(self._new_entry())
        # what a run did: prefilled requests and decode calls
        self.prefills = 0
        self.decode_steps = 0

    # ---- introspection ----------------------------------------------------
    def decode_graph_count(self) -> int:
        """Captured decode graphs: the entries made on the graph path
        (``n_slots`` where it was given, else at most the most requests
        live at once), 0 on the eager path."""
        return sum(e.captures for e in self._pool)

    def decode_graph_stats(self) -> Dict[str, float]:
        """The entries' summed counts (:func:`graph_stats`)."""
        return graph_stats(self._pool)

    def prefill_graph_count(self) -> int:
        """Captured prefill graphs kept: one per prompt length seen, at
        most ``max_prefill_graphs``; 0 on the eager path."""
        return self._prefills.count()

    def prefill_graph_stats(self) -> Dict[str, float]:
        """The prefill graphs' counts (:meth:`PrefillGraphs.stats`)."""
        return self._prefills.stats()

    def _prefill_buffers(self, shape) -> Dict[str, object]:
        return {"tokens": torch.zeros(shape, dtype=torch.int64,
                                      device=self.device),
                **self._frontend, **self._landing}

    # ---- entries ------------------------------------------------------------
    def _new_entry(self) -> DecodeGraph:
        bufs = {"cache": model.init_cache(self.cfg, 1, self.max_len,
                                          self.device),
                "tok": torch.zeros((1,), dtype=torch.int64,
                                   device=self.device)}
        step = functools.partial(greedy_step, self._decode,
                                 self.serving_params)
        entry = DecodeGraph(step, bufs, self.device, self._decode_mode,
                            stream=self._stream, pool=self._mempool)
        self._pool.append(entry)
        return entry

    def _finish(self, pend: List[torch.Tensor], t0: float
                ) -> Tuple[List[int], float]:
        # every slot's work is issued; ONE device-to-host copy of all the
        # tokens (one sync) before the clock — a per-slot read would
        # serialise N round-trips into the cost
        toks = torch.cat(pend).tolist() if pend else []
        return toks, max(0.0, self.clock() - t0)

    # ---- executor protocol ------------------------------------------------
    def prefill(self, reqs: Sequence) -> Tuple[List[int], float]:
        t0 = self.clock()
        pend = []
        with torch.inference_mode():
            for r in reqs:
                if r.prompt is None:
                    raise ValueError(
                        f"request {r.rid} carries no prompt tokens")
                tokens = np.asarray(r.prompt, np.int64)[None, :]
                entry = self._spare.pop() if self._spare else \
                    self._new_entry()
                out = self._prefills(
                    tokens.shape,
                    lambda b: copy_inputs(b, {"tokens": tokens},
                                          self.device))
                copy_tree_(entry.buffers["cache"], out["cache"], "cache")
                entry.buffers["tok"].copy_(out["tok"])
                self._entries[r.rid] = entry
                self._caches[r.rid] = entry.buffers["cache"]
                self._tok[r.rid] = entry.buffers["tok"]
                self.prefills += 1
                pend.append(entry.buffers["tok"])
            return self._finish(pend, t0)

    def decode(self, reqs: Sequence) -> Tuple[List[int], float]:
        t0 = self.clock()
        with torch.inference_mode():
            for r in reqs:
                self._entries[r.rid]()
            self.decode_steps += 1
            return self._finish([self._tok[r.rid] for r in reqs], t0)

    def release(self, req) -> None:
        entry = self._entries.pop(req.rid, None)
        if entry is None:
            return
        del self._caches[req.rid], self._tok[req.rid]
        self._spare.append(entry)
