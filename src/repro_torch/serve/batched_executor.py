"""Batched real-model executor: one decode at fixed width over the paged
KV pool (the port's ``repro.serve.batched_executor.JaxBatchedExecutor``).

The design is the reference's:

  * **fixed batch width** — the decode runs at ``n_slots`` rows; a live
    request is a *row assignment*, admission pops a free row, detach
    pushes it back.  Inactive rows carry ``length == 0`` and an all-null
    block table, so they mask out inside the paged-attention kernel
    instead of changing any shape;
  * **block-table ABI** — the engine allocates/grows/frees block tables
    on ``self.kv``; before each decode the executor re-reads the live
    tables and lengths into its fixed (W,)/(W, nb_max) host arrays, so
    allocator state IS the kernel's gather map (one extra *null* page
    backs inactive rows' writes);
  * **prefill** — each admitted prompt runs a batch-1 prefill (the
    flash-attention kernel on CUDA), then its cache scatters into the
    request's pages.

JAX compiles the decode once and counts compiles as its zero-recompile
probe.  The port captures the decode once as a CUDA graph
(:class:`~repro_torch.serve.decode_graph.DecodeGraph`, ``decode_impl``)
at construction, with every row inactive, so the warm-up's K/V writes
land on the null page alone; every engine step then replays it.  The
step's inputs are static device buffers — token, lengths and block
tables at (W,) / (W,) / (W, nb_max) int32 — filled each step from
pinned host arrays, and its output is a static (W,) int32 of argmax
tokens, read back with one device-to-host copy.  On the CPU the same
buffers go through a direct call.  :meth:`decode_graph_count` (1 on
CUDA, 0 eager) is the counterpart of the reference's
``decode_compiles()``; :meth:`decode_shape_count`, the signature of the
decode's inputs, stays 1 across admission churn.

The reference jits its prefill and its page scatter, compiled once per
prompt length.  The port captures both as one step per length
(:class:`~repro_torch.serve.prefill_graph.PrefillGraphs`,
``prefill_impl``): static tokens (1, s), page ids (s,) and offsets (s,)
in, filled by non-blocking copies from pinned host arrays; the prefill,
its argmax into a static token, and the scatter of its cache into the
page pools, so the prefill cache never leaves the graph's memory pool.
The decode graph and the prefill graphs capture on one side stream into
one pool.

Construct the engine with ``kv_cache=executor.kv`` — the allocator must
be shared or the gather map and the bookkeeping drift apart.

MoE configs decode with ``capacity_factor`` raised to ``num_experts``
(drop-free routing, :func:`decode_config`): at fixed width W a garbage
inactive row must never evict an active token from an expert buffer, and
a capacity that admits every assignment makes each row's expert output
independent of its batch neighbours — the token identity with the
reference the tests pin.  Prefill keeps the config's own factor, as the
reference's does.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model, transformer
from repro_torch.models.compute_params import serving_params
from repro_torch.serve.decode_graph import DecodeGraph
from repro_torch.serve.kv_cache import FLASH_ATTENTION_BLOCK_K, PagedKVCache
from repro_torch.serve.prefill_graph import (MAX_PREFILL_GRAPHS,
                                             PrefillGraphs, copy_inputs)
from repro_torch.serve.slot_executor import TorchSlotExecutor, slot_kv_cache
from repro_torch.step_graph import graph_stats


def _paged_step(step, params, k_pages, v_pages, b) -> None:
    """The captured step: static inputs in, argmax tokens out.  A free
    function over what it reads, so the graph holds no reference back to
    its executor (which would keep the executor's device memory until a
    garbage collection)."""
    logits, _, _ = step(params, b["tok"], b["len"], k_pages, v_pages,
                        b["tables"])
    b["out"].copy_(torch.argmax(logits, -1))


def _paged_prefill_step(prefill, params, cfg, k_pages, v_pages, b) -> None:
    """The captured prefill of one prompt length: the tokens, page ids
    and offsets in, the argmax in ``b["tok"]`` and the cache scattered
    into the page pools.  A free function, as :func:`_paged_step` is."""
    logits, cache = prefill(params, {"tokens": b["tokens"]})
    b["tok"].copy_(torch.argmax(logits, -1))
    transformer.scatter_prefill_pages(cache, cfg, k_pages, v_pages,
                                      b["pages"], b["offs"])


def decode_config(cfg):
    """The config the batched decode runs: for MoE, ``capacity_factor``
    raised to ``num_experts`` so every assignment has a slot."""
    if cfg.num_experts > 0:
        return dataclasses.replace(
            cfg, capacity_factor=max(cfg.capacity_factor,
                                     float(cfg.num_experts)))
    return cfg


class TorchBatchedExecutor:
    """Fixed-width batched paged decode for the continuous engine.

    The model runs on ``serving_params``, the weights cast to the compute
    dtype once (:func:`~repro_torch.models.compute_params.compute_params`).
    ``params=None`` draws random params from a ``torch.Generator`` on the
    executor's device seeded with 0 and keeps only their cast tree
    (``self.params`` is None), so the raw fp32 weights do not stay on the
    card beside it; a given tree (e.g. ``params_from_numpy`` of the
    reference's) stays ``self.params``, as it is.
    ``attn_impl`` selects the attention of both phases and ``gmm_impl``
    the experts' grouped matmul ("auto" = the kernels on CUDA, the plain
    versions on the CPU); ``decode_impl`` the decode step's graph and
    ``prefill_impl`` the prefill's graphs, at most ``max_prefill_graphs``
    of them ("auto" = a CUDA graph on CUDA, a direct call on the CPU; see
    :mod:`~repro_torch.serve.decode_graph` and
    :mod:`~repro_torch.serve.prefill_graph`).
    """

    def __init__(self, cfg, max_len: int, n_slots: int,
                 clock: Callable[[], float] = time.monotonic,
                 attn_impl: str = "auto", device=None, params=None,
                 gmm_impl: str = "auto", decode_impl: str = "auto",
                 prefill_impl: str = "auto",
                 max_prefill_graphs: int = MAX_PREFILL_GRAPHS):
        if not model.supports_paged_decode(cfg, max_len):
            raise ValueError(
                f"family {cfg.family!r} (window={cfg.attention_window}) "
                f"does not support paged decode")
        self.cfg = cfg
        self.max_len = max_len
        self.n_slots = n_slots
        self.clock = clock
        self.device = resolve_device(device)
        self.block_tokens = FLASH_ATTENTION_BLOCK_K
        self.nb_max = -(-max_len // self.block_tokens)
        n_blocks = n_slots * self.nb_max
        # the allocator the engine must share (kv_cache=executor.kv)
        self.kv = PagedKVCache(n_blocks, self.block_tokens)
        self.null_page = n_blocks          # pool holds n_blocks + 1 pages
        shape = transformer.paged_kv_shape(cfg, n_blocks + 1,
                                           self.block_tokens)
        # the tree the model runs on: weights cast to the compute dtype
        # once here, not on every call (bit-identical results)
        self.params = params
        self.serving_params = serving_params(cfg, params, self.device)
        self._prefill = model.prefill_fn(cfg, max_len=max_len,
                                         attn_impl=attn_impl,
                                         gmm_impl=gmm_impl)
        self._step = model.paged_decode_fn(decode_config(cfg),
                                           attn_impl=attn_impl,
                                           gmm_impl=gmm_impl)

        # host-side row state (fixed width W): numpy views of (pinned,
        # on CUDA) host tensors, the sources of the step's input copies
        self.rows: Dict[int, int] = {}              # rid -> row
        self._free_rows: List[int] = list(range(n_slots - 1, -1, -1))
        pin = self.device.type == "cuda"
        host = {"tok": torch.zeros((n_slots,), dtype=torch.int32,
                                   pin_memory=pin),
                "len": torch.zeros((n_slots,), dtype=torch.int32,
                                   pin_memory=pin),
                "tables": torch.full((n_slots, self.nb_max), self.null_page,
                                     dtype=torch.int32, pin_memory=pin)}
        self._host = host
        self._tok, self._len, self._tables = (
            host[k].numpy() for k in ("tok", "len", "tables"))
        # what a run did: prefilled requests, decode calls, and the
        # distinct decode input signatures (the zero-recompile analogue)
        self.prefills = 0
        self.decode_steps = 0
        self._decode_shapes: Set[Tuple] = set()
        # one side stream and one memory pool for every graph captured
        stream = pool = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode():
            self._kp = torch.zeros(shape, dtype=cfg.compute_dtype,
                                   device=self.device)
            self._vp = torch.zeros_like(self._kp)
            # the step's static buffers: inputs as the host arrays are
            # now (every row inactive: the capture's K/V writes land on
            # the null page), and the argmax tokens out
            bufs = {k: v.to(self.device, copy=True)
                    for k, v in host.items()}
            bufs["out"] = torch.zeros((n_slots,), dtype=torch.int32,
                                      device=self.device)
            step = functools.partial(_paged_step, self._step,
                                     self.serving_params, self._kp,
                                     self._vp)
            self._graph = DecodeGraph(step, bufs, self.device, decode_impl,
                                      stream=stream, pool=pool)
        self._prefills = PrefillGraphs(
            functools.partial(_paged_prefill_step, self._prefill,
                              self.serving_params, cfg, self._kp, self._vp),
            self._prefill_buffers, self.device, prefill_impl, stream, pool,
            max_prefill_graphs)

    # ---- introspection ----------------------------------------------------
    def decode_shape_count(self) -> int:
        """Distinct (shape, dtype) signatures the decode was called with;
        1 for any run: admission and detach never change a shape."""
        return len(self._decode_shapes)

    def decode_graph_count(self) -> int:
        """Captured decode graphs: 1 on the graph path (captured at
        construction, replayed by every step), 0 on the eager path."""
        return self._graph.captures

    def decode_graph_stats(self) -> Dict[str, float]:
        """The decode graph's counts (:func:`graph_stats`)."""
        return graph_stats([self._graph])

    def prefill_graph_count(self) -> int:
        """Captured prefill graphs kept: one per prompt length seen, at
        most ``max_prefill_graphs``; 0 on the eager path."""
        return self._prefills.count()

    def prefill_graph_stats(self) -> Dict[str, float]:
        """The prefill graphs' counts (:meth:`PrefillGraphs.stats`)."""
        return self._prefills.stats()

    def _prefill_buffers(self, shape) -> Dict[str, torch.Tensor]:
        b, s = shape

        def zeros(*size):
            return torch.zeros(size, dtype=torch.int64, device=self.device)

        return {"tokens": zeros(b, s), "pages": zeros(s), "offs": zeros(s),
                "tok": zeros(b)}

    # ---- executor protocol ------------------------------------------------
    def prefill(self, reqs: Sequence) -> Tuple[List[int], float]:
        t0 = self.clock()
        pend, rows = [], []
        with torch.inference_mode():
            for r in reqs:
                if r.prompt is None:
                    raise ValueError(
                        f"request {r.rid} carries no prompt tokens")
                row = self._free_rows.pop()
                self.rows[r.rid] = row
                prompt = np.asarray(r.prompt, np.int64)
                s = prompt.shape[-1]
                table = np.asarray(self.kv.block_table(r.rid), np.int64)
                pos = np.arange(s)
                inputs = {"tokens": prompt[None, :],
                          "pages": table[pos // self.block_tokens],
                          "offs": pos % self.block_tokens}
                bufs = self._prefills(
                    (1, s), lambda b: copy_inputs(b, inputs, self.device))
                # the next prefill of this length rewrites the buffer
                pend.append(bufs["tok"].clone())
                rows.append(row)
                self._len[row] = s
                self.prefills += 1
            # ONE device-to-host copy of every token (one sync) before
            # the clock is read
            toks = torch.cat(pend).tolist() if pend else []
        cost = max(0.0, self.clock() - t0)
        for row, t in zip(rows, toks):
            self._tok[row] = t
        return toks, cost

    def decode(self, reqs: Sequence) -> Tuple[List[int], float]:
        t0 = self.clock()
        # refresh the gather map from the allocator (the engine's
        # append_token may have claimed fresh blocks since last step)
        for r in reqs:
            row = self.rows[r.rid]
            self._len[row] = self.kv.seq_len(r.rid)
            table = self.kv.block_table(r.rid)
            self._tables[row, :len(table)] = table
        bufs = self._graph.buffers
        self._decode_shapes.add(tuple(
            (tuple(t.shape), t.dtype)
            for t in (bufs["tok"], bufs["len"], self._kp, self._vp,
                      bufs["tables"])))
        with torch.inference_mode():
            # the host arrays are not written again before the read-back
            # below has synchronised, so the copies may be asynchronous
            for k, v in self._host.items():
                bufs[k].copy_(v, non_blocking=True)
            self._graph()
            tok_np = bufs["out"].cpu().numpy()
        cost = max(0.0, self.clock() - t0)
        self.decode_steps += 1
        self._tok[:] = tok_np
        return [int(tok_np[self.rows[r.rid]]) for r in reqs], cost

    def release(self, req) -> None:
        row = self.rows.pop(req.rid, None)
        if row is None:
            return
        self._free_rows.append(row)
        self._tok[row] = 0
        self._len[row] = 0
        self._tables[row, :] = self.null_page


def make_executor(cfg, max_len: int, n_slots: int,
                  clock: Callable[[], float] = time.monotonic,
                  attn_impl: str = "auto", device=None, params=None,
                  gmm_impl: str = "auto", decode_impl: str = "auto",
                  prefill_impl: str = "auto",
                  max_prefill_graphs: int = MAX_PREFILL_GRAPHS):
    """The executor the reference's ``run_continuous_server`` picks, and
    the allocator to pass to the engine: the batched paged executor (its
    own allocator) where ``model.supports_paged_decode`` holds, else the
    per-slot executor with the reference's block sizing
    (:func:`slot_kv_cache`), its ``n_slots`` decode entries made (and, on
    the graph path, captured) here.  Nothing else is substituted."""
    kw = dict(clock=clock, attn_impl=attn_impl, device=device,
              params=params, gmm_impl=gmm_impl, decode_impl=decode_impl,
              prefill_impl=prefill_impl,
              max_prefill_graphs=max_prefill_graphs)
    if model.supports_paged_decode(cfg, max_len):
        ex = TorchBatchedExecutor(cfg, max_len, n_slots, **kw)
        return ex, ex.kv
    ex = TorchSlotExecutor(cfg, max_len, n_slots=n_slots, **kw)
    return ex, slot_kv_cache(max_len, n_slots)
