"""Per-slot real-model executor for the continuous engine (the port's
``repro.serve.jax_executor.JaxSlotExecutor``).

Each live request owns its own batch-1 decode cache, kept in a dict by
rid, so admission and detach are dict inserts and removes and no row of
one request's cache couples to another's.  This is the executor of the
families whose decode state has no place in a block table — the hybrid
(RG-LRU + local attention) and ssm (RWKV-6) families, and attention
windows narrower than ``max_len`` — as the reference's
``run_continuous_server`` decides (``model.supports_paged_decode``).

``prefill`` and ``decode`` issue every slot's work, then synchronise the
device once before reading the clock, so the measured cost is the device
time of all the slots and not N host round-trips.  The clock is read
once at the start and once at the end of each call (``TickClock`` in the
tests, ``time.monotonic`` for real runs), as the reference reads it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model
from repro_torch.models.compute_params import compute_params
from repro_torch.models.init import init_params
from repro_torch.serve.kv_cache import PagedKVCache


def slot_kv_cache(max_len: int, n_slots: int) -> PagedKVCache:
    """The engine's allocator beside a per-slot executor, sized as the
    reference's CLI sizes it: blocks of min(128, max_len) tokens, enough
    for every slot at ``max_len``.  The executor keeps no KV in it; the
    engine books admission and growth against it."""
    block_tokens = min(128, max_len)
    need_blocks = -(-max_len // block_tokens)
    return PagedKVCache(n_blocks=n_slots * need_blocks,
                        block_tokens=block_tokens)


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
    CPU (the recurrence kernels always run as "auto").
    """

    def __init__(self, cfg, max_len: int,
                 clock: Callable[[], float] = time.monotonic,
                 attn_impl: str = "auto", device=None, params=None,
                 gmm_impl: str = "auto"):
        self.cfg = cfg
        self.max_len = max_len
        self.clock = clock
        self.device = resolve_device(device)
        # the tree the model runs on: weights cast to the compute dtype
        # once here, not on every call (bit-identical results)
        if params is None:      # drawn here: only the cast tree is kept
            self.params = None
            self.serving_params = compute_params(
                init_params(cfg, torch.Generator(self.device).manual_seed(0),
                            self.device), cfg, consume=True)
        else:
            self.params = params
            self.serving_params = compute_params(params, cfg)
        self._prefill = model.prefill_fn(cfg, max_len=max_len,
                                         attn_impl=attn_impl,
                                         gmm_impl=gmm_impl)
        self._decode = model.decode_fn(cfg, gmm_impl=gmm_impl)
        self._caches: Dict[int, object] = {}
        self._tok: Dict[int, torch.Tensor] = {}
        # what a run did: prefilled requests and decode calls
        self.prefills = 0
        self.decode_steps = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finish(self, pend: List[torch.Tensor], t0: float
                ) -> Tuple[List[int], float]:
        # every slot's work is issued; ONE device sync before the clock —
        # a per-slot int() would serialise N round-trips into the cost
        self._sync()
        cost = max(0.0, self.clock() - t0)
        return [int(t[0]) for t in pend], cost

    # ---- executor protocol ------------------------------------------------
    def prefill(self, reqs: Sequence) -> Tuple[List[int], float]:
        t0 = self.clock()
        pend = []
        with torch.inference_mode():
            for r in reqs:
                if r.prompt is None:
                    raise ValueError(
                        f"request {r.rid} carries no prompt tokens")
                tokens = torch.from_numpy(
                    np.asarray(r.prompt, np.int64)[None, :]).to(self.device)
                logits, cache = self._prefill(self.serving_params,
                                              {"tokens": tokens})
                tok = torch.argmax(logits, -1)
                self._caches[r.rid] = cache
                self._tok[r.rid] = tok
                self.prefills += 1
                pend.append(tok)
        return self._finish(pend, t0)

    def decode(self, reqs: Sequence) -> Tuple[List[int], float]:
        t0 = self.clock()
        pend = []
        with torch.inference_mode():
            for r in reqs:
                logits, cache = self._decode(self.serving_params,
                                             self._tok[r.rid],
                                             self._caches[r.rid])
                tok = torch.argmax(logits, -1)
                self._caches[r.rid] = cache
                self._tok[r.rid] = tok
                pend.append(tok)
        self.decode_steps += 1
        return self._finish(pend, t0)

    def release(self, req) -> None:
        self._caches.pop(req.rid, None)
        self._tok.pop(req.rid, None)
