"""The port's copy of ``repro.serve.kv_cache``, unchanged in behaviour.

Paged KV-cache allocator for the continuous-batching serve engine.

vLLM-style block-table memory management: the decode KV cache is carved
into fixed-size blocks of ``block_tokens`` token slots, and each live
request holds a *block table* — an ordered list of block ids its tokens
occupy.  Admission needs only enough free blocks for the prompt; decode
grows a request one block at a time as generation crosses block
boundaries, so memory tracks *actual* sequence lengths instead of the
worst-case ``prompt + max_new`` a dense per-slot cache must reserve.

``block_tokens`` defaults to 128 — the kv tile of the flash-attention
kernel (``repro_torch.kernels.flash_attention``, as the Pallas kernel's
``block_k`` in the reference): the paged-attention kernel stages the KV
cache one (block_tokens, head_dim) page per loop step, so a block table
maps 1:1 onto the kernel's page loop with no partial-tile waste.

Everything is deterministic: the free list is a LIFO stack, so the same
admission/free sequence always yields the same block tables (the serve
trace record/replay contract extends down to memory layout).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


# the kv tile of the port's flash-attention kernel
# (repro_torch.kernels.flash_attention.flash_attention.BLOCK_K, kBK in
# its CUDA source) — pinned against both by test.
FLASH_ATTENTION_BLOCK_K = 128


class OutOfBlocksError(RuntimeError):
    """Raised when an allocation cannot be satisfied; the engine responds
    by preempting a victim request (recompute preemption)."""


@dataclasses.dataclass
class KVCacheStats:
    """Cumulative allocator telemetry (reported into serve artifacts)."""
    n_blocks: int = 0
    block_tokens: int = 0
    peak_blocks_used: int = 0
    allocations: int = 0
    block_appends: int = 0
    frees: int = 0
    failed_allocations: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class PagedKVCache:
    """Block-granular KV-cache bookkeeping for one serving replica.

    This is the *allocator*: it owns which token positions live in which
    block, not the tensors themselves.  The executor backing real model
    state maps (request, block table) onto its storage; the simulated
    executor needs only the occupancy accounting.
    """

    def __init__(self, n_blocks: int,
                 block_tokens: int = FLASH_ATTENTION_BLOCK_K):
        if n_blocks <= 0:
            raise ValueError(f"n_blocks must be positive, got {n_blocks}")
        if block_tokens <= 0:
            raise ValueError(
                f"block_tokens must be positive, got {block_tokens}")
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        # LIFO free stack: pop from the end -> block 0 first
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._tokens: Dict[int, int] = {}
        self.stats = KVCacheStats(n_blocks=n_blocks,
                                  block_tokens=block_tokens)

    # ---- queries ----------------------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        """ceil(n_tokens / block_tokens) — full blocks covering a span."""
        return -(-max(0, n_tokens) // self.block_tokens)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= len(self._free)

    def block_table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def seq_len(self, rid: int) -> int:
        return self._tokens[rid]

    def utilization(self) -> float:
        return self.used_blocks / self.n_blocks

    # ---- mutation ---------------------------------------------------------
    def allocate(self, rid: int, n_tokens: int) -> List[int]:
        """Claim blocks for a request's first ``n_tokens`` (its prompt)."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds a block table")
        if n_tokens <= 0:
            raise ValueError(
                f"n_tokens must be positive, got {n_tokens}")
        need = self.blocks_needed(n_tokens)
        if need > len(self._free):
            self.stats.failed_allocations += 1
            raise OutOfBlocksError(
                f"need {need} blocks for {n_tokens} tokens, "
                f"{len(self._free)} free")
        blocks = [self._free.pop() for _ in range(need)]
        self._tables[rid] = blocks
        self._tokens[rid] = n_tokens
        self.stats.allocations += 1
        self.stats.peak_blocks_used = max(self.stats.peak_blocks_used,
                                          self.used_blocks)
        return list(blocks)

    def append_token(self, rid: int) -> bool:
        """Grow a request by one generated token.

        Returns True when the append claimed a fresh block (the token
        crossed a block boundary).  Raises :class:`OutOfBlocksError` when
        a fresh block is needed but none is free — the engine's cue to
        preempt a victim.
        """
        if rid not in self._tables:
            raise KeyError(f"request {rid} holds no block table")
        n = self._tokens[rid]
        if n % self.block_tokens == 0:       # the current blocks are full
            if not self._free:
                self.stats.failed_allocations += 1
                raise OutOfBlocksError(
                    f"request {rid} needs a decode block, 0 free")
            self._tables[rid].append(self._free.pop())
            self._tokens[rid] = n + 1
            self.stats.block_appends += 1
            self.stats.peak_blocks_used = max(self.stats.peak_blocks_used,
                                              self.used_blocks)
            return True
        self._tokens[rid] = n + 1
        return False

    def free(self, rid: int) -> int:
        """Release a request's blocks (detach or preemption); returns the
        number of blocks returned to the free stack."""
        blocks = self._tables.pop(rid)
        del self._tokens[rid]
        # LIFO reuse in reverse claim order keeps the free stack a
        # deterministic function of the event sequence
        self._free.extend(reversed(blocks))
        self.stats.frees += 1
        return len(blocks)
