"""Serve path of the port: the continuous-batching engine and paged KV
allocator (copies of the reference's), and the two executors over the
real model — batched paged decode (``repro_torch.serve.batched_executor``,
whose ``make_executor`` picks between them) and per-slot batch-1 decode
(``repro_torch.serve.slot_executor``) — imported by callers."""
from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                      ServeReport, ServeRequest, ServeSLO,
                                      SimulatedExecutor, run_static,
                                      synthetic_requests)
from repro_torch.serve.kv_cache import (FLASH_ATTENTION_BLOCK_K,
                                        KVCacheStats, OutOfBlocksError,
                                        PagedKVCache)

__all__ = [
    "NO_SLO", "ContinuousServeEngine", "ServeReport", "ServeRequest",
    "ServeSLO", "SimulatedExecutor", "run_static", "synthetic_requests",
    "FLASH_ATTENTION_BLOCK_K",
    "KVCacheStats", "OutOfBlocksError", "PagedKVCache",
]
