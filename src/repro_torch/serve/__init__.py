"""Serve path of the port: the continuous-batching engine and paged KV
allocator (copies of the reference's), and the batched paged-decode
executor over the real model (``repro_torch.serve.batched_executor``,
imported by callers)."""
from repro_torch.serve.engine import (NO_SLO, ContinuousServeEngine,
                                      ServeReport, ServeRequest, ServeSLO,
                                      SimulatedExecutor)
from repro_torch.serve.kv_cache import (FLASH_ATTENTION_BLOCK_K,
                                        KVCacheStats, OutOfBlocksError,
                                        PagedKVCache)

__all__ = [
    "NO_SLO", "ContinuousServeEngine", "ServeReport", "ServeRequest",
    "ServeSLO", "SimulatedExecutor", "FLASH_ATTENTION_BLOCK_K",
    "KVCacheStats", "OutOfBlocksError", "PagedKVCache",
]
