"""Public wrapper of the paged-attention decode.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.paged_attention import paged_attention as _pa
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention_decode(q, k_pages, v_pages, block_tables, lengths, *,
                           window: int = 0, impl: str = "auto"):
    """q: (b, hq, d); k_pages/v_pages: (hkv, n_pages, block_tokens, d);
    block_tables: (b, nb) int32; lengths: (b,) int32.  Returns (b, hq, d).
    """
    if resolve_impl(impl, q) == "kernel":
        return _pa.paged_attention(q, k_pages, v_pages, block_tables,
                                   lengths, window=window)
    return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               window=window)
