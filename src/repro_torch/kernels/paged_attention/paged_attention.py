"""ctypes wrapper of the CUDA paged-attention decode kernel
(``kernels/csrc/paged_attention.cu``; the source's note says which TPU
kernel it replaces and how it is built).

``LAUNCHES`` counts the kernel's launches: the wrapper adds one where it
launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8                 # query heads per kv head the kernel takes
MAX_BLOCK_TOKENS = 128        # page size it takes (one thread per slot)

LAUNCHES = 0

_ARGS = [C.P] * 6 + [C.I] * 8 + [C.F, C.I, C.P]


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = 0):
    """One-token paged attention for a batch of rows.

    q: (b, hq, d); k_pages, v_pages: (hkv, n_pages, block_tokens, d);
    block_tables: (b, nb) int32; lengths: (b,) int32 (0 = inactive row,
    exact zeros out).  All contiguous CUDA tensors; q and the pools fp32
    or bf16.  Returns (b, hq, d) in q.dtype; softmax in fp32.
    """
    global LAUNCHES
    C.require_cuda("paged_attention", q, k_pages, v_pages, block_tables,
                   lengths)
    b, hq, d = q.shape
    hkv, n_pages, btok, _ = k_pages.shape
    nb = block_tables.shape[1]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d
            or hq % hkv or hq // hkv > MAX_GROUP or d not in HEAD_DIMS
            or not 0 < btok <= MAX_BLOCK_TOKENS
            or tuple(block_tables.shape) != (b, nb)
            or tuple(lengths.shape) != (b,)):
        raise ValueError(
            f"paged_attention: unsupported shapes q {tuple(q.shape)} pages "
            f"{tuple(k_pages.shape)} tables {tuple(block_tables.shape)} "
            f"lengths {tuple(lengths.shape)}")
    if (not (q.dtype == k_pages.dtype == v_pages.dtype)
            or q.dtype not in C.DTYPE_CODES
            or block_tables.dtype != torch.int32
            or lengths.dtype != torch.int32):
        raise ValueError("paged_attention: q/pages must share fp32 or bf16, "
                         "tables and lengths must be int32")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages,
                                           block_tables, lengths)):
        raise ValueError("paged_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = C.entry("paged_attention", "repro_paged_attention_decode", _ARGS)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, hq, hkv, n_pages, btok, nb, d, int(window), d ** -0.5,
                C.DTYPE_CODES[q.dtype], C.stream_of(q))
    C.check("paged_attention", rc)
    LAUNCHES += 1
    return out
