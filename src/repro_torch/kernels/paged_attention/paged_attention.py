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
# blocks a call may start before a split takes more than one page: about
# eight resident blocks of 128 threads on each of the H100's 132 SMs
MAX_BLOCKS = 1024

LAUNCHES = 0

_ARGS = [C.P] * 8 + [C.I] * 9 + [C.F, C.I, C.P]

# the int32 tickets of the split merge, one per (row, kv head), zero
# between calls (the kernel resets each one it uses): one fixed array per
# (device, stream), zeroed on the stream's first call outside any graph
# capture and never replaced, since a captured graph keeps its pointer.
# Calls on one stream run one after another and share it; calls that may
# run at the same time are on other streams and have their own.  A graph
# uses the array of the stream it was captured on.
MAX_TICKETS = 4096
_COUNTERS = {}


def plan_splits(b: int, hkv: int, nb: int) -> int:
    """Pages per split: 1, doubled while the grid ``(ceil(nb / pps), hkv,
    b)`` would exceed ``MAX_BLOCKS`` blocks (never more than nb)."""
    pps = 1
    while pps < nb and b * hkv * -(-nb // pps) > MAX_BLOCKS:
        pps *= 2
    return min(pps, nb)


def workspace_floats(b: int, hkv: int, g: int, d: int, nb: int,
                     pps: int) -> int:
    """fp32 workspace of one call: each split's (acc[g x d], max[g],
    sum[g]) per (row, kv head); none when every row fits one split."""
    n_splits = -(-nb // pps)
    return 0 if n_splits == 1 else b * hkv * n_splits * (g * d + 2 * g)


def _counters(device):
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention: first call on this stream inside a CUDA "
                "graph capture; call it once on the capture stream first")
        buf = _COUNTERS[key] = torch.zeros(MAX_TICKETS, dtype=torch.int32,
                                           device=device)
    return buf


def paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                    window: int = 0):
    """One-token paged attention for a batch of rows.

    q: (b, hq, d); k_pages, v_pages: (hkv, n_pages, block_tokens, d);
    block_tables: (b, nb) int32; lengths: (b,) int32 (0 = inactive row,
    exact zeros out).  All contiguous CUDA tensors, q and the pools
    16-byte aligned and fp32 or bf16.  Returns (b, hq, d) in q.dtype;
    softmax in fp32.  The row's pages are split over blocks
    (``plan_splits``) and merged in the same launch through an fp32
    workspace (``workspace_floats``) and a per-stream ticket array of
    ``MAX_TICKETS`` (so b * hkv may not exceed it).
    """
    global LAUNCHES
    C.require_cuda("paged_attention", q, k_pages, v_pages, block_tables,
                   lengths)
    b, hq, d = q.shape
    hkv, n_pages, btok, _ = k_pages.shape
    nb = block_tables.shape[1]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d
            or hq % hkv or hq // hkv > MAX_GROUP or d not in HEAD_DIMS
            or btok < 1 or nb < 1
            or tuple(block_tables.shape) != (b, nb)
            or tuple(lengths.shape) != (b,) or b * hkv > MAX_TICKETS):
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
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned (the kernel reads them 16 bytes a lane)")
    out = torch.empty_like(q)
    if b == 0:
        return out
    pps = plan_splits(b, hkv, nb)
    n_ws = workspace_floats(b, hkv, hq // hkv, d, nb, pps)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=q.device)
          if n_ws else None)
    counters = _counters(q.device)
    fn = C.entry("paged_attention", "repro_paged_attention_decode", _ARGS)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), counters.data_ptr(),
                b, hq, hkv, n_pages, btok, nb, d, pps, int(window),
                d ** -0.5, C.DTYPE_CODES[q.dtype], C.stream_of(q))
    C.check("paged_attention", rc)
    LAUNCHES += 1
    return out
