"""ctypes wrappers of the CUDA RWKV-6 WKV recurrence and of its reverse,
the gradient (``kernels/csrc/rwkv6_wkv.cu``; the source's note says which
TPU kernel each replaces and how it is built).

``LAUNCHES`` counts the forward's launches, ``LAUNCHES_BWD`` the
reverse's: each wrapper adds one where it launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

HEAD_DIMS = (16, 32, 64)
# the forward keeps the state before every STATE_CHUNK tokens for the
# reverse (the kernels' staged chunk)
STATE_CHUNK = 32
# state rows a block of the reverse owns (n / ROW_BLOCK blocks a head)
ROW_BLOCK = 32
# the reverse cuts the sequence into segments of whole chunks until its
# main launch has this many blocks (``bwd_segments``)
SEG_TARGET_BLOCKS = 1024

LAUNCHES = 0
LAUNCHES_BWD = 0

_ARGS = [C.P] * 9 + [C.I] * 4 + [C.LL] * 15 + [C.I, C.P]
_ARGS_BWD = [C.P] * 15 + [C.I] * 4 + [C.LL] * 15 + [C.P]
_ARGS_BWD_INFO = [C.I] * 4 + [C.P]


def _check(name, r, k, v, logw, u, s0, dtypes):
    """Raise ``ValueError`` for what the kernels do not take: r, k, v,
    logw (b, s, h, n) CUDA tensors of one dtype in ``dtypes``, n in
    HEAD_DIMS and contiguous; u (h, n); s0 None or a contiguous fp32
    (b, h, n, n)."""
    C.require_cuda(name, r, k, v, logw, u, *([] if s0 is None else [s0]))
    b, s, h, n = r.shape
    if (any(t.shape != r.shape for t in (k, v, logw))
            or tuple(u.shape) != (h, n) or n not in HEAD_DIMS):
        raise ValueError(f"{name}: unsupported shapes r {tuple(r.shape)} "
                         f"u {tuple(u.shape)} (want r, k, v, logw (b, s, h, "
                         f"n), u (h, n), n in {HEAD_DIMS})")
    if any(t.dtype != r.dtype for t in (k, v, logw)) or r.dtype not in dtypes:
        raise ValueError(f"{name}: dtypes {r.dtype}/{k.dtype}/{v.dtype}/"
                         f"{logw.dtype}; takes one of {list(dtypes)}")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError(f"{name}: the head dim n must be contiguous")
    if s0 is not None and (s0.dtype != torch.float32
                           or tuple(s0.shape) != (b, h, n, n)
                           or not s0.is_contiguous()):
        raise ValueError(f"{name}: s0 must be contiguous fp32 "
                         f"{(b, h, n, n)}, got {s0.dtype} {tuple(s0.shape)}")


def _strides(*tensors):
    return [x for t in tensors for x in t.stride()[:3]]


def n_state_chunks(s: int) -> int:
    return -(-s // STATE_CHUNK)


def bwd_row_blocks(n: int) -> int:
    return n // min(n, ROW_BLOCK)


def bwd_segments(b: int, s: int, h: int, n: int):
    """(segments, chunks a segment) of the reverse, as the kernel's
    ``segments`` cuts them: as many parts as bring the main launch (row
    blocks x segments x b x h) to SEG_TARGET_BLOCKS, at most one a
    STATE_CHUNK-token chunk, each rounded up to whole chunks (the last
    may hold fewer).  The shape alone decides, never the card."""
    chunks = n_state_chunks(s)
    blocks = max(1, b * h * bwd_row_blocks(n))
    want = max(1, min(chunks, -(-SEG_TARGET_BLOCKS // blocks)))
    per = -(-chunks // want)
    return -(-chunks // per), per


def bwd_workspace_elems(b: int, s: int, h: int, n: int) -> int:
    """fp32 elements of the reverse's workspace: the carries of segments
    1 .. P-1 (each b h n x n, and its decay product b h n) and du per
    segment and batch row (P b h n)."""
    segs, _ = bwd_segments(b, s, h, n)
    bhn = b * h * n
    return (segs - 1) * bhn * (n + 1) + segs * bhn


def bwd_info(b: int, s: int, h: int, n: int) -> dict:
    """What the reverse's main launch gets on the current card for this
    shape: its segments and blocks, blocks resident on an SM, registers
    and local (spill) bytes a thread, shared memory a block."""
    import ctypes

    out = (ctypes.c_int * 7)()
    fn = C.entry("rwkv6_wkv", "repro_rwkv6_wkv_bwd_info", _ARGS_BWD_INFO)
    C.check("rwkv6_wkv", fn(b, h, s, n, ctypes.addressof(out)))
    keys = ("segments", "chunks_per_segment", "blocks", "blocks_per_sm",
            "registers", "local_bytes", "smem_bytes")
    return dict(zip(keys, list(out)))


def rwkv6_wkv(r, k, v, logw, u, s0=None, states: bool = False):
    """RWKV-6 WKV over the sequence, from state ``s0`` (zeros if None).

    r, k, v, logw: (b, s, h, n) CUDA tensors of one dtype (fp32 or bf16),
    n in HEAD_DIMS and contiguous, any other strides (the model's reshaped
    projections go in as they are); u: (h, n); s0: (b, h, n, n) fp32 or
    None.  Returns (o (b, s, h, n) in r.dtype, final state (b, h, n, n)
    fp32), all arithmetic in fp32; with ``states``, also the state before
    every STATE_CHUNK tokens, (b, h, n_state_chunks(s), n, n) fp32, which
    :func:`rwkv6_wkv_bwd` takes.
    """
    global LAUNCHES
    _check("rwkv6_wkv", r, k, v, logw, u, s0, C.DTYPE_CODES)
    b, s, h, n = r.shape
    uf = u.float().contiguous()
    o = torch.empty((b, s, h, n), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    chunks = (torch.empty((b, h, n_state_chunks(s), n, n),
                          dtype=torch.float32, device=r.device)
              if states else None)
    if b == 0 or h == 0:
        return (o, s_out, chunks) if states else (o, s_out)
    fn = C.entry("rwkv6_wkv", "repro_rwkv6_wkv", _ARGS)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                uf.data_ptr(), None if s0 is None else s0.data_ptr(),
                o.data_ptr(), s_out.data_ptr(),
                None if chunks is None else chunks.data_ptr(), b, h, s, n,
                *_strides(r, k, v, logw, o), C.DTYPE_CODES[r.dtype],
                C.stream_of(r))
    C.check("rwkv6_wkv", rc)
    LAUNCHES += 1
    return (o, s_out, chunks) if states else (o, s_out)


def rwkv6_wkv_bwd(r, k, v, logw, u, do, states, s0=None, ds=None):
    """Gradient of :func:`rwkv6_wkv`: the recurrence run backwards from
    the final state's gradient ``ds`` (zeros if None), each chunk's
    states recomputed from ``states``, the forward's chunk states
    (``rwkv6_wkv(..., states=True)``; they start from s0, which the
    reverse itself does not read).  ``ref.rwkv6_wkv_bwd_ref`` states the
    recurrence; the kernel cuts the sequence into :func:`bwd_segments`,
    each started from the later ones' carried gradient
    (``ref.rwkv6_wkv_bwd_split_ref`` models it), with a workspace of
    :func:`bwd_workspace_elems`.

    r, k, v, logw and the output's gradient do: fp32 (b, s, h, n) CUDA
    tensors, n in HEAD_DIMS and contiguous, any other strides; u: (h,
    n); s0: the forward's (b, h, n, n) fp32 or None; ds: (b, h, n, n)
    fp32 or None.  Returns (dr, dk, dv, dlogw (b, s, h, n) fp32, du (h,
    n) in u's dtype, ds0 (b, h, n, n) fp32, None without an s0).  The
    sums run in another order than the plain version's, and two calls
    give the same bits.
    """
    global LAUNCHES_BWD
    _check("rwkv6_wkv_bwd", r, k, v, logw, u, s0, (torch.float32,))
    b, s, h, n = r.shape
    C.require_cuda("rwkv6_wkv_bwd", r, do, states,
                   *([] if ds is None else [ds]))
    if do.shape != r.shape or do.dtype != torch.float32 or do.stride(-1) != 1:
        raise ValueError(f"rwkv6_wkv_bwd: do must be fp32 {tuple(r.shape)} "
                         f"with n contiguous, got {do.dtype} "
                         f"{tuple(do.shape)}")
    want = (b, h, n_state_chunks(s), n, n)
    if (states.dtype != torch.float32 or tuple(states.shape) != want
            or not states.is_contiguous()):
        raise ValueError(f"rwkv6_wkv_bwd: states must be the forward's "
                         f"contiguous fp32 {want}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    if ds is not None and (ds.dtype != torch.float32
                           or tuple(ds.shape) != (b, h, n, n)
                           or not ds.is_contiguous()):
        raise ValueError(f"rwkv6_wkv_bwd: ds must be contiguous fp32 "
                         f"{(b, h, n, n)}, got {ds.dtype} {tuple(ds.shape)}")
    dr, dk, dv, dlogw = (torch.empty((b, s, h, n), dtype=torch.float32,
                                     device=r.device) for _ in range(4))
    du = torch.empty((h, n), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty_like(s0)
    if b == 0 or h == 0 or s == 0:
        du.zero_()
        if ds0 is not None and ds is not None:
            ds0.copy_(ds)
        elif ds0 is not None:
            ds0.zero_()
        return dr, dk, dv, dlogw, du.to(u.dtype), ds0
    ws = torch.empty((bwd_workspace_elems(b, s, h, n),),
                     dtype=torch.float32, device=r.device)
    uf = u.float().contiguous()
    fn = C.entry("rwkv6_wkv", "repro_rwkv6_wkv_bwd", _ARGS_BWD)
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                uf.data_ptr(), do.data_ptr(),
                None if ds is None else ds.data_ptr(), states.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
                du.data_ptr(), None if ds0 is None else ds0.data_ptr(),
                ws.data_ptr(), b, h, s, n, *_strides(r, k, v, logw, do),
                C.stream_of(r))
    C.check("rwkv6_wkv", rc)
    LAUNCHES_BWD += 1
    return dr, dk, dv, dlogw, du.to(u.dtype), ds0
