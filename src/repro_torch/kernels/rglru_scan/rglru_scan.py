"""ctypes wrappers of the CUDA RG-LRU scan and of its reverse, the
gradient (``kernels/csrc/rglru_scan.cu``; the source's note says which
TPU kernel each replaces and how it is built).

``LAUNCHES`` counts the forward's launches, ``LAUNCHES_BWD`` the
reverse scan's: each wrapper adds one where it launches and nowhere
else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

LAUNCHES = 0
LAUNCHES_BWD = 0

_ARGS = [C.P] * 4 + [C.I] * 4 + [C.P]
_ARGS_BWD = [C.P] * 7 + [C.I] * 4 + [C.P]


def _check(name, a, others, h0):
    """Raise ``ValueError`` for what the kernels do not take: a and the
    ``others`` contiguous (batch, seq, ch) of one dtype (fp32 or bf16),
    h0 None or a contiguous fp32 (batch, ch)."""
    C.require_cuda(name, a, *others, *([] if h0 is None else [h0]))
    if a.dim() != 3 or any(t.shape != a.shape for t in others):
        raise ValueError(f"{name}: unsupported shapes "
                         f"{[tuple(t.shape) for t in (a, *others)]} (want "
                         f"{1 + len(others)} of (batch, seq, ch))")
    if (any(t.dtype != a.dtype for t in others)
            or a.dtype not in C.DTYPE_CODES):
        raise ValueError(f"{name}: dtypes "
                         f"{[t.dtype for t in (a, *others)]}; takes one of "
                         f"{list(C.DTYPE_CODES)} for all")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (a.shape[0], a.shape[2])):
        raise ValueError(f"{name}: h0 must be fp32 (batch, ch), got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in (a, *others)) or (
            h0 is not None and not h0.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t along axis 1, from ``h0`` (zeros if None).

    a, b: contiguous (batch, seq, ch) CUDA tensors of one dtype (fp32 or
    bf16), any alignment; h0: (batch, ch) fp32 or None.  Returns h
    (batch, seq, ch) in a.dtype, carried in fp32; ``h[:, -1]`` is the
    final state.
    """
    global LAUNCHES
    _check("rglru_scan", a, [b], h0)
    batch, seq, ch = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    fn = C.entry("rglru_scan", "repro_rglru_scan", _ARGS)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(),
                None if h0 is None else h0.data_ptr(), h.data_ptr(),
                batch, seq, ch, C.DTYPE_CODES[a.dtype], C.stream_of(a))
    C.check("rglru_scan", rc)
    LAUNCHES += 1
    return h


def rglru_scan_bwd(a, h, dh, h0=None):
    """Gradient of :func:`rglru_scan`: the reverse recurrence
    ``g_t = dh_t + a_{t+1} g_{t+1}`` from the end (fp32 carry), giving
    ``db_t = g_t``, ``da_t = g_t h_{t-1}`` (``h_{-1}`` = h0, or zeros)
    and ``dh0 = a_0 g_0``.

    a, h (the forward's output), dh: contiguous (batch, seq, ch) CUDA
    tensors of one dtype (fp32 or bf16), any alignment; h0: the
    forward's (batch, ch) fp32 or None.  Returns (da, db, dh0): da, db in
    a.dtype, dh0 fp32 (None without an h0).  Bit-exact against
    ``ref.rglru_scan_bwd_ref``.
    """
    global LAUNCHES_BWD
    _check("rglru_scan_bwd", a, [h, dh], h0)
    batch, seq, ch = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if a.numel() == 0:
        return da, db, (None if dh0 is None else dh0.zero_())
    fn = C.entry("rglru_scan", "repro_rglru_scan_bwd", _ARGS_BWD)
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                None if h0 is None else h0.data_ptr(), da.data_ptr(),
                db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
                batch, seq, ch, C.DTYPE_CODES[a.dtype], C.stream_of(a))
    C.check("rglru_scan", rc)
    LAUNCHES_BWD += 1
    return da, db, dh0
