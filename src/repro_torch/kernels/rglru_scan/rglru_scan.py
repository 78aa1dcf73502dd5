"""ctypes wrapper of the CUDA RG-LRU scan (``kernels/csrc/rglru_scan.cu``;
the source's note says which TPU kernel it replaces and how it is built).

``LAUNCHES`` counts the kernel's launches: the wrapper adds one where it
launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

LAUNCHES = 0

_ARGS = [C.P] * 4 + [C.I] * 4 + [C.P]


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t along axis 1, from ``h0`` (zeros if None).

    a, b: contiguous (batch, seq, ch) CUDA tensors of one dtype (fp32 or
    bf16), any alignment; h0: (batch, ch) fp32 or None.  Returns h
    (batch, seq, ch) in a.dtype, carried in fp32; ``h[:, -1]`` is the
    final state.
    """
    global LAUNCHES
    C.require_cuda("rglru_scan", a, b, *([] if h0 is None else [h0]))
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: unsupported shapes a {tuple(a.shape)} "
                         f"b {tuple(b.shape)} (want two (batch, seq, ch))")
    if a.dtype != b.dtype or a.dtype not in C.DTYPE_CODES:
        raise ValueError(f"rglru_scan: dtypes {a.dtype}/{b.dtype}; takes one "
                         f"of {list(C.DTYPE_CODES)} for both")
    if h0 is not None and (h0.dtype != torch.float32
                           or tuple(h0.shape) != (a.shape[0], a.shape[2])):
        raise ValueError(f"rglru_scan: h0 must be fp32 (batch, ch), got "
                         f"{h0.dtype} {tuple(h0.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("rglru_scan: inputs must be contiguous")
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
