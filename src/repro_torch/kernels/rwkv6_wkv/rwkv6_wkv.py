"""ctypes wrapper of the CUDA RWKV-6 WKV recurrence
(``kernels/csrc/rwkv6_wkv.cu``; the source's note says which TPU kernel it
replaces and how it is built).

``LAUNCHES`` counts the kernel's launches: the wrapper adds one where it
launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

HEAD_DIMS = (16, 32, 64)

LAUNCHES = 0

_ARGS = [C.P] * 8 + [C.I] * 4 + [C.LL] * 15 + [C.I, C.P]


def rwkv6_wkv(r, k, v, logw, u, s0=None):
    """RWKV-6 WKV over the sequence, from state ``s0`` (zeros if None).

    r, k, v, logw: (b, s, h, n) CUDA tensors of one dtype (fp32 or bf16),
    n in HEAD_DIMS and contiguous, any other strides (the model's reshaped
    projections go in as they are); u: (h, n); s0: (b, h, n, n) fp32 or
    None.  Returns (o (b, s, h, n) in r.dtype, final state (b, h, n, n)
    fp32), all arithmetic in fp32.
    """
    global LAUNCHES
    C.require_cuda("rwkv6_wkv", r, k, v, logw, u,
                   *([] if s0 is None else [s0]))
    b, s, h, n = r.shape
    if (any(t.shape != r.shape for t in (k, v, logw))
            or tuple(u.shape) != (h, n) or n not in HEAD_DIMS):
        raise ValueError(f"rwkv6_wkv: unsupported shapes r {tuple(r.shape)} "
                         f"u {tuple(u.shape)} (want r, k, v, logw (b, s, h, "
                         f"n), u (h, n), n in {HEAD_DIMS})")
    if (any(t.dtype != r.dtype for t in (k, v, logw))
            or r.dtype not in C.DTYPE_CODES):
        raise ValueError(f"rwkv6_wkv: dtypes {r.dtype}/{k.dtype}/{v.dtype}/"
                         f"{logw.dtype}; takes one of {list(C.DTYPE_CODES)}")
    if any(t.stride(-1) != 1 for t in (r, k, v, logw)):
        raise ValueError("rwkv6_wkv: the head dim n must be contiguous")
    if s0 is not None and (s0.dtype != torch.float32
                           or tuple(s0.shape) != (b, h, n, n)
                           or not s0.is_contiguous()):
        raise ValueError(f"rwkv6_wkv: s0 must be contiguous fp32 "
                         f"{(b, h, n, n)}, got {s0.dtype} {tuple(s0.shape)}")
    uf = u.float().contiguous()
    o = torch.empty((b, s, h, n), dtype=r.dtype, device=r.device)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b == 0 or h == 0:
        return o, s_out
    fn = C.entry("rwkv6_wkv", "repro_rwkv6_wkv", _ARGS)
    strides = [x for t in (r, k, v, logw, o) for x in t.stride()[:3]]
    with torch.cuda.device(r.device):
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                uf.data_ptr(), None if s0 is None else s0.data_ptr(),
                o.data_ptr(), s_out.data_ptr(), b, h, s, n, *strides,
                C.DTYPE_CODES[r.dtype], C.stream_of(r))
    C.check("rwkv6_wkv", rc)
    LAUNCHES += 1
    return o, s_out
