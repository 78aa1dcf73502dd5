"""ctypes wrapper of the CUDA grouped expert matmul
(``kernels/csrc/moe_gmm.cu``; the source's note says which TPU kernel it
replaces and how it is built).

``LAUNCHES`` counts the kernel's launches: the wrapper adds one where it
launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

LAUNCHES = 0

_ARGS = [C.P] * 3 + [C.I] * 5 + [C.P]


def moe_gmm(x, w):
    """out[e] = x[e] @ w[e] for every expert e.

    x: (E, C, K), w: (E, K, F), contiguous CUDA tensors of one dtype
    (fp32 or bf16); any C, K and F.  Returns (E, C, F) in x.dtype, the
    products summed in fp32.
    """
    global LAUNCHES
    C.require_cuda("moe_gmm", x, w)
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]):
        raise ValueError(f"moe_gmm: unsupported shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} (want (E, C, K), (E, K, F))")
    if x.dtype != w.dtype or x.dtype not in C.DTYPE_CODES:
        raise ValueError(f"moe_gmm: dtypes {x.dtype}/{w.dtype}; takes one "
                         f"of {list(C.DTYPE_CODES)} for both")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm: inputs must be contiguous")
    e, c, k = x.shape
    f = w.shape[2]
    if e == 0 or c == 0 or f == 0 or k == 0:
        return x.new_zeros((e, c, f))
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    fn = C.entry("moe_gmm", "repro_moe_gmm", _ARGS)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, f,
                C.DTYPE_CODES[x.dtype], C.stream_of(x))
    C.check("moe_gmm", rc)
    LAUNCHES += 1
    return out
