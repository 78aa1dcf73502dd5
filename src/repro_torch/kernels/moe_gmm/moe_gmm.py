"""ctypes wrapper of the CUDA grouped expert matmul
(``kernels/csrc/moe_gmm.cu``; the source's note says which TPU kernel it
replaces, what bounds each instance and how it is built).

The source has two instances, and :func:`instance` picks one from the
inputs' dtype and shape: ``"tc"`` (bf16 on the tensor cores, K and F
multiples of 8, 16-byte aligned) or ``"cuda_core"`` (fp32 FMAs; fp32, and
bf16 of any other shape).  This is dispatch by shape, not a fallback:
nothing is caught or retried.

``LAUNCHES`` counts the kernel's launches (either instance) and
``LAUNCHES_TC`` those of the tensor-core instance: the wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C
from repro_torch.kernels.moe_gmm.ref import check_counts

LAUNCHES = 0
LAUNCHES_TC = 0

_ARGS = [C.P] * 4 + [C.I] * 5 + [C.P]
_ARGS_TC = [C.P] * 4 + [C.I] * 4 + [C.P]


def instance(x, w) -> str:
    """The instance that takes ``x @ w``: "tc" or "cuda_core"."""
    k, f = w.shape[1], w.shape[2]
    if (x.dtype == w.dtype == torch.bfloat16 and k % 8 == 0 and f % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "tc"
    return "cuda_core"


def moe_gmm(x, w, counts=None):
    """out[e] = x[e] @ w[e] for every expert e.

    x: (E, C, K), w: (E, K, F), contiguous CUDA tensors of one dtype
    (fp32 or bf16); any C, K and F.  ``counts``: None or an (E,) int32
    tensor on x's device, the rows each expert holds (rows [counts[e], C)
    of x are zero); its output rows from counts[e] on are zeros and no
    weight of an expert with no row is read.  Returns (E, C, F) in
    x.dtype, the products summed in fp32.
    """
    global LAUNCHES, LAUNCHES_TC
    C.require_cuda("moe_gmm", x, w)
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]):
        raise ValueError(f"moe_gmm: unsupported shapes x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} (want (E, C, K), (E, K, F))")
    if x.dtype != w.dtype or x.dtype not in C.DTYPE_CODES:
        raise ValueError(f"moe_gmm: dtypes {x.dtype}/{w.dtype}; takes one "
                         f"of {list(C.DTYPE_CODES)} for both")
    check_counts(x, counts)
    if not (x.is_contiguous() and w.is_contiguous()
            and (counts is None or counts.is_contiguous())):
        raise ValueError("moe_gmm: inputs must be contiguous")
    e, c, k = x.shape
    f = w.shape[2]
    if e == 0 or c == 0 or f == 0 or k == 0:
        return x.new_zeros((e, c, f))
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    cp = 0 if counts is None else counts.data_ptr()
    tc = instance(x, w) == "tc"
    with torch.cuda.device(x.device):
        if tc:
            fn = C.entry("moe_gmm", "repro_moe_gmm_tc", _ARGS_TC)
            rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), cp, e, c, k,
                    f, C.stream_of(x))
        else:
            fn = C.entry("moe_gmm", "repro_moe_gmm", _ARGS)
            rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), cp, e, c, k,
                    f, C.DTYPE_CODES[x.dtype], C.stream_of(x))
    C.check("moe_gmm", rc)
    LAUNCHES += 1
    LAUNCHES_TC += tc
    return out
