"""ctypes wrappers of the CUDA grouped expert matmul
(``kernels/csrc/moe_gmm.cu``; the source's note says which TPU kernel it
replaces, what bounds each instance and how it is built) and of its
backward (``kernels/csrc/moe_gmm_bwd.cu``: dX and dW in one call).

Each source has two instances, and :func:`instance` / :func:`bwd_instance`
pick one from the inputs' dtype and shape: ``"tc"`` (bf16 on the tensor
cores, K and F multiples of 8, 16-byte aligned) or ``"cuda_core"`` (fp32
FMAs; fp32, and bf16 of any other shape).  This is dispatch by shape, not
a fallback: nothing is caught or retried.

``LAUNCHES`` counts the forward's launches (either instance),
``LAUNCHES_TC`` those of its tensor-core instance, ``LAUNCHES_BWD`` the
backward's (one per call: the CUDA-core instance runs two kernels, the
tensor-core one a single persistent launch over dX's and dW's tiles) and
``LAUNCHES_BWD_TC`` those of the backward's tensor-core instance: each
wrapper adds one where it launches and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C
from repro_torch.kernels.moe_gmm.ref import check_counts

LAUNCHES = 0
LAUNCHES_TC = 0
LAUNCHES_BWD = 0
LAUNCHES_BWD_TC = 0

_ARGS = [C.P] * 4 + [C.I] * 5 + [C.P]
_ARGS_TC = [C.P] * 4 + [C.I] * 4 + [C.P]
_ARGS_BWD = [C.P] * 6 + [C.I] * 5 + [C.P]
_ARGS_BWD_TC = [C.P] * 6 + [C.I] * 4 + [C.P]


def instance(x, w, *others) -> str:
    """The instance that takes ``x @ w`` (and the other tensors of the
    call: the backward's ``dy``): "tc" or "cuda_core"."""
    k, f = w.shape[1], w.shape[2]
    if (all(t.dtype == torch.bfloat16 for t in (x, w, *others))
            and k % 8 == 0 and f % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, *others))):
        return "tc"
    return "cuda_core"


def bwd_instance(x, w, dy) -> str:
    """The instance of :func:`moe_gmm_bwd` for these inputs: the
    forward's rule over x, w and dy (its outputs are allocated here,
    aligned)."""
    return instance(x, w, dy)


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
    _check("moe_gmm", x, w, counts)
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


def moe_gmm_bwd(x, w, dy, counts=None):
    """The gradients of :func:`moe_gmm` for the cotangent ``dy``:
    dx[e] = dy[e] @ w[e]^T and dw[e] = x[e]^T @ dy[e].

    x: (E, C, K), w: (E, K, F), dy: (E, C, F), contiguous CUDA tensors of
    one dtype (fp32 or bf16); ``counts`` as :func:`moe_gmm` takes it.
    Rows of dx from counts[e] on are zeros, and rows of x and dy from
    counts[e] on add nothing to dw (an expert with no row gets a zero
    dw).  Returns (dx (E, C, K), dw (E, K, F)) in the inputs' dtype, each
    element summed in fp32 by one thread in a fixed order (no atomics:
    the same bits on every call).
    """
    global LAUNCHES_BWD, LAUNCHES_BWD_TC
    _check("moe_gmm_bwd", x, w, counts, dy)
    e, c, k = x.shape
    f = w.shape[2]
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if e == 0 or c == 0 or f == 0 or k == 0:
        return dx.zero_(), dw.zero_()
    cp = 0 if counts is None else counts.data_ptr()
    tc = bwd_instance(x, w, dy) == "tc"
    args = (x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), cp, e, c, k, f)
    with torch.cuda.device(x.device):
        if tc:
            fn = C.entry("moe_gmm_bwd", "repro_moe_gmm_bwd_tc", _ARGS_BWD_TC)
            rc = fn(*args, C.stream_of(x))
        else:
            fn = C.entry("moe_gmm_bwd", "repro_moe_gmm_bwd", _ARGS_BWD)
            rc = fn(*args, C.DTYPE_CODES[x.dtype], C.stream_of(x))
    C.check("moe_gmm_bwd", rc)
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_TC += tc
    return dx, dw


def _check(name, x, w, counts, dy=None):
    """Raise ``ValueError`` unless x (E, C, K), w (E, K, F) and dy (E, C,
    F) (when given) are contiguous CUDA tensors of one supported dtype on
    one device, with ``counts`` None or (E,) int32 beside them."""
    ts = (x, w) if dy is None else (x, w, dy)
    C.require_cuda("moe_gmm", *ts)
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]
            or (dy is not None
                and tuple(dy.shape) != (*x.shape[:2], w.shape[2]))):
        got = " ".join(f"{n} {tuple(t.shape)}" for n, t in zip("xwd", ts))
        raise ValueError(f"{name}: unsupported shapes {got} (want x (E, C, "
                         f"K), w (E, K, F), dy (E, C, F))")
    if (any(t.dtype != x.dtype for t in ts)
            or x.dtype not in C.DTYPE_CODES):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in ts]}; takes "
                         f"one of {list(C.DTYPE_CODES)} for all")
    check_counts(x, counts)
    if not (all(t.is_contiguous() for t in ts)
            and (counts is None or counts.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous")
