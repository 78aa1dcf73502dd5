"""Public wrapper of the grouped expert matmul.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


def moe_gmm(x, w, counts=None, *, impl: str = "auto"):
    """x: (E, C, K), w: (E, K, F) -> (E, C, F) in x.dtype, fp32 sums;
    ``counts`` (E,) int32: the rows each expert holds (None: all C)."""
    if resolve_impl(impl, x) == "kernel":
        return _gmm.moe_gmm(x, w, counts)
    return moe_gmm_ref(x, w, counts)
