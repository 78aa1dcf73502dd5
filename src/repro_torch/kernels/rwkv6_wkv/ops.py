"""Public wrapper of the RWKV-6 WKV recurrence.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as _wkv
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref


def rwkv6_wkv(r, k, v, logw, u, s0=None, *, impl: str = "auto"):
    """r, k, v, logw: (b, s, h, n); u: (h, n); s0: (b, h, n, n) fp32 or
    None -> (o (b, s, h, n) in r.dtype, final state fp32)."""
    if resolve_impl(impl, r) == "kernel":
        return _wkv.rwkv6_wkv(r, k, v, logw, u, s0)
    return rwkv6_wkv_ref(r, k, v, logw, u, s0)
