"""Public wrapper of the RG-LRU scan.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.rglru_scan import rglru_scan as _scan
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (batch, seq, ch), h0: (batch, ch) fp32 or None -> h in
    a.dtype (fp32 carry); h[:, -1] is the final state."""
    if resolve_impl(impl, a) == "kernel":
        return _scan.rglru_scan(a, b, h0)
    return rglru_scan_ref(a, b, h0)
