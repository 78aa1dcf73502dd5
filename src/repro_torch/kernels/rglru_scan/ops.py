"""Public wrapper of the RG-LRU scan, differentiable.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).

Where autograd records (grad enabled and an input that requires grad),
the call goes through :class:`RglruScanFn`, one
``torch.autograd.Function`` for both implementations: its backward runs
the reverse scan (the kernel ``rglru_scan_bwd`` or its plain version)
from the saved (a, h, h0).  Otherwise the forward runs alone (the serving
paths: the same bits and launches as before).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.rglru_scan import rglru_scan as _scan
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)


class RglruScanFn(torch.autograd.Function):
    """h = rglru_scan(a, b, h0) with its gradient for a, b and h0.
    ``kernel`` picks the CUDA kernels (True) or the plain versions."""

    @staticmethod
    def forward(ctx, a, b, h0, kernel: bool):
        h = _scan.rglru_scan(a, b, h0) if kernel else rglru_scan_ref(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.kernel = kernel
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        bwd = _scan.rglru_scan_bwd if ctx.kernel else rglru_scan_bwd_ref
        da, db, dh0 = bwd(a, h, dh.contiguous(), h0)
        return da, db, dh0, None


def rglru_scan(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (batch, seq, ch), h0: (batch, ch) fp32 or None -> h in
    a.dtype (fp32 carry); h[:, -1] is the final state."""
    kernel = resolve_impl(impl, a) == "kernel"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RglruScanFn.apply(a, b, h0, kernel)
    if kernel:
        return _scan.rglru_scan(a, b, h0)
    return rglru_scan_ref(a, b, h0)
