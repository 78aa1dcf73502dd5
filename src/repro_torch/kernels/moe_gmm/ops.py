"""Public wrapper of the grouped expert matmul, differentiable.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).

Where autograd records (grad enabled and x or w requiring grad), the call
goes through :class:`MoeGmmFn`, one ``torch.autograd.Function`` for both
implementations: its backward computes dX and dW from the saved (x, w,
counts) on the backward kernel or its plain version.  Otherwise the
forward runs alone (the serving paths: the same bits as before).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm
from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref, moe_gmm_ref


class MoeGmmFn(torch.autograd.Function):
    """out = moe_gmm(x, w, counts) with its gradient for x and w.
    ``kernel`` picks the CUDA kernels (True) or the plain versions."""

    @staticmethod
    def forward(ctx, x, w, counts, kernel: bool):
        out = (_gmm.moe_gmm(x, w, counts) if kernel
               else moe_gmm_ref(x, w, counts))
        ctx.save_for_backward(x, w, counts)
        ctx.kernel = kernel
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        bwd = _gmm.moe_gmm_bwd if ctx.kernel else moe_gmm_bwd_ref
        dx, dw = bwd(x, w, dy.contiguous(), counts)
        return dx, dw, None, None


def moe_gmm(x, w, counts=None, *, impl: str = "auto"):
    """x: (E, C, K), w: (E, K, F) -> (E, C, F) in x.dtype, fp32 sums;
    ``counts`` (E,) int32: the rows each expert holds (None: all C)."""
    kernel = resolve_impl(impl, x) == "kernel"
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmmFn.apply(x, w, counts, kernel)
    if kernel:
        return _gmm.moe_gmm(x, w, counts)
    return moe_gmm_ref(x, w, counts)
