"""Public wrapper of the RWKV-6 WKV recurrence, differentiable.

``impl``: "kernel" (CUDA only), "ref" (the plain version, any device) or
"auto" (the kernel for a CUDA tensor, the plain version for a CPU tensor;
no fallback).

Where autograd records (grad enabled and an input that requires grad),
the call goes through :class:`WkvFn`, one ``torch.autograd.Function``
for both implementations: its backward runs the reverse recurrence (the
kernel ``rwkv6_wkv_bwd``, from the chunk states the forward kernel kept,
or its plain version) from the saved inputs.  Otherwise the forward runs
alone (the serving paths: the same bits and launches as before).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as _wkv
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_bwd_ref, rwkv6_wkv_ref


class WkvFn(torch.autograd.Function):
    """(o, state) = rwkv6_wkv(r, k, v, logw, u, s0) with the gradient for
    r, k, v, logw, u and s0, from the output's and the final state's.
    ``kernel`` picks the CUDA kernels (True) or the plain versions."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0, kernel: bool):
        if kernel:
            o, s1, states = _wkv.rwkv6_wkv(r, k, v, logw, u, s0, states=True)
        else:
            (o, s1), states = rwkv6_wkv_ref(r, k, v, logw, u, s0), None
        ctx.save_for_backward(r, k, v, logw, u, s0, states)
        ctx.kernel = kernel
        # a final state nobody differentiates comes back as None
        ctx.set_materialize_grads(False)
        return o, s1

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, logw, u, s0, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        elif do.stride(-1) != 1:
            do = do.contiguous()
        if ctx.kernel:
            grads = _wkv.rwkv6_wkv_bwd(r, k, v, logw, u, do, states, s0,
                                       None if ds is None else ds.contiguous())
        else:
            grads = rwkv6_wkv_bwd_ref(r, k, v, logw, u, do, s0, ds)
        return (*grads, None)


def rwkv6_wkv(r, k, v, logw, u, s0=None, *, impl: str = "auto"):
    """r, k, v, logw: (b, s, h, n); u: (h, n); s0: (b, h, n, n) fp32 or
    None -> (o (b, s, h, n) in r.dtype, final state fp32)."""
    kernel = resolve_impl(impl, r) == "kernel"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, logw, u, s0)):
        return WkvFn.apply(r, k, v, logw, u, s0, kernel)
    if kernel:
        return _wkv.rwkv6_wkv(r, k, v, logw, u, s0)
    return rwkv6_wkv_ref(r, k, v, logw, u, s0)
