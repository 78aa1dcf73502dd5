"""Public wrapper of flash attention in the model's (b, s, h, d) layout,
differentiable.

``impl`` picks the implementation:

* ``"kernel"`` — the CUDA kernels (CUDA tensors only; raises otherwise);
* ``"ref"`` — the plain PyTorch versions (any device; on CUDA tensors
  they are the yardstick ``chip_smoke.py`` holds the kernels against);
* ``"auto"`` — the kernels for a CUDA tensor, the plain versions for a
  CPU tensor.  No fallback: a CUDA tensor gets the kernels or an
  exception.

Where autograd records (grad enabled and an input that requires grad),
the call goes through :class:`FlashAttentionFn`, one
``torch.autograd.Function`` for both implementations: its forward also
keeps each row's log-sum-exp, its backward computes dQ, dK and dV from
the saved (q, k, v, o, lse), on the backward kernel or its plain
version.  Otherwise the forward runs alone and writes no log-sum-exp
(the serving paths: the same output bits as before).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v) on (b, h, s, d) views, with its gradient.
    ``kernel`` picks the CUDA kernels (True) or the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, kernel: bool):
        if kernel:
            # refuse at the forward what the backward kernel will not take
            _fa.check_inputs(q, k, v, _fa.BWD_HEAD_DIMS)
            o, lse = _fa.flash_attention(q, k, v, causal=causal,
                                         window=window, return_lse=True)
        else:
            _fa.check_inputs(q, k, v)
            o, lse = attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.kernel = causal, window, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = _fa.flash_attention_bwd if ctx.kernel else attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=ctx.causal,
                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         impl: str = "auto"):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kernel = resolve_impl(impl, q) == "kernel"
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o = FlashAttentionFn.apply(qt, kt, vt, causal, window, kernel)
    elif kernel:
        o = _fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    else:
        o = attention_ref(qt, kt, vt, causal=causal, window=window)
    return o.transpose(1, 2)
