"""Public wrapper of flash attention in the model's (b, s, h, d) layout.

``impl`` picks the implementation:

* ``"kernel"`` — the CUDA kernel (CUDA tensors only; raises otherwise);
* ``"ref"`` — the plain PyTorch version (any device; on CUDA tensors it
  is the yardstick ``chip_smoke.py`` holds the kernel against);
* ``"auto"`` — the kernel for a CUDA tensor, the plain version for a CPU
  tensor.  No fallback: a CUDA tensor gets the kernel or an exception.
"""
from __future__ import annotations

from repro_torch.kernels import resolve_impl
from repro_torch.kernels.flash_attention import flash_attention as _fa
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_bshd(q, k, v, *, causal: bool = True, window: int = 0,
                         impl: str = "auto"):
    """q: (b, sq, hq, d); k, v: (b, skv, hkv, d) -> (b, sq, hq, d)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if resolve_impl(impl, q) == "kernel":
        o = _fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    else:
        o = attention_ref(qt, kt, vt, causal=causal, window=window)
    return o.transpose(1, 2)
