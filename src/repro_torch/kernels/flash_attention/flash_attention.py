"""ctypes wrapper of the CUDA flash-attention forward
(``kernels/csrc/flash_attention.cu``; the source's note says which TPU
kernel it replaces and how it is built).

The source has two instances, and :func:`instance` picks one from the
inputs' dtype, head_dim and layout: ``"tc"`` (bf16 at head_dim 64, 128
or 256 on the tensor cores, every tensor 16-byte aligned with strides in
multiples of 8) or ``"cuda_core"`` (fp32 FMAs; fp32, and bf16 otherwise).
This is dispatch by shape, not a fallback: nothing is caught or retried.

``LAUNCHES`` counts the kernel's launches (either instance) and
``LAUNCHES_TC`` those of the tensor-core instance: the wrapper adds one
where it launches and nowhere else, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _ctypes as C

# the kernel's kv tile for head_dim <= 128 (kBK in the .cu) == the Pallas
# kernel's block_k == the serve allocator's page size (pinned by test
# against repro_torch.serve.kv_cache.FLASH_ATTENTION_BLOCK_K and the
# source); head_dim 256 runs 64-key tiles to fit shared memory
BLOCK_K = 128
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)

LAUNCHES = 0
LAUNCHES_TC = 0

_ARGS = [C.P] * 4 + [C.I] * 6 + [C.LL] * 12 + [C.I, C.I, C.F, C.I, C.P]
_ARGS_TC = [C.P] * 4 + [C.I] * 6 + [C.LL] * 12 + [C.I, C.I, C.F, C.P]


def _rows_aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def instance(q, k, v, out=None) -> str:
    """The instance that takes these inputs (and output): "tc" or
    "cuda_core"."""
    ts = (q, k, v) if out is None else (q, k, v, out)
    if (q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS
            and all(_rows_aligned(t) for t in ts)):
        return "tc"
    return "cuda_core"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (b, hq, sq, d); k, v: (b, hkv, skv, d), CUDA, fp32 or bf16,
    last dim contiguous (any other strides, e.g. transposed views of the
    model's (b, s, h, d) tensors).  hq % hkv == 0 (GQA), d in HEAD_DIMS.

    Returns (b, hq, sq, d) in q.dtype with q's memory layout; softmax and
    accumulation in fp32 (the tensor-core instance rounds the
    probabilities to bf16 before the P V product, as the model's bf16
    attention does).
    """
    global LAUNCHES, LAUNCHES_TC
    C.require_cuda("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hq % hkv or d not in HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head_dim in {HEAD_DIMS})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in C.DTYPE_CODES:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; takes one of {list(C.DTYPE_CODES)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")
    out = torch.empty_like(q)
    if sq == 0:
        return out
    tc = instance(q, k, v, out) == "tc"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), int(window), d ** -0.5)
    with torch.cuda.device(q.device):
        if tc:
            fn = C.entry("flash_attention", "repro_flash_attention_fwd_tc",
                         _ARGS_TC)
            rc = fn(*args, C.stream_of(q))
        else:
            fn = C.entry("flash_attention", "repro_flash_attention_fwd",
                         _ARGS)
            rc = fn(*args, C.DTYPE_CODES[q.dtype], C.stream_of(q))
    C.check("flash_attention", rc)
    LAUNCHES += 1
    LAUNCHES_TC += tc
    return out
