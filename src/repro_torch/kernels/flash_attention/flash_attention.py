"""ctypes wrappers of the CUDA flash attention: the forward
(``kernels/csrc/flash_attention.cu``; the source's note says which TPU
kernel it replaces and how it is built) and its backward
(``kernels/csrc/flash_attention_bwd.cu``, dQ, dK and dV from the
forward's output and row log-sum-exp).

Each source has two instances, and :func:`instance` picks one from the
tensors' dtype, head_dim and layout: ``"tc"`` on the tensor cores (bf16
at head_dim 64, 128 or 256, every tensor 16-byte aligned with strides in
multiples of 8) or ``"cuda_core"`` (fp32 FMAs; fp32, and bf16
otherwise).  This is dispatch by shape, not a fallback: nothing is
caught or retried.

``LAUNCHES`` counts the forward's launches (either instance),
``LAUNCHES_TC`` those of its tensor-core instance, ``LAUNCHES_BWD`` the
backward's (one per call, which runs its kernels: two; at head_dim 256
four on the tensor cores, three on the CUDA cores) and
``LAUNCHES_BWD_TC`` those of the backward's tensor-core instance: each
wrapper adds one where it launches and nowhere else, so a run can show
that it went through the kernels.
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
# the backward takes smollm-135m's head_dim, the dense configs' 128 and
# recurrentgemma-2b's 256
BWD_HEAD_DIMS = (64, 128, 256)

# At head_dim 256 the backward's dK / dV kernel splits each kv head's
# group of query heads over ``bwd_splits`` blocks of each 64-key kv tile
# (MQA at batch 1 would otherwise give one block a tile: 64 blocks at
# 4096 keys), each writing fp32 partial dK and dV that a fixed-order sum
# adds up: enough blocks for two of the H100's 132 SMs each, fixed here
# so that the count, and with it the bits, depend on the shape alone
BWD_KV_TILE = 64
SPLIT_TARGET_BLOCKS = 264

LAUNCHES = 0
LAUNCHES_TC = 0
LAUNCHES_BWD = 0
LAUNCHES_BWD_TC = 0

_ARGS = [C.P] * 5 + [C.I] * 6 + [C.LL] * 12 + [C.I, C.I, C.F, C.I, C.P]
_ARGS_TC = [C.P] * 5 + [C.I] * 6 + [C.LL] * 12 + [C.I, C.I, C.F, C.P]
_ARGS_BWD = [C.P] * 11 + [C.I] * 7 + [C.LL] * 24 + [C.I, C.I, C.F, C.I, C.P]
_ARGS_BWD_TC = [C.P] * 11 + [C.I] * 7 + [C.LL] * 24 + [C.I, C.I, C.F, C.P]


def _rows_aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def instance(q, k, v, *others, head_dims=TC_HEAD_DIMS) -> str:
    """The instance that takes these inputs (and the other tensors of the
    call: the forward's output, the backward's o, do and gradients): "tc"
    or "cuda_core".  ``head_dims`` are the tensor-core instance's: the
    forward's by default, ``BWD_HEAD_DIMS`` for the backward."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in head_dims
            and all(_rows_aligned(t) for t in (q, k, v, *others))):
        return "tc"
    return "cuda_core"


def _bwd_outputs(q, k, v):
    """dq, dk, dv as the backward allocates them: each with its input's
    memory layout."""
    return tuple(torch.empty_like(t) for t in (q, k, v))


def bwd_instance(q, k, v, o, do, grads=None) -> str:
    """The backward's instance for these tensors (``grads`` the dq, dk,
    dv it writes; by default allocated as the wrapper allocates them)."""
    grads = _bwd_outputs(q, k, v) if grads is None else grads
    return instance(q, k, v, o, do, *grads, head_dims=BWD_HEAD_DIMS)


def bwd_splits(b: int, hq: int, hkv: int, skv: int, d: int) -> int:
    """Blocks over which the backward splits each kv tile's group of
    query heads: 1 below head_dim 256 (those kernels do not split);
    else the fewest that bring the grid (b x hkv x the 64-key tiles of
    skv, times the splits) to ``SPLIT_TARGET_BLOCKS``, at most the group
    size (so 1 where the unsplit grid reaches it).  The splits need not
    divide the group (:func:`split_heads`).  The shape alone decides,
    never the card."""
    if d != 256:
        return 1
    blocks = b * hkv * -(-skv // BWD_KV_TILE)
    return max(1, min(hq // hkv, -(-SPLIT_TARGET_BLOCKS // blocks)))


def split_heads(g: int, splits: int):
    """The heads of a group of ``g`` (indices within it) that each of
    ``splits`` blocks takes, as the kernels' ``split_head`` cuts them."""
    return [range(i * g // splits, (i + 1) * g // splits)
            for i in range(splits)]


def check_inputs(q, k, v, head_dims=HEAD_DIMS) -> None:
    """Raise ``ValueError`` for inputs the kernels do not take: q (b, hq,
    sq, d), k and v (b, hkv, skv, d) with hq % hkv == 0, d in
    ``head_dims``, one dtype of fp32 and bf16, head dim contiguous.  The
    autograd function runs the same check on every device, so the CPU
    path refuses what the card's would."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hq % hkv or d not in head_dims):
        raise ValueError(f"flash_attention: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head_dim in {head_dims})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in C.DTYPE_CODES:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; takes one of {list(C.DTYPE_CODES)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: head_dim must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (b, hq, sq, d); k, v: (b, hkv, skv, d), CUDA, fp32 or bf16,
    last dim contiguous (any other strides, e.g. transposed views of the
    model's (b, s, h, d) tensors).  hq % hkv == 0 (GQA), d in HEAD_DIMS.

    Returns (b, hq, sq, d) in q.dtype with q's memory layout; softmax and
    accumulation in fp32 (the tensor-core instance rounds the
    probabilities to bf16 before the P V product, as the model's bf16
    attention does).  With ``return_lse`` also each row's log-sum-exp,
    fp32 (b, hq, sq), for the backward; the output is the same bit for
    bit either way.
    """
    global LAUNCHES, LAUNCHES_TC
    C.require_cuda("flash_attention", q, k, v)
    check_inputs(q, k, v)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if sq == 0:
        return (out, lse) if return_lse else out
    tc = instance(q, k, v, out) == "tc"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
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
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """Gradients (dq, dk, dv) of :func:`flash_attention` on the CUDA
    kernels: q, o, do (b, hq, sq, d), k, v (b, hkv, skv, d) as the forward
    takes them (any strides, head dim contiguous; a ``do`` whose head dim
    is strided, e.g. an expanded gradient, is copied contiguous first),
    ``lse`` the forward's (b, hq, sq) fp32.  d in BWD_HEAD_DIMS.

    Returns dq, dk, dv in the inputs' dtype, each with its input's memory
    layout; fp32 softmax and accumulation, dk and dv summed over each kv
    head's group, no atomics (the same bits on every call).  At head_dim
    256 the group is split over :func:`bwd_splits` blocks whose fp32
    partials go through a workspace allocated here.  The
    tensor-core instance (:func:`bwd_instance`) rounds P and dS to bf16
    as the operands of their products, as FlashAttention-2 does
    (``attention_bwd_ref(..., operand_dtype=torch.bfloat16)`` models it).
    """
    global LAUNCHES_BWD, LAUNCHES_BWD_TC
    check_inputs(q, k, v, BWD_HEAD_DIMS)
    if do.stride(-1) != 1:
        do = do.contiguous()
    C.require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or o.stride(-1) != 1
            or lse.shape != (b, hq, sq) or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    lse = lse.contiguous()
    if lse.data_ptr() % 16:                 # read by TMA at head_dim 256
        lse = lse.clone()
    dq, dk, dv = grads = _bwd_outputs(q, k, v)
    if sq == 0 or skv == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    splits = bwd_splits(b, hq, hkv, skv, d)
    ws = (torch.empty((2, splits, b, hkv, skv, d), dtype=torch.float32,
                      device=q.device) if d == 256 else None)
    tc = bwd_instance(q, k, v, o, do, grads) == "tc"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            None if ws is None else ws.data_ptr(), splits,
            b, hq, hkv, sq, skv, d,
            *(s for t in (q, k, v, o, do, dq, dk, dv)
              for s in t.stride()[:3]),
            int(causal), int(window), d ** -0.5)
    with torch.cuda.device(q.device):
        if tc:
            fn = C.entry("flash_attention_bwd",
                         "repro_flash_attention_bwd_tc", _ARGS_BWD_TC)
            rc = fn(*args, C.stream_of(q))
        else:
            fn = C.entry("flash_attention_bwd", "repro_flash_attention_bwd",
                         _ARGS_BWD)
            rc = fn(*args, C.DTYPE_CODES[q.dtype], C.stream_of(q))
    C.check("flash_attention_bwd", rc)
    LAUNCHES_BWD += 1
    LAUNCHES_BWD_TC += tc
    return dq, dk, dv
