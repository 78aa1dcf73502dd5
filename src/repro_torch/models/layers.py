"""Primitive layers (the port's ``repro.models.layers``).

Same numerics contract as the reference: norms compute in fp32 and cast
back; ``dense`` multiplies in the compute dtype with fp32 accumulation
(cuBLAS accumulates bf16 products in fp32) and casts back; logits come
out in fp32 from compute-dtype operands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def rmsnorm(x, w, eps: float):
    dt = x.dtype
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * w.float()).to(dt)


def layernorm(x, w, b, eps: float):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def norm(x, block, name: str, cfg: ModelConfig):
    if cfg.norm_type == "layernorm":
        return layernorm(x, block[name], block[f"{name}_b"], cfg.norm_eps)
    return rmsnorm(x, block[name], cfg.norm_eps)


def dense(x, w, b=None):
    """x @ w in compute dtype with fp32 accumulation."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _act(cfg: ModelConfig):
    if cfg.mlp_activation == "silu":
        return F.silu
    # jax.nn.gelu defaults to the tanh approximation
    return lambda h: F.gelu(h, approximate="tanh")


def mlp(x, p, cfg: ModelConfig):
    """(Gated) MLP: silu/gelu — SwiGLU or GeGLU when cfg.mlp_gated."""
    act = _act(cfg)
    h = dense(x, p["wi"])
    if cfg.mlp_gated:
        h = act(dense(x, p["wg"])) * h
    else:
        h = act(h)
    return dense(h, p["wo"])


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs    # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]             # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def embed_tokens(tokens, w, compute_dtype):
    return w[tokens].to(compute_dtype)


class HeadFn(torch.autograd.Function):
    """logits = x @ w for compute-dtype (bf16) ``x`` (n, d) and ``w`` (d,
    V): products summed in fp32, fp32 logits (the reference's
    ``preferred_element_type=float32``).  On CUDA one bf16 GEMM with fp32
    output (``aten::mm.dtype``, a library GEMM: the reference computes
    this product outside any Pallas kernel); on the CPU, which has no
    kernel for it, an fp32 GEMM of the operands cast up, the same values
    up to summation order.

    The backward is the reference's transpose rule (``dot_general``'s
    ``_dot_general_transpose_lhs`` / ``_rhs``): the fp32 cotangent times
    the other operand cast up, summed in fp32, cast to the operand's
    dtype (:func:`head_backward`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return head_backward(g, x, w, *ctx.needs_input_grad[:2])


def head_backward(g, x, w, need_x: bool = True, need_w: bool = True):
    """(dx, dw) of :class:`HeadFn` for the fp32 cotangent ``g`` (n, V):
    two fp32 GEMMs, each result cast to its operand's dtype (``None``
    where not needed)."""
    dx = torch.mm(g, w.float().T).to(x.dtype) if need_x else None
    dw = torch.mm(x.float().T, g).to(w.dtype) if need_w else None
    return dx, dw


def lm_logits(x, params, cfg: ModelConfig, softcap: float = 0.0):
    """fp32 logits of compute-dtype inputs: the head is cast to ``x``'s
    dtype and multiplied with fp32 accumulation (the reference's
    ``preferred_element_type=float32``): fp32 ``x`` by one fp32 GEMM,
    anything narrower through :class:`HeadFn`.  A tree from
    ``compute_params`` carries the cast head as ``params["head"]``."""
    head = params.get("head")
    if head is None:
        w = (params["embed"]["tok"].T if cfg.tie_embeddings
             else params["lm_head"])
        head = w.to(x.dtype)
    if x.dtype == torch.float32:
        logits = torch.matmul(x, head)
    else:
        logits = HeadFn.apply(x.reshape(-1, x.shape[-1]), head).view(
            *x.shape[:-1], head.shape[-1])
    cap = softcap or cfg.logit_softcap
    if cap > 0:
        logits = cap * torch.tanh(logits / cap)
    return logits


def softmax_xent(logits, labels):
    """Mean token cross-entropy in fp32 (``repro.models.layers.
    softmax_xent``): logsumexp of each row less its gold logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)
