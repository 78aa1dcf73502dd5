"""Attention of the port: GQA projections with RoPE, and prefill
self-attention through the flash-attention kernel.

The reference computes prefill attention with XLA (``repro.models.
attention.attention``) and names the Pallas flash kernel as its TPU
implementation; the port runs its own flash-attention kernel there
(``repro_torch.kernels.flash_attention``), the same function.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, rope


def project_qkv(x, p, cfg: ModelConfig, positions, use_rope: bool = True):
    """x: (b, s, d) -> q (b, s, hq, hd), k, v (b, s, hkv, hd)."""
    b, s, _ = x.shape
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def merge_heads_out(o, p):
    b, s = o.shape[:2]
    return dense(o.reshape(b, s, -1), p["wo"])


def self_attention(x, p, cfg: ModelConfig, *, positions=None, causal=True,
                   window: Optional[int] = None, use_rope=True,
                   attn_impl: str = "auto"):
    """Prefill self-attention over the whole sequence.  Returns
    (output (b, s, d), (k, v)) with k, v (b, s, hkv, hd)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(x, p, cfg, positions, use_rope)
    w = cfg.attention_window if window is None else window
    o = flash_attention_bshd(q, k, v, causal=causal, window=w,
                             impl=attn_impl)
    return merge_heads_out(o, p), (k, v)
