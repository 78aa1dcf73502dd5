"""Attention of the port: GQA projections with RoPE, prefill
self-attention and cross-attention through the flash-attention kernel,
and one-token decode attention against a (ring-buffer) KV cache.

The reference computes prefill attention and cross-attention with XLA
(``repro.models.attention.attention``) and names the Pallas flash kernel
as its TPU implementation; the port runs its own flash-attention kernel
there (``repro_torch.kernels.flash_attention``), the same function.
Decode self-attention against a per-request cache is plain torch, as the
reference computes it in XLA and no Pallas kernel covers it.
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


def cross_attention(x, p, cfg: ModelConfig, k, v, attn_impl: str = "auto"):
    """Attention of x (b, s, d) to given keys and values k, v (b, t, hkv,
    hd) (the encoder's states, projected): q from x, every query sees
    every key (non-causal, no window), through the flash kernel; s and t
    need not be equal.  Returns (b, s, d)."""
    b, s, _ = x.shape
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, cfg.num_heads,
                                              cfg.head_dim)
    o = flash_attention_bshd(q, k, v, causal=False, window=0, impl=attn_impl)
    return merge_heads_out(o, p)


NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, n_valid):
    """One-token attention against a cache.

    q: (b, 1, hq, hd); caches: (b, S, hkv, hd) with ``n_valid`` filled
    slots, a scalar or a (b,) vector.  Scores and the PV sum in fp32 on the
    compute-dtype operands (the reference's ``preferred_element_type``),
    probabilities rounded to v's dtype first, as the reference does.  A
    row with ``n_valid == 0`` gets the uniform mean of its cache (the
    reference's behaviour: every score is NEG_INF).  Slot order does not
    matter (keys are stored post-RoPE), so a ring buffer needs no unpermute.
    """
    b, _, hq, hd = q.shape
    S, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q * hd ** -0.5).reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float())
    n_valid = torch.as_tensor(n_valid, device=q.device)
    mask = torch.arange(S, device=q.device) < n_valid.reshape(-1, 1)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    probs = e / (torch.sum(e, dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype).reshape(b, 1, hq, hd)


def decode_self_attention(x, p, cfg: ModelConfig, cache, use_rope=True,
                          ring=None):
    """x: (b, 1, d).  cache: dict with k/v (b, S, hkv, hd) and pos (a
    scalar shared across the batch, or a (b,) per-row vector).

    Writes the new kv at slot pos % R of each row (a ring buffer for
    windowed caches) and attends over min(pos + 1, R) valid slots, R the
    ring's length: S, or the (b,) tensor ``ring`` of each row's ring in
    the first R slots of the S (whisper's prompt + 64).  Unlike the
    reference, the cache tensors are written in place (no second copy of
    the cache per step) and returned in the new cache dict.
    """
    b = x.shape[0]
    k_cache, v_cache = cache["k"], cache["v"]
    S = k_cache.shape[1] if ring is None else ring
    pos = torch.as_tensor(cache["pos"], device=x.device)
    rows_pos = pos.expand(b) if pos.dim() == 0 else pos
    q, k, v = project_qkv(x, p, cfg, rows_pos[:, None].long(), use_rope)
    rows = torch.arange(b, device=x.device)
    slot = (rows_pos % S).long()
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    n_valid = (torch.clamp(pos + 1, max=S) if ring is None
               else torch.minimum(pos + 1, ring))
    o = decode_attention(q, k_cache, v_cache, n_valid)
    return merge_heads_out(o, p), {"k": k_cache, "v": v_cache, "pos": pos}
