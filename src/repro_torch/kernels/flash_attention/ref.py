"""Plain PyTorch version of the flash-attention kernel (the contract of
``repro.kernels.flash_attention.ref.attention_ref``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (b, hq, sq, d); k, v: (b, hkv, skv, d) -> (b, hq, sq, d).

    GQA: query head ``ih`` reads kv head ``ih // g``.  Softmax and
    accumulation in fp32; the result is cast to ``q.dtype``.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float() * d ** -0.5
    qg = qf.reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > (q_pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)
