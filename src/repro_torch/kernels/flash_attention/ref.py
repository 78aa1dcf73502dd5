"""Plain PyTorch version of the flash-attention kernel (the contract of
``repro.kernels.flash_attention.ref.attention_ref``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal: bool, window: int):
    """fp32 scaled scores (b, hkv, g, sq, skv) of q (b, hq, sq, d) against
    k (b, hkv, skv, d), and the (sq, skv) mask of the keys each row sees."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = (q.float() * d ** -0.5).reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > (q_pos - window)
    return s, mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  return_lse: bool = False):
    """q: (b, hq, sq, d); k, v: (b, hkv, skv, d) -> (b, hq, sq, d).

    GQA: query head ``ih`` reads kv head ``ih // g``.  Softmax and
    accumulation in fp32; the result is cast to ``q.dtype``.  With
    ``return_lse`` also each row's log-sum-exp of the scaled, masked
    scores, fp32 (b, hq, sq): what the backward needs of the forward.
    """
    b, hq, sq, d = q.shape
    s, mask = _scores(q, k, causal, window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / den, v.float())
    o = o.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(den)).reshape(b, hq, sq)


def _operand(t, dtype):
    """``t`` as a product's operand: rounded to ``dtype`` (kept in fp32),
    or as it is for None."""
    return t if dtype is None else t.to(dtype).float()


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, operand_dtype=None):
    """Gradients (dq, dk, dv) of :func:`attention_ref` from its output
    ``o``, row log-sum-exp ``lse`` (b, hq, sq) and the output's gradient
    ``do``, in fp32 (FlashAttention-2's formulas, the plain version of
    ``csrc/flash_attention_bwd.cu``):

        P = exp(S - LSE) on the keys a row sees, 0 elsewhere
        D = rowsum(dO o O);  dS = P o (dO V^T - D)
        dV = P^T dO;  dK = scale dS^T Q;  dQ = scale dS K

    dk and dv sum over the g query heads of their kv head.  Each result
    is cast to its input's dtype.  With ``operand_dtype`` (the tensor-core
    kernels' ``torch.bfloat16``), P is rounded to it before dV = P^T dO
    and dS before dK and dQ, the products still summed in fp32: the
    tensor-core instance's function up to the order of the sums.  None
    leaves every result as it is.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    s, mask = _scores(q, k, causal, window)
    lse = lse.float().reshape(b, hkv, g, sq, 1)
    p = torch.where(mask, torch.exp(s - lse), torch.zeros_like(s))
    dof = do.float().reshape(b, hkv, g, sq, d)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", _operand(p, operand_dtype), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    delta = torch.sum(dof * o.float().reshape(b, hkv, g, sq, d), dim=-1,
                      keepdim=True)
    ds = p * (dp - delta)
    scale = d ** -0.5
    ds = _operand(ds, operand_dtype)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                      q.float().reshape(b, hkv, g, sq, d)) * scale
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
