"""Attention of the port: GQA projections with RoPE, prefill
self-attention and cross-attention through the flash-attention kernel,
and one-token decode attention against a (ring-buffer) KV cache.

The reference computes prefill attention and cross-attention with XLA
(``repro.models.attention.attention``) and names the Pallas flash kernel
as its TPU implementation; the port runs its own flash-attention kernel
there (``repro_torch.kernels.flash_attention``), the same function.
Decode self-attention against a per-request cache is plain torch, as the
reference computes it in XLA and no Pallas kernel covers it.

Under a ``ParallelCtx`` with DTensor activations the projections' heads
are laid out as the reference's ``act_heads`` spec (batch over the data
axes, heads over the model axis; heads replicated when the query or KV
head count does not divide the model axis), and the flash kernel runs on
each rank's heads and rows (``repro_torch.parallel.ctx.run_local``).

A decode step against a DTensor cache (``cache_placements``: the batch
over the data axes, the cached sequence over model where it divides)
runs on each rank's rows and slots: each row's new K/V is written, in
place, by the model rank that owns its slot, and the softmax is split
over the slots (:func:`decode_attention_pieces`): the row maxima and the
exponentials' sums are all-reduced over model, each rank's P (rounded to
v's dtype, as the reference rounds it) meets its V, and the fp32 outputs
are summed over model.  That is what the reference's GSPMD makes of
``decode_attention`` on the same layout (partial sums and a small
reduction).  Where the sequence is not split the one-piece
:func:`decode_attention` runs on each rank's block.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.collectives import region
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, rope
from repro_torch.parallel.ctx import get_ctx, run_local, shard_activation


def project_qkv(x, p, cfg: ModelConfig, positions, use_rope: bool = True):
    """x: (b, s, d) -> q (b, s, hq, hd), k, v (b, s, hkv, hd)."""
    q = _split_heads(dense(x, p["wq"], p.get("bq")), cfg, cfg.num_heads)
    k = _split_heads(dense(x, p["wk"], p.get("bk")), cfg, cfg.num_kv_heads)
    v = _split_heads(dense(x, p["wv"], p.get("bv")), cfg, cfg.num_kv_heads)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _split_heads(y, cfg: ModelConfig, heads: int):
    """A projection (b, s, heads * hd) -> (b, s, heads, hd).  A DTensor is
    first laid out as the ``act_heads`` spec (batch over the data axes,
    heads over model), or on the batch only (``kv_rep``) when the query
    or KV head count does not divide the model axis, and split on each
    rank's block, so that neither the view nor its gradient ever cuts
    a head."""
    if not isinstance(y, DTensor):
        return y.reshape(*y.shape[:2], heads, cfg.head_dim)
    ctx = get_ctx()
    n = ctx.size(ctx.tp_axis)
    even = cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0
    y = shard_activation(y, "act_heads" if even else "kv_rep")
    plc = tuple(y.placements)
    return run_local(lambda t: t.reshape(*t.shape[:2], -1, cfg.head_dim),
                     y.device_mesh, (y,), (plc,), plc)


def _attend(q, k, v, *, causal: bool, window: int, impl: str):
    """flash_attention_bshd, on each rank's blocks for DTensors (k and v
    take q's placements: its batch rows and its heads' KV heads)."""
    if not isinstance(q, DTensor):
        return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    impl=impl)
    plc = tuple(q.placements)
    return run_local(
        lambda a, b_, c: flash_attention_bshd(a, b_, c, causal=causal,
                                              window=window, impl=impl),
        q.device_mesh, (q, k, v), (plc, plc, plc), plc)


def merge_heads_out(o, p):
    b, s = o.shape[:2]
    if isinstance(o, DTensor):
        # the heads merged on each rank's block (see ``_split_heads``)
        plc = tuple(o.placements)
        flat = run_local(lambda t: t.reshape(*t.shape[:2], -1),
                         o.device_mesh, (o,), (plc,), plc)
    else:
        flat = o.reshape(b, s, -1)
    return dense(flat, p["wo"])


def self_attention(x, p, cfg: ModelConfig, *, positions=None, causal=True,
                   window: Optional[int] = None, use_rope=True,
                   attn_impl: str = "auto"):
    """Prefill self-attention over the whole sequence.  Returns
    (output (b, s, d), (k, v)) with k, v (b, s, hkv, hd)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(x, p, cfg, positions, use_rope)
    if cfg.attn_kv_gather:
        # K/V gathered across the model axis once per layer (the
        # reference's SP attention lever); the identity without a mesh
        k = shard_activation(k, "kv_rep")
        v = shard_activation(v, "kv_rep")
    w = cfg.attention_window if window is None else window
    o = _attend(q, k, v, causal=causal, window=w, impl=attn_impl)
    return merge_heads_out(o, p), (k, v)


def cross_attention(x, p, cfg: ModelConfig, k, v, attn_impl: str = "auto"):
    """Attention of x (b, s, d) to given keys and values k, v (b, t, hkv,
    hd) (the encoder's states, projected, laid out by ``_split_heads``):
    q from x, every query sees every key (non-causal, no window), through
    the flash kernel; s and t need not be equal.  Returns (b, s, d)."""
    q = _split_heads(dense(x, p["wq"], p.get("bq")), cfg, cfg.num_heads)
    o = _attend(q, k, v, causal=False, window=0, impl=attn_impl)
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
    if isinstance(k_cache, DTensor):
        o = _decode_sharded(q, k, v, k_cache, v_cache, pos, ring)
        return merge_heads_out(o, p), {"k": k_cache, "v": v_cache,
                                       "pos": pos}
    rows = torch.arange(b, device=x.device)
    slot = (rows_pos % S).long()
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    n_valid = (torch.clamp(pos + 1, max=S) if ring is None
               else torch.minimum(pos + 1, ring))
    o = decode_attention(q, k_cache, v_cache, n_valid)
    return merge_heads_out(o, p), {"k": k_cache, "v": v_cache, "pos": pos}


def decode_attention_pieces(q, k_pieces, v_pieces, n_valid, offsets,
                            reduce_max, reduce_sum):
    """:func:`decode_attention` over a cache cut into pieces of its slots:
    ``k_pieces``, ``v_pieces`` (P, b, S_p, hkv, hd), piece j holding the
    slots ``offsets[j]`` .. ``offsets[j] + S_p - 1`` (``offsets`` a (P,)
    tensor), the mask taken on those global slot indices.  ``reduce_max``
    and ``reduce_sum`` reduce a (P, ...) tensor over every piece, the
    ones here and the ones on other ranks, and give each piece the
    result: the row maxima M and the sums l of exp(s - M) are reduced,
    P = exp(s - M) / (l + 1e-30) is rounded to v's dtype and multiplied
    with each piece's V in fp32, and those outputs are reduced.  A row
    with ``n_valid == 0`` gets the uniform mean of the whole cache, as
    the one-piece form gives it; a piece whose slots are all masked adds
    exp(-1e30 - M) = 0.  Returns (b, 1, hq, hd) in q's dtype."""
    b, _, hq, hd = q.shape
    S, hkv = k_pieces.shape[2], k_pieces.shape[3]
    g = hq // hkv
    qg = (q * hd ** -0.5).reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,pbkhd->pbhgk", qg.float(), k_pieces.float())
    slots = offsets.reshape(-1, 1) + torch.arange(S, device=q.device)
    n_valid = torch.as_tensor(n_valid, device=q.device)
    mask = slots[:, None, :] < n_valid.reshape(1, -1, 1)
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    m = reduce_max(torch.amax(scores, dim=-1, keepdim=True))
    e = torch.exp(scores - m)
    probs = e / (reduce_sum(torch.sum(e, dim=-1, keepdim=True)) + 1e-30)
    out = reduce_sum(torch.einsum("pbhgk,pbkhd->pbhgd",
                                  probs.to(v_pieces.dtype).float(),
                                  v_pieces.float()))
    return out[0].to(q.dtype).reshape(b, 1, hq, hd)


def _all_reduce(t, op: str, group):
    out = funcol.all_reduce(t, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def _decode_sharded(q, k, v, k_cache, v_cache, pos, ring=None):
    """The decode write and attention of DTensor q (b, 1, hq, hd), new k,
    v (b, 1, hkv, hd) against a DTensor cache (b, S, hkv, hd) at the
    DTensor positions ``pos`` (b,), on each rank's rows and slots (the
    module note): each row's ring is S, or its entry of the DTensor
    ``ring`` (b,), the first ``ring`` slots of the S (whisper's); q's
    heads are gathered whole on model for the product, and the output
    (b, 1, hq, hd) comes back in q's placements."""
    mesh = k_cache.device_mesh
    c_plc = tuple(k_cache.placements)
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in c_plc)
    split = [i for i, p in enumerate(c_plc) if p == Shard(1)]
    group = mesh.get_group(split[0]) if split else None
    S = k_cache.shape[1]
    args = (q, k, v, k_cache, v_cache, pos)
    plcs = (rows, rows, rows, c_plc, c_plc, rows)
    if ring is not None:
        args += (ring,)
        plcs += (rows if isinstance(ring, DTensor) else None,)

    def body(ql, kl, vl, kc, vc, pl, rl=None):
        b = ql.shape[0]
        r = torch.arange(b, device=ql.device)
        ring_len = S if rl is None else rl
        slot = (pl % ring_len).long()
        n_valid = torch.clamp(pl + 1, max=ring_len)
        if group is None:
            kc[r, slot] = kl[:, 0].to(kc.dtype)
            vc[r, slot] = vl[:, 0].to(vc.dtype)
            return decode_attention(ql, kc, vc, n_valid)
        s_loc = kc.shape[1]
        offset = mesh.get_local_rank(split[0]) * s_loc
        # each row's slot is written by the rank that holds it; the other
        # ranks write their block's own values back (unique rows: no
        # collision), so every block stays where it lies
        at = (slot - offset).clamp(0, s_loc - 1)
        mine = ((slot >= offset) & (slot < offset + s_loc))[:, None, None]
        kc[r, at] = torch.where(mine, kl[:, 0].to(kc.dtype), kc[r, at])
        vc[r, at] = torch.where(mine, vl[:, 0].to(vc.dtype), vc[r, at])
        with region("decode_attention"):
            return decode_attention_pieces(
                ql, kc[None], vc[None], n_valid,
                torch.full((1,), offset, device=ql.device),
                lambda t: _all_reduce(t, "max", group),
                lambda t: _all_reduce(t, "sum", group))

    o = run_local(body, mesh, args, plcs, rows)
    return o.redistribute(mesh, tuple(q.placements))
