"""Decoder-only LM of the port, dense and MoE families: prefill and
batched paged decode (the counterparts of ``repro.models.transformer``).

Layer stacks are a Python loop: the unrolled ``dense_layers`` first
(``first_k_dense`` of them), then the stacked L dim of ``blocks``.
Public functions keep the reference's layouts — the prefill cache's
stacked KV is (L, b, S, hkv, hd) with the sequence on axis 2, the page
pool is (L, hkv, n_pages, block_tokens, hd) — so the tests compare like
with like.  Unlike JAX, the page pool is updated in place: the paged
functions write into the tensors they are given and return them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.paged_attention.ops import paged_attention_decode
from repro_torch.models.attention import (merge_heads_out, project_qkv,
                                          self_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import check_ported
from repro_torch.models.layers import embed_tokens, lm_logits, mlp, norm
from repro_torch.models.moe import moe_block

PyTree = Any


def _tree_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ffn(x, bp, cfg: ModelConfig, moe: bool, gmm_impl: str):
    """The block's feed-forward on the post-attention residual ``x``:
    MoE or dense MLP.  The MoE aux loss is dropped: serving has no use
    for it (training sums it)."""
    h = norm(x, bp, "ln2", cfg)
    if moe:
        return moe_block(h, bp["moe"], cfg, gmm_impl=gmm_impl)[0]
    return mlp(h, bp["mlp"], cfg)


def decoder_block(x, bp, cfg: ModelConfig, *, moe: bool,
                  collect_kv: bool = False, attn_impl: str = "auto",
                  gmm_impl: str = "auto"):
    """Pre-norm decoder block. Returns (x, (k, v) | None)."""
    h = norm(x, bp, "ln1", cfg)
    attn_out, kv = self_attention(h, bp["attn"], cfg, attn_impl=attn_impl)
    x = x + attn_out
    return x + _ffn(x, bp, cfg, moe, gmm_impl), (kv if collect_kv else None)


def run_stack(x, params, cfg: ModelConfig, collect_caches: bool = False,
              attn_impl: str = "auto", gmm_impl: str = "auto"):
    """Run the dense layers, then the block stack.  Returns (hidden,
    caches); with collect_caches, caches["dense_layers"] is a list of
    (k, v) (b, s, hkv, hd) and caches["blocks"] = (k, v) stacked to
    (L - first_k_dense, b, s, hkv, hd)."""
    check_ported(cfg)
    caches: Dict[str, Any] = {}
    for i in range(cfg.first_k_dense):
        x, kv = decoder_block(x, params["dense_layers"][str(i)], cfg,
                              moe=False, collect_kv=collect_caches,
                              attn_impl=attn_impl)
        if collect_caches:
            caches.setdefault("dense_layers", []).append(kv)
    is_moe = cfg.num_experts > 0
    ks, vs = [], []
    for i in range(cfg.num_layers - cfg.first_k_dense):
        x, kv = decoder_block(x, _tree_slice(params["blocks"], i), cfg,
                              moe=is_moe, collect_kv=collect_caches,
                              attn_impl=attn_impl, gmm_impl=gmm_impl)
        if collect_caches:
            ks.append(kv[0])
            vs.append(kv[1])
    if collect_caches:
        caches["blocks"] = (torch.stack(ks), torch.stack(vs))
    return x, caches


def embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding (dense and MoE families). Returns (b, s, d)."""
    check_ported(cfg)
    return embed_tokens(batch["tokens"], params["embed"]["tok"],
                        cfg.compute_dtype)


def ring_place(kv, seq_end: int, s_slots: int, seq_axis: int):
    """Arrange kv entries so absolute position p lands in slot p % S.

    ``kv`` holds consecutive positions ending at ``seq_end - 1`` along
    ``seq_axis`` (see ``repro.models.transformer.ring_place``).
    """
    n = kv.shape[seq_axis]
    m = min(n, s_slots)
    part = kv.narrow(seq_axis, n - m, m)
    if m < s_slots:
        pad = list(kv.shape)
        pad[seq_axis] = s_slots - m
        part = torch.cat([part, part.new_zeros(pad)], dim=seq_axis)
    shift = (seq_end - m) % s_slots
    if shift:
        part = torch.roll(part, shift, dims=seq_axis)
    return part


def prefill(params, batch, cfg: ModelConfig, max_len: int = 0,
            attn_impl: str = "auto", gmm_impl: str = "auto"):
    """Forward over a prompt; returns (last-token logits (b, V) fp32,
    decode cache).  ``max_len`` sizes the cache (default prompt + 64)."""
    x = embed_inputs(params, batch, cfg)
    b, seq = x.shape[:2]
    max_len = max_len or seq + 64
    x, caches = run_stack(x, params, cfg, collect_caches=True,
                          attn_impl=attn_impl, gmm_impl=gmm_impl)
    x = norm(x, params, "final_norm", cfg)
    logits = lm_logits(x[:, -1:], params, cfg)[:, 0]
    return logits, _caches_to_decode_cache(caches, cfg, seq, max_len, b)


def _caches_to_decode_cache(caches, cfg: ModelConfig, seq: int, max_len: int,
                            batch: int):
    """Dense / MoE branch of the reference's conversion: each dense
    layer's (b, s, hkv, hd) KV ring-placed on the seq axis (1), the
    stacked blocks' (L, b, s, hkv, hd) KV on axis 2."""
    window = cfg.attention_window or max_len
    s_slots = min(window, max_len)

    def trim(kv, seq_axis):
        k, v = kv
        return {"k": ring_place(k.to(cfg.compute_dtype), seq, s_slots,
                                seq_axis),
                "v": ring_place(v.to(cfg.compute_dtype), seq, s_slots,
                                seq_axis)}

    k_st = caches["blocks"][0]
    out: Dict[str, Any] = {
        "pos": torch.full((batch,), seq, dtype=torch.int32,
                          device=k_st.device)}
    if "dense_layers" in caches:
        out["dense_layers"] = {
            str(i): trim(kv, 1) for i, kv in enumerate(caches["dense_layers"])}
    out["blocks"] = trim(caches["blocks"], 2)
    return out


# ---------------------------------------------------------------------------
# paged decode (block-table KV storage; see repro_torch.kernels.paged_attention)
# ---------------------------------------------------------------------------

def paged_kv_shape(cfg: ModelConfig, n_pages: int, block_tokens: int):
    """Page-pool shape for one replica: every layer's KV lives in one
    stacked pool, so a single block table addresses all layers."""
    return (cfg.num_layers, cfg.num_kv_heads, n_pages, block_tokens,
            cfg.head_dim)


def _full_stack_kv(cache, cfg: ModelConfig):
    """(L, b, S, hkv, hd) stacked KV of a dense / MoE decode cache, the
    dense layers first.  Valid for un-windowed caches (S == max_len),
    where slot index == position."""
    ks = [cache["dense_layers"][str(i)]["k"][None]
          for i in range(cfg.first_k_dense)] + [cache["blocks"]["k"]]
    vs = [cache["dense_layers"][str(i)]["v"][None]
          for i in range(cfg.first_k_dense)] + [cache["blocks"]["v"]]
    return ((torch.cat(ks), torch.cat(vs)) if len(ks) > 1
            else (ks[0], vs[0]))


def scatter_prefill_pages(cache, cfg: ModelConfig, k_pages, v_pages,
                          page_ids, offs):
    """Scatter a batch-1 prefill cache into the paged KV pool, in place.

    ``page_ids``/``offs`` are (s,) for absolute positions 0..s-1 —
    position p goes to ``(page_ids[p], offs[p])`` per the block-table
    ABI.  Returns (k_pages, v_pages), the tensors given, updated.
    """
    k_st, v_st = _full_stack_kv(cache, cfg)         # (L, 1, S, hkv, hd)
    s = page_ids.shape[0]
    pg, off = page_ids.long(), offs.long()
    # (L, s, hkv, hd) -> (L, hkv, s, hd)
    k_pages[:, :, pg, off] = k_st[:, 0, :s].transpose(1, 2).to(k_pages.dtype)
    v_pages[:, :, pg, off] = v_st[:, 0, :s].transpose(1, 2).to(v_pages.dtype)
    return k_pages, v_pages


def paged_decode_step(params, token, lengths, k_pages, v_pages, block_tables,
                      cfg: ModelConfig, *, attn_impl: str = "auto",
                      gmm_impl: str = "auto"):
    """One batched decode step over paged KV storage.

    token: (b,) int (last sampled token per row); lengths: (b,) int32
    valid positions per row *including* the token written this step, so
    the new KV goes to absolute position ``lengths - 1`` (RoPE position
    ``max(lengths - 1, 0)``) and attention spans ``lengths`` positions.
    ``lengths == 0`` marks an inactive row: its logits are garbage the
    caller must mask.  block_tables: (b, nb) int32.

    The dense layers use pool layers 0 .. first_k_dense - 1, the blocks
    the ones after.  Returns (logits (b, V) fp32, k_pages, v_pages), the
    pools updated in place.
    """
    check_ported(cfg)
    btok = k_pages.shape[3]
    write_pos = torch.clamp(lengths.long() - 1, min=0)
    page_ids = torch.gather(block_tables.long(), 1,
                            (write_pos // btok)[:, None])[:, 0]
    offs = write_pos % btok
    positions = write_pos[:, None]
    window = cfg.attention_window or 0

    def attn_layer(h, bp, li):
        """li: page-pool layer index (dense layers first, then blocks)."""
        hn = norm(h, bp, "ln1", cfg)
        q, k, v = project_qkv(hn, bp["attn"], cfg, positions)
        kpi, vpi = k_pages[li], v_pages[li]
        # (b, 1, hkv, hd) -> (hkv, b, hd): row r writes (page_ids[r],
        # offs[r]).  Inactive rows all name the null page at offset 0, so
        # those writes collide and which one lands is unspecified on CUDA;
        # that is harmless only because no live row's table ever names
        # the null page — keep it so.
        kpi[:, page_ids, offs] = k[:, 0].transpose(0, 1).to(kpi.dtype)
        vpi[:, page_ids, offs] = v[:, 0].transpose(0, 1).to(vpi.dtype)
        o = paged_attention_decode(q[:, 0], kpi, vpi, block_tables, lengths,
                                   window=window, impl=attn_impl)
        return h + merge_heads_out(o[:, None], bp["attn"])

    x = embed_tokens(token[:, None], params["embed"]["tok"], cfg.compute_dtype)
    for i in range(cfg.first_k_dense):
        bp = params["dense_layers"][str(i)]
        x = attn_layer(x, bp, i)
        x = x + _ffn(x, bp, cfg, False, gmm_impl)
    is_moe = cfg.num_experts > 0
    for i in range(cfg.num_layers - cfg.first_k_dense):
        bp = _tree_slice(params["blocks"], i)
        x = attn_layer(x, bp, cfg.first_k_dense + i)
        x = x + _ffn(x, bp, cfg, is_moe, gmm_impl)

    x = norm(x, params, "final_norm", cfg)
    logits = lm_logits(x[:, -1], params, cfg)
    return logits, k_pages, v_pages
