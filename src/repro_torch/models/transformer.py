"""Decoder-only LM of the port, dense family: prefill and batched paged
decode (the counterparts of ``repro.models.transformer``).

Layer stacks are a Python loop over the stacked L dim of the params.
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
from repro_torch.models.init import check_dense
from repro_torch.models.layers import embed_tokens, lm_logits, mlp, norm

PyTree = Any


def _tree_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def decoder_block(x, bp, cfg: ModelConfig, *, collect_kv: bool = False,
                  attn_impl: str = "auto"):
    """Pre-norm decoder block. Returns (x, (k, v) | None)."""
    h = norm(x, bp, "ln1", cfg)
    attn_out, kv = self_attention(h, bp["attn"], cfg, attn_impl=attn_impl)
    x = x + attn_out
    h = norm(x, bp, "ln2", cfg)
    x = x + mlp(h, bp["mlp"], cfg)
    return x, (kv if collect_kv else None)


def run_stack(x, params, cfg: ModelConfig, collect_caches: bool = False,
              attn_impl: str = "auto"):
    """Run the block stack. Returns (hidden, caches); with collect_caches,
    caches["blocks"] = (k, v) stacked to (L, b, s, hkv, hd)."""
    check_dense(cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, kv = decoder_block(x, _tree_slice(params["blocks"], i), cfg,
                              collect_kv=collect_caches, attn_impl=attn_impl)
        if collect_caches:
            ks.append(kv[0])
            vs.append(kv[1])
    caches: Dict[str, Any] = {}
    if collect_caches:
        caches["blocks"] = (torch.stack(ks), torch.stack(vs))
    return x, caches


def embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding (dense family). Returns (b, s, d)."""
    check_dense(cfg)
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
            attn_impl: str = "auto"):
    """Forward over a prompt; returns (last-token logits (b, V) fp32,
    decode cache).  ``max_len`` sizes the cache (default prompt + 64)."""
    x = embed_inputs(params, batch, cfg)
    b, seq = x.shape[:2]
    max_len = max_len or seq + 64
    x, caches = run_stack(x, params, cfg, collect_caches=True,
                          attn_impl=attn_impl)
    x = norm(x, params, "final_norm", cfg)
    logits = lm_logits(x[:, -1:], params, cfg)[:, 0]
    return logits, _caches_to_decode_cache(caches, cfg, seq, max_len, b)


def _caches_to_decode_cache(caches, cfg: ModelConfig, seq: int, max_len: int,
                            batch: int):
    """Dense branch of the reference's conversion: stacked KV from the
    layer loop, (L, b, s, hkv, hd), ring-placed on the seq axis (2)."""
    window = cfg.attention_window or max_len
    s_slots = min(window, max_len)
    k_st, v_st = caches["blocks"]
    dev = k_st.device
    return {
        "pos": torch.full((batch,), seq, dtype=torch.int32, device=dev),
        "blocks": {
            "k": ring_place(k_st.to(cfg.compute_dtype), seq, s_slots, 2),
            "v": ring_place(v_st.to(cfg.compute_dtype), seq, s_slots, 2),
        },
    }


# ---------------------------------------------------------------------------
# paged decode (block-table KV storage; see repro_torch.kernels.paged_attention)
# ---------------------------------------------------------------------------

def paged_kv_shape(cfg: ModelConfig, n_pages: int, block_tokens: int):
    """Page-pool shape for one replica: every layer's KV lives in one
    stacked pool, so a single block table addresses all layers."""
    return (cfg.num_layers, cfg.num_kv_heads, n_pages, block_tokens,
            cfg.head_dim)


def _full_stack_kv(cache, cfg: ModelConfig):
    """(L, b, S, hkv, hd) stacked KV of a dense decode cache.  Valid for
    un-windowed caches (S == max_len), where slot index == position."""
    check_dense(cfg)
    return cache["blocks"]["k"], cache["blocks"]["v"]


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
                      cfg: ModelConfig, *, attn_impl: str = "auto"):
    """One batched decode step over paged KV storage.

    token: (b,) int (last sampled token per row); lengths: (b,) int32
    valid positions per row *including* the token written this step, so
    the new KV goes to absolute position ``lengths - 1`` (RoPE position
    ``max(lengths - 1, 0)``) and attention spans ``lengths`` positions.
    ``lengths == 0`` marks an inactive row: its logits are garbage the
    caller must mask.  block_tables: (b, nb) int32.

    Returns (logits (b, V) fp32, k_pages, v_pages), the pools updated in
    place.
    """
    check_dense(cfg)
    btok = k_pages.shape[3]
    write_pos = torch.clamp(lengths.long() - 1, min=0)
    page_ids = torch.gather(block_tables.long(), 1,
                            (write_pos // btok)[:, None])[:, 0]
    offs = write_pos % btok
    positions = write_pos[:, None]
    window = cfg.attention_window or 0

    x = embed_tokens(token[:, None], params["embed"]["tok"], cfg.compute_dtype)
    for li in range(cfg.num_layers):
        bp = _tree_slice(params["blocks"], li)
        hn = norm(x, bp, "ln1", cfg)
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
        x = x + merge_heads_out(o[:, None], bp["attn"])
        hn = norm(x, bp, "ln2", cfg)
        x = x + mlp(hn, bp["mlp"], cfg)

    x = norm(x, params, "final_norm", cfg)
    logits = lm_logits(x[:, -1], params, cfg)
    return logits, k_pages, v_pages
