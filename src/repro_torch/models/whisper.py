"""Whisper-medium backbone of the port (the counterpart of
``repro.models.whisper``): an encoder-decoder transformer.

The conv1d audio frontend is a stub, as in the reference: the callers
give precomputed frame embeddings (b, 1500, d), zeros on the serving
paths.  LayerNorm + GELU MLP, pre-norm blocks, a fixed sinusoid on the
encoder, learned decoder positions (32,768 of them), tied output
projection.

``loss_fn`` is the training loss (the reference's), each block under
remat.  Encoder self-attention, the decoder's prefill and training
self-attention and every cross-attention (training, prefill and decode:
the queries against the encoder's 1500 keys) run on the flash-attention
kernel, forward and, in training, backward, where the reference calls
its ``attention``; decoder self-attention at decode is the plain
``decode_attention`` against the ring cache, as for every family.  The
decode step projects the encoder's keys and values again in every layer,
as the reference's does.

The decode cache: ``pos`` (b,) int32, ``ring`` (b,) int32, ``blocks.k``
/ ``blocks.v`` (L, b, S, hkv, hd) and ``enc_out`` (b, T, d).  The
reference's prefill sizes its ring to prompt + ``RING_EXTRA`` slots,
whatever length the server asked for, and keeps a scalar ``pos``; the
port keeps that ring length per row in ``ring`` and the ring in the
first ``ring`` slots of an S-slot buffer (S >= ring), so that every
cache a server holds has one shape: the same function.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.attention import (_split_heads, cross_attention,
                                          decode_self_attention,
                                          self_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense, embed_tokens, layernorm,
                                       lm_logits, mlp, softmax_xent)
from repro_torch.models.transformer import _remat, _tree_slice, ring_place
from repro_torch.parallel.ctx import run_local, shard_activation
from repro_torch.tree import copy_tree_

# the reference's prefill ring: prompt + this many slots
RING_EXTRA = 64


def _ln(x, bp, name, cfg: ModelConfig):
    return layernorm(x, bp[name], bp[f"{name}_b"], cfg.norm_eps)


def _sinusoid(positions: int, d: int, device=None):
    """(positions, d) fp32 [sin | cos] table, the reference's: frequencies
    exp(-log(10000) i / (d/2 - 1))."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=device)
    # a fill on the device, not a host copy (a prefill graph captures it)
    log_base = torch.full((), math.log(10_000.0), dtype=torch.float32,
                          device=device)
    freq = torch.exp(-log_base * ar / (half - 1))
    t = torch.arange(positions, dtype=torch.float32,
                     device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def _enc_block(x, bp, cfg: ModelConfig, attn_impl: str):
    """One encoder block: non-causal self-attention, MLP."""
    x = shard_activation(x, "act")
    a, _ = self_attention(_ln(x, bp, "ln1", cfg), bp["attn"], cfg,
                          causal=False, use_rope=False, attn_impl=attn_impl)
    x = x + a
    return x + mlp(_ln(x, bp, "ln2", cfg), bp["mlp"], cfg)


def encode(params, frames, cfg: ModelConfig, attn_impl: str = "auto"):
    """frames: (b, T, d) precomputed conv-frontend output (stub) ->
    encoder states (b, T, d) in the compute dtype.  Each block runs under
    ``transformer._remat`` (the reference's ``jax.checkpoint``)."""
    dt = cfg.compute_dtype
    x = frames.to(dt)
    table = _sinusoid(x.shape[1], cfg.d_model, x.device).to(dt)
    if isinstance(x, DTensor):
        # a constant every rank computes whole: a replicated DTensor
        table = DTensor.from_local(table, x.device_mesh,
                                   (Replicate(),) * x.device_mesh.ndim,
                                   run_check=False)
    x = shard_activation(x + table, "act")
    block = _remat(lambda h, bp: _enc_block(h, bp, cfg, attn_impl), cfg,
                   False)
    for i in range(cfg.encoder_layers):
        x = block(x, _tree_slice(params["enc_blocks"], i))
    return layernorm(x, params["final_norm_enc"], params["final_norm_enc_b"],
                     cfg.norm_eps)


def _enc_kv(bp, enc_out, cfg: ModelConfig):
    """One decoder layer's cross-attention keys and values of the encoder
    states: (b, T, hkv, hd) each, laid out as the queries' heads
    (``attention._split_heads``)."""
    k = dense(enc_out, bp["xattn"]["wk"], bp["xattn"].get("bk"))
    v = dense(enc_out, bp["xattn"]["wv"], bp["xattn"].get("bv"))
    return (_split_heads(k, cfg, cfg.num_kv_heads),
            _split_heads(v, cfg, cfg.num_kv_heads))


def _dec_block(x, bp, cfg: ModelConfig, enc_kv, attn_impl: str = "auto"):
    """One decoder block over a prompt: causal self-attention,
    cross-attention to the encoder, MLP.  Returns (x, (k, v))."""
    x = shard_activation(x, "act")
    a, kv = self_attention(_ln(x, bp, "ln1", cfg), bp["attn"], cfg,
                           causal=True, use_rope=False, attn_impl=attn_impl)
    x = x + a
    x = x + cross_attention(_ln(x, bp, "ln_x", cfg), bp["xattn"], cfg,
                            *enc_kv, attn_impl=attn_impl)
    return x + mlp(_ln(x, bp, "ln2", cfg), bp["mlp"], cfg), kv


def decode_train(params, tokens, enc_out, cfg: ModelConfig,
                 collect_caches: bool = False, attn_impl: str = "auto"):
    """The decoder over whole token sequences (b, s) from position 0.
    Returns (hidden after the final LayerNorm, (k, v) stacked to (L, b,
    s, hkv, hd) with ``collect_caches``, else None).  Each block, the
    projection of the encoder states to its cross-attention keys and
    values included, runs under ``transformer._remat`` (the reference's
    checkpointed body), so the backward recomputes them; ``enc_out`` is
    the checkpoint's argument, and its gradient flows through every
    layer's ``xattn.wk`` / ``wv``."""
    s = tokens.shape[1]
    dt = cfg.compute_dtype
    x = embed_tokens(tokens, params["embed"]["tok"], dt)
    x = x + params["embed"]["pos_dec"][:s].to(dt)

    def body(h, bp, enc):
        h, kv = _dec_block(h, bp, cfg, _enc_kv(bp, enc, cfg), attn_impl)
        return h, (kv if collect_caches else None)

    block = _remat(body, cfg, collect_caches)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, kv = block(x, _tree_slice(params["dec_blocks"], i), enc_out)
        if collect_caches:
            ks.append(kv[0])
            vs.append(kv[1])
    x = layernorm(x, params["final_norm"], params["final_norm_b"],
                  cfg.norm_eps)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_caches
               else None)


def loss_fn(params, batch, cfg: ModelConfig, attn_impl: str = "auto"):
    """Training loss (``repro.models.whisper.loss_fn``): batch ``frames``
    (b, T, d) and ``tokens`` (b, s); the encoder, then the decoder over
    the tokens, the logits of positions ``[:-1]`` against ``tokens[:,
    1:]``, mean cross-entropy in fp32.  Returns (loss, {"xent"}), the
    reference's metrics (no aux).  ``attn_impl`` picks the attention's
    implementation, forward and backward."""
    enc_out = encode(params, batch["frames"], cfg, attn_impl)
    x, _ = decode_train(params, batch["tokens"], enc_out, cfg,
                        attn_impl=attn_impl)
    logits = shard_activation(lm_logits(x[:, :-1], params, cfg), "logits")
    loss = softmax_xent(logits, batch["tokens"][:, 1:])
    return loss, {"xent": loss}


def prefill(params, batch, cfg: ModelConfig, max_len: int = 0,
            attn_impl: str = "auto"):
    """Encode the frames, run the prompt through the decoder and build the
    decode cache.  batch: tokens (b, s), frames (b, T, d).  Returns
    (last-token logits (b, V) fp32, cache).

    The ring is the reference's, s + ``RING_EXTRA`` slots; ``max_len``
    sizes the buffer that holds it (default the ring itself) and must be
    at least the ring."""
    enc_out = encode(params, batch["frames"], cfg, attn_impl)
    tokens = batch["tokens"]
    b, seq = tokens.shape
    ring = seq + RING_EXTRA
    slots = max_len or ring
    if slots < ring:
        raise ValueError(f"{cfg.name}: a {slots}-slot cache cannot hold the "
                         f"{ring}-slot ring of a {seq}-token prompt")
    x, (k_st, v_st) = decode_train(params, tokens, enc_out, cfg,
                                   collect_caches=True, attn_impl=attn_impl)
    logits = lm_logits(x[:, -1:], params, cfg)[:, 0]
    dt, dev = cfg.compute_dtype, tokens.device
    cache = {
        "pos": torch.full((b,), seq, dtype=torch.int32, device=dev),
        "ring": torch.full((b,), ring, dtype=torch.int32, device=dev),
        "blocks": {"k": ring_place(k_st.to(dt), seq, slots, 2),
                   "v": ring_place(v_st.to(dt), seq, slots, 2)},
        "enc_out": enc_out,
    }
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zero decode cache of ``seq_len`` slots, the ring all of them (the
    reference's ``init_cache``, with the port's ``ring``)."""
    dt = cfg.compute_dtype
    kv = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "ring": torch.full((batch,), seq_len, dtype=torch.int32,
                           device=device),
        "blocks": {"k": torch.zeros(kv, dtype=dt, device=device),
                   "v": torch.zeros(kv, dtype=dt, device=device)},
        "enc_out": torch.zeros((batch, cfg.encoder_positions, cfg.d_model),
                               dtype=dt, device=device),
    }


def _rows(table, pos):
    """``table[pos]`` (b, d), each index clamped to the table as the
    reference's dynamic slice clamps it; a DTensor table is gathered
    whole and read at each rank's rows of the DTensor ``pos`` (b,)."""
    def rows(t, p):
        return t[torch.clamp(p.long(), 0, t.shape[0] - 1)]

    if not isinstance(table, DTensor):
        return rows(table, pos)
    mesh = table.device_mesh
    whole = (Replicate(),) * mesh.ndim
    p_plc = tuple(pos.placements)
    out = tuple(Shard(0) if p == Shard(0) else Replicate() for p in p_plc)
    return run_local(rows, mesh, (table, pos), (whole, p_plc), out)


def decode_step(params, token, cache, cfg: ModelConfig,
                attn_impl: str = "auto"):
    """One decoder token per row, token (b,), against the self-attention
    ring and the encoder states of ``cache``.  Each row writes its KV at
    slot pos % ring and attends over min(pos + 1, ring) slots; its
    position embedding is ``pos_dec[pos]``, the index clamped to the
    table as the reference's dynamic slice clamps it.  Returns (logits
    (b, V) fp32, cache with pos + 1); the rings are written in place."""
    dt = cfg.compute_dtype
    pos, ring = cache["pos"], cache["ring"]
    pos_dec = params["embed"]["pos_dec"]
    x = embed_tokens(token[:, None], params["embed"]["tok"], dt)
    x = x + _rows(pos_dec, pos)[:, None].to(dt)
    enc_out = cache["enc_out"]
    ks, vs = cache["blocks"]["k"], cache["blocks"]["v"]
    for i in range(cfg.num_layers):
        bp = _tree_slice(params["dec_blocks"], i)
        a, _ = decode_self_attention(
            _ln(x, bp, "ln1", cfg), bp["attn"], cfg,
            {"k": ks[i], "v": vs[i], "pos": pos}, use_rope=False, ring=ring)
        x = x + a
        x = x + cross_attention(_ln(x, bp, "ln_x", cfg), bp["xattn"], cfg,
                                *_enc_kv(bp, enc_out, cfg),
                                attn_impl=attn_impl)
        x = x + mlp(_ln(x, bp, "ln2", cfg), bp["mlp"], cfg)
    x = layernorm(x, params["final_norm"], params["final_norm_b"],
                  cfg.norm_eps)
    new_cache: Dict[str, Any] = {"pos": pos + 1, "ring": ring,
                                 "blocks": {"k": ks, "v": vs},
                                 "enc_out": enc_out}
    return lm_logits(x[:, -1], params, cfg), new_cache


def decode_step_inplace(params, token, cache, cfg: ModelConfig,
                        attn_impl: str = "auto"):
    """:func:`decode_step` that leaves every leaf of ``cache`` at its
    address (the new ``pos`` copied back into the given tensor); returns
    the logits (b, V) fp32, bit for bit ``decode_step``'s."""
    logits, new_cache = decode_step(params, token, cache, cfg, attn_impl)
    copy_tree_(cache, new_cache, "cache")
    return logits
