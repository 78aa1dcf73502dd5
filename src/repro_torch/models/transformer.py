"""Decoder-only LM of the port, dense, MoE, hybrid (RG-LRU + local
attention), ssm (RWKV-6) and vlm (a dense decoder behind patch
embeddings) families: prefill, the per-request decode step, and batched
paged decode (the counterparts of ``repro.models.transformer``), and the
training loss of all five (``loss_fn``).  The enc-dec family, serving and
training, is ``repro_torch.models.whisper``.

Layer stacks are a Python loop: for dense and MoE the unrolled
``dense_layers`` first (``first_k_dense`` of them), then the stacked L dim
of ``blocks``; for hybrid the unrolled ``layers``; for ssm the stacked
``blocks``.  Public functions keep the reference's layouts — the prefill
cache's stacked KV is (L, b, S, hkv, hd) with the sequence on axis 2, the
page pool is (L, hkv, n_pages, block_tokens, hd) — so the tests compare
like with like.  Unlike JAX, caches are updated in place: the page pool
and the decode step's cache tensors are written where they lie and
returned.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.paged_attention.ops import paged_attention_decode
from repro_torch.models import rglru, rwkv
from repro_torch.models.attention import (decode_self_attention,
                                          merge_heads_out, project_qkv,
                                          self_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import check_ported
from repro_torch.models.layers import (embed_tokens, lm_logits, mlp, norm,
                                       rmsnorm, softmax_xent)
from repro_torch.models.moe import moe_block
from repro_torch.parallel.ctx import (get_ctx, parallel_ctx, run_local,
                                      shard_activation)
from repro_torch.parallel.sharding import (cache_placements, distribute,
                                           placements)
from repro_torch.tree import copy_tree_, flatten, tree_map

PyTree = Any


def _tree_slice(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _tree_stack(trees):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ffn(x, bp, cfg: ModelConfig, moe: bool, gmm_impl: str):
    """The block's feed-forward on the post-attention residual ``x``:
    MoE or dense MLP.  Returns (out, aux): the MoE layer's load-balancing
    loss (training sums it; serving drops it), None for a dense MLP."""
    h = norm(x, bp, "ln2", cfg)
    if moe:
        return moe_block(h, bp["moe"], cfg, gmm_impl=gmm_impl)
    return mlp(h, bp["mlp"], cfg), None


def decoder_block(x, bp, cfg: ModelConfig, *, moe: bool,
                  collect_kv: bool = False, attn_impl: str = "auto",
                  gmm_impl: str = "auto"):
    """Pre-norm decoder block. Returns (x, (k, v) | None, aux | None),
    aux the MoE layer's load-balancing loss."""
    x = shard_activation(x, "act")
    h = norm(x, bp, "ln1", cfg)
    attn_out, kv = self_attention(h, bp["attn"], cfg, attn_impl=attn_impl)
    x = x + attn_out
    out, aux = _ffn(x, bp, cfg, moe, gmm_impl)
    return x + out, (kv if collect_kv else None), aux


def hybrid_block(x, bp, cfg: ModelConfig, collect_state: bool = False,
                 attn_impl: str = "auto", scan_impl: str = "auto"):
    """RecurrentGemma block over a prompt: RG-LRU or local attention +
    GeGLU MLP.  Returns (x, state | None); an attention layer's state is
    its last min(window, s) keys and values.  (Decode runs the layers in
    ``decode_step``.)"""
    x = shard_activation(x, "act")
    h = norm(x, bp, "ln1", cfg)
    new_state = None
    if "attn" in bp:
        out, kv = self_attention(h, bp["attn"], cfg,
                                 window=cfg.attention_window,
                                 attn_impl=attn_impl)
        if collect_state:
            w = min(cfg.attention_window or x.shape[1], x.shape[1])
            new_state = {"k": kv[0][:, -w:], "v": kv[1][:, -w:]}
    else:
        out, new_state = rglru.recurrent_block(h, bp["rec"], cfg,
                                               scan_impl=scan_impl)
        if not collect_state:
            new_state = None
    x = x + out
    h = norm(x, bp, "ln2", cfg)
    return x + mlp(h, bp["mlp"], cfg), new_state


def rwkv_block(x, bp, cfg: ModelConfig, state=None,
               collect_state: bool = False, scan_impl: str = "auto"):
    """RWKV-6 block: time mix + channel mix, each after an RMSNorm."""
    x = shard_activation(x, "act")
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    tm_out, tm_state = rwkv.time_mix(h, bp["tm"], cfg,
                                     state["tm"] if state else None,
                                     scan_impl=scan_impl)
    x = x + tm_out
    h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    cm_out, cm_state = rwkv.channel_mix(h, bp["cm"], cfg,
                                        state["cm"] if state else None)
    x = x + cm_out
    return x, ({"tm": tm_state, "cm": cm_state} if collect_state else None)


def _remat(block, cfg: ModelConfig, collect: bool):
    """``block`` (x, bp, ...) -> its outputs as it runs in the stack: under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``) when
    cfg.remat is set, autograd records and no cache is collected, so the
    backward recomputes the block's forward instead of keeping its
    activations; otherwise as it is.  The serving paths run with grad
    disabled or collect caches, so they never take the checkpoint.  No
    block draws a random number, so the checkpoint keeps no RNG state
    (``preserve_rng_state=False``, exact): reading the CUDA generator's
    state is not allowed while a CUDA graph is being captured."""
    if not (cfg.remat and torch.is_grad_enabled()) or collect:
        return block
    # the recompute runs in autograd's backward, on its own thread on
    # CUDA: it re-installs the forward's ParallelCtx (thread-local)
    ctx = get_ctx()

    def run(*args):
        with parallel_ctx(ctx):
            return block(*args)

    return lambda *args: checkpoint(run, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def run_stack(x, params, cfg: ModelConfig, collect_caches: bool = False,
              attn_impl: str = "auto", gmm_impl: str = "auto",
              scan_impl: str = "auto"):
    """Run the block stack.  Returns (hidden, aux, caches): aux the MoE
    layers' load-balancing losses summed in the stack's order (an fp32
    zero without MoE layers, as the reference's).  With
    collect_caches: dense / MoE give caches["dense_layers"], a list of
    (k, v) (b, s, hkv, hd), and caches["blocks"] = (k, v) stacked to
    (L - first_k_dense, b, s, hkv, hd); hybrid gives caches["layers"], a
    list of per-layer states; ssm gives caches["blocks"], the per-layer
    states stacked on a leading L dim.  Each block is rematerialised in
    the backward where :func:`_remat` says so."""
    check_ported(cfg)
    caches: Dict[str, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        block = _remat(
            lambda h, bp: hybrid_block(h, bp, cfg,
                                       collect_state=collect_caches,
                                       attn_impl=attn_impl,
                                       scan_impl=scan_impl),
            cfg, collect_caches)
        states = []
        for i in range(cfg.num_layers):
            x, st = block(x, params["layers"][str(i)])
            states.append(st)
        if collect_caches:
            caches["layers"] = states
        return x, aux_total, caches
    if cfg.family == "ssm":
        block = _remat(
            lambda h, bp: rwkv_block(h, bp, cfg,
                                     collect_state=collect_caches,
                                     scan_impl=scan_impl),
            cfg, collect_caches)
        states = []
        for i in range(cfg.num_layers):
            x, st = block(x, _tree_slice(params["blocks"], i))
            states.append(st)
        if collect_caches:
            caches["blocks"] = _tree_stack(states)
        return x, aux_total, caches

    def block(moe):
        return _remat(
            lambda h, bp: decoder_block(h, bp, cfg, moe=moe,
                                        collect_kv=collect_caches,
                                        attn_impl=attn_impl,
                                        gmm_impl=gmm_impl),
            cfg, collect_caches)

    dense_block = block(False)
    for i in range(cfg.first_k_dense):
        x, kv, _ = dense_block(x, params["dense_layers"][str(i)])
        if collect_caches:
            caches.setdefault("dense_layers", []).append(kv)
    stacked_block = block(cfg.num_experts > 0)
    ks, vs = [], []
    for i in range(cfg.num_layers - cfg.first_k_dense):
        x, kv, aux = stacked_block(x, _tree_slice(params["blocks"], i))
        if aux is not None:
            aux_total = aux_total + aux
        if collect_caches:
            ks.append(kv[0])
            vs.append(kv[1])
    if collect_caches:
        caches["blocks"] = (torch.stack(ks), torch.stack(vs))
    return x, aux_total, caches


def _embed(tokens, params, cfg: ModelConfig):
    """Token embedding; hybrid scales it by sqrt(d_model), rounded to the
    compute dtype first as the reference does (50.596 -> 50.5 in bf16)."""
    x = embed_tokens(tokens, params["embed"]["tok"], cfg.compute_dtype)
    if cfg.family == "hybrid":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.compute_dtype)
    return x


def embed_inputs(params, batch, cfg: ModelConfig):
    """Token (+ patch) embedding of a prompt batch.  Returns (x (b, s,
    d), patch_len): the vlm family prepends ``batch["patches"]`` (b, p,
    d), cast to the compute dtype, and gives p; the others give 0."""
    check_ported(cfg)
    x = _embed(shard_activation(batch["tokens"], "tokens"), params, cfg)
    if cfg.family == "vlm":
        patches = batch["patches"].to(cfg.compute_dtype)
        return (shard_activation(torch.cat([patches, x], dim=1), "act"),
                patches.shape[1])
    return shard_activation(x, "act"), 0


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
            attn_impl: str = "auto", gmm_impl: str = "auto",
            scan_impl: str = "auto"):
    """Forward over a prompt; returns (last-token logits (b, V) fp32,
    decode cache).  ``max_len`` sizes the cache (default prompt + 64);
    for vlm the prompt is the patches and the tokens, and a ``max_len``
    below their count keeps the newest positions, as the reference's
    ring does."""
    x, _ = embed_inputs(params, batch, cfg)
    b, seq = x.shape[:2]
    max_len = max_len or seq + 64
    x, _, caches = run_stack(x, params, cfg, collect_caches=True,
                             attn_impl=attn_impl, gmm_impl=gmm_impl,
                             scan_impl=scan_impl)
    x = norm(x, params, "final_norm", cfg)
    logits = lm_logits(x[:, -1:], params, cfg)[:, 0]
    return logits, _caches_to_decode_cache(caches, cfg, seq, max_len, b)


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def loss_fn(params, batch, cfg: ModelConfig, attn_impl: str = "auto",
            gmm_impl: str = "auto", scan_impl: str = "auto"):
    """Causal LM loss of the dense, MoE, hybrid, ssm and vlm families
    (``repro.models.transformer.loss_fn``): predict ``tokens[:, 1:]`` from
    stream positions ``[patch_len:-1]`` (the vlm's patches come first and
    predict nothing; ``patch_len`` is 0 for the others), mean token
    cross-entropy in fp32; over sequence chunks when ``cfg.loss_chunk``
    divides the predicted length and is shorter.  Returns (loss, {"xent",
    "aux"}): aux the MoE layers' summed load-balancing loss (a zero
    without them), added to the loss as ``0.01 * aux`` when the config
    has experts.  ``attn_impl``, ``gmm_impl`` and ``scan_impl`` pick the
    attention's, the experts' and the recurrences' (the RG-LRU scan, the
    RWKV-6 WKV) implementations, forward and backward."""
    x, patch_len = embed_inputs(params, batch, cfg)
    x, aux, _ = run_stack(x, params, cfg, attn_impl=attn_impl,
                          gmm_impl=gmm_impl, scan_impl=scan_impl)
    x = norm(x, params, "final_norm", cfg)
    h = x[:, patch_len:-1]
    labels = batch["tokens"][:, 1:]
    if cfg.loss_chunk and h.shape[1] % cfg.loss_chunk == 0 \
            and h.shape[1] > cfg.loss_chunk:
        loss = _chunked_xent(h, labels, params, cfg)
    else:
        logits = shard_activation(lm_logits(h, params, cfg), "logits")
        loss = softmax_xent(logits, labels)
    metrics = {"xent": loss, "aux": aux}
    if cfg.num_experts > 0:
        loss = loss + 0.01 * aux
    return loss, metrics


def _chunked_xent(h, labels, params, cfg: ModelConfig):
    """Cross-entropy over sequence chunks of ``cfg.loss_chunk`` positions,
    one (b, chunk, vocab) logits tensor each: the mean of the chunks'
    means (the reference's scan over chunks)."""
    c = cfg.loss_chunk
    nc = h.shape[1] // c
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        logits = shard_activation(
            lm_logits(h[:, i * c:(i + 1) * c], params, cfg), "logits")
        total = total + softmax_xent(logits, labels[:, i * c:(i + 1) * c])
    return total / nc


def _caches_to_decode_cache(caches, cfg: ModelConfig, seq: int, max_len: int,
                            batch: int):
    """The reference's conversion of prefill caches to the decode cache,
    which carries a per-row position vector ``pos`` (batch,).  Dense /
    MoE: each dense layer's (b, s, hkv, hd) KV ring-placed on the seq axis
    (1), the stacked blocks' (L, b, s, hkv, hd) KV on axis 2.  Hybrid:
    attention layers' KV ring-placed into min(window, max_len) slots,
    recurrent states as they are.  ssm: the stacked states as they are."""
    window = cfg.attention_window or max_len
    s_slots = min(window, max_len)
    dev = _tree_device(caches)
    out: Dict[str, Any] = {
        "pos": torch.full((batch,), seq, dtype=torch.int32, device=dev)}
    if cfg.family == "hybrid":
        w = min(cfg.attention_window, max_len)
        out["layers"] = {
            str(i): (st if "h" in st else
                     {name: _ring_place_rows(st[name].to(cfg.compute_dtype),
                                             seq, w)
                      for name in ("k", "v")})
            for i, st in enumerate(caches["layers"])}
        return _place_cache(out, cfg)
    if cfg.family == "ssm":
        out["blocks"] = caches["blocks"]
        return _place_cache(out, cfg)

    def trim(kv, seq_axis):
        # the dense layers' 4-D KV takes the "cache" kind, as the
        # reference constrains it; the stacked KV is placed below
        return {name: (shard_activation(t, "cache") if seq_axis == 1
                       else t)
                for name, t in zip(("k", "v"), (
                    ring_place(t.to(cfg.compute_dtype), seq, s_slots,
                               seq_axis) for t in kv))}

    if "dense_layers" in caches:
        out["dense_layers"] = {
            str(i): trim(kv, 1) for i, kv in enumerate(caches["dense_layers"])}
    out["blocks"] = trim(caches["blocks"], 2)
    return _place_cache(out, cfg)


def _ring_place_rows(kv, seq_end: int, s_slots: int):
    """:func:`ring_place` of (b, s, hkv, hd) ``kv`` on its seq axis; a
    DTensor on each rank's block, its sequence gathered first."""
    if not isinstance(kv, DTensor):
        return ring_place(kv, seq_end, s_slots, 1)
    plc = tuple(Replicate() if q == Shard(1) else q for q in kv.placements)
    return run_local(lambda t: ring_place(t, seq_end, s_slots, 1),
                     kv.device_mesh, (kv,), (plc,), plc)


def _place_cache(cache, cfg: ModelConfig):
    """Under a ``ParallelCtx`` with a prefill's DTensor states (any
    family of this module: the dense / MoE KV, the hybrid's window K/V
    and recurrent states, the ssm's stacked states), every leaf placed
    as ``cache_placements`` of the tree says (the layout the reference's
    GSPMD gives the prefill's cache: the batch over the data axes, the
    cached sequence, or the hybrid's window slots, over model; recurrent
    states on the batch only), ``pos`` a DTensor on the batch; else the
    cache as it is."""
    ctx = get_ctx()
    if ctx is None or not any(isinstance(t, DTensor)
                              for t in flatten(cache)[0]):
        return cache
    mesh = ctx.mesh

    def place(t, parts):
        plc = placements(parts, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, plc)
        return distribute(t, plc, mesh)

    return tree_map(place, cache, cache_placements(cfg, cache, mesh))


def _tree_device(tree) -> torch.device:
    """The device of the first tensor in a (nested) tree."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


# ---------------------------------------------------------------------------
# per-request decode (stacked ring cache; the per-slot executor's path)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """Zero decode cache of the reference's stacked layout for ``batch``
    rows and ``seq_len`` positions (the reference's ``decode_unroll``
    layout is not ported)."""
    check_ported(cfg)
    s_slots = min(cfg.attention_window or seq_len, seq_len)
    hkv, hd, dt = cfg.num_kv_heads, cfg.head_dim, cfg.compute_dtype

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache: Dict[str, Any] = {"pos": zeros((batch,), torch.int32)}
    if cfg.family == "hybrid":
        w = min(cfg.attention_window, seq_len)
        cache["layers"] = {
            str(i): ({"k": zeros((batch, w, hkv, hd)),
                      "v": zeros((batch, w, hkv, hd))}
                     if cfg.is_attention_layer(i) else
                     {"conv": zeros((batch, cfg.conv_width - 1,
                                     cfg.lru_width)),
                      "h": zeros((batch, cfg.lru_width), torch.float32)})
            for i in range(cfg.num_layers)}
        return cache
    if cfg.family == "ssm":
        h, n, L = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.num_layers
        cache["blocks"] = {
            "tm": {"last": zeros((L, batch, cfg.d_model)),
                   "s": zeros((L, batch, h, n, n), torch.float32)},
            "cm": {"last": zeros((L, batch, cfg.d_model))}}
        return cache
    for i in range(cfg.first_k_dense):
        cache.setdefault("dense_layers", {})[str(i)] = {
            "k": zeros((batch, s_slots, hkv, hd)),
            "v": zeros((batch, s_slots, hkv, hd))}
    n = cfg.num_layers - cfg.first_k_dense
    cache["blocks"] = {"k": zeros((n, batch, s_slots, hkv, hd)),
                       "v": zeros((n, batch, s_slots, hkv, hd))}
    return cache


def decode_step(params, token, cache, cfg: ModelConfig, *,
                gmm_impl: str = "auto"):
    """One decode step against a per-request cache (``prefill``'s or
    ``init_cache``'s).  token: (b,) int.  ``cache["pos"]`` is a scalar
    shared by the rows or a (b,) vector; each row writes its KV at slot
    pos % S of the ring and attends over min(pos + 1, S) slots.

    Returns (logits (b, V) fp32, cache with pos + 1).  The cache's tensors
    are updated in place; a recurrent layer's new state replaces its
    entry.  The decode step runs no kernel of the port but the MoE
    experts' grouped matmul (``gmm_impl``): one-token attention, the
    RG-LRU step and the WKV step are plain torch, as in the reference.
    """
    check_ported(cfg)
    x = _embed(token[:, None], params, cfg)
    pos = torch.as_tensor(cache["pos"], device=x.device)
    new_cache: Dict[str, Any] = {"pos": pos + 1}

    if cfg.family == "hybrid":
        layers = {}
        for i in range(cfg.num_layers):
            bp = params["layers"][str(i)]
            st = cache["layers"][str(i)]
            x = shard_activation(x, "act")
            h = norm(x, bp, "ln1", cfg)
            if "attn" in bp:
                out, lc = decode_self_attention(h, bp["attn"], cfg,
                                                {**st, "pos": pos})
                layers[str(i)] = {"k": lc["k"], "v": lc["v"]}
            else:
                out, layers[str(i)] = rglru.recurrent_block(h, bp["rec"], cfg,
                                                            st)
            x = x + out
            x = x + mlp(norm(x, bp, "ln2", cfg), bp["mlp"], cfg)
        new_cache["layers"] = layers
    elif cfg.family == "ssm":
        blocks = cache["blocks"]
        for i in range(cfg.num_layers):
            x, st = rwkv_block(x, _tree_slice(params["blocks"], i), cfg,
                               state=_tree_slice(blocks, i),
                               collect_state=True)
            copy_tree_(_tree_slice(blocks, i), st, "cache")
        new_cache["blocks"] = blocks

    else:
        def layer(x, bp, lc, moe):
            x = shard_activation(x, "act")
            h = norm(x, bp, "ln1", cfg)
            out, _ = decode_self_attention(h, bp["attn"], cfg,
                                           {**lc, "pos": pos})
            x = x + out
            return x + _ffn(x, bp, cfg, moe, gmm_impl)[0]

        for i in range(cfg.first_k_dense):
            lc = cache["dense_layers"][str(i)]
            x = layer(x, params["dense_layers"][str(i)], lc, False)
            new_cache.setdefault("dense_layers", {})[str(i)] = {
                "k": lc["k"], "v": lc["v"]}
        ks, vs = cache["blocks"]["k"], cache["blocks"]["v"]
        for i in range(ks.shape[0]):
            x = layer(x, _tree_slice(params["blocks"], i),
                      {"k": ks[i], "v": vs[i]}, cfg.num_experts > 0)
        new_cache["blocks"] = {"k": ks, "v": vs}

    x = norm(x, params, "final_norm", cfg)
    return lm_logits(x[:, -1], params, cfg), new_cache


def decode_step_inplace(params, token, cache, cfg: ModelConfig, *,
                        gmm_impl: str = "auto"):
    """``decode_step`` that leaves every leaf of ``cache`` at its address:
    the new ``pos`` and recurrent states are copied back into the given
    tensors (the KV rings and the ssm states are already written where
    they lie; copying a tensor onto itself is a no-op).  ``cache["pos"]``
    must be a tensor.  Returns the logits (b, V) fp32; the values are
    ``decode_step``'s, bit for bit.  A captured CUDA graph of this step
    reads and writes the same cache on every replay."""
    logits, new_cache = decode_step(params, token, cache, cfg,
                                    gmm_impl=gmm_impl)
    copy_tree_(cache, new_cache, "cache")
    return logits


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
        h = shard_activation(h, "act")
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
        x = x + _ffn(x, bp, cfg, False, gmm_impl)[0]
    is_moe = cfg.num_experts > 0
    for i in range(cfg.num_layers - cfg.first_k_dense):
        bp = _tree_slice(params["blocks"], i)
        x = attn_layer(x, bp, cfg.first_k_dense + i)
        x = x + _ffn(x, bp, cfg, is_moe, gmm_impl)[0]

    x = norm(x, params, "final_norm", cfg)
    logits = lm_logits(x[:, -1], params, cfg)
    return logits, k_pages, v_pages
