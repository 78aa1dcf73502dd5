"""The serving tree: weights cast to the compute dtype once, not per call.

The reference casts its fp32 weights to the compute dtype inside one
compiled program; the port runs eagerly, where the same casts would
read every weight in fp32, write a bf16 copy and read it again on every
call.  The executors call :func:`compute_params` once and run the model
on its tree, which gives bit-identical results: every ``.to(dtype)`` a
consumer applies to a cast leaf is a no-op, and the logits head is
exactly the operand ``lm_logits`` would build, in the same layout.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.init import init_params

PyTree = Any

# Leaves whose every consumer first casts them to the compute dtype:
# the matrices of ``dense`` (attention wq/wk/wv/wo, whisper's
# cross-attention ``xattn`` ones by the same names, MLP and shared-expert
# wi/wg/wo, RG-LRU w_y/w_gate/lru_wa/lru_wx/w_out, RWKV time-mix
# wr/wk/wv/wg/wo and channel-mix wk/wv/wr), the experts' wi/wg/wo
# (``moe.expert_ffn``) and the embedding table (``layers.embed_tokens``).
CAST = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "wr", "w_y", "w_gate",
                  "lru_wa", "lru_wx", "w_out", "tok"})


def compute_params(params: PyTree, cfg: ModelConfig,
                   consume: bool = False) -> PyTree:
    """``params`` with each leaf named in ``CAST`` in ``cfg.compute_dtype``
    and a ``head`` entry, the logits operand in the compute dtype: the
    tied models' ``embed.tok.T``, a view of the cast table (no copy), or
    the untied models' cast ``lm_head``.

    Every other leaf is the very tensor of ``params``, because its
    consumer reads it in fp32 or casts only a slice of it:

    * the norm weights and biases (``ln1``, ``ln2``, whisper's ``ln_x``
      and ``final_norm_enc``, ``final_norm`` and their ``_b``; RWKV's
      group norm ``gn``): ``layers.rmsnorm`` /
      ``layernorm`` / ``rwkv._group_norm`` read ``w.float()``;
    * the MoE router: ``moe.router_topk`` multiplies ``x.float()`` by
      ``router_w.float()``;
    * RG-LRU's ``lru_a`` (``rglru._gates``, ``.float()``), ``conv_w`` and
      ``conv_b`` (``rglru.causal_conv1d``, ``.float()``) and the gate
      biases ``lru_ba``, ``lru_bx``;
    * the attention biases ``bq``, ``bk``, ``bv`` (``dense`` casts the
      bias after the product, a vector's worth);
    * RWKV's ``mix`` vectors (``.to(x.dtype)``, a (5, d) row block),
      ``decay_base``, ``decay_a``, ``decay_b`` and ``bonus`` (``.float()``);
    * whisper's learned decoder positions ``pos_dec`` (32,768 rows):
      a call casts only the rows it reads, as the reference does;
    * ``lm_head``, which ``lm_logits`` no longer reads once ``head`` is
      there.

    A leaf already in the compute dtype is shared too (``Tensor.to``
    returns it), so with fp32 compute and fp32 params nothing is copied
    and ``head`` is a view of the table.

    ``consume=True`` is for a tree no one else holds (the executors' own
    random draw): each entry leaves ``params`` as it is visited, so a raw
    leaf is freed as soon as its cast exists, and ``lm_head`` is dropped
    once ``head`` is built.  The raw and the cast trees are then never
    whole on the device together: the peak is the raw tree plus its
    largest leaf's copy, and what stays is the cast tree alone.
    """
    dt = cfg.compute_dtype

    def cast(node, name):
        if isinstance(node, dict):
            if consume:
                return {k: cast(node.pop(k), k) for k in list(node)}
            return {k: cast(v, k) for k, v in node.items()}
        return node.to(dt) if name in CAST else node

    out = cast(params, "")
    if cfg.tie_embeddings:
        out["head"] = out["embed"]["tok"].T
    else:
        out["head"] = (out.pop("lm_head") if consume
                       else out["lm_head"]).to(dt)
    return out


def serving_params(cfg: ModelConfig, params: Optional[PyTree],
                   device: torch.device) -> PyTree:
    """The tree a server runs on: :func:`compute_params` of ``params``,
    or, for ``params=None``, of random params drawn on ``device`` from a
    ``torch.Generator`` seeded with 0 and consumed as they are cast, so
    only the cast tree stays on the device."""
    if params is not None:
        return compute_params(params, cfg)
    return compute_params(
        init_params(cfg, torch.Generator(device).manual_seed(0), device),
        cfg, consume=True)
