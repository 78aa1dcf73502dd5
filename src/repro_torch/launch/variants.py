"""Named optimization variants (the reference's ``repro.launch.variants``):
each a config transform applied on top of the paper-faithful baseline, so
that every measurement names exactly what changed.

The table is the reference's, name for name.  :func:`apply_variant`
refuses (``ValueError``) a variant that sets a knob no code of the port
reads, so that no run is labelled with a change that never happened:
``attn_chunk`` sizes the query blocks of the reference's XLA attention,
which the port's attention (the flash kernel, or its plain version over
the whole sequence) does not have; and ``decode_unroll`` unrolls the
reference's scanned layer stack in decode, with a per-layer cache, where
the port's layer stacks are Python loops, unrolled always, that update
the stacked cache in place.  The mesh knobs are read by the sharded
step: ``moe_impl`` by ``models.moe.moe_block``,
``seq_shard_activations`` and ``bf16_grad_reduce`` by
``launch.strategy.make_ctx`` / ``constrain_grads``, ``attn_kv_gather``
by ``models.attention.self_attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.models.config import ModelConfig


def _v(**kw) -> Callable[[ModelConfig], ModelConfig]:
    fn = lambda cfg: dataclasses.replace(cfg, **kw)  # noqa: E731
    fn.knobs = tuple(kw)
    return fn


def _baseline(cfg: ModelConfig) -> ModelConfig:
    return cfg


_baseline.knobs = ()

VARIANTS: Dict[str, Callable[[ModelConfig], ModelConfig]] = {
    "baseline": _baseline,
    # MoE dispatch: GSPMD sort/scatter -> explicit shard_map EP/TP
    "moe_shard_map": _v(moe_impl="ep"),
    # gradient-accumulation microbatching (activation-memory lever)
    "microbatch2": _v(microbatches=2),
    "microbatch4": _v(microbatches=4),
    "microbatch8": _v(microbatches=8),
    # seq-chunked cross-entropy (logits-memory lever)
    "loss_chunk512": _v(loss_chunk=512),
    # smaller attention query blocks (VMEM/live-buffer lever)
    "attn_chunk512": _v(attn_chunk=512),
    "attn_chunk2048": _v(attn_chunk=2048),
    # no sequence parallelism (ablation: what SP buys)
    "no_sp": _v(seq_shard_activations=False),
    # no remat (ablation: memory/compute trade)
    "no_remat": _v(remat=False),
    # collective-term levers
    "kv_gather": _v(attn_kv_gather=True),
    "bf16_grads": _v(bf16_grad_reduce=True),
    # combos
    "mb4_losschunk": _v(microbatches=4, loss_chunk=512),
    "moe_sm_mb4": _v(moe_impl="ep", microbatches=4),
    "moe_sm_mb4_losschunk": _v(moe_impl="ep", microbatches=4,
                               loss_chunk=512),
    "moe_sm_losschunk": _v(moe_impl="ep", loss_chunk=512),
    "kv_bf16": _v(attn_kv_gather=True, bf16_grad_reduce=True),
    "dense_opt": _v(bf16_grad_reduce=True, microbatches=4, loss_chunk=512),
    "moe_opt": _v(moe_impl="ep", bf16_grad_reduce=True, microbatches=4,
                  loss_chunk=512),
    "kvg_opt": _v(attn_kv_gather=True, bf16_grad_reduce=True,
                  microbatches=4, loss_chunk=512),
    # comm-neutral memory levers (no microbatching: 1x gathers/reduces)
    "lc_ac512": _v(loss_chunk=512, attn_chunk=512, bf16_grad_reduce=True),
    "mb2_lc": _v(microbatches=2, loss_chunk=512, bf16_grad_reduce=True),
    "mb8_lc": _v(microbatches=8, loss_chunk=512, bf16_grad_reduce=True),
    # serving: bf16 checkpoint weights (standard for inference)
    "serve_bf16": _v(param_dtype=torch.bfloat16),
    "decode_unrolled": _v(decode_unroll=True),
    "decode_opt": _v(decode_unroll=True, param_dtype=torch.bfloat16),
}

# knob -> where it goes: the knobs no code of the port reads yet
UNREAD_KNOBS = {
    "attn_chunk": "the query blocks of the reference's XLA attention; the "
                  "port's attention has no query chunking",
    "decode_unroll": "the reference's unrolled decode over a per-layer "
                     "cache; the port's layer stacks are Python loops, "
                     "always unrolled, so the layout would change "
                     "nothing it computes",
}


def apply_variant(cfg: ModelConfig, name: str) -> ModelConfig:
    """``cfg`` with variant ``name`` applied: the reference's field values.
    Raises ``KeyError`` for an unknown name and ``ValueError``, naming the
    knob and where it goes, for a variant that sets a knob the port does
    not read."""
    fn = VARIANTS[name]
    unread = [k for k in fn.knobs if k in UNREAD_KNOBS]
    if unread:
        raise ValueError(
            f"variant {name!r} sets "
            + "; ".join(f"{k}, read by no code of the port: it goes to "
                        f"{UNREAD_KNOBS[k]}" for k in unread))
    return fn(cfg)
