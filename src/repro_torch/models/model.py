"""Family dispatch façade of the port (``repro.models.model`` less the
enc-dec family).

    loss_fn(cfg)         -> f(params, batch)   (mean loss, metrics)
    prefill_fn(cfg)      -> f(params, batch)   (logits, cache)
    decode_inplace_fn(cfg) -> f(params, token, cache) logits, cache kept
                                                      at its addresses
    init_cache(cfg, batch, seq_len)             zero decode cache
    paged_decode_fn(cfg) -> f(params, token, lengths, k_pages, v_pages,
                              block_tables)    (logits, k_pages, v_pages)
    input_specs(cfg, shape)                     abstract (meta) batch
    synthetic_batch(cfg, shape, generator)      concrete random batch
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.init import (abstract_params,  # noqa: F401
                                     check_ported, init_params)


def loss_fn(cfg: ModelConfig, attn_impl: str = "auto",
            gmm_impl: str = "auto", scan_impl: str = "auto") -> Callable:
    """f(params, batch) -> (mean loss, {"xent", "aux"}); raises
    ``NotImplementedError`` for a family the port does not train yet."""
    transformer.check_trainable(cfg)
    return lambda p, b: transformer.loss_fn(p, b, cfg, attn_impl=attn_impl,
                                            gmm_impl=gmm_impl,
                                            scan_impl=scan_impl)


def supports_paged_decode(cfg: ModelConfig, max_len: int) -> bool:
    """Whether the batched paged-decode path can serve this config: the
    reference's rule.  dense/moe caches page cleanly; the other families
    carry state the block tables don't model; a window narrower than
    ``max_len`` trims the prefill cache below the full positional
    coverage the page scatter needs."""
    if cfg.family not in ("dense", "moe"):
        return False
    return cfg.attention_window == 0 or cfg.attention_window >= max_len


def prefill_fn(cfg: ModelConfig, max_len: int = 0, attn_impl: str = "auto",
               gmm_impl: str = "auto") -> Callable:
    return lambda p, b: transformer.prefill(p, b, cfg, max_len=max_len,
                                            attn_impl=attn_impl,
                                            gmm_impl=gmm_impl)


def decode_inplace_fn(cfg: ModelConfig, gmm_impl: str = "auto") -> Callable:
    """f(params, token, cache) -> logits, every cache leaf kept at its
    address — see transformer.decode_step_inplace."""
    return lambda p, t, c: transformer.decode_step_inplace(
        p, t, c, cfg, gmm_impl=gmm_impl)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    return transformer.init_cache(cfg, batch, seq_len, device)


def paged_decode_fn(cfg: ModelConfig, attn_impl: str = "auto",
                    gmm_impl: str = "auto") -> Callable:
    """f(params, token, lengths, k_pages, v_pages, block_tables) ->
    (logits, k_pages, v_pages) — see transformer.paged_decode_step."""
    return lambda p, t, ln, kp, vp, bt: transformer.paged_decode_step(
        p, t, ln, kp, vp, bt, cfg, attn_impl=attn_impl, gmm_impl=gmm_impl)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                abstract: bool = True, device=None) -> Dict[str, Any]:
    """Model inputs for one shape cell, as ``meta`` tensors (shapes and
    dtypes, nothing allocated) or, with ``abstract=False``, zeros on
    ``device``: train / prefill ``{"tokens": (b, s) int32}``, decode
    ``{"token": (b,) int32, "cache": a seq_len-deep decode cache}``."""
    check_ported(cfg)
    dev = torch.device("meta") if abstract else device
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        return {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev)}
    return {"token": torch.zeros((b,), dtype=torch.int32, device=dev),
            "cache": init_cache(cfg, b, s, device=dev)}


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig,
                    generator: torch.Generator) -> Dict[str, Any]:
    """Concrete random inputs matching :func:`input_specs`, on the
    generator's device: integer leaves uniform in [0, min(vocab, 32000)),
    as the reference draws them (other numbers: another generator),
    floating leaves zeros."""

    def fill(spec):
        if isinstance(spec, dict):
            return {k: fill(v) for k, v in spec.items()}
        if spec.dtype.is_floating_point:
            return torch.zeros(spec.shape, dtype=spec.dtype,
                               device=generator.device)
        return torch.randint(0, min(cfg.vocab_size, 32_000), spec.shape,
                             generator=generator, dtype=spec.dtype,
                             device=generator.device)

    return fill(input_specs(cfg, shape))
