"""Family dispatch façade of the port (``repro.models.model``): the
enc-dec family goes to ``whisper``, every other to ``transformer``.

    loss_fn(cfg)         -> f(params, batch)   (mean loss, metrics)
    prefill_fn(cfg, max_len) -> f(params, batch) (logits, cache)
    decode_fn(cfg)       -> f(params, token, cache) (logits, cache)
    decode_inplace_fn(cfg) -> f(params, token, cache) logits, cache kept
                                                      at its addresses
    init_cache(cfg, batch, max_len)             zero decode cache, the
                                                prefill cache's shape
    frontend_inputs(cfg, batch, device)         the stub frames / patches
    paged_decode_fn(cfg) -> f(params, token, lengths, k_pages, v_pages,
                              block_tables)    (logits, k_pages, v_pages)
    input_specs(cfg, shape)                     abstract (meta) batch
    synthetic_batch(cfg, shape, generator)      concrete random batch
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import transformer, whisper
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.init import (abstract_params,  # noqa: F401
                                     check_ported, init_params)


def loss_fn(cfg: ModelConfig, attn_impl: str = "auto",
            gmm_impl: str = "auto", scan_impl: str = "auto") -> Callable:
    """f(params, batch) -> (mean loss, metrics): the enc-dec family's is
    ``whisper.loss_fn`` (metrics {"xent"}), every other family's
    ``transformer.loss_fn`` ({"xent", "aux"}), as the reference's
    dispatch; raises ``ValueError`` for a family the reference does not
    know."""
    check_ported(cfg)
    if cfg.family == "encdec":
        return lambda p, b: whisper.loss_fn(p, b, cfg, attn_impl=attn_impl)
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
               gmm_impl: str = "auto", scan_impl: str = "auto") -> Callable:
    """f(params, batch) -> (logits, cache), the cache a server of requests
    of at most ``max_len`` tokens (prompt + new) keeps, of
    ``init_cache(cfg, b, max_len)``'s shape; ``max_len`` 0 sizes it to
    prompt + 64.  The decoder families' ring is ``max_len`` slots; the
    enc-dec buffer is ``max_len`` + ``whisper.RING_EXTRA``, room for the
    reference's ring of prompt + 64, which its prefill sizes whatever
    ``max_len`` is.  ``attn_impl``, ``gmm_impl`` and ``scan_impl`` pick
    the attention's, the experts' and the recurrences' implementations."""
    check_ported(cfg)
    if cfg.family == "encdec":
        slots = max_len + whisper.RING_EXTRA if max_len else 0
        return lambda p, b: whisper.prefill(p, b, cfg, max_len=slots,
                                            attn_impl=attn_impl)
    return lambda p, b: transformer.prefill(p, b, cfg, max_len=max_len,
                                            attn_impl=attn_impl,
                                            gmm_impl=gmm_impl,
                                            scan_impl=scan_impl)


def decode_fn(cfg: ModelConfig, attn_impl: str = "auto",
              gmm_impl: str = "auto") -> Callable:
    """f(params, token, cache) -> (logits, cache); ``attn_impl`` is the
    enc-dec cross-attention's, ``gmm_impl`` the MoE experts'."""
    check_ported(cfg)
    if cfg.family == "encdec":
        return lambda p, t, c: whisper.decode_step(p, t, c, cfg,
                                                   attn_impl=attn_impl)
    return lambda p, t, c: transformer.decode_step(p, t, c, cfg,
                                                   gmm_impl=gmm_impl)


def decode_inplace_fn(cfg: ModelConfig, gmm_impl: str = "auto",
                      attn_impl: str = "auto") -> Callable:
    """f(params, token, cache) -> logits, every cache leaf kept at its
    address — see transformer.decode_step_inplace and
    whisper.decode_step_inplace."""
    check_ported(cfg)
    if cfg.family == "encdec":
        return lambda p, t, c: whisper.decode_step_inplace(
            p, t, c, cfg, attn_impl=attn_impl)
    return lambda p, t, c: transformer.decode_step_inplace(
        p, t, c, cfg, gmm_impl=gmm_impl)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero decode cache of ``prefill_fn(cfg, max_len)``'s shape for
    ``batch`` rows: ``max_len`` slots, for enc-dec ``max_len`` +
    ``whisper.RING_EXTRA``."""
    if cfg.family == "encdec":
        return whisper.init_cache(cfg, batch, max_len + whisper.RING_EXTRA,
                                  device)
    return transformer.init_cache(cfg, batch, max_len, device)


def frontend_inputs(cfg: ModelConfig, batch: int, device=None
                    ) -> Dict[str, torch.Tensor]:
    """The stubbed front-end inputs of a ``batch``-row prefill, zeros in
    the compute dtype as the reference's executors and static server
    build them: ``frames`` (batch, encoder_positions, d) for enc-dec,
    ``patches`` (batch, num_patches, d) for vlm, nothing for the
    others."""
    def zeros(n):
        return torch.zeros((batch, n, cfg.d_model), dtype=cfg.compute_dtype,
                           device=device)

    if cfg.family == "encdec":
        return {"frames": zeros(cfg.encoder_positions)}
    if cfg.family == "vlm":
        return {"patches": zeros(cfg.num_patches)}
    return {}


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
    ``device``: train / prefill ``{"tokens": (b, s) int32}``, for vlm
    ``tokens`` (b, s - num_patches) and ``patches`` (b, num_patches, d)
    bf16, for enc-dec ``tokens`` and ``frames`` (b, encoder_positions,
    d) bf16 (the reference's); decode ``{"token": (b,) int32, "cache":
    init_cache(cfg, b, seq_len)}``."""
    check_ported(cfg)
    dev = torch.device("meta") if abstract else device
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        def arr(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=dev)

        if cfg.family == "vlm":
            p = cfg.num_patches
            return {"tokens": arr((b, s - p), torch.int32),
                    "patches": arr((b, p, cfg.d_model), torch.bfloat16)}
        batch = {"tokens": arr((b, s), torch.int32)}
        if cfg.family == "encdec":
            batch["frames"] = arr((b, cfg.encoder_positions, cfg.d_model),
                                  torch.bfloat16)
        return batch
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
