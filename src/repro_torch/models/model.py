"""Family dispatch façade of the port (the serving subset of
``repro.models.model``).

    prefill_fn(cfg)      -> f(params, batch)   (logits, cache)
    decode_inplace_fn(cfg) -> f(params, token, cache) logits, cache kept
                                                      at its addresses
    init_cache(cfg, batch, seq_len)             zero decode cache
    paged_decode_fn(cfg) -> f(params, token, lengths, k_pages, v_pages,
                              block_tables)    (logits, k_pages, v_pages)
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


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
