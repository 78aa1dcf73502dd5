"""Analytic MODEL_FLOPS — the paper's Program-Goodput numerator (the
reference's ``repro.core.flops``, unchanged).

MODEL_FLOPS = 6*N*D for training (fwd+bwd) and 2*N*D for inference, with
N = active parameters (MoE activates top-k only) and D = tokens
processed.  Attention score FLOPs are intentionally excluded — the
counted / MODEL_FLOPS ratio then surfaces attention cost, remat
recompute, and masking waste as "non-useful" compute.  N is
``num_active_params()`` as the reference counts it: whisper's 32,768 x d
``pos_dec`` table is in it, though a step reads only its first rows.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, ShapeConfig


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch


def model_bytes_min(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Lower-bound HBM traffic: every active parameter read once (bf16).

    For decode this is the classic weights-bound roofline; for train it
    undercounts activations deliberately (it is a floor, not an estimate).
    """
    n = cfg.num_active_params()
    return 2.0 * n
