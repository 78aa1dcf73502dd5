"""The system under test: the port's configuration built from a
configuration file and a mix, and its import path.

The checkout's ``src`` holds the port (``repro_torch``); a checkout
without it cannot run, and a run there exits before printing a result.
"""
from __future__ import annotations

import sys

import torch

from portbench.dims import Dims
from portbench.spec import ROOT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Every cell computes in bf16 with remat; the harness's CPU tests set
# fp32 here, so that only rounding separates the program and the reference.
COMPUTE_DTYPE = torch.bfloat16


def use_src() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def model_config(name: str, dm: Dims, mix: dict):
    """The port's ``ModelConfig`` of these sizes: the mix's parameter
    dtype, ``COMPUTE_DTYPE``, remat."""
    use_src()
    from repro_torch.models.config import ModelConfig

    return ModelConfig(
        name=name, family="moe" if dm.moe else "dense",
        num_layers=dm.layers, d_model=dm.d, num_heads=dm.hq,
        num_kv_heads=dm.hkv, head_dim=dm.hd, d_ff=dm.ff,
        vocab_size=dm.vocab, rope_theta=dm.rope_theta, norm_eps=dm.eps,
        tie_embeddings=dm.tied, num_experts=dm.experts,
        num_shared_experts=dm.shared, experts_per_token=dm.top_k,
        first_k_dense=dm.first_dense,
        d_ff_dense=dm.ff_dense if dm.moe else 0,
        router_renormalize=dm.renormalize,
        capacity_factor=dm.capacity_factor,
        param_dtype=DTYPES[mix["param_dtype"]],
        compute_dtype=COMPUTE_DTYPE, remat=True)
