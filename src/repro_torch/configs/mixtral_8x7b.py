"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L d4096 32H (GQA kv=8) d_ff=14336
per expert, vocab 32000, MoE 8 experts top-2, sliding-window attention (4096).

46.7 B parameters (about 93 GB in bf16) do not fit one 80 GB card; its
serving waits for the distribution slice.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention_window=4096,
    num_experts=8,
    experts_per_token=2,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=128, attention_window=16, attn_chunk=8,
    compute_dtype=torch.float32,
)
