"""Granite-3 8B [hf:ibm-granite/granite-3.0 family]: 40L d4096 32H (GQA kv=8)
d_ff=12800, vocab 49155.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=129, attn_chunk=8, compute_dtype=torch.float32,
)
