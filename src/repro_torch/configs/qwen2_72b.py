"""Qwen2-72B [arXiv:2407.10671]: 80L d8192 64H (GQA kv=8) d_ff=29568,
vocab 152064, QKV bias.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, attn_chunk=8, compute_dtype=torch.float32,
)
