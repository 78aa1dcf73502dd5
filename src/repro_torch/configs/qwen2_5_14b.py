"""Qwen2.5-14B [hf:Qwen family]: 48L d5120 40H (GQA kv=8) d_ff=13824,
vocab 152064, QKV bias.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=80, num_heads=5, num_kv_heads=1, head_dim=16,
    d_ff=160, vocab_size=128, attn_chunk=8, compute_dtype=torch.float32,
)
