"""Whisper-medium [arXiv:2212.04356]: enc-dec, 24+24L d1024 16H (MHA kv=16)
d_ff=4096, vocab 51865; the conv audio frontend is a stub (the executors
feed zero frame embeddings (b, 1500, d)).  Decoder positions extended to
32768, as the reference's config has them.

791.8 M parameters (3.2 GB in fp32) on one card; served through the
per-slot executor (the encoder's states have no place in a block table).
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    encoder_positions=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    norm_type="layernorm",
    mlp_activation="gelu",
    mlp_gated=False,
    tie_embeddings=True,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, encoder_layers=2, encoder_positions=24, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=128,
    attn_chunk=8, compute_dtype=torch.float32,
)
