"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf]: 32L d2560, attention-free,
d_ff=8960 channel-mix, vocab 65536; data-dependent per-channel decay.

3.07 B parameters (12.3 GB in fp32) on one card; served through the
per-slot executor (the WKV state has no place in a block table).
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,      # 40 wkv heads
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, d_ff=128, vocab_size=128,
    rwkv_head_dim=16, compute_dtype=torch.float32,
)
