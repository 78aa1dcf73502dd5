"""RecurrentGemma-2B [arXiv:2402.19427; hf]: 26L d2560 10H (MQA kv=1,
head_dim 256) d_ff=7680 (GeGLU), vocab 256000; RG-LRU + local attention
(window 2048) in a 1:2 attention:recurrent pattern.

2.89 B parameters (11.6 GB in fp32) on one card; served through the
per-slot executor (recurrent state has no place in a block table).
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attention_window=2048,
    attn_every=3,            # layers 2, 5, 8, ... are attention (1:2)
    lru_width=2560,
    conv_width=4,
    mlp_activation="gelu",
    logit_softcap=30.0,
    tie_embeddings=True,
    scan_layers=False,       # heterogeneous pattern -> unrolled
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=6, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=128, attention_window=16, lru_width=64, attn_chunk=8,
    compute_dtype=torch.float32,
)
