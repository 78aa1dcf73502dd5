"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
32L d4096 32H (GQA kv=8) d_ff=14336, vocab 32000.  The anyres vision
tiling is a stub: the executors feed zero patch embeddings (b, 1152, d),
prepended to the token stream.

7.24 B parameters (29.0 GB in fp32) on one card; served through the
per-slot executor, as the reference picks it for the vlm family.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_patches=1152,      # anyres 2x grid of 576-patch tiles (stubbed)
    rope_theta=1e6,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=128, num_patches=8, attn_chunk=8,
    compute_dtype=torch.float32,
)
