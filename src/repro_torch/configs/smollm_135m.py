"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: 30L d576 9H (GQA kv=3)
d_ff=1536, vocab 49152 -- llama-architecture small model.
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=128, attn_chunk=8, compute_dtype=torch.float32,
)
