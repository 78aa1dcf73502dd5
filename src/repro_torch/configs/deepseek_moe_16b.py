"""DeepSeekMoE 16B [arXiv:2401.06066; hf]: 28L d2048 16H (kv=16, MHA)
d_ff=1408 per routed expert, vocab 102400; 64 routed top-6 + 2 shared
experts (fine-grained), first layer dense (d_ff 10944 in the release; we use
the published ratio 1408*8=11264 -- backbone-equivalent FLOPs).

16.38 B parameters: 32.8 GB in bf16, so one 80 GB card serves it only
with ``param_dtype=torch.bfloat16`` (the reference's ``serve_bf16``
variant).
"""
import dataclasses

import torch

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_shared_experts=2,
    experts_per_token=6,
    first_k_dense=1,
    d_ff_dense=11264,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, d_ff_dense=128, num_experts=8, experts_per_token=2,
    vocab_size=128, attn_chunk=8, compute_dtype=torch.float32,
)
