"""Model configuration: the port's copy of ``repro.models.config``.

The fields and derived properties are the reference's, so a config file
reads the same on both sides; only the two dtypes are ``torch`` dtypes.
The port serves and trains all six families of the reference (dense,
MoE, hybrid, ssm and vlm in ``repro_torch.models.transformer``, enc-dec
in ``repro_torch.models.whisper``).  ``ShapeConfig`` is the reference's
input-shape cell; ``SHAPES``, ``SHAPES_BY_NAME`` and ``shape_applicable``
are its table of the four cells and its skip rule, which the
compile-time analysis (``repro_torch.core.roofline``,
``repro_torch.launch.dryrun``) walks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact values live in repro_torch/configs)."""

    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | encdec | vlm

    # Trunk
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 256

    # Attention
    attention_window: int = 0   # 0 -> full attention; >0 -> sliding window
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # hybrid models: every `attn_every`-th block is attention, rest recurrent.
    attn_every: int = 0         # 0 -> all attention

    # Norm / MLP
    norm_eps: float = 1e-6
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    mlp_activation: str = "silu"    # silu | gelu  (gated for silu/gelu-glu)
    mlp_gated: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    experts_per_token: int = 0
    first_k_dense: int = 0          # leading layers use a dense FFN
    d_ff_dense: int = 0             # d_ff of those dense layers (0 -> d_ff)
    router_renormalize: bool = True
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"

    # Recurrent (RG-LRU) blocks — RecurrentGemma
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4

    # RWKV6
    rwkv_head_dim: int = 64

    # Encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_positions: int = 0

    # VLM backbone (LLaVA) — patch embeddings are provided pre-computed.
    num_patches: int = 0

    # Numerics
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    # Performance knobs of the reference (kept so config files match;
    # the port reads remat, loss_chunk and microbatches, in training)
    attn_chunk: int = 1024
    remat: bool = True
    scan_layers: bool = True
    seq_shard_activations: bool = True
    unroll_loops: bool = False
    loss_chunk: int = 0
    microbatches: int = 1
    decode_unroll: bool = False
    attn_kv_gather: bool = False
    bf16_grad_reduce: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    # ---- derived ------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def is_attention_layer(self, layer_idx: int) -> bool:
        """Hybrid models: attention every `attn_every` blocks (else recurrent)."""
        if self.family != "hybrid" or self.attn_every <= 0:
            return True
        return (layer_idx % self.attn_every) == (self.attn_every - 1)

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.num_experts > 0 and layer_idx >= self.first_k_dense

    @property
    def sub_quadratic(self) -> bool:
        """True when a 500k-token decode is feasible (windowed or attn-free)."""
        if self.family == "ssm":
            return True
        return self.attention_window > 0

    def num_params(self) -> int:
        """Exact parameter count from the parameter specs."""
        from repro_torch.models.init import param_specs

        return sum(math.prod(s.shape) for s in param_specs(self).values())

    def num_active_params(self) -> int:
        """Parameters touched per token (the reference's rule): a MoE's
        routed expert weights count at experts_per_token / num_experts."""
        if self.num_experts == 0:
            return self.num_params()
        from repro_torch.models.init import param_specs

        total = 0
        for name, spec in param_specs(self).items():
            n = math.prod(spec.shape)
            if ".experts." in name:
                n = n * self.experts_per_token // self.num_experts
            total += n
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: the reference's ``ShapeConfig``."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4_096, 256),
    ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    ShapeConfig("decode_32k", "decode", 32_768, 128),
    ShapeConfig("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, plus the reason when skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention: 500k decode infeasible (DESIGN.md §5)"
    return True, ""
