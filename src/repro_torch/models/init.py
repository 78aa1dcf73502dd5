"""Parameter specification, initialisation and the weight bridge.

The port's counterpart of ``repro.models.init`` for every family of the
reference (dense, MoE, hybrid (RG-LRU), ssm (RWKV-6), enc-dec (whisper)
and vlm (a dense decoder behind patch embeddings)): the same nested-dict
tree, the same keys, shapes, dtypes and init rules, so a tree of the
reference's params (as numpy arrays) drops straight in through
:func:`params_from_numpy`.

Parameter tree layout (nested dicts of tensors):
  embed.tok                 (vocab, d)
  embed.pos_dec             (32768, d) learned decoder positions [enc-dec]
  dense_layers.<i>          the first ``first_k_dense`` layers, unrolled:
                            ln1, ln2, attn.*, mlp.* of width d_ff_dense
  blocks.*                  stacked decoder blocks (leading L dim):
                            ln1, ln2, attn.{wq,wk,wv,wo[,bq,bk,bv]},
                            mlp.{wi,wg,wo}  or  moe.{router (d, E),
                            experts.{wi,wg (E, d, f), wo (E, f, d)},
                            shared.{wi,wg,wo} of width num_shared * f}
  layers.<i>                hybrid: every layer unrolled: ln1, ln2, mlp.*
                            and attn.* (attention layers) or rec.* (RG-LRU)
  blocks.*                  ssm: stacked RWKV-6 blocks: ln1, ln2,
                            tm.{mix (5, d), wr, wk, wv, wg, wo, decay_base,
                            decay_a, decay_b, bonus (h, n), gn},
                            cm.{mix (2, d), wk, wv, wr}
  enc_blocks.* / dec_blocks.*  enc-dec: stacked encoder blocks (ln1, ln2
                            and their _b, attn.*, mlp.*) and decoder blocks
                            (the same plus ln_x, ln_x_b and the
                            cross-attention xattn.*)
  final_norm_enc[_b]        (d,) the encoder's final LayerNorm [enc-dec]
  final_norm                (d,)
  lm_head                   (d, vocab)                  [absent when tied]
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape, its logical axis names (one per dim: the names the
    rule table of ``repro_torch.parallel.reshard`` maps onto mesh axes),
    dtype and init rule."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"   # fan_in | normal | zeros | ones | lru_a | rwkv_decay

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def _attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": ParamSpec((d, q), ("embed", "heads")),
        "wk": ParamSpec((d, kv), ("embed", "kv")),
        "wv": ParamSpec((d, kv), ("embed", "kv")),
        "wo": ParamSpec((q, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((q,), ("vec",), init="zeros")
        p["bk"] = ParamSpec((kv,), ("vec",), init="zeros")
        p["bv"] = ParamSpec((kv,), ("vec",), init="zeros")
    return p


def _mlp_specs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamSpec]:
    d, ff = cfg.d_model, (d_ff or cfg.d_ff)
    p = {"wi": ParamSpec((d, ff), ("embed", "ffn")),
         "wo": ParamSpec((ff, d), ("ffn", "embed"))}
    if cfg.mlp_gated:
        p["wg"] = ParamSpec((d, ff), ("embed", "ffn"))
    return p


def _moe_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p: Dict[str, Any] = {
        "router": ParamSpec((d, e), ("embed", "experts_r")),
        "experts": {
            "wi": ParamSpec((e, d, ff), ("experts", "embed", "ffn")),
            "wg": ParamSpec((e, d, ff), ("experts", "embed", "ffn")),
            "wo": ParamSpec((e, ff, d), ("experts", "ffn", "embed")),
        },
    }
    if cfg.num_shared_experts > 0:
        sff = cfg.num_shared_experts * ff
        p["shared"] = {
            "wi": ParamSpec((d, sff), ("embed", "ffn")),
            "wg": ParamSpec((d, sff), ("embed", "ffn")),
            "wo": ParamSpec((sff, d), ("ffn", "embed")),
        }
    return p


def _rglru_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """RecurrentGemma recurrent block: proj -> conv1d -> RG-LRU -> gated out."""
    d, w = cfg.d_model, cfg.lru_width
    return {
        "w_y": ParamSpec((d, w), ("embed", "rnn")),      # value branch
        "w_gate": ParamSpec((d, w), ("embed", "rnn")),   # multiplicative gate
        "conv_w": ParamSpec((cfg.conv_width, w), ("vec", "rnn")),
        "conv_b": ParamSpec((w,), ("vec",), init="zeros"),
        "lru_wa": ParamSpec((w, w), ("rnn_in", "rnn")),  # recurrence gate
        "lru_wx": ParamSpec((w, w), ("rnn_in", "rnn")),  # input gate
        "lru_ba": ParamSpec((w,), ("vec",), init="zeros"),
        "lru_bx": ParamSpec((w,), ("vec",), init="zeros"),
        "lru_a": ParamSpec((w,), ("vec",), init="lru_a"),  # log-decay param
        "w_out": ParamSpec((w, d), ("rnn", "embed")),
    }


def _rwkv_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """RWKV6 'Finch': data-dependent-decay time mix + squared-relu channel
    mix."""
    d, ff = cfg.d_model, cfg.d_ff
    lora = 64
    return {
        "ln1": ParamSpec((d,), ("vec",), init="ones"),
        "ln2": ParamSpec((d,), ("vec",), init="ones"),
        "tm": {
            # token-shift interpolation weights for (r, k, v, w, g)
            "mix": ParamSpec((5, d), ("vec", "embed_v"), init="normal"),
            "wr": ParamSpec((d, d), ("embed", "rnn")),
            "wk": ParamSpec((d, d), ("embed", "rnn")),
            "wv": ParamSpec((d, d), ("embed", "rnn")),
            "wg": ParamSpec((d, d), ("embed", "rnn")),
            "wo": ParamSpec((d, d), ("rnn", "embed")),
            "decay_base": ParamSpec((d,), ("vec",), init="rwkv_decay"),
            "decay_a": ParamSpec((d, lora), ("embed", "vec"),
                                 init="normal"),
            "decay_b": ParamSpec((lora, d), ("vec", "embed_v"),
                                 init="zeros"),
            "bonus": ParamSpec((cfg.rwkv_heads, cfg.rwkv_head_dim),
                               ("vec", "vec2"), init="normal"),
            "gn": ParamSpec((d,), ("vec",), init="ones"),
        },
        "cm": {
            "mix": ParamSpec((2, d), ("vec", "embed_v"), init="normal"),
            "wk": ParamSpec((d, ff), ("embed", "ffn")),
            "wv": ParamSpec((ff, d), ("ffn", "embed")),
            "wr": ParamSpec((d, d), ("embed", "rnn")),
        },
    }


def _hybrid_block_specs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "ln1": ParamSpec((cfg.d_model,), ("vec",), init="ones"),
        "ln2": ParamSpec((cfg.d_model,), ("vec",), init="ones"),
        "mlp": _mlp_specs(cfg),
    }
    if cfg.is_attention_layer(layer_idx):
        p["attn"] = _attn_specs(cfg)
    else:
        p["rec"] = _rglru_specs(cfg)
    return p


def _decoder_block_specs(cfg: ModelConfig, moe: bool) -> Dict[str, Any]:
    p: Dict[str, Any] = {
        "ln1": ParamSpec((cfg.d_model,), ("vec",), init="ones"),
        "ln2": ParamSpec((cfg.d_model,), ("vec",), init="ones"),
        "attn": _attn_specs(cfg),
    }
    if cfg.norm_type == "layernorm":
        p["ln1_b"] = ParamSpec((cfg.d_model,), ("vec",), init="zeros")
        p["ln2_b"] = ParamSpec((cfg.d_model,), ("vec",), init="zeros")
    if moe:
        p["moe"] = _moe_specs(cfg)
    else:
        p["mlp"] = _mlp_specs(cfg)
    return p


def _whisper_enc_block(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), ("vec",), init="ones"),
        "ln1_b": ParamSpec((d,), ("vec",), init="zeros"),
        "ln2": ParamSpec((d,), ("vec",), init="ones"),
        "ln2_b": ParamSpec((d,), ("vec",), init="zeros"),
        "attn": _attn_specs(cfg),
        "mlp": _mlp_specs(cfg),
    }


def _whisper_dec_block(cfg: ModelConfig) -> Dict[str, Any]:
    """An encoder block plus the cross-attention and its LayerNorm."""
    d = cfg.d_model
    return {**_whisper_enc_block(cfg),
            "ln_x": ParamSpec((d,), ("vec",), init="ones"),
            "ln_x_b": ParamSpec((d,), ("vec",), init="zeros"),
            "xattn": _attn_specs(cfg)}


def _map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def _stack(tree, n: int):
    """Prepend a stacked ``layers`` axis of length n to every spec in
    tree."""
    return _map_specs(lambda s: ParamSpec((n,) + s.shape,
                                          ("layers",) + s.axes, s.dtype,
                                          s.init), tree)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not know
    (every family of the reference is ported)."""
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(
            f"{cfg.name}: unknown model family {cfg.family!r}; the "
            f"families are {', '.join(PORTED_FAMILIES)}")


def spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    check_ported(cfg)
    d = cfg.d_model
    tree: Dict[str, Any] = {
        "embed": {"tok": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                                   init="normal")},
        "final_norm": ParamSpec((d,), ("vec",), init="ones"),
    }
    if cfg.norm_type == "layernorm":
        tree["final_norm_b"] = ParamSpec((d,), ("vec",), init="zeros")
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.family == "encdec":
        tree["embed"]["pos_dec"] = ParamSpec((32_768, d), ("pos", "embed"),
                                             init="normal")
        tree["final_norm_enc"] = ParamSpec((d,), ("vec",), init="ones")
        tree["final_norm_enc_b"] = ParamSpec((d,), ("vec",), init="zeros")
        tree["enc_blocks"] = _stack(_whisper_enc_block(cfg),
                                    cfg.encoder_layers)
        tree["dec_blocks"] = _stack(_whisper_dec_block(cfg), cfg.num_layers)
        return _apply_param_dtype(tree, cfg)
    if cfg.family == "hybrid":
        # heterogeneous 1:2 attention:recurrent pattern -> unrolled layers
        tree["layers"] = {str(i): _hybrid_block_specs(cfg, i)
                          for i in range(cfg.num_layers)}
        return _apply_param_dtype(tree, cfg)
    if cfg.family == "ssm":
        tree["blocks"] = _stack(_rwkv_block_specs(cfg), cfg.num_layers)
        return _apply_param_dtype(tree, cfg)
    if cfg.first_k_dense > 0:
        tree["dense_layers"] = {
            str(i): {
                "ln1": ParamSpec((d,), ("vec",), init="ones"),
                "ln2": ParamSpec((d,), ("vec",), init="ones"),
                "attn": _attn_specs(cfg),
                "mlp": _mlp_specs(cfg, cfg.d_ff_dense or cfg.d_ff),
            }
            for i in range(cfg.first_k_dense)
        }
    tree["blocks"] = _stack(_decoder_block_specs(cfg, cfg.num_experts > 0),
                            cfg.num_layers - cfg.first_k_dense)
    return _apply_param_dtype(tree, cfg)


def _apply_param_dtype(tree, cfg: ModelConfig):
    """Leaves of two or more dims take cfg.param_dtype (as the reference's,
    stacked vectors included); vectors and norms stay fp32."""
    if cfg.param_dtype == torch.float32:
        return tree
    return _map_specs(
        lambda s: (ParamSpec(s.shape, s.axes, cfg.param_dtype, s.init)
                   if len(s.shape) >= 2 else s), tree)


def param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Flat {dotted.name: ParamSpec} view (for counting)."""
    flat: Dict[str, ParamSpec] = {}

    def visit(prefix, node):
        if isinstance(node, ParamSpec):
            flat[prefix] = node
            return
        for k, v in node.items():
            visit(f"{prefix}.{k}" if prefix else k, v)

    visit("", spec_tree(cfg))
    return flat


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    shape, dtype = spec.shape, spec.dtype
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init == "lru_a":
        # RG-LRU decay a = exp(-exp(p)) with a ~ U[0.9, 0.999]
        u = torch.rand(shape, generator=generator, device=generator.device)
        u = 0.9 + (0.999 - 0.9) * u
        return torch.log(-torch.log(u)).to(dtype=dtype, device=device)
    if spec.init == "rwkv_decay":
        # per-channel decay ramp -6 .. -1 over the last dim, as in RWKV
        d = shape[-1]
        ramp = torch.arange(d, dtype=torch.float32) / max(d - 1, 1)
        return torch.broadcast_to(-6.0 + 5.0 * ramp, shape).to(
            dtype=dtype, device=device)
    if spec.init == "normal":
        scale = 0.02
    else:                                   # fan_in scaled
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    # draws come from the generator's own device, one slice of the leading
    # (layer / expert) dim at a time into the preallocated leaf, so a
    # stacked leaf never needs a second full-size fp32 temporary
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out if len(shape) >= 3 else out[None]
    for part in parts:
        x = torch.randn(part.shape, generator=generator,
                        device=generator.device)
        part.copy_(x.mul_(scale))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> PyTree:
    """Random params with the reference's init rules, drawn on the
    generator's device (give it one on ``device`` to keep the draws off
    the host).  The numbers differ from ``repro.models.init.init_params``
    (another generator); tests that need both sides on the same weights
    use :func:`params_from_numpy`."""
    dev = resolve_device(device)
    return _map_specs(lambda s: _init_leaf(s, generator, dev),
                      spec_tree(cfg))


def abstract_params(cfg: ModelConfig) -> PyTree:
    """Tree of ``meta`` tensors: shapes and dtypes, nothing allocated."""
    return _map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree(cfg))


def _to_tensor(a, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes bf16: no numpy twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: PyTree, device=None,
                      dtype: Optional[torch.dtype] = None) -> PyTree:
    """Turn a nested dict of numpy arrays (e.g. the reference's params via
    ``np.asarray``) into the port's tree on ``device``.  Floating leaves
    keep their dtype unless ``dtype`` is given."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return conv(tree)
