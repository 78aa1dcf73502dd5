"""Random weights made from the run's seed, on the device, leaf by leaf in
one draw each, in the dtype they are served or trained in.

The tree has the layout the program's ``params=`` takes (and the plain
reference reads): ``embed.tok`` (V, d); ``dense_layers.<i>`` for the
leading dense layers (``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo}``,
``mlp.{wi,wg,wo}``); ``blocks`` stacked on a leading layer axis, with
``mlp.*`` or ``moe.{router, experts.{wi,wg,wo}, shared.{wi,wg,wo}}``;
``final_norm``; ``lm_head`` (d, V) unless the embeddings are tied.
Matrices are drawn from a normal of standard deviation 1 / sqrt(fan in),
the embedding from one of ``initializer_range``; norm weights are ones,
in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.dims import Dims


def layout(dims: Dims) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{dotted name: (shape, kind)}, kind "embed", "matrix" or "norm"."""
    d, q, kv, V = dims.d, dims.hq * dims.hd, dims.hkv * dims.hd, dims.vocab
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "embed.tok": ((V, d), "embed"), "final_norm": ((d,), "norm")}
    if not dims.tied:
        out["lm_head"] = ((d, V), "matrix")

    def block(prefix, lead, ff, moe):
        out[f"{prefix}.ln1"] = (lead + (d,), "norm")
        out[f"{prefix}.ln2"] = (lead + (d,), "norm")
        for name, shp in (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)),
                          ("wo", (q, d))):
            out[f"{prefix}.attn.{name}"] = (lead + shp, "matrix")
        if moe:
            e, f = dims.experts, dims.ff
            out[f"{prefix}.moe.router"] = (lead + (d, e), "matrix")
            for name, shp in (("wi", (e, d, f)), ("wg", (e, d, f)),
                              ("wo", (e, f, d))):
                out[f"{prefix}.moe.experts.{name}"] = (lead + shp, "matrix")
            if dims.shared:
                sf = dims.shared * f
                for name, shp in (("wi", (d, sf)), ("wg", (d, sf)),
                                  ("wo", (sf, d))):
                    out[f"{prefix}.moe.shared.{name}"] = (lead + shp,
                                                          "matrix")
        else:
            for name, shp in (("wi", (d, ff)), ("wg", (d, ff)),
                              ("wo", (ff, d))):
                out[f"{prefix}.mlp.{name}"] = (lead + shp, "matrix")

    for i in range(dims.first_dense):
        block(f"dense_layers.{i}", (), dims.ff_dense, False)
    block("blocks", (dims.layers - dims.first_dense,), dims.ff,
          dims.experts > 0)
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        else:
            out[name] = v
    return out


def _std(dims: Dims, shape, kind: str) -> float:
    return (dims.init_range if kind == "embed"
            else 1.0 / math.sqrt(shape[-2]))


def make(dims: Dims, seed: int, dtype: torch.dtype, device) -> dict:
    """The tree, drawn from ``seed`` on ``device``; matrices and the
    embedding in ``dtype``, norms in fp32."""
    device = torch.device(device)
    leaves = {}
    for name, (shape, kind) in sorted(layout(dims).items()):
        leaves[name] = torch.empty(
            shape, dtype=torch.float32 if kind == "norm" else dtype,
            device=device)
    tree = nest(leaves)
    fill_(tree, dims, seed)
    return tree


def fill_(tree: dict, dims: Dims, seed: int) -> None:
    """Draw ``seed``'s weights into the tree's tensors, in place: one
    ``normal_`` call a leaf on the generator of the leaves' device, so
    no leaf needs a second full-size temporary."""
    leaves = flat(tree)
    dev = next(iter(leaves.values())).device
    gen = torch.Generator(dev).manual_seed(seed)
    for name, (shape, kind) in sorted(layout(dims).items()):
        t = leaves[name]
        if kind == "norm":
            t.fill_(1.0)
        else:
            t.normal_(0.0, _std(dims, shape, kind), generator=gen)

