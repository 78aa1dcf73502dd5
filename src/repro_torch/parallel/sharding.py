"""Parameter, batch and cache placements on a mesh (the port's
``repro.parallel.sharding``).

A placement is given two ways: as ``parts``, a per-dim tuple of mesh
axis names (None: replicated; a tuple of names: that dim split over
several mesh axes, outer first) — the reference's ``PartitionSpec`` as
a tuple — and as the DTensor placements of a mesh (:func:`placements`:
one ``Shard(dim)`` or ``Replicate()`` per mesh dim).  The parameters'
parts come from the rule table (``repro_torch.parallel.reshard``), the
batch's and the decode cache's from the reference's rules.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec, spec_tree
from repro_torch.parallel.reshard import assign_axes
from repro_torch.tree import tree_map

PyTree = Any
Parts = Tuple[Any, ...]
MeshLike = Union[DeviceMesh, Dict[str, int]]


def mesh_axes(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} in the mesh's order (a dict is taken as it is)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _spec_map(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _spec_map(fn, v) for k, v in tree.items()}


def spec_to_placements(spec: ParamSpec, mesh: MeshLike,
                       rules=None) -> Parts:
    """One leaf's parts under the rule table (the reference's
    ``spec_to_pspec``)."""
    return assign_axes(spec.shape, spec.axes, mesh_axes(mesh), rules)


def placements(parts: Parts, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """DTensor placements of ``parts`` on ``mesh``: for each mesh dim of
    more than one rank, ``Shard(d)`` where tensor dim d names it, else
    ``Replicate()`` (a split over one rank is no split: a 1 x 1 mesh
    replicates everything)."""
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        dims = [d for d, p in enumerate(parts)
                if p == name or (isinstance(p, tuple) and name in p)]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1
                   else Replicate())
    return tuple(out)


def param_placements(cfg: ModelConfig, mesh: DeviceMesh,
                     rules=None) -> PyTree:
    """DTensor placements of every parameter (the reference's
    ``param_shardings``)."""
    return _spec_map(lambda s: placements(spec_to_placements(s, mesh, rules),
                                          mesh), spec_tree(cfg))


def local_slice(t: torch.Tensor, plc: Sequence[Any],
                mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``plc``: each
    ``Shard(d)`` mesh dim, in the mesh's order, keeps this rank's even
    chunk of dim d."""
    for i, p in enumerate(plc):
        if p.is_partial():
            raise ValueError("a full tensor has no Partial placement")
        if isinstance(p, Shard):
            n = mesh.size(i)
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does "
                                 f"not split evenly over {n} ranks")
            c = t.shape[p.dim] // n
            t = t.narrow(p.dim, mesh.get_local_rank(i) * c, c)
    return t


def distribute(t: torch.Tensor, plc: Sequence[Any], mesh: DeviceMesh,
               device=None) -> DTensor:
    """The full tensor ``t`` (the same on every rank) as a DTensor of
    placements ``plc`` whose local tensor is a copy of this rank's block
    only, on ``device`` (default: t's); no communication."""
    local = local_slice(t, plc, mesh).detach().to(
        device if device is not None else t.device, copy=True)
    return DTensor.from_local(local.contiguous(), mesh, tuple(plc),
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def shard_params(tree: PyTree, cfg: ModelConfig, mesh: DeviceMesh,
                 rules=None) -> PyTree:
    """Full parameter tensors -> DTensors, each rank keeping its slice."""
    return tree_map(lambda t, plc: distribute(t, plc, mesh), tree,
                    param_placements(cfg, mesh, rules))


def local_bytes(tree: PyTree) -> int:
    """Bytes this rank holds of a tree of DTensors (plain tensors whole)."""
    total = 0

    def add(t):
        nonlocal total
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()

    tree_map(add, tree)
    return total


def sharded_param_bytes(cfg: ModelConfig, mesh: MeshLike,
                        rules=None) -> int:
    """Per-device parameter bytes under the rule table."""
    sizes = mesh_axes(mesh)
    total = 0

    def add(s: ParamSpec):
        nonlocal total
        elems = math.prod(s.shape)
        for part in spec_to_placements(s, sizes, rules):
            if part:
                elems //= sizes[part]
        total += elems * torch.empty((), dtype=s.dtype).element_size()

    _spec_map(add, spec_tree(cfg))
    return total


# ---------------------------------------------------------------------------
# inputs and caches
# ---------------------------------------------------------------------------

def _dp(mesh: MeshLike):
    """The batch axes present in the mesh, as a part: a name, a tuple of
    names (pod outer), or None."""
    dp = tuple(a for a in ("pod", "data") if a in mesh_axes(mesh))
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_placements(batch_tree: PyTree, mesh: MeshLike) -> PyTree:
    """Parts of model inputs (the reference's ``batch_pspecs``): the batch
    dim over (pod, data); a batch of one is replicated."""
    dp = _dp(mesh)

    def parts(leaf):
        if leaf.dim() == 0:
            return ()
        if leaf.shape[0] == 1:
            return (None,) * leaf.dim()
        return (dp,) + (None,) * (leaf.dim() - 1)

    return tree_map(parts, batch_tree)


def cache_placements(cfg: ModelConfig, cache_tree: PyTree,
                     mesh: MeshLike) -> PyTree:
    """Parts of a decode cache (the reference's ``cache_pspecs``): K/V
    leaves (b, S, hkv, hd), or (L, b, ...) under ``blocks``, split on the
    batch over (pod, data) and on the cached sequence over model, each
    where it divides; recurrent and other states on the batch only."""
    sizes = mesh_axes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp_axes) if dp_axes else 1
    dp = _dp(mesh)
    model_ax = "model" if "model" in sizes else None
    msize = sizes.get("model", 1)

    def visit(node, names):
        if isinstance(node, dict):
            return {k: visit(v, names + (k,)) for k, v in node.items()}
        if node.dim() == 0:
            return ()
        stacked = "blocks" in names
        parts = [None] * node.dim()
        if names and names[-1] in ("k", "v"):
            b_dim = 1 if stacked else 0
            s_dim = b_dim + 1
            if dp and node.shape[b_dim] % dp_size == 0 \
                    and node.shape[b_dim] > 1:
                parts[b_dim] = dp
            if model_ax and node.shape[s_dim] % msize == 0 and msize > 1:
                parts[s_dim] = model_ax
            return tuple(parts)
        b_dim = 1 if (stacked and node.dim() >= 2) else 0
        if dp and node.dim() > b_dim and node.shape[b_dim] % dp_size == 0 \
                and node.shape[b_dim] > 1:
            parts[b_dim] = dp
        return tuple(parts)

    return visit(cache_tree, ())
