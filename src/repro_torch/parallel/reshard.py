"""Logical-axis -> mesh-axis rule table and the elastic-resize cost
model (the port's copy of ``repro.parallel.reshard``, unchanged in
behaviour).

Every parameter carries logical axis names
(``repro_torch.models.init.ParamSpec.axes``).  The rule table maps each
name to candidate mesh axes; :func:`assign_axes` walks a leaf's dims and
gives each the first candidate that is in the mesh, unused by another
dim, larger than 1 and divides the dim evenly, else replicates it.  The
defaults are FSDP ("embed" on data) x TP ("ffn" / "heads" / "vocab" on
model) with expert parallelism on "experts" when it divides.

The fleet simulator (``repro_torch.fleet.sim``) prices an elastic resize
with the same walk: when a job's slice shrinks or regrows, every chip
fetches the part of its *new* shard it does not already hold.  The cost
model:
  * canonical mesh for a slice of C chips (:func:`canonical_mesh`);
  * a leaf replicated under the *old* mesh is free to reshard;
  * any other leaf costs its full new per-chip shard;
  * optimizer state travels with the parameters (``OPT_STATE_FACTOR`` =
    params + Adam m + v);
  * transfers run chip-parallel over the simulated fleet's per-chip DCN
    bandwidth (``repro_torch.fleet.generations.DCN_BW_PER_CHIP``).
The inventory of each architecture (shape, logical axes, dtype size of
every leaf) is derived from the port's own ``models.init.spec_tree`` in
``tree.flatten``'s sorted-key order, the order ``jax.tree`` walks the
reference's tree in.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.generations import DCN_BW_PER_CHIP

# logical axis -> candidate mesh axes (first that divides wins; () =
# replicate)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "embed": ("data",),          # FSDP: weights gathered per layer
    "ffn": ("model",),           # TP
    "heads": ("model",),
    "kv": ("model",),
    "experts": ("model",),       # EP when num_experts % model == 0
    "experts_r": (),             # router output dim: tiny, replicate
    "rnn": ("model",),
    "rnn_in": ("data",),
    "pos": (),
    "layers": (),
    "vec": (),
    "embed_v": (),
    "vec2": (),
}


def assign_axes(shape: Sequence[int], axes: Sequence[str],
                mesh_axes: Dict[str, int],
                rules: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> Tuple[Optional[str], ...]:
    """Per-dim mesh-axis assignment for one parameter: the first rule
    candidate present in the mesh, not already used by another dim, and
    dividing the dim evenly wins; otherwise the dim replicates (None).
    ``mesh_axes`` maps mesh axis name -> size."""
    rules = rules or DEFAULT_RULES
    parts: List[Optional[str]] = []
    used = set()
    for dim, logical in zip(shape, axes):
        choice = None
        for cand in rules.get(logical, ()):
            size = mesh_axes.get(cand, 1)
            if cand in mesh_axes and cand not in used \
                    and dim % size == 0 and size > 1:
                choice = cand
                break
        if choice:
            used.add(choice)
        parts.append(choice)
    return tuple(parts)


def canonical_mesh(chips: int) -> Dict[str, int]:
    """The default TP-within-FSDP mesh for a slice of ``chips``: model =
    min(8, the largest power of two dividing chips), data = the rest."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, got {chips}")
    pow2 = chips & -chips                   # largest power of 2 dividing
    model = min(8, pow2)
    return {"data": chips // model, "model": model}


# ---------------------------------------------------------------------------
# the resize pricing of the fleet simulator
# ---------------------------------------------------------------------------

# params + Adam first/second moments move together on a resize
OPT_STATE_FACTOR = 3.0


@functools.lru_cache(maxsize=None)
def param_inventory(arch: str) -> List[Tuple[Tuple[int, ...],
                                             Tuple[str, ...], int]]:
    """(shape, logical axes, dtype itemsize) per parameter leaf of
    ``arch`` at its published size, in sorted-key order."""
    from repro_torch.configs import get_config
    from repro_torch.models.init import spec_tree
    from repro_torch.tree import flatten

    leaves, _ = flatten(spec_tree(get_config(arch)))
    return [(tuple(s.shape), tuple(s.axes), s.dtype.itemsize)
            for s in leaves]


def _shard_bytes_per_chip(shape, itemsize, parts, mesh: Dict[str, int]
                          ) -> float:
    elems = math.prod(shape)
    for dim, part in zip(shape, parts):
        if part:
            elems //= mesh[part]
    return float(elems * itemsize)


@functools.lru_cache(maxsize=None)
def reshard_bytes_per_chip(arch: str, old_chips: int, new_chips: int
                           ) -> float:
    """Inbound bytes per chip to re-partition ``arch`` parameters from a
    slice of ``old_chips`` to one of ``new_chips`` (optimizer state
    included)."""
    old_mesh = canonical_mesh(old_chips)
    new_mesh = canonical_mesh(new_chips)
    inbound = 0.0
    for shape, axes, itemsize in param_inventory(arch):
        old_parts = assign_axes(shape, axes, old_mesh)
        if not any(old_parts):
            continue                 # replicated before: already on-chip
        new_parts = assign_axes(shape, axes, new_mesh)
        inbound += _shard_bytes_per_chip(shape, itemsize, new_parts,
                                         new_mesh)
    return inbound * OPT_STATE_FACTOR


def reshard_seconds(arch: str, old_chips: int, new_chips: int,
                    bw: float = DCN_BW_PER_CHIP) -> float:
    """Wall seconds the resize transfer takes (chip-parallel over DCN)."""
    if old_chips == new_chips:
        return 0.0
    return reshard_bytes_per_chip(arch, old_chips, new_chips) / bw
