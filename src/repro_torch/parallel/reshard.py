"""Logical-axis -> mesh-axis rule table (the port's copy of the
framework-free part of ``repro.parallel.reshard``).

Every parameter carries logical axis names
(``repro_torch.models.init.ParamSpec.axes``).  The rule table maps each
name to candidate mesh axes; :func:`assign_axes` walks a leaf's dims and
gives each the first candidate that is in the mesh, unused by another
dim, larger than 1 and divides the dim evenly, else replicates it.  The
defaults are FSDP ("embed" on data) x TP ("ffn" / "heads" / "vocab" on
model) with expert parallelism on "experts" when it divides.

The reference's DCN resize pricing (``reshard_bytes_per_chip``,
``reshard_seconds``) and its parameter inventory JSON serve only its
fleet simulator and are not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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
