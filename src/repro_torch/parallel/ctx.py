"""Ambient parallelism context (the port's ``repro.parallel.ctx``).

Model code is mesh-agnostic: it calls :func:`shard_activation` with a
logical activation kind; the launcher installs a :class:`ParallelCtx`
that maps kinds to parts (per-dim mesh axes) on the active mesh, and
``shard_activation`` redistributes a DTensor to them (the counterpart of
``with_sharding_constraint``).  Without a context, or on a plain tensor,
every call is the identity, so single-device code never sees a mesh.

:func:`run_local` is the counterpart of ``shard_map``: a function of
plain tensors run under ``local_map`` on each rank's blocks of DTensor
arguments; the model's kernels (flash attention, the grouped matmul,
the RG-LRU scan, the WKV, the logits head) and the ops DTensor has no
sharding rule for (the embedding lookup, RoPE, the loss, the MoE
dispatch, the causal conv, the reshapes to heads) go through it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Placement
from torch.distributed.tensor.experimental import local_map

from repro_torch.parallel.sharding import placements

_STATE = threading.local()


class ParallelCtx:
    """Maps logical activation kinds -> parts on a concrete mesh.

    dp_axes: mesh axes carrying the batch dim (e.g. ("pod", "data")).
    sp_axis: mesh axis carrying the sequence dim between blocks (Megatron
             sequence parallelism), or None.
    tp_axis: tensor-parallel axis (heads / ffn / vocab).
    bf16_grad: weight gradients leave ``dense`` in the weight's dtype
             (``repro_torch.models.layers.DenseBf16Grad``).
    """

    def __init__(self, mesh: DeviceMesh, dp_axes=("data",), tp_axis="model",
                 sp_axis: Optional[str] = None, bf16_grad: bool = False):
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.dp_axes = tuple(a for a in dp_axes if a in names)
        self.tp_axis = tp_axis if tp_axis in names else None
        self.sp_axis = sp_axis if (sp_axis and sp_axis in names) else None
        self.bf16_grad = bf16_grad

    def spec(self, kind: str, shape: Optional[Sequence[int]] = None
             ) -> tuple:
        """The parts of ``kind``; with the tensor's ``shape``, the
        "logits" vocab stays whole where the model axis does not divide
        it (as ``assign_axes`` keeps a parameter's dim and
        ``_split_heads`` the heads: an uneven block has no one offset
        rule)."""
        dp = self.dp_axes if len(self.dp_axes) > 1 else (
            self.dp_axes[0] if self.dp_axes else None)
        if kind == "tokens":          # (b, s)
            return (dp, self.sp_axis)
        if kind == "act":             # (b, s, d) residual stream
            return (dp, self.sp_axis, None)
        if kind == "act_heads":       # (b, s, h, hd)
            return (dp, None, self.tp_axis, None)
        if kind == "logits":          # (b, s, vocab), vocab over tp
            even = shape is None or shape[-1] % self.size(self.tp_axis) == 0
            return (dp, None, self.tp_axis if even else None)
        if kind == "cache":           # (b, S, hkv, hd), seq-sharded KV
            return (dp, self.tp_axis, None, None)
        if kind == "cache_batch":     # (b, S, hkv, hd), batch only
            return (dp, None, None, None)
        if kind == "kv_rep":          # (b, s, hkv, hd), K/V replicated on tp
            return (dp, None, None, None)
        if kind == "act_rnn":         # (b, s, rnn_ch), channel-sharded scan
            return (dp, None, self.tp_axis)
        raise KeyError(kind)

    def placements(self, kind: str, ndim: int,
                   shape: Optional[Sequence[int]] = None):
        """DTensor placements of ``kind`` for a tensor of ``ndim`` dims
        (of ``shape``, where given: :meth:`spec`)."""
        spec = self.spec(kind, shape)[:ndim]
        return placements(spec + (None,) * (ndim - len(spec)), self.mesh)

    def size(self, axis: Optional[str]) -> int:
        if axis is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))


def set_ctx(ctx: Optional[ParallelCtx]):
    _STATE.ctx = ctx


def get_ctx() -> Optional[ParallelCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def parallel_ctx(ctx: Optional[ParallelCtx]):
    prev = get_ctx()
    set_ctx(ctx)
    try:
        yield ctx
    finally:
        set_ctx(prev)


def shard_activation(x, kind: str):
    """``x`` redistributed to the placements of ``kind`` when a context
    is installed and ``x`` is a DTensor; else ``x`` itself."""
    ctx = get_ctx()
    if ctx is None or not isinstance(x, DTensor):
        return x
    plc = ctx.placements(kind, x.dim(), x.shape)
    if tuple(x.placements) == plc:
        return x
    return x.redistribute(ctx.mesh, plc)


def param_grad_placements(act_plc: Sequence[Any],
                          param_plc: Sequence[Any]) -> tuple:
    """The placements of the gradient that a ``run_local`` body computes
    for a parameter block of placements ``param_plc`` read by every
    element of an activation block of placements ``act_plc``: the sum
    over this rank's elements only, a ``Partial`` over each mesh dim
    that splits the activation but not the parameter (``shard_map``'s
    transpose sums it there)."""
    return tuple(Partial() if a.is_shard() and not p.is_shard() else p
                 for a, p in zip(act_plc, param_plc))


def run_local(fn, mesh: DeviceMesh, args: Sequence[Any],
              in_placements: Sequence[Any], out_placements: Any,
              in_grad_placements: Optional[Sequence[Any]] = None):
    """``fn(*local args)`` under ``local_map`` (``shard_map``): each
    DTensor argument is first redistributed to its entry of
    ``in_placements`` (None for a non-DTensor argument), the body sees
    this rank's blocks as plain tensors, and its outputs come back as
    DTensors of ``out_placements``.  ``in_grad_placements`` states the
    placements of each input's gradient as the body computes it (a
    replicated input read by every rank has a ``Partial`` gradient:
    ``shard_map``'s transpose sums it); None, or a None entry: the
    input's own."""
    placed = []
    for a, plc in zip(args, in_placements):
        if isinstance(a, DTensor) and tuple(a.placements) != tuple(plc):
            a = a.redistribute(mesh, tuple(plc))
        placed.append(a)
    in_plc = tuple(None if p is None else tuple(p) for p in in_placements)
    grads = in_plc if in_grad_placements is None else tuple(
        p if g is None else tuple(g)
        for p, g in zip(in_plc, in_grad_placements))
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = (tuple(out_placements),)     # one output
        single = True
    else:
        single = False
    mapped = local_map(fn, out_placements=out_placements,
                       in_placements=in_plc, in_grad_placements=grads,
                       device_mesh=mesh)
    out = mapped(*placed)
    return out[0] if single and isinstance(out, (tuple, list)) else out
