"""Expert- and tensor-parallel MoE (the port's ``repro.parallel.moe_ep``),
each a body of plain tensors run on every rank's blocks under
``local_map`` (``repro_torch.parallel.ctx.run_local``), the counterpart
of the reference's ``shard_map``.

``moe_ep``: tokens split over (pod, data) x model; each rank routes its
own tokens, packs per-expert capacity buffers (the capacity of its own
token count), exchanges them over the model axis with one all-to-all
(``all_to_all_single_autograd``: its backward is the reverse exchange),
runs its local experts through ``expert_ffn`` (so the grouped-matmul
kernel, forward and backward, on the rows this rank received), sends
the outputs back with a second all-to-all and combines them with the
gate weights.  ``moe_tp``: every model rank routes the same tokens and
runs every expert on its ``d_ff`` block; the partial outputs are summed
over the model axis (a ``Partial`` output: one all-reduce, or the
reduce-scatter that the next layout asks for).  Both take the
reference's pack and combine arithmetic through the port's
deterministic dispatch (``repro_torch.models.moe``): each kept row
written once, each token's k rows summed in top-k order.

The load-balancing loss is each rank's own, averaged over every rank
(``pmean``): a ``Partial`` of aux / ranks.  A replicated weight read by
every rank has a ``Partial`` gradient over the ranks that read it with
other tokens (``shard_map``'s transpose of a replicated input).
"""
from __future__ import annotations

import math

import torch
from torch.distributed._functional_collectives import \
    all_to_all_single_autograd
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.core.collectives import region
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import (_shared, build_dispatch, capacity,
                                    combine, expert_counts, expert_ffn,
                                    pack, router_topk)
from repro_torch.parallel.ctx import run_local
from repro_torch.parallel.sharding import placements


class _GradCopied(torch.autograd.Function):
    """The identity, whose gradient is copied into a plain tensor: the
    reverse exchange's gradient reaches the experts' backward kernels
    through views of a lazily waited wrapper, and a kernel reads raw
    pointers."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clone(memory_format=torch.contiguous_format)


def _route(x2d, router_w, cfg: ModelConfig):
    t = x2d.shape[0]
    gates, idx, aux = router_topk(x2d, router_w, cfg)
    cap = capacity(t, cfg)
    _, e_sorted, slot, keep, order = build_dispatch(idx, t, cap, cfg)
    return gates, idx, aux, cap, e_sorted, slot, keep, order


def moe_ep(x, p, cfg: ModelConfig, mesh, *, gmm_impl: str = "auto"):
    """x: DTensor (b, s, d) -> (out, aux).  Requires num_experts % |model|
    == 0; tokens are split on the batch over (pod, data) and on the
    sequence over model, each evenly (``ValueError`` otherwise, as the
    reference's ``shard_map`` refuses it: a decode step's sequence of 1
    on |model| > 1 among them), so every rank's capacity is the same
    inside one all-to-all."""
    names = tuple(mesh.mesh_dim_names)
    n_model = mesh.size(names.index("model"))
    if cfg.num_experts % n_model:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{n_model} model ranks")
    dp = [a for a in ("pod", "data") if a in names]
    n_dp = math.prod(mesh.size(names.index(a)) for a in dp)
    if x.shape[1] % n_model or x.shape[0] % n_dp:
        raise ValueError(f"moe_ep: tokens {tuple(x.shape[:2])} do not split "
                         f"evenly over {n_dp} data x {n_model} model ranks")
    e_loc = cfg.num_experts // n_model
    n_ranks = mesh.size()
    group = mesh.get_group("model")
    x_plc = placements(((tuple(dp) if len(dp) > 1 else dp[0])
                        if dp else None, "model", None), mesh)
    rep = (Replicate(),) * mesh.ndim
    part = (Partial(),) * mesh.ndim
    e_plc = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    e_grad = tuple(Shard(0) if n == "model" else Partial() for n in names)
    shared = p.get("shared")
    sh_keys = ("wi", "wg", "wo") if shared is not None else ()

    def local(x_loc, router_w, wi, wg, wo, *sh):
        b, s, d = x_loc.shape
        t = b * s
        x2d = x_loc.reshape(t, d)
        gates, idx, aux, cap, e_sorted, slot, keep, order = _route(
            x2d, router_w, cfg)
        buf, dest = pack(x2d, e_sorted, slot, keep, order, cap, cfg)
        send = buf[:cfg.num_experts * cap]
        recv = all_to_all_single_autograd(send, None, None, group)
        # the exchange returns a lazily waited wrapper whose views wait
        # for nothing; the kernels read raw pointers, so the rows are
        # copied out, grouped by local expert, by a real op first
        xe = recv.view(n_model, e_loc, cap, d).transpose(0, 1).clone(
            memory_format=torch.contiguous_format).view(
            e_loc, n_model * cap, d)
        # one source: each expert's rows are its first ``counts``, as on
        # one device; several: zero rows between the sources' blocks
        counts = expert_counts(idx, cap, cfg) if n_model == 1 else None
        ye = _GradCopied.apply(expert_ffn(
            xe, {"wi": wi, "wg": wg, "wo": wo}, cfg, counts,
            gmm_impl=gmm_impl))
        ye = ye.view(e_loc, n_model, cap, d).transpose(0, 1).reshape(
            n_model * e_loc * cap, d)
        back = all_to_all_single_autograd(ye, None, None, group)
        out = combine(back, gates, keep, order, dest, t, cfg)
        if sh:
            out = out + _shared(x2d, dict(zip(sh_keys, sh)), cfg)
        return out.reshape(b, s, d), aux / n_ranks

    args = (x, p["router"], *(p["experts"][k] for k in ("wi", "wg", "wo")),
            *(shared[k] for k in sh_keys))
    in_plc = (x_plc, rep, e_plc, e_plc, e_plc) + (rep,) * len(sh_keys)
    grads = (x_plc, part, e_grad, e_grad, e_grad) + (part,) * len(sh_keys)
    with region("moe_ep"):
        out, aux = run_local(local, mesh, args, in_plc, (x_plc, part),
                             grads)
        return out, aux.redistribute(mesh, rep)


def moe_tp(x, p, cfg: ModelConfig, mesh, *, gmm_impl: str = "auto"):
    """Tensor-parallel MoE for num_experts not divisible by |model| (and
    d_ff divisible): every model rank routes the same tokens (the batch
    split over (pod, data) only), runs all experts on its d_ff block, and
    the partial outputs are summed over model."""
    names = tuple(mesh.mesh_dim_names)
    n_ranks = mesh.size()
    dp = [a for a in ("pod", "data") if a in names]
    x_plc = placements(((tuple(dp) if len(dp) > 1 else dp[0])
                        if dp else None, None, None), mesh)
    rep = (Replicate(),) * mesh.ndim
    part = (Partial(),) * mesh.ndim

    def on_model(dim):
        return tuple(Shard(dim) if n == "model" else Replicate()
                     for n in names)

    def grad_of(plc):
        return tuple(q if isinstance(q, Shard) and n == "model"
                     else Partial() for n, q in zip(names, plc))

    out_plc = tuple(Partial() if n == "model" else q
                    for n, q in zip(names, x_plc))
    x_grad = out_plc
    shared = p.get("shared")
    sh_keys = ("wi", "wg", "wo") if shared is not None else ()
    sh_plc = {"wi": on_model(1), "wg": on_model(1), "wo": on_model(0)}

    def local(x_loc, router_w, wi, wg, wo, *sh):
        b, s, d = x_loc.shape
        t = b * s
        x2d = x_loc.reshape(t, d)
        gates, idx, aux, cap, e_sorted, slot, keep, order = _route(
            x2d, router_w, cfg)
        buf, dest = pack(x2d, e_sorted, slot, keep, order, cap, cfg)
        ye = expert_ffn(buf[:cfg.num_experts * cap].view(
            cfg.num_experts, cap, d), {"wi": wi, "wg": wg, "wo": wo}, cfg,
            expert_counts(idx, cap, cfg), gmm_impl=gmm_impl)
        out = combine(ye.reshape(-1, d), gates, keep, order, dest, t, cfg)
        if sh:
            out = out + _shared(x2d, dict(zip(sh_keys, sh)), cfg)
        return out.reshape(b, s, d), aux / n_ranks

    ew, eo = on_model(2), on_model(1)
    args = (x, p["router"], *(p["experts"][k] for k in ("wi", "wg", "wo")),
            *(shared[k] for k in sh_keys))
    in_plc = (x_plc, rep, ew, ew, eo) + tuple(sh_plc[k] for k in sh_keys)
    grads = (x_grad, part, grad_of(ew), grad_of(ew), grad_of(eo)) + tuple(
        grad_of(sh_plc[k]) for k in sh_keys)
    with region("moe_tp"):
        out, aux = run_local(local, mesh, args, in_plc, (out_plc, part),
                             grads)
        return out, aux.redistribute(mesh, rep)


def moe_dispatch(cfg: ModelConfig, mesh_axes) -> str:
    """The reference's ``moe_block`` choice on a mesh of ``mesh_axes``
    ({name: size}, or None for no mesh): "ep" when ``moe_impl == "ep"``
    and the experts split over model, else "tp" when d_ff does, else
    "gspmd"."""
    if cfg.moe_impl == "ep" and mesh_axes and "model" in mesh_axes:
        n_model = mesh_axes["model"]
        if cfg.num_experts % n_model == 0:
            return "ep"
        if cfg.d_ff % n_model == 0:
            return "tp"
    return "gspmd"

