"""Mixture-of-Experts FFN of the port (``repro.models.moe``): top-k
routing with capacity-bounded, sort-based dispatch (token drop on
overflow, GShard-style), the experts' three products through the
grouped-matmul kernel (``repro_torch.kernels.moe_gmm``).

``moe_block`` dispatches as the reference's: with no mesh (no
``ParallelCtx``) ``moe_gspmd``; on a mesh with ``moe_impl == "ep"`` the
expert-parallel ``repro_torch.parallel.moe_ep.moe_ep`` when the experts
split over the model axis, else the tensor-parallel ``moe_tp`` when
``d_ff`` does, else ``moe_gspmd`` on the tokens gathered whole (its
global sort needs them all).

Two departures from the reference's arithmetic, neither changing the
function: the dispatch writes each kept row once (dropped rows go to a
spare row of the buffer) instead of scatter-adding, and the combine sums
each token's k rows in a fixed order (the top-k order) instead of
scatter-adding in the experts' order, so a bf16 run on the card gives
the same result every time.  In fp32 the second changes the sum's order
only (about 1e-7 relative).

The backward is as deterministic as the forward (training captures it in
a CUDA graph and holds the replay to a direct call bit for bit).  Every
index the forward gathers with is unique or lands in a discarded row,
so no gradient is scatter-added at a repeated index: the dispatch takes
each token's k rows as an expand (whose backward sums the k rows in a
fixed order) permuted into expert order, and the combine gathers dropped
assignments from a spare zero row past the experts' output.  The
experts' products differentiate through ``moe_gmm``'s backward kernel
(``MoeGmmFn``); the load-balancing loss goes back through the router's
probabilities.
"""
from __future__ import annotations

import math

import torch

from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels.moe_gmm.ops import moe_gmm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _act, dense
from repro_torch.parallel.ctx import get_ctx, run_local
from repro_torch.tree import flatten, unflatten


def router_topk(x2d, router_w, cfg: ModelConfig):
    """x2d: (T, d) -> gates (T, k) fp32, expert idx (T, k) int64, aux loss
    (the Switch load-balancing loss)."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    if cfg.router_renormalize:
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    e = cfg.num_experts
    me = torch.nn.functional.one_hot(idx[:, 0], e).float().mean(dim=0)
    ce = probs.mean(dim=0)
    aux = e * torch.sum(me * ce)
    return gates, idx, aux


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_per_token
                      / cfg.num_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def build_dispatch(idx, n_tokens: int, cap: int, cfg: ModelConfig):
    """Sort assignments by expert; compute (expert, slot) for each (token, k).

    Returns sorted token ids, expert ids, slot-in-expert, keep mask
    (slot < capacity) and the sorting order; all shape (T*k,).
    """
    k = cfg.experts_per_token
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    pos = torch.arange(n_tokens * k, device=idx.device)
    tok = (pos // k)[order]
    e_sorted = flat_e[order]
    starts = torch.searchsorted(
        e_sorted, torch.arange(cfg.num_experts, device=idx.device,
                               dtype=e_sorted.dtype))
    slot = pos - starts[e_sorted]
    keep = slot < cap
    return tok, e_sorted, slot, keep, order


def expert_ffn(xe, experts, cfg: ModelConfig, counts=None, *,
               gmm_impl: str = "auto"):
    """xe: (E, C, d) batched through each expert's gated MLP -> (E, C, d);
    each product is one grouped matmul (fp32 sums, xe's dtype out).

    ``counts`` (E,) int32, the rows each expert holds (rows past it are
    zero), lets the products skip the empty rows and experts; rows past
    it stay zero through the MLP, since act(0) * 0 == 0."""
    act = _act(cfg)
    h = moe_gmm(xe, experts["wi"].to(xe.dtype), counts, impl=gmm_impl)
    g = moe_gmm(xe, experts["wg"].to(xe.dtype), counts, impl=gmm_impl)
    h = act(g) * h
    return moe_gmm(h, experts["wo"].to(xe.dtype), counts, impl=gmm_impl)


def expert_counts(idx, cap: int, cfg: ModelConfig):
    """Rows each expert's buffer holds: its assignments, at most ``cap``;
    an (E,) int32 tensor on idx's device.  ``index_add_`` rather than
    ``bincount``, which reads its input's max back to the host on CUDA."""
    flat = idx.reshape(-1)
    ones = torch.ones_like(flat, dtype=torch.int32)
    counts = torch.zeros(cfg.num_experts, dtype=torch.int32,
                         device=idx.device).index_add_(0, flat, ones)
    return counts.clamp_(max=cap)


def pack(x2d, e_sorted, slot, keep, order, cap: int, cfg: ModelConfig):
    """The (E * cap + 1, d) dispatch buffer of tokens x2d (T, d) and each
    assignment's row in it (``dest``, (T*k,)).

    Each kept assignment owns its (expert, slot) row; dropped ones all
    land on one spare row past the buffer, which the experts never see.
    The rows are x2d[tok] (build_dispatch's tok) taken as each token's
    k copies permuted into expert order: ``order`` is a permutation, so
    the backward gathers instead of scatter-adding at tok's repeated
    indices."""
    t, d = x2d.shape
    k = cfg.experts_per_token
    n_rows = cfg.num_experts * cap
    dest = torch.where(keep, e_sorted * cap + slot,
                       torch.full_like(slot, n_rows))
    rows = x2d.unsqueeze(1).expand(t, k, d).reshape(t * k, d)[order]
    buf = x2d.new_zeros((n_rows + 1, d))
    buf[dest] = rows
    return buf, dest


def combine(ye_rows, gates, keep, order, dest, t: int, cfg: ModelConfig):
    """The experts' output rows ye_rows (E * cap, d) gathered back to
    their tokens, weighted by gate prob (dropped rows from a spare zero
    row, so the kept indices stay unique), each token's k rows summed in
    top-k order: (t, d)."""
    k = cfg.experts_per_token
    d = ye_rows.shape[-1]
    g_sorted = gates.reshape(-1)[order]
    w = torch.where(keep, g_sorted, torch.zeros_like(g_sorted)).to(
        ye_rows.dtype)
    ye_rows = torch.cat([ye_rows, ye_rows.new_zeros((1, d))])
    out_rows = ye_rows[dest] * w[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    return out_rows[inv].view(t, k, d).sum(dim=1)


def moe_gspmd(x, p, cfg: ModelConfig, *, gmm_impl: str = "auto"):
    """x: (b, s, d) -> (b, s, d), aux_loss."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, aux = router_topk(x2d, p["router"], cfg)
    cap = capacity(t, cfg)
    _, e_sorted, slot, keep, order = build_dispatch(idx, t, cap, cfg)
    buf, dest = pack(x2d, e_sorted, slot, keep, order, cap, cfg)
    n_rows = cfg.num_experts * cap
    ye = expert_ffn(buf[:n_rows].view(cfg.num_experts, cap, d),
                    p["experts"], cfg, expert_counts(idx, cap, cfg),
                    gmm_impl=gmm_impl)
    out = combine(ye.reshape(n_rows, d), gates, keep, order, dest, t, cfg)
    if cfg.num_shared_experts > 0:
        out = out + _shared(x2d, p["shared"], cfg)
    return out.reshape(b, s, d), aux


def _shared(x2d, shared, cfg: ModelConfig):
    act = _act(cfg)
    h = dense(x2d, shared["wi"])
    h = act(dense(x2d, shared["wg"])) * h
    return dense(h, shared["wo"])


def moe_block(x, p, cfg: ModelConfig, *, gmm_impl: str = "auto"):
    """The MoE FFN, dispatched as the reference's ``moe_block`` (the
    module note); a DTensor ``x`` needs a ``ParallelCtx``."""
    if not isinstance(x, DTensor):
        return moe_gspmd(x, p, cfg, gmm_impl=gmm_impl)
    from repro_torch.parallel import moe_ep as ep
    from repro_torch.parallel.sharding import mesh_axes

    mesh = get_ctx().mesh
    impl = ep.moe_dispatch(cfg, mesh_axes(mesh))
    if impl == "ep":
        return ep.moe_ep(x, p, cfg, mesh, gmm_impl=gmm_impl)
    if impl == "tp":
        return ep.moe_tp(x, p, cfg, mesh, gmm_impl=gmm_impl)
    # the global sort needs every token: run it whole on each rank
    rep = (Replicate(),) * mesh.ndim
    leaves, structure = flatten(p)
    out, aux = run_local(
        lambda xl, *ls: moe_gspmd(xl, unflatten(structure, ls), cfg,
                                  gmm_impl=gmm_impl),
        mesh, (x, *leaves), (rep,) * (1 + len(leaves)), (rep, rep))
    return out, aux
