"""RWKV-6 "Finch" of the port (arXiv:2404.05892; the counterpart of
``repro.models.rwkv``): attention-free time-mix with data-dependent
per-channel decay + squared-ReLU channel-mix.

Semantics (per head, key/value dim N, state S in R^{NxN}):
    o_t[j] = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])
    S_t    = diag(w_t) S_{t-1} + k_t (x) v_t
with w_t = exp(-exp(d_t)) in (0,1), d_t data-dependent (LoRA on the shifted
input).  Prefill runs the recurrence through the port's rwkv6_wkv kernel
(``repro_torch.kernels.rwkv6_wkv``), where the reference picks its XLA
``wkv_chunked`` or ``wkv_scan``; a one-token decode step with a state is
``wkv_step`` in plain torch, as in the reference.

Under a ``ParallelCtx`` with DTensor activations (the sharded steps) the
token shift runs on whole sequences (a split sequence is gathered
first: each block's first token needs the previous block's last), r, k,
v and the decay are laid out with the batch over the data axes and the
heads over model (each head whole on one rank; every head on every
rank where the heads do not divide the model axis), and the WKV kernel
and its reverse run on each rank's heads
(``repro_torch.parallel.ctx.run_local``): the heads are independent, so
no collective enters the recurrence.  The group norm runs per head on
the same layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.collectives import region
from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv.ref import wkv_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, seq_whole
from repro_torch.parallel.ctx import (get_ctx, param_grad_placements,
                                      run_local, shard_activation)


def _token_shift(x, last):
    """last: (b, d) previous token (zeros at t=0). Returns shifted x."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _split_heads(y, heads: int):
    """(b, s, heads * n) -> (b, s, heads, n).  A DTensor is first laid out
    with the batch over the data axes and the channels over model
    (``act_rnn``) when the heads divide the model axis, else on the batch
    only, and reshaped on each rank's block: no head is ever cut."""
    if not isinstance(y, DTensor):
        return y.reshape(*y.shape[:2], heads, -1)
    ctx = get_ctx()
    y = shard_activation(y, "act_rnn" if heads % ctx.size(ctx.tp_axis) == 0
                         else "kv_rep")
    plc = tuple(y.placements)
    n = y.shape[-1] // heads
    return run_local(lambda t: t.reshape(*t.shape[:2], -1, n),
                     y.device_mesh, (y,), (plc,), plc)


def _merge_heads(y):
    """(b, s, h, n) -> (b, s, h * n), a DTensor on each rank's block."""
    if not isinstance(y, DTensor):
        return y.reshape(*y.shape[:2], -1)
    plc = tuple(y.placements)
    return run_local(lambda t: t.reshape(*t.shape[:2], -1), y.device_mesh,
                     (y,), (plc,), plc)


def _norm_heads(xh, w, eps=1e-5):
    """Per-head normalization of xh (b, s, h, n), times w (h * n,):
    (b, s, h * n) in xh's dtype."""
    x32 = xh.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    x32 = (x32 - mu) * torch.rsqrt(var + eps)
    return (_merge_heads(x32) * w.float()).to(xh.dtype)


def _group_norm(x, w, heads, eps=1e-5):
    """Per-head normalization. x: (b, s, d)."""
    return _norm_heads(_split_heads(x, heads), w, eps)


def _wkv_blocks(r, k, v, logw, u, s0=None, *, impl: str = "auto"):
    """The WKV of DTensors r, k, v, logw (b, s, h, n) laid out by
    :func:`_split_heads`, u (h, n) and s0 (b, h, n, n) or None on each
    rank's rows and heads; returns (o, final state) DTensors of the same
    split.  u's gradient is summed over the ranks that split the
    batch."""
    mesh = r.device_mesh
    plc = tuple(r.placements)
    u_plc = tuple(Shard(0) if q == Shard(2) else Replicate() for q in plc)
    s_plc = tuple(Shard(1) if q == Shard(2) else q for q in plc)
    args = [r, k, v, logw, u.redistribute(mesh, u_plc)]
    in_plc = [plc] * 4 + [u_plc]
    grads = [None] * 4 + [param_grad_placements(plc, u_plc)]
    if s0 is not None:
        args.append(s0.redistribute(mesh, s_plc))
        in_plc.append(s_plc)
        grads.append(None)
    with region("rwkv6_wkv"):
        return run_local(lambda *t: rwkv6_wkv(*t, impl=impl), mesh,
                         args, in_plc, (plc, s_plc), grads)


def _wkv_step_blocks(r, k, v, w, u, s):
    """One decode token's WKV (``wkv_step``) of DTensors r, k, v, w
    (b, h, n), u (h, n) and the state s (b, h, n, n) on each rank's rows
    and heads: the einsums over DTensors would flatten a batch split and
    a head split into one dim, which some torch versions refuse (2.11);
    returns (o, new state) DTensors split as r."""
    mesh = r.device_mesh
    plc = tuple(r.placements)
    u_plc = tuple(Shard(0) if q == Shard(1) else Replicate() for q in plc)
    with region("rwkv6_wkv"):
        return run_local(wkv_step, mesh,
                         (r, k, v, w, u.redistribute(mesh, u_plc), s),
                         [plc] * 4 + [u_plc, plc], (plc, plc))


def time_mix(x, p, cfg: ModelConfig, state=None, scan_impl: str = "auto"):
    """RWKV6 attention replacement. x: (b, s, d).

    state: None or dict(last (b, d), s (b, h, n, n) fp32).  Returns
    (y, new_state).
    """
    x = seq_whole(x)
    s = x.shape[1]
    h = cfg.rwkv_heads
    last = state["last"] if state is not None else torch.zeros_like(x[:, 0])
    delta = _token_shift(x, last) - x
    mix = p["mix"].to(x.dtype)  # (5, d) for r, k, v, w, g
    xr, xk, xv, xw, xg = (x + mix[i] * delta for i in range(5))

    r = _split_heads(dense(xr, p["wr"]), h).float()
    k = _split_heads(dense(xk, p["wk"]), h).float()
    v = _split_heads(dense(xv, p["wv"]), h).float()
    g = F.silu(dense(xg, p["wg"]))

    dlo = torch.einsum("bsd,dk->bsk", torch.tanh(xw.float()),
                       p["decay_a"].float())
    dd = p["decay_base"].float() + torch.einsum(
        "bsk,kd->bsd", dlo, p["decay_b"].float())
    logw = -torch.exp(_split_heads(torch.clamp(dd, -20.0, 10.0), h))

    u = p["bonus"].float()
    if s == 1 and state is not None:
        step = _wkv_step_blocks if isinstance(r, DTensor) else wkv_step
        o, s1 = step(r[:, 0], k[:, 0], v[:, 0], torch.exp(logw)[:, 0], u,
                     state["s"])
        o = o[:, None]
    else:
        wkv = _wkv_blocks if isinstance(r, DTensor) else rwkv6_wkv
        o, s1 = wkv(r, k, v, logw, u, None if state is None else state["s"],
                    impl=scan_impl)

    o = _norm_heads(o.to(x.dtype), p["gn"])
    y = dense(o * g, p["wo"])
    return y, {"last": x[:, -1], "s": s1}


def channel_mix(x, p, cfg: ModelConfig, state=None):
    """Squared-ReLU channel mix. state: dict(last (b, d)) for decode."""
    x = seq_whole(x)
    last = state["last"] if state is not None else torch.zeros_like(x[:, 0])
    delta = _token_shift(x, last) - x
    mix = p["mix"].to(x.dtype)
    xk = x + mix[0] * delta
    xr = x + mix[1] * delta
    kk = torch.square(torch.relu(dense(xk, p["wk"])))
    y = torch.sigmoid(dense(xr, p["wr"])) * dense(kk, p["wv"])
    return y, {"last": x[:, -1]}
