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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv.ops import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv.ref import wkv_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense


def _token_shift(x, last):
    """last: (b, d) previous token (zeros at t=0). Returns shifted x."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _group_norm(x, w, heads, eps=1e-5):
    """Per-head normalization. x: (b, s, d)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, heads, d // heads).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xh - mu), dim=-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, d) * w.float()).to(x.dtype)


def time_mix(x, p, cfg: ModelConfig, state=None, scan_impl: str = "auto"):
    """RWKV6 attention replacement. x: (b, s, d).

    state: None or dict(last (b, d), s (b, h, n, n) fp32).  Returns
    (y, new_state).
    """
    b, s, d = x.shape
    h, n = cfg.rwkv_heads, cfg.rwkv_head_dim
    last = state["last"] if state is not None else x.new_zeros((b, d))
    delta = _token_shift(x, last) - x
    mix = p["mix"].to(x.dtype)  # (5, d) for r, k, v, w, g
    xr, xk, xv, xw, xg = (x + mix[i] * delta for i in range(5))

    r = dense(xr, p["wr"]).reshape(b, s, h, n).float()
    k = dense(xk, p["wk"]).reshape(b, s, h, n).float()
    v = dense(xv, p["wv"]).reshape(b, s, h, n).float()
    g = F.silu(dense(xg, p["wg"]))

    dlo = torch.einsum("bsd,dk->bsk", torch.tanh(xw.float()),
                       p["decay_a"].float())
    dd = p["decay_base"].float() + torch.einsum(
        "bsk,kd->bsd", dlo, p["decay_b"].float())
    logw = -torch.exp(torch.clamp(dd, -20.0, 10.0)).reshape(b, s, h, n)

    u = p["bonus"].float()
    if s == 1 and state is not None:
        o, s1 = wkv_step(r[:, 0], k[:, 0], v[:, 0], torch.exp(logw)[:, 0], u,
                         state["s"])
        o = o[:, None]
    else:
        o, s1 = rwkv6_wkv(r, k, v, logw, u,
                          None if state is None else state["s"],
                          impl=scan_impl)

    o = _group_norm(o.reshape(b, s, d).to(x.dtype), p["gn"], h)
    y = dense(o * g, p["wo"])
    return y, {"last": x[:, -1], "s": s1}


def channel_mix(x, p, cfg: ModelConfig, state=None):
    """Squared-ReLU channel mix. state: dict(last (b, d)) for decode."""
    b, s, d = x.shape
    last = state["last"] if state is not None else x.new_zeros((b, d))
    delta = _token_shift(x, last) - x
    mix = p["mix"].to(x.dtype)
    xk = x + mix[0] * delta
    xr = x + mix[1] * delta
    kk = torch.square(torch.relu(dense(xk, p["wk"])))
    y = torch.sigmoid(dense(xr, p["wr"])) * dense(kk, p["wv"])
    return y, {"last": x[:, -1]}
