"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427; the counterpart of ``repro.models.rglru``).

Block: x -> {value branch: linear -> causal conv1d -> RG-LRU} * gate branch
         -> output projection.

RG-LRU recurrence (per channel):
    r_t = sigmoid(x_t @ W_a + b_a)                    (recurrence gate)
    i_t = sigmoid(x_t @ W_x + b_x)                    (input gate)
    log_a_t = -c * softplus(Lambda) * r_t             (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the sequence form as an associative scan in XLA; the
port runs the recurrence through its rglru_scan kernel
(``repro_torch.kernels.rglru_scan``), the same function.  Decode carries
(conv_state, h) and is O(1) per token, in plain torch.

Under a ``ParallelCtx`` with DTensor activations (the sharded steps) the
value branch is laid out as the ``act_rnn`` kind, the batch over the
data axes and the channels over model, before the causal conv: the conv
and the recurrence are per channel, so each rank runs both on its own
channels (``repro_torch.parallel.ctx.run_local``), the scan kernel and
its reverse included, and no collective enters them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.collectives import region
from repro_torch.kernels.rglru_scan.ops import rglru_scan as _scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense
from repro_torch.parallel.ctx import (param_grad_placements, run_local,
                                      shard_activation)

_C = 8.0


def _softplus(x):
    """``jax.nn.softplus`` = logaddexp(x, 0), without F.softplus's
    linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(x, p):
    """(a, sqrt(1 - a^2) * i * x), both fp32 (b, s, w)."""
    r = torch.sigmoid(dense(x, p["lru_wa"], p["lru_ba"]).float())
    i = torch.sigmoid(dense(x, p["lru_wx"], p["lru_bx"]).float())
    log_a = -_C * _softplus(p["lru_a"].float()) * r
    a = torch.exp(log_a)
    gated_x = i * x.float()
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x


def _like(plc, batch, chan):
    """Placements of a tensor whose batch dim is ``batch`` (None: it has
    none) and channel dim ``chan``, split as the ``act_rnn`` placements
    ``plc`` of a (b, s, c) tensor split its batch and channels."""
    return tuple(
        Shard(batch) if q == Shard(0) and batch is not None else
        Shard(chan) if q == Shard(2) else Replicate() for q in plc)


def _scan_blocks(a, bx, h0=None, *, impl: str = "auto"):
    """The scan of DTensors a, bx (b, s, w) and h0 (b, w) or None on each
    rank's block of the ``act_rnn`` layout; h comes back so placed."""
    a = shard_activation(a, "act_rnn")
    bx = shard_activation(bx, "act_rnn")
    plc = tuple(a.placements)
    if h0 is None:
        args, in_plc = (a, bx), (plc, plc)
    else:
        args, in_plc = (a, bx, h0), (plc, plc, _like(plc, 0, 1))
    with region("rglru_scan"):
        return run_local(lambda *t: _scan(*t, impl=impl),
                         a.device_mesh, args, in_plc, plc)


def rglru_scan(x, p, h0=None, scan_impl: str = "auto"):
    """x: (b, s, w) -> (y (b, s, w) in x.dtype, h_last (b, w) fp32)."""
    a, bx = _gates(x, p)
    h0 = None if h0 is None else h0.float()
    scan = _scan_blocks if isinstance(a, DTensor) else _scan
    h = scan(a, bx, h0, impl=scan_impl)
    return h.to(x.dtype), h[:, -1]


def rglru_step(x, p, h):
    """x: (b, 1, w), h: (b, w) -> (y (b, 1, w), h' fp32)."""
    a, bx = _gates(x, p)
    h_new = a[:, 0] * h.float() + bx[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def causal_conv1d(x, w, b, state=None):
    """Depthwise causal conv. x: (b, s, c); w: (width, c).

    When ``state`` (b, width-1, c) is given, runs one-step decode and
    returns (y, new_state); otherwise returns (y, the last width-1 inputs
    of the zero-padded sequence).
    """
    width = w.shape[0]
    if state is not None:
        window = torch.cat([state, x], dim=1)            # (b, width, c)
        y = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b.float()
        return y[:, None].to(x.dtype), window[:, 1:]
    pad = x.new_zeros(x.shape[:1] + (width - 1,) + x.shape[2:])
    xp = torch.cat([pad, x], dim=1)
    y = 0
    for i in range(width):      # the reference's sum(), in its order
        y = y + xp[:, i:i + x.shape[1]].float() * w[i].float()
    y = y + b.float()
    return y.to(x.dtype), (xp[:, -(width - 1):] if width > 1 else None)


def _conv_blocks(x, w, b):
    """:func:`causal_conv1d` over a prompt for DTensor ``x`` (b, s, c), on
    each rank's channels of the ``act_rnn`` layout, whole sequences (a
    split sequence would cut the conv's window); the weights' gradients
    are summed over the ranks that split the batch."""
    x = shard_activation(x, "act_rnn")
    plc = tuple(x.placements)
    w_plc, b_plc = _like(plc, None, 1), _like(plc, None, 0)
    return run_local(causal_conv1d, x.device_mesh, (x, w, b),
                     (plc, w_plc, b_plc), (plc, plc),
                     (None, param_grad_placements(plc, w_plc),
                      param_grad_placements(plc, b_plc)))


def recurrent_block(x, p, cfg: ModelConfig, state=None,
                    scan_impl: str = "auto"):
    """RecurrentGemma recurrent block. x: (b, s, d).

    state: None (prefill from scratch) or dict(conv, h) for decode.
    Returns (y, new_state {conv (b, width-1, w) in x.dtype, h (b, w) fp32}).
    """
    y = dense(x, p["w_y"])
    gate = F.gelu(dense(x, p["w_gate"]), approximate="tanh")
    if state is None:
        conv = _conv_blocks if isinstance(y, DTensor) else causal_conv1d
        y, conv_state = conv(y, p["conv_w"], p["conv_b"])
        y, h = rglru_scan(y, p, scan_impl=scan_impl)
    else:
        y, conv_state = causal_conv1d(y, p["conv_w"], p["conv_b"],
                                      state["conv"])
        y, h = rglru_step(y, p, state["h"])
    out = dense(y * gate, p["w_out"])
    return out, {"conv": conv_state, "h": h}
