"""Plain PyTorch version of the RG-LRU scan and of its gradient: the
recurrence token by token, forward and backward in time (the reference's
``repro.kernels.rglru_scan.ref`` computes the forward as an associative
scan and takes its gradient from XLA's autodiff).

Both carry in fp32 (fp64 for fp64 inputs, so that ``gradcheck`` can run
on them) and multiply and add as two ops, each rounded, as the CUDA
kernels do: the kernels are bit-exact against them."""
from __future__ import annotations

import torch


def _carry_dtype(a):
    return torch.promote_types(a.dtype, torch.float32)


def rglru_scan_ref(a, b, h0=None):
    """a, b: (batch, seq, ch); h0: (batch, ch) or None (zeros).  Returns
    h (batch, seq, ch) in a.dtype, the carry in fp32."""
    acc = _carry_dtype(a)
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=acc, device=a.device)
         if h0 is None else h0.to(acc))
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t].to(acc) * h + b[:, t].to(acc)
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(a, h, dh, h0=None):
    """Gradient of :func:`rglru_scan_ref` (``h_t = a_t h_{t-1} + b_t``)
    from its inputs ``a`` and ``h0``, its output ``h`` and the output's
    gradient ``dh`` (each (batch, seq, ch); ``h0`` (batch, ch) or None):

        g_{S-1} = dh_{S-1};  g_t = dh_t + a_{t+1} g_{t+1}
        db_t = g_t;  da_t = g_t h_{t-1} (h_{-1} = h0, or zeros);
        dh0 = a_0 g_0

    Returns (da, db, dh0): da and db in a.dtype, dh0 in h0's dtype (None
    without an h0).  The carry g is fp32; each step multiplies, then
    adds."""
    acc = _carry_dtype(a)
    batch, seq, ch = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    prev0 = (torch.zeros((batch, ch), dtype=acc, device=a.device)
             if h0 is None else h0.to(acc))
    g = torch.zeros((batch, ch), dtype=acc, device=a.device)
    for t in range(seq - 1, -1, -1):
        g = (dh[:, t].to(acc) if t == seq - 1
             else dh[:, t].to(acc) + a[:, t + 1].to(acc) * g)
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1].to(acc) if t > 0 else prev0)
    if h0 is None:
        return da, db, None
    dh0 = (a[:, 0].to(acc) * g if seq > 0 else torch.zeros_like(prev0))
    return da, db, dh0.to(h0.dtype)
