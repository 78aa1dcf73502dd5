"""Plain PyTorch version of the RG-LRU scan: the recurrence token by token
(the reference's ``repro.kernels.rglru_scan.ref`` computes the same
function as an associative scan)."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0=None):
    """a, b: (batch, seq, ch); h0: (batch, ch) or None (zeros).  Returns
    h (batch, seq, ch) in a.dtype, the carry in fp32."""
    h = (torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device) if h0 is None else h0.float())
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out
