"""Plain PyTorch version of the RWKV-6 WKV recurrence: the per-token step
of the reference's model (``repro.models.rwkv.wkv_step``) in a loop, the
function of ``repro.kernels.rwkv6_wkv.ref.wkv_ref`` with the state in and
out."""
from __future__ import annotations

import torch


def wkv_step(r, k, v, w, u, state):
    """One token.  r, k, v, w: (b, h, n); u: (h, n); state: (b, h, n, n).
    Returns (o (b, h, n), state)."""
    rkv = torch.einsum("bhi,bhi,bhj->bhj", r, u[None] * k, v)
    o = torch.einsum("bhi,bhij->bhj", r, state) + rkv
    state = w[..., None] * state + torch.einsum("bhi,bhj->bhij", k, v)
    return o, state


def rwkv6_wkv_ref(r, k, v, logw, u, s0=None):
    """r, k, v, logw: (b, s, h, n); u: (h, n); s0: (b, h, n, n) or None
    (zeros).  Returns (o (b, s, h, n) in r.dtype, state fp32); the
    arithmetic is fp32."""
    b, s, h, n = r.shape
    state = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()
    o = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    for t in range(s):
        o[:, t], state = wkv_step(rf[:, t], kf[:, t], vf[:, t], wf[:, t], uf,
                                  state)
    return o.to(r.dtype), state
