"""Plain PyTorch version of the RWKV-6 WKV recurrence and of its
gradient: the per-token step of the reference's model
(``repro.models.rwkv.wkv_step``) in a loop, the function of
``repro.kernels.rwkv6_wkv.ref.wkv_ref`` with the state in and out, and
the same recurrence run backwards in time (the reference takes the
gradient from XLA's autodiff of ``wkv_chunked`` / ``wkv_scan``)."""
from __future__ import annotations

import torch


def wkv_step(r, k, v, w, u, state):
    """One token.  r, k, v, w: (b, h, n); u: (h, n); state: (b, h, n, n).
    Returns (o (b, h, n), state)."""
    rkv = torch.einsum("bhi,bhi,bhj->bhj", r, u[None] * k, v)
    o = torch.einsum("bhi,bhij->bhj", r, state) + rkv
    state = w[..., None] * state + torch.einsum("bhi,bhj->bhij", k, v)
    return o, state


def _carry_dtype(r):
    return torch.promote_types(r.dtype, torch.float32)


def rwkv6_wkv_ref(r, k, v, logw, u, s0=None):
    """r, k, v, logw: (b, s, h, n); u: (h, n); s0: (b, h, n, n) or None
    (zeros).  Returns (o (b, s, h, n) in r.dtype, state); the arithmetic
    and the state are fp32 (fp64 for fp64 inputs)."""
    b, s, h, n = r.shape
    acc = _carry_dtype(r)
    state = (torch.zeros((b, h, n, n), dtype=acc, device=r.device)
             if s0 is None else s0.to(acc))
    rf, kf, vf = r.to(acc), k.to(acc), v.to(acc)
    wf = torch.exp(logw.to(acc))
    uf = u.to(acc)
    o = torch.empty((b, s, h, n), dtype=acc, device=r.device)
    for t in range(s):
        o[:, t], state = wkv_step(rf[:, t], kf[:, t], vf[:, t], wf[:, t], uf,
                                  state)
    return o.to(r.dtype), state


def _bwd_terms(r, k, v, logw, u, do, s0):
    """The reverse's inputs carried in fp32 (fp64 for fp64 inputs), the
    states S_0 .. S_{s-1} before each token (recomputed forward from s0),
    and the terms that need no G, for every token at once."""
    b, s, h, n = r.shape
    acc = _carry_dtype(r)
    rf, kf, vf, dof = (t.to(acc) for t in (r, k, v, do))
    wf = torch.exp(logw.to(acc))
    uf = u.to(acc)
    state = (torch.zeros((b, h, n, n), dtype=acc, device=r.device)
             if s0 is None else s0.to(acc))
    prev = torch.empty((b, s, h, n, n), dtype=acc, device=r.device)
    for t in range(s):
        prev[:, t] = state
        state = wf[:, t, ..., None] * state + torch.einsum(
            "bhi,bhj->bhij", kf[:, t], vf[:, t])
    dov = (dof * vf).sum(-1, keepdim=True)                  # do_t . v_t
    dr = torch.einsum("bshij,bshj->bshi", prev, dof) + uf * kf * dov
    dk = uf * rf * dov
    dv = dof * (rf * uf * kf).sum(-1, keepdim=True)
    return dict(acc=acc, rf=rf, kf=kf, vf=vf, dof=dof, wf=wf, prev=prev,
                dov=dov, dr=dr, dk=dk, dv=dv, dlogw=torch.empty_like(dr))


def _reverse(x, g, lo, hi):
    """Tokens hi-1 .. lo of the reverse from G = ``g``, adding G's terms
    into x's dk, dv and writing its dlogw; returns G before token lo."""
    wf, vf, kf, rf, dof, prev = (x[n] for n in
                                 ("wf", "vf", "kf", "rf", "dof", "prev"))
    for t in range(hi - 1, lo - 1, -1):
        x["dk"][:, t] += torch.einsum("bhij,bhj->bhi", g, vf[:, t])
        x["dv"][:, t] += torch.einsum("bhij,bhi->bhj", g, kf[:, t])
        x["dlogw"][:, t] = wf[:, t] * (g * prev[:, t]).sum(-1)
        g = wf[:, t, ..., None] * g + torch.einsum("bhi,bhj->bhij", rf[:, t],
                                                   dof[:, t])
    return g


def _grads(x, r, u, du, g, s0):
    ds0 = None if s0 is None else g.to(s0.dtype)
    return (x["dr"].to(r.dtype), x["dk"].to(r.dtype), x["dv"].to(r.dtype),
            x["dlogw"].to(r.dtype), du.to(u.dtype), ds0)


def rwkv6_wkv_bwd_ref(r, k, v, logw, u, do, s0=None, ds=None):
    """Gradient of :func:`rwkv6_wkv_ref` from its inputs, the output's
    gradient ``do`` (b, s, h, n) and the final state's ``ds`` (b, h, n, n)
    or None (zeros).  The states S_0 .. S_{s-1} before each token are
    recomputed forward first; then, per (row, head), with G = dL/dS_t
    from ``ds``, for t = s-1 .. 0:

        dr_t[i]    = sum_j do_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
        dk_t[i]    = sum_j G[i,j] v_t[j] + u[i] r_t[i] sum_j do_t[j] v_t[j]
        dv_t[j]    = sum_i G[i,j] k_t[i] + do_t[j] sum_i r_t[i] u[i] k_t[i]
        dlogw_t[i] = w_t[i] sum_j G[i,j] S_{t-1}[i,j]
        du[i]     += r_t[i] k_t[i] sum_j do_t[j] v_t[j]   (rows and time)
        G          = diag(w_t) G + r_t do_t^T

    and ds0 = G.  Returns (dr, dk, dv, dlogw, du, ds0): the first four in
    r.dtype, du in u's, ds0 fp32 (None without an s0).  Carried in fp32
    (fp64 for fp64 inputs, so that ``gradcheck`` can run on it)."""
    b, s, h, n = r.shape
    x = _bwd_terms(r, k, v, logw, u, do, s0)
    du = (x["rf"] * x["kf"] * x["dov"]).sum((0, 1))
    g = (torch.zeros((b, h, n, n), dtype=x["acc"], device=r.device)
         if ds is None else ds.to(x["acc"]))
    g = _reverse(x, g, 0, s)
    return _grads(x, r, u, du, g, s0)


def rwkv6_wkv_bwd_split_ref(r, k, v, logw, u, do, s0=None, ds=None, *,
                            segment: int):
    """:func:`rwkv6_wkv_bwd_ref` computed as the CUDA reverse splits it:
    the sequence cut into segments of ``segment`` tokens (whole 32-token
    chunks in the kernel; the last segment may be shorter).

    1. Each segment p >= 1 carries its part of G from zero, L_p = sum_t
       (c_t r_t) do_t^T over its tokens t, with c_t the product of the
       segment's w before t (a running product, forward in time), and its
       decay product D_p = prod w.
    2. Segment p's incoming G is ``ds`` (or zeros) joined with the later
       segments' carries in a fixed order, G <- D_q G + L_q for q = P-1
       down to p+1.  Nothing is divided by a decay.
    3. Each segment runs the reverse from it over its own tokens; du is
       summed per segment, then over the segments in order; segment 0's
       G is ds0.

    The same arithmetic in another order: tests hold it to the serial
    reverse; the main path does not use it.  Returns what
    :func:`rwkv6_wkv_bwd_ref` returns."""
    b, s, h, n = r.shape
    x = _bwd_terms(r, k, v, logw, u, do, s0)
    acc = x["acc"]
    bounds = [(a, min(s, a + segment)) for a in range(0, max(s, 1), segment)]
    carries = [None]
    for lo, hi in bounds[1:]:
        c = torch.ones((b, h, n), dtype=acc, device=r.device)
        lp = torch.zeros((b, h, n, n), dtype=acc, device=r.device)
        for t in range(lo, hi):
            lp = lp + torch.einsum("bhi,bhj->bhij", c * x["rf"][:, t],
                                   x["dof"][:, t])
            c = c * x["wf"][:, t]
        carries.append((lp, c))
    du_seg = []
    g = None
    for p in range(len(bounds) - 1, -1, -1):
        g = (torch.zeros((b, h, n, n), dtype=acc, device=r.device)
             if ds is None else ds.to(acc))
        for lp, dp in carries[:p:-1]:            # segments P-1 .. p+1
            g = dp[..., None] * g + lp
        lo, hi = bounds[p]
        g = _reverse(x, g, lo, hi)
        du_seg.append((x["rf"] * x["kf"] * x["dov"])[:, lo:hi].sum((0, 1)))
    du = torch.zeros((h, n), dtype=acc, device=r.device)
    for part in du_seg[::-1]:                    # segment 0 first
        du = du + part
    return _grads(x, r, u, du, g, s0)
