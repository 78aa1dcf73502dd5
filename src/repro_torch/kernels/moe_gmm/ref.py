"""Plain PyTorch versions of the grouped expert matmul (the contract of
``repro.kernels.moe_gmm.ref.moe_gmm_ref``: products summed in fp32,
output in x's dtype; with ``counts``, output rows from ``counts[e]`` on
are zeros) and of its backward (the transpose of that function)."""
from __future__ import annotations

import torch


def check_counts(x, counts) -> None:
    """Raise unless ``counts`` is None or an (E,) int32 tensor on x's
    device."""
    if counts is None:
        return
    if (counts.dtype != torch.int32 or tuple(counts.shape) != (x.shape[0],)
            or counts.device != x.device):
        raise ValueError(
            f"moe_gmm: counts must be an ({x.shape[0]},) int32 tensor on "
            f"{x.device}, got {tuple(counts.shape)} {counts.dtype} on "
            f"{counts.device}")


def moe_gmm_ref(x, w, counts=None):
    """x: (E, C, K), w: (E, K, F) -> (E, C, F) in x.dtype; ``counts``
    (E,) int32 zeroes rows [counts[e], C) of expert e's output."""
    check_counts(x, counts)
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
    if counts is not None:
        out = out.masked_fill(_past(x, counts), 0)
    return out


def moe_gmm_bwd_ref(x, w, dy, counts=None):
    """x: (E, C, K), w: (E, K, F), dy: (E, C, F) -> (dx (E, C, K) in
    x.dtype, dw (E, K, F) in w.dtype): dx[e] = dy[e] @ w[e]^T and dw[e] =
    x[e]^T @ dy[e], einsums in fp32.  With ``counts``, rows of dy from
    counts[e] on are dropped first (the forward wrote them as zeros), so
    those rows of dx are zeros and those of x add nothing to dw."""
    check_counts(x, counts)
    dyf = dy.float()
    if counts is not None:
        dyf = dyf.masked_fill(_past(x, counts), 0)
    dx = torch.einsum("ecf,ekf->eck", dyf, w.float()).to(x.dtype)
    dw = torch.einsum("eck,ecf->ekf", x.float(), dyf).to(w.dtype)
    return dx, dw


def _past(x, counts):
    """(E, C, 1) bool: rows at or past each expert's count."""
    rows = torch.arange(x.shape[1], device=x.device)
    return (rows[None, :] >= counts[:, None])[..., None]
