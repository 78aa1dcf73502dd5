"""Plain PyTorch version of the grouped expert matmul (the contract of
``repro.kernels.moe_gmm.ref.moe_gmm_ref``): products summed in fp32,
output in x's dtype; with ``counts``, output rows from ``counts[e]`` on
are zeros."""
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
        rows = torch.arange(x.shape[1], device=x.device)
        out = out.masked_fill((rows[None, :] >= counts[:, None])[..., None],
                              0)
    return out
