"""Plain PyTorch version of the grouped expert matmul (the contract of
``repro.kernels.moe_gmm.ref.moe_gmm_ref``): products summed in fp32,
output in x's dtype."""
from __future__ import annotations

import torch


def moe_gmm_ref(x, w):
    """x: (E, C, K), w: (E, K, F) -> (E, C, F) in x.dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
