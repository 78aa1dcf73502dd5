"""Device selection for the port's entry points.

The port is written for the GPU.  An entry point that was not asked for
the CPU runs on CUDA, and raises when there is none: it never carries on
silently on the host, so a number it reports is always from the device
it names.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA.  Raises ``RuntimeError`` for a CUDA device
    when ``torch.cuda.is_available()`` is false; ``"cpu"`` must be asked
    for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to "
            "run the port on the host")
    return dev
