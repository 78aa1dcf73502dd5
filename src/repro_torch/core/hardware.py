"""Target-hardware constants for the roofline terms: the card the port
runs on (the reference's ``repro.core.hardware`` holds its TPU
generations; the port keeps the ``ChipSpec`` fields and
``ideal_step_time`` and states the H100 alone).  The TPU generations of
the simulated fleet are ``repro_torch.fleet.generations``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float      # FLOP/s per chip
    hbm_bw: float               # bytes/s
    hbm_bytes: float            # capacity
    ici_link_bw: float          # bytes/s per link (one direction)
    ici_links: int              # links per chip


# NVIDIA H100 SXM5 80 GB, data sheet: 989 TFLOP/s dense bf16 on the
# tensor cores, 3.35 TB/s of HBM3, 80 GiB; NVLink 4 is 18 links of 25
# GB/s each way (900 GB/s both ways in all)
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=80 * 1024 ** 3,
    ici_link_bw=25e9,
    ici_links=18,
)

GENERATIONS = {c.name: c for c in (H100_SXM,)}


def ideal_step_time(model_flops: float, chips: int,
                    chip: ChipSpec = H100_SXM) -> float:
    """The paper's Program-Goodput numerator: intrinsic FLOPs at peak."""
    return model_flops / (chips * chip.peak_flops_bf16)
