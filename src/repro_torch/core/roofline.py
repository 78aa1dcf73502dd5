"""Three-term roofline analysis (the reference's ``repro.core.roofline``,
unchanged in behaviour; the chip defaults to the H100):

    compute term    = counted FLOPs / (chips * peak_FLOP/s)
    memory term     = counted bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

The counted FLOPs and bytes come from ``repro_torch.core.costref`` (the
port's plain step counted on ``meta`` tensors, extrapolated exactly in
layers, batch and seq).  On one device the collective term is zero.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.flops import model_flops
from repro_torch.core.hardware import H100_SXM, ChipSpec
from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # total, all chips
    hlo_bytes: float           # total, all chips
    collective_bytes_per_chip: float
    model_flops: float
    chip: ChipSpec = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.chip.peak_flops_bf16)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self.chip.ici_link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_ideal(self) -> float:
        """Paper PG numerator: MODEL_FLOPS at peak."""
        return self.model_flops / (self.chips * self.chip.peak_flops_bf16)

    @property
    def t_lower_bound(self) -> float:
        """Best case: perfect compute/memory/collective overlap."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_no_overlap(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: fraction of the compute that is
        'useful' (catches remat recompute, masked-attention waste,
        dispatch overhead)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def pg_optimistic(self) -> float:
        return self.t_ideal / self.t_lower_bound if self.t_lower_bound else 0.0

    @property
    def pg_pessimistic(self) -> float:
        return self.t_ideal / self.t_no_overlap if self.t_no_overlap else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "pg_overlap": self.pg_optimistic,
            "pg_no_overlap": self.pg_pessimistic,
        }


def make_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str,
              chips: int, hlo_flops: float, hlo_bytes: float,
              collective_bytes_per_chip: float) -> RooflineCell:
    return RooflineCell(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes_per_chip=collective_bytes_per_chip,
        model_flops=model_flops(cfg, shape))


def fit_poly_and_eval(xs, ys, x_target: float, degree: int = 2) -> float:
    """Exact polynomial cost extrapolation (costs are polynomial in
    batch/seq by construction)."""
    import numpy as np

    degree = min(degree, len(xs) - 1)
    coef = np.polyfit(np.asarray(xs, float), np.asarray(ys, float), degree)
    return float(np.polyval(coef, x_target))
