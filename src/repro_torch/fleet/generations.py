"""The port's copy of the TPU generations of ``repro.core.hardware``
(``TPU_V4``, ``TPU_V5E``, ``TPU_V5P``, ``GENERATIONS``) and its
``DCN_BW_PER_CHIP``, unchanged in value.

These are the *simulated* fleet's inputs: the pods of the fleet
simulator (``repro_torch.fleet.sim``) are TPU pods of these generations,
Program Goodput is weighted by their peak-FLOPS ratios
(``repro_torch.core.goodput.generation_pg_weights``) and an elastic
resize is priced over the cross-pod bandwidth
(``repro_torch.parallel.reshard.reshard_seconds``).  They are copied
from the reference, not measured: nothing the port runs on its card is
described by them.  The card the port runs on is
``repro_torch.core.hardware.H100_SXM``.
"""
from __future__ import annotations

from repro_torch.core.hardware import ChipSpec

TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_bytes=16 * 1024 ** 3,
    ici_link_bw=50e9,
    ici_links=4,
)

# Older / newer generations the heterogeneous-fleet scenarios mix in
# (paper §3.1: the fleet spans several TPU generations at once; per-chip
# peak FLOPS is what Program Goodput normalizes against).
TPU_V4 = ChipSpec(
    name="tpu-v4",
    peak_flops_bf16=275e12,
    hbm_bw=1228e9,
    hbm_bytes=32 * 1024 ** 3,
    ici_link_bw=50e9,
    ici_links=6,
)

TPU_V5P = ChipSpec(
    name="tpu-v5p",
    peak_flops_bf16=459e12,
    hbm_bw=2765e9,
    hbm_bytes=95 * 1024 ** 3,
    ici_link_bw=100e9,
    ici_links=6,
)

GENERATIONS = {c.name: c for c in (TPU_V4, TPU_V5E, TPU_V5P)}

# Cross-pod (DCN) bandwidth per chip — used by the fleet simulator for
# multi-pod gradient all-reduces (pod axis) and elastic resizes.
DCN_BW_PER_CHIP = 6.25e9  # bytes/s
