"""The port's copy of ``repro.fleet.workload``, unchanged in behaviour
(the port imports nothing of the reference package).

Workload generators: parameterized job populations matching the paper's
qualitative fleet shapes (Fig. 4 size-mix drift; train/serve/bulk phases;
per-arch Program Goodput from the roofline table when available).

The port's roofline table is its own (``ROOFLINE_TABLE``, under
``build/``), never the reference's TPU-priced ``results/roofline``; the
caller of ``build_sim`` passes a ``pg_table`` (the H100's measured PG,
say) explicitly."""
from __future__ import annotations

import json
import pathlib
import random
from typing import Callable, Dict, List, Optional

from repro_torch.fleet.job import JobSpec

ROOFLINE_TABLE = (pathlib.Path(__file__).resolve().parents[3] / "build"
                  / "roofline_torch" / "table.json")

# the reference registry's order (``repro.configs.ARCH_IDS``, which the
# port's ``configs.ARCH_IDS`` lists in another order): each job's
# ``rng.choice`` of its arch depends on it
ARCH_IDS = (
    "mixtral-8x7b",
    "deepseek-moe-16b",
    "recurrentgemma-2b",
    "smollm-135m",
    "qwen2.5-14b",
    "qwen2-72b",
    "granite-3-8b",
    "rwkv6-3b",
    "llava-next-mistral-7b",
    "whisper-medium",
)

# chip-count choices per size class (powers of two: torus slices)
SIZE_CHIPS = {
    "small": [1, 2, 4, 8],
    "medium": [16, 32, 64],
    "large": [128, 256],
    "xl": [512, 1024],
}

# paper Fig. 4: the XL share grows over the year; these are the endpoints.
SIZE_MIX_EARLY = {"small": 0.45, "medium": 0.35, "large": 0.15, "xl": 0.05}
SIZE_MIX_LATE = {"small": 0.30, "medium": 0.30, "large": 0.22, "xl": 0.18}

PHASE_MIX = {"train": 0.55, "serve": 0.30, "bulk_inference": 0.15}


def roofline_pg_table() -> Dict[str, float]:
    """Per-arch PG seeds from the port's roofline table (if present):
    rows of ``arch``, ``shape`` and ``pg_overlap``, the ``train_4k``
    ones read."""
    out: Dict[str, float] = {}
    tbl = ROOFLINE_TABLE
    if tbl.exists():
        for row in json.loads(tbl.read_text()):
            if row.get("shape") == "train_4k":
                out[row["arch"]] = max(0.05, min(0.95, row.get("pg_overlap", 0.4)))
    return out


def make_warp(intensity: Callable[[float], float], span: float,
              grid: int = 512) -> Callable[[float], float]:
    """Build ``u -> t`` mapping uniform draws in [0, span) onto an
    inhomogeneous arrival process with the given intensity profile, by
    inverting the normalized cumulative intensity on a fixed grid (built
    once here; each call is just a binary search + interpolation).

    Deterministic (no rng draws): scenario arrival modulation warps the
    *same* uniform stream the default workload consumes, so switching a
    modulation on cannot perturb any other seeded random stream — the
    determinism contract the trace record/replay tests rely on.
    """
    dt = span / grid if span > 0 else 0.0
    cum = [0.0]
    for i in range(grid):
        cum.append(cum[-1] + max(0.0, intensity((i + 0.5) * dt)) * dt)
    total = cum[-1]

    def warp(u: float) -> float:
        if span <= 0:
            return 0.0
        if total <= 0.0:
            return u
        target = (u / span) * total
        # binary search the bracketing grid cell, interpolate linearly
        lo, hi = 0, grid
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if cum[mid] <= target:
                lo = mid
            else:
                hi = mid
        cell = cum[lo + 1] - cum[lo]
        frac = (target - cum[lo]) / cell if cell > 0 else 0.0
        return min(span, (lo + frac) * dt)

    return warp


def warp_times(u: float, intensity: Callable[[float], float], span: float,
               grid: int = 512) -> float:
    """One-shot convenience over :func:`make_warp` (grid rebuilt per call —
    prefer ``make_warp`` inside loops)."""
    return make_warp(intensity, span, grid)(u)


def _pick(rng: random.Random, mix: Dict[str, float]) -> str:
    r = rng.random()
    acc = 0.0
    for k, v in mix.items():
        acc += v
        if r <= acc:
            return k
    return k  # noqa: B023 — last key


def generate_jobs(n_jobs: int, horizon: float, seed: int = 0,
                  size_mix: Optional[Dict[str, float]] = None,
                  async_checkpoint: bool = False,
                  compile_cache: bool = False,
                  framework_mix: float = 0.7,
                  pg_table: Optional[Dict[str, float]] = None,
                  capacity_chips: Optional[int] = None,
                  target_load: float = 0.70,
                  arrival_profile: Optional[Callable[[float], float]] = None
                  ) -> List[JobSpec]:
    """Poisson arrivals over [0, 0.8*horizon) with the given size mix.

    When ``capacity_chips`` is given, per-job work is rescaled so aggregate
    demand is ``target_load`` of fleet capacity — production fleets run
    below saturation (headroom for priority jobs, paper §3.2), and SG>95%
    (Fig. 16) is only achievable in that regime.

    ``arrival_profile`` is an intensity function over absolute sim time
    (diurnal/bursty load, ``repro_torch.fleet.scenarios``): uniform
    arrival draws are warped through its inverse CDF, leaving every other
    random choice (sizes, archs, work, ...) byte-identical to the
    unmodulated workload.
    """
    rng = random.Random(seed)
    pg_table = pg_table if pg_table is not None else roofline_pg_table()
    jobs: List[JobSpec] = []
    for i in range(n_jobs):
        sc = _pick(rng, size_mix or SIZE_MIX_EARLY)
        chips = rng.choice(SIZE_CHIPS[sc])
        phase = _pick(rng, PHASE_MIX)
        arch = rng.choice(ARCH_IDS)
        # work sized so jobs run hours-to-days
        wall_target = rng.uniform(2, 30) * 3600 * (0.5 if sc == "small" else 1)
        work = wall_target * chips
        fw = "jax-pathways" if rng.random() < framework_mix else "multi-client"
        jobs.append(JobSpec(
            job_id=f"job{i:05d}",
            chips=chips,
            work=work,
            phase_kind=phase,
            arch=arch,
            priority={"small": 1, "medium": 1, "large": 2, "xl": 3}[sc]
            + (1 if phase == "serve" else 0),
            framework=fw,
            checkpoint_interval=rng.uniform(300, 900),
            checkpoint_write=rng.uniform(15, 60) * (chips / 64) ** 0.5,
            async_checkpoint=async_checkpoint,
            compile_cache_hit=compile_cache,
            init_time=rng.uniform(60, 240) * (1 + 0.3 * (chips > 256)),
            data_stall_frac=rng.uniform(0.01, 0.08),
            pg=pg_table.get(arch, rng.uniform(0.25, 0.6)),
            elastic=(phase == "train" and sc in ("medium", "large")),
            # mid-size training jobs run as 2-slice gangs (multi-slice over
            # DCN): a slice failure degrades/refills instead of killing the
            # job.  Deterministic rule — no rng draw, so the stream stays
            # byte-identical to pre-gang workloads.
            n_slices=2 if (phase == "train" and 32 <= chips <= 256) else 1,
            arrival=rng.uniform(0, 0.8 * horizon),
        ))
    if arrival_profile is not None:
        warp = make_warp(arrival_profile, 0.8 * horizon)
        jobs = [dataclasses_replace(j, arrival=warp(j.arrival))
                for j in jobs]
    if capacity_chips is not None:
        demand = sum(j.work for j in jobs)
        cap = capacity_chips * horizon * target_load
        scale = cap / demand if demand > 0 else 1.0
        jobs = [dataclasses_replace_work(j, j.work * scale) for j in jobs]
    return jobs


def dataclasses_replace(j: JobSpec, **kw) -> JobSpec:
    import dataclasses

    return dataclasses.replace(j, **kw)


def dataclasses_replace_work(j: JobSpec, work: float) -> JobSpec:
    return dataclasses_replace(j, work=work)
