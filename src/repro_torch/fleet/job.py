"""The port's copy of ``repro.fleet.job``, unchanged in behaviour (the
port imports nothing of the reference package).

Job model: what the fleet runs.

Jobs reference the assigned architectures — their Program Goodput comes
from the dry-run roofline table, closing the loop between the compiled
artifacts and the fleet metric (paper Fig. 10's per-workload breakdown).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

SIZE_CLASSES = ("small", "medium", "large", "xl")


def size_class(chips: int, pod_size: int = 256) -> str:
    if chips <= 8:
        return "small"
    if chips <= 64:
        return "medium"
    if chips <= pod_size:
        return "large"
    return "xl"


@dataclasses.dataclass
class JobSpec:
    job_id: str
    chips: int
    # productive work still to do, in chip-seconds
    work: float
    phase_kind: str = "train"          # train | serve | bulk_inference
    arch: str = "smollm-135m"
    priority: int = 1                  # higher preempts lower
    framework: str = "jax-pathways"    # jax-pathways | multi-client
    checkpoint_interval: float = 600.0     # seconds between checkpoints
    checkpoint_write: float = 30.0         # sync write cost (seconds)
    async_checkpoint: bool = False         # paper §5.2 optimization
    compile_cache_hit: bool = False        # AOT cache (paper §5.2)
    init_time: float = 120.0               # cold program setup + compile
    data_stall_frac: float = 0.03          # input-pipeline stall fraction
    pg: float = 0.45                       # Program Goodput of its program
    elastic: bool = False
    n_slices: int = 1                      # gang width: independent slices
    arrival: float = 0.0

    def __post_init__(self):
        # a zero-chip or negative-work spec silently corrupts ledger
        # totals (chip_time factors `chips`; remaining starts at `work`)
        if self.chips < 1:
            raise ValueError(f"{self.job_id}: chips must be >= 1, "
                             f"got {self.chips}")
        if self.work <= 0:
            raise ValueError(f"{self.job_id}: work must be > 0, "
                             f"got {self.work}")
        if self.checkpoint_interval <= 0:
            raise ValueError(f"{self.job_id}: checkpoint_interval must be "
                             f"> 0, got {self.checkpoint_interval}")
        if self.n_slices < 1:
            raise ValueError(f"{self.job_id}: n_slices must be >= 1, "
                             f"got {self.n_slices}")
        if self.chips % self.n_slices:
            raise ValueError(f"{self.job_id}: chips ({self.chips}) must "
                             f"divide evenly into n_slices "
                             f"({self.n_slices}) equal slices")

    @property
    def slice_chips(self) -> int:
        """Chips per gang slice (== chips for single-slice jobs)."""
        return self.chips // self.n_slices

    @property
    def size_class(self) -> str:
        # memoized per instance: specs only change via dataclasses.replace
        # (a fresh instance), and this sits on the scheduler's hot path
        sc = self.__dict__.get("_size_class")
        if sc is None:
            sc = self.__dict__["_size_class"] = size_class(self.chips)
        return sc

    def effective_init(self) -> float:
        init = self.init_time
        if self.compile_cache_hit:
            init *= 0.35               # AOT cache skips JIT compile
        if self.framework == "multi-client":
            init *= 1.6                # per-host connect/compile fan-out
        return init

    def effective_stall(self) -> float:
        stall = self.data_stall_frac
        if self.framework == "multi-client":
            stall *= 1.5
        if self.phase_kind == "bulk_inference":
            stall *= 2.0               # sharded weight reads (paper Fig 15)
        if self.phase_kind == "serve":
            stall += 0.10              # demand-trough idle (paper Fig 15)
        return stall


@dataclasses.dataclass
class JobRuntime:
    """Mutable scheduler-side state of a job."""
    spec: JobSpec
    remaining: float = 0.0             # chip-seconds of work left
    checkpointed: float = 0.0          # chip-seconds safely persisted
    since_checkpoint: float = 0.0      # productive chip-s since last ckpt
    started: Optional[float] = None    # current allocation start
    preemptions: int = 0
    failures: int = 0
    target_chips: int = 0              # submitted width (regrow target)
    target_slices: int = 0             # submitted gang width
    last_chips: int = 0                # width of the last run segment
                                       # (0 until first scheduled; a width
                                       # change on restart pays a reshard)

    def __post_init__(self):
        if self.remaining == 0.0:
            self.remaining = self.spec.work
        if self.target_chips == 0:
            self.target_chips = self.spec.chips
        if self.target_slices == 0:
            self.target_slices = self.spec.n_slices
