"""The port's copy of ``repro.core.goodput``, unchanged in behaviour (the port
imports nothing of the reference package).

ML Productivity Goodput (paper §4): the metric itself.

    MPG = Scheduling Goodput x Runtime Goodput x Program Goodput

    SG = all-allocated chip-time          / fleet capacity chip-time
    RG = checkpointed productive chip-time / all-allocated chip-time
    PG = ideal (compute-roofline) time    / actual execution time

The accounting is event-based: jobs emit intervals tagged with a phase
(the paper's Figure 5/11 timeline) and the metric is computed by summing
chip-time per phase.  Work done between the last checkpoint and a failure
or preemption is NOT productive (paper §4.3, Runtime Goodput definition).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterable, Optional


class Phase(enum.Enum):
    """What a job's chips were doing during an interval."""
    QUEUED = "queued"                # waiting for all-allocation (counts against SG)
    PARTIAL = "partial"              # some but not all chips allocated (SG loss)
    INIT = "init"                    # program load/compile/connect (RG loss)
    STEP = "step"                    # productive compute (subject to checkpoint survival)
    CHECKPOINT = "checkpoint"        # synchronous checkpoint write (RG loss)
    DATA_STALL = "data_stall"        # input-pipeline stall (RG loss)
    LOST = "lost"                    # rolled-back work after failure/preemption
    IDLE = "idle"                    # allocated but idle (RG loss)
    SLO_BREACH = "slo_breach"        # serving: decode past the latency SLO
                                     # (allocated, compute ran, but the token
                                     # missed its deadline — an RG loss the
                                     # batching/admission policy is
                                     # responsible for)
    RESHARD = "reshard"              # elastic resize: moving checkpointed
                                     # shards between the old and new
                                     # partition assignments (RG loss)
    CONTROL = "control"              # adaptive-controller overhead: the
                                     # orchestration cost of a live policy
                                     # switch, charged to the scheduling
                                     # layer so closing the loop is itself
                                     # visible in the waterfall (RG loss)


class Layer(enum.Enum):
    """Which stack layer is *responsible* for an interval (paper §3/§6).

    The paper's central diagnostic move is attributing lost goodput to a
    layer of the ML system stack, not just to a timeline phase: the same
    LOST second is a hardware problem after a chip failure but a
    scheduling problem after a preemption.  Every emitter
    (``fleet.sim`` / ``runtime.orchestrator`` / ``launch.serve``) tags
    its intervals with the responsible layer via ``segment["layer"]``;
    the emitting subsystem itself is tagged separately as
    ``segment["emitter"]`` (fleet / runtime / serve — trace provenance).
    """
    MODEL = "model"                  # the program's own compute
    DATA = "data"                    # input pipeline
    FRAMEWORK = "framework"          # runtime/framework (ckpt, multi-client)
    COMPILER = "compiler"            # JIT/AOT compilation
    SCHEDULING = "scheduling"        # placement, preemption, batching
    HARDWARE = "hardware"            # failures, slow generations


# the layer held responsible for a phase when the emitter did not say
# (legacy streams, hand-built test intervals)
DEFAULT_LAYER: Dict[Phase, Layer] = {
    Phase.QUEUED: Layer.SCHEDULING,
    Phase.PARTIAL: Layer.SCHEDULING,
    Phase.INIT: Layer.FRAMEWORK,
    Phase.STEP: Layer.MODEL,
    Phase.CHECKPOINT: Layer.FRAMEWORK,
    Phase.DATA_STALL: Layer.DATA,
    Phase.LOST: Layer.HARDWARE,
    Phase.IDLE: Layer.SCHEDULING,
    Phase.SLO_BREACH: Layer.SCHEDULING,
    Phase.RESHARD: Layer.SCHEDULING,
    Phase.CONTROL: Layer.SCHEDULING,
}

# (Phase, Layer) -> named loss bucket: the rows of the attribution
# waterfall (repro.core.attribution).  One phase splits into different
# buckets by responsible layer — LOST is a failure rollback on the
# hardware layer but a preemption rollback on the scheduling layer.
LOSS_BUCKETS: Dict[tuple, str] = {
    (Phase.QUEUED, Layer.SCHEDULING): "queue_wait",
    (Phase.PARTIAL, Layer.SCHEDULING): "allocation_wait",
    (Phase.INIT, Layer.COMPILER): "compile",
    (Phase.INIT, Layer.FRAMEWORK): "program_setup",
    (Phase.INIT, Layer.SCHEDULING): "migration_restart",
    (Phase.INIT, Layer.MODEL): "warmup",
    (Phase.CHECKPOINT, Layer.FRAMEWORK): "checkpoint_write",
    (Phase.DATA_STALL, Layer.DATA): "input_stall",
    (Phase.LOST, Layer.HARDWARE): "failure_rollback",
    (Phase.LOST, Layer.SCHEDULING): "preemption_rollback",
    (Phase.IDLE, Layer.SCHEDULING): "batch_bubble",
    (Phase.IDLE, Layer.FRAMEWORK): "host_idle",
    # healthy gang slices holding their allocation while a rigid job
    # waits for a replacement slice after a hardware failure
    (Phase.IDLE, Layer.HARDWARE): "gang_stall",
    (Phase.SLO_BREACH, Layer.SCHEDULING): "slo_breach",
    (Phase.RESHARD, Layer.SCHEDULING): "reshard_transfer",
    (Phase.CONTROL, Layer.SCHEDULING): "policy_switch",
}


def layer_of(segment: Dict[str, str], phase: Phase) -> Layer:
    """The responsible layer of an interval: its ``segment["layer"]`` tag
    when present and valid, else the phase's default layer."""
    tag = segment.get("layer")
    if tag is not None:
        try:
            return Layer(tag)
        except ValueError:
            pass                      # legacy emitter tags ("fleet", ...)
    return DEFAULT_LAYER[phase]


def loss_bucket(phase: Phase, layer: Layer) -> Optional[str]:
    """Waterfall bucket for a (phase, layer) cell; ``None`` for STEP
    (productive time is not a loss).  Unmapped combinations fall back to
    the phase's default-layer bucket name, so arbitrary streams still
    land in a named bucket."""
    if phase in PRODUCTIVE_PHASES:
        return None
    return LOSS_BUCKETS.get((phase, layer),
                            LOSS_BUCKETS[(phase, DEFAULT_LAYER[phase])])


@dataclasses.dataclass(frozen=True)
class Interval:
    """A [t0, t1) span of one job on `chips` chips."""
    job_id: str
    phase: Phase
    t0: float
    t1: float
    chips: int
    segment: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def chip_time(self) -> float:
        return max(0.0, self.t1 - self.t0) * self.chips


ALLOCATED_PHASES = {Phase.INIT, Phase.STEP, Phase.CHECKPOINT,
                    Phase.DATA_STALL, Phase.LOST, Phase.IDLE,
                    Phase.SLO_BREACH, Phase.RESHARD, Phase.CONTROL}
PRODUCTIVE_PHASES = {Phase.STEP}


@dataclasses.dataclass
class GoodputReport:
    sg: float
    rg: float
    pg: float
    capacity_chip_time: float
    allocated_chip_time: float
    productive_chip_time: float
    ideal_chip_time: float

    @property
    def mpg(self) -> float:
        return self.sg * self.rg * self.pg

    def as_dict(self) -> Dict[str, float]:
        return {"SG": self.sg, "RG": self.rg, "PG": self.pg, "MPG": self.mpg}


def _ledger_over(intervals: Iterable[Interval],
                 pg_by_job: Optional[Dict[str, float]] = None):
    """Feed an interval stream into a throwaway streaming ledger.

    The batch API is kept as a compatibility veneer; the single source of
    accounting truth is ``repro_torch.core.ledger.GoodputLedger`` (imported
    lazily — ledger.py imports this module's types at load time).
    """
    from repro_torch.core.ledger import GoodputLedger

    led = GoodputLedger(retain_intervals=False, window=0.0)
    led.extend(intervals, pg_by_job=pg_by_job)
    return led


def compute_goodput(intervals: Iterable[Interval],
                    capacity_chip_time: float,
                    pg_by_job: Optional[Dict[str, float]] = None
                    ) -> GoodputReport:
    """Compose MPG from an interval log.

    ``pg_by_job`` maps job -> Program Goodput (ideal/actual step time, from
    the roofline model or measured step times); productive chip-time is
    weighted by it to yield the fleet PG.
    """
    return _ledger_over(intervals, pg_by_job).report(capacity_chip_time)


# ---------------------------------------------------------------------------
# Segmentation (paper §5: disaggregate to find bottlenecks; avoids
# Simpson's-paradox traps by keeping per-segment denominators)
# ---------------------------------------------------------------------------

def segment_goodput(intervals: Iterable[Interval],
                    key: str,
                    capacity_by_segment: Dict[str, float],
                    pg_by_job: Optional[Dict[str, float]] = None
                    ) -> Dict[str, GoodputReport]:
    """Per-segment MPG, segmenting on an interval tag (e.g. 'phase_kind',
    'arch', 'size_class', 'framework', 'chip')."""
    tagged = (iv if key in iv.segment else
              dataclasses.replace(iv, segment={**iv.segment, key: "unknown"})
              for iv in intervals)
    return _ledger_over(tagged, pg_by_job).segment_report(key,
                                                          capacity_by_segment)


def rg_breakdown(intervals: Iterable[Interval]) -> Dict[str, float]:
    """Where allocated-but-unproductive chip-time goes (paper Fig. 10)."""
    return _ledger_over(intervals).rg_breakdown()
