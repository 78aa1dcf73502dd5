"""The port's training orchestrator (``repro.runtime.orchestrator``): the
runtime layer of the stack (paper §3.3), instrumented so every second of
chip time lands in an MPG Interval ledger.  It runs on CUDA unless
``RunConfig.device`` asks for the CPU, and trains the dense, MoE,
hybrid and ssm families: its pipeline yields tokens only, as the
reference's, so the step refuses the batch of an enc-dec or vlm config,
which also needs ``frames`` / ``patches`` (``ValueError``).

The same emissions, layers and segments as the reference's: INIT split
into the compiler layer (the compile clock's seconds: here the step's
preparation, see ``runtime/compile_cache.py``) and the framework layer,
STEP per step, CHECKPOINT per save, DATA_STALL from the pipeline's
measured consumer wait, LOST for the rolled-back steps in the layer of
the failure's kind.  The step is ``launch.strategy.TrainStep``, one
captured CUDA graph on the card over a static state that each step
updates in place (the reference's jit with the state donated); the run
copies its starting state, example or restored, into that state and
each batch into its static batch.  Unlike the reference, the example
state is drawn before the step is prepared: it is the static state's
template.

Responsibilities: program setup (AOT cache), data feeding (prefetch
pipeline), stepping, checkpoint creation (sync or async), preemption/
failure recovery (restart resumes from the newest committed checkpoint and
books the rolled-back work as LOST — the paper's RG definition).
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.goodput import Interval, Layer, Phase
from repro_torch.core.ledger import GoodputLedger
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.compile_cache import AotCache


@dataclasses.dataclass
class RunConfig:
    steps: int = 50
    batch: int = 4
    seq: int = 64
    checkpoint_every: int = 10
    async_checkpoint: bool = False
    # None: a fresh temporary directory per Orchestrator
    ckpt_dir: Optional[str] = None
    keep: int = 3
    preempt_at_step: Optional[int] = None   # simulate a mid-run kill
    # what the kill is: "preemption" books the rollback to the scheduling
    # layer, "hardware" (a chip failure) to the hardware layer — the
    # attribution waterfall must show the loss in the right row
    failure_kind: str = "preemption"
    # stream the checkpoint restore on a worker thread while compile and
    # param-init proceed; the hidden read time is reported in the summary
    async_restore: bool = True
    job_id: str = "job0"
    chips: int = 1
    # torch device of the run: None is CUDA (raises without a card);
    # the CPU must be asked for by name
    device: Optional[str] = None

    def __post_init__(self):
        if self.failure_kind not in ("preemption", "hardware"):
            raise ValueError(f"failure_kind must be 'preemption' or "
                             f"'hardware', got {self.failure_kind!r}")


class Orchestrator:
    def __init__(self, cfg: ModelConfig, run: RunConfig,
                 aot: Optional[AotCache] = None,
                 ledger: Optional[GoodputLedger] = None,
                 keep_intervals: bool = True):
        self.cfg = cfg
        self.run_cfg = run
        self.device = resolve_device(run.device)
        self.aot = aot or AotCache()
        # accounting streams into a GoodputLedger — pass a shared one to
        # fold this run into fleet-wide MPG alongside sim/serve emitters.
        # keep_intervals=False keeps long attribution runs O(1) memory
        # (ignored for an injected ledger; its retention setting wins).
        self.ledger = ledger if ledger is not None else GoodputLedger(
            retain_intervals=keep_intervals)
        self.ckpt_dir = run.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
        self.ckpt = CheckpointManager(self.ckpt_dir, keep=run.keep,
                                      async_mode=run.async_checkpoint)
        self.state = None
        self.train_step = None      # the run's TrainStep, from the AOT cache
        self.step_times: List[float] = []

    @property
    def intervals(self) -> List[Interval]:
        """The raw event stream (requires a retaining ledger)."""
        if self.ledger.intervals is None:
            raise AttributeError("interval retention is off on this ledger; "
                                 "use the streaming ledger reports instead")
        return self.ledger.intervals

    # ------------------------------------------------------------------
    def _emit(self, phase: Phase, t0: float, t1: float, layer: Layer,
              extra: Optional[Dict[str, str]] = None):
        r = self.run_cfg
        self.ledger.emit(
            job_id=r.job_id, phase=phase, t0=t0, t1=t1, chips=r.chips,
            segment={"arch": self.cfg.name, "phase_kind": "train",
                     "ckpt": "async" if r.async_checkpoint else "sync",
                     "emitter": "runtime", "layer": layer.value,
                     **(extra or {})})

    # ------------------------------------------------------------------
    def _build(self, example):
        """The ready ``TrainStep`` from the AOT cache: on a miss, one over
        a static state shaped like ``example`` (its warm-ups load the
        kernels, and on the card it is captured); a hit returns the step
        an earlier run built, whose state the caller then loads."""
        from repro_torch.launch.strategy import TrainStep

        cfg, r = self.cfg, self.run_cfg
        key = (cfg.name, r.batch, r.seq, "train")
        return self.aot.get_or_compile(key, lambda: TrainStep(
            cfg, AdamWConfig(lr=1e-3), example, r.batch, r.seq))

    def _init_state(self):
        from repro_torch.launch.strategy import init_train_state

        gen = torch.Generator(device=self.device).manual_seed(0)
        return init_train_state(self.cfg, gen, self.device)

    # ------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        """Run (or resume) the job; returns summary metrics."""
        r = self.run_cfg
        t_init0 = time.monotonic()
        # async restore: the checkpoint read streams from storage while
        # compile + param-init run; only the non-overlapped remainder
        # extends INIT (the measured reduction lands in the summary)
        restore_fut = self.ckpt.start_restore() if r.async_restore else None
        example = self._init_state()
        compile_before = self.aot.clock.total_compile_s
        compiled = self._build(example)
        # the compile portion of setup is the compiler layer's chip-time;
        # a warm AOT cache records 0s here and the whole INIT shifts to
        # the framework layer — the attribution move fig14 quantifies
        compile_s = self.aot.clock.total_compile_s - compile_before
        t_compiled = t_init0 + compile_s
        if restore_fut is not None:
            restored, ckpt_step, restore_stats = \
                self.ckpt.finish_restore(restore_fut, example)
        else:
            t_r0 = time.monotonic()
            restored, ckpt_step = self.ckpt.restore(example)
            read_s = time.monotonic() - t_r0
            restore_stats = {"read_s": read_s, "exposed_s": read_s,
                             "overlap_s": 0.0}
        start_step = ckpt_step + 1 if restored is not None else 0
        compiled.load_state(restored if restored is not None else example)
        self.train_step, self.state = compiled, compiled.state
        del example, restored      # the static state holds their values
        pipeline = DataPipeline(self.cfg.vocab_size, r.batch, r.seq,
                                seed=start_step).start()
        t_init1 = time.monotonic()
        if compile_s > 0:
            self._emit(Phase.INIT, t_init0, t_compiled,
                       layer=Layer.COMPILER, extra={"cache": "miss"})
        else:
            t_compiled = t_init0
        self._emit(Phase.INIT, t_compiled, t_init1, layer=Layer.FRAMEWORK,
                   extra={"cache": "hit" if compile_s == 0 else "miss"})

        last_ckpt_step = start_step - 1
        losses = []
        preempted = False
        step = start_step
        try:
            for step in range(start_step, r.steps):
                if r.preempt_at_step is not None and step == r.preempt_at_step:
                    preempted = True
                    break
                batch = next(pipeline)   # wait accounted via pipeline stats
                t1 = time.monotonic()
                metrics = compiled({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
                loss = float(metrics["loss"])    # waits for the device
                t2 = time.monotonic()
                self._emit(Phase.STEP, t1, t2, layer=Layer.MODEL)
                self.step_times.append(t2 - t1)
                losses.append(loss)
                if (step + 1) % r.checkpoint_every == 0:
                    t3 = time.monotonic()
                    self.ckpt.save(self.state, step)
                    t4 = time.monotonic()
                    self._emit(Phase.CHECKPOINT, t3, t4,
                               layer=Layer.FRAMEWORK)
                    last_ckpt_step = step
        finally:
            pipeline.stop()

        # data-layer stall time from *measured* pipeline stats (Plumber-
        # style, paper §5.2) rather than a per-batch wall-clock heuristic:
        # the consumer-wait total is the chip-time the model spent waiting
        # on input, and the bottleneck stage names the culprit.  Like the
        # LOST rollback below it is a synthetic interval appended after
        # the loop; ``t_cursor`` keeps the two from overlapping (which
        # would over-fill the ledger's time windows).
        t_cursor = time.monotonic()
        pstats = pipeline.analyze()
        if pstats.consumer_wait_s > 0:
            stage, share = pstats.bottleneck()
            self._emit(Phase.DATA_STALL, t_cursor,
                       t_cursor + pstats.consumer_wait_s,
                       layer=Layer.DATA,
                       extra={"stage": stage,
                              "input_bound":
                                  "yes" if pstats.input_bound() else "no"})
            t_cursor += pstats.consumer_wait_s

        if preempted:
            # roll back: work after the last committed checkpoint is LOST
            lost_steps = step - 1 - last_ckpt_step
            if lost_steps > 0 and self.step_times:
                avg = float(np.mean(self.step_times))
                # the rollback's layer follows the kill's cause: a chip
                # failure is a hardware loss, a preemption a scheduling one
                lost_layer = (Layer.HARDWARE if r.failure_kind == "hardware"
                              else Layer.SCHEDULING)
                self._emit(Phase.LOST, t_cursor,
                           t_cursor + lost_steps * avg,
                           layer=lost_layer,
                           extra={"kind": r.failure_kind})
        else:
            self.ckpt.save(self.state, r.steps - 1)
            self.ckpt.wait()
        self.ckpt.wait()

        stage, share = pstats.bottleneck()
        return {
            "start_step": start_step,
            "end_step": step if preempted else r.steps,
            "preempted": preempted,
            "losses": losses,
            "ckpt_metrics": dict(self.ckpt.metrics),
            # restore-overlap accounting: read_s spent streaming from
            # storage, overlap_s of it hidden behind compile/param-init
            # (the INIT-phase reduction), exposed_s the serial remainder
            "restore": dict(restore_stats),
            "compile_s": self.aot.clock.total_compile_s,
            "data": {"bottleneck_stage": stage,
                     "bottleneck_share": share,
                     "input_bound": pstats.input_bound(),
                     "consumer_wait_s": pstats.consumer_wait_s},
        }
