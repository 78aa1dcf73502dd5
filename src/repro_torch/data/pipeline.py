"""The port's copy of ``repro.data.pipeline``, unchanged in behaviour
(numpy only; the port imports nothing of the reference package): for a
seed it yields the reference's arrays.  Batches stay numpy on the host;
the train loop moves them to the device inside its step interval.

Input pipeline: synthetic token stream with background prefetch and
Plumber-style bottleneck analysis (paper §5.2, ref [36]).

The pipeline is a chain of named stages (generate -> tokenize-stub ->
batch -> shard).  A background thread keeps a bounded prefetch queue warm;
per-stage wall-times are recorded so `analyze()` can report which stage
bounds throughput and by how much — exactly what Plumber does for tf.data.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineStats:
    stage_time_s: Dict[str, float]
    batches: int
    consumer_wait_s: float
    producer_idle_s: float

    def bottleneck(self) -> Tuple[str, float]:
        """(stage, fraction of total pipeline time)."""
        total = sum(self.stage_time_s.values()) or 1.0
        name = max(self.stage_time_s, key=self.stage_time_s.get)
        return name, self.stage_time_s[name] / total

    def input_bound(self) -> bool:
        """True when the model waits on data (RG loss; paper Fig. 10)."""
        return self.consumer_wait_s > self.producer_idle_s


class DataPipeline:
    """Synthetic causal-LM batches: tokens (batch, seq) int32."""

    def __init__(self, vocab_size: int, batch: int, seq: int,
                 seed: int = 0, prefetch: int = 2,
                 extra_stage_cost_s: float = 0.0,
                 extra_fields: Optional[Dict[str, Tuple[tuple, Any]]] = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.prefetch = prefetch
        self.extra_cost = extra_stage_cost_s
        self.extra_fields = extra_fields or {}
        self._rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stats = {"generate": 0.0, "augment": 0.0, "shard": 0.0}
        self._consumer_wait = 0.0
        self._producer_idle = 0.0
        self._batches = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- stages -----------------------------------------------------------
    def _generate(self) -> Dict[str, np.ndarray]:
        t0 = time.monotonic()
        out = {"tokens": self._rng.integers(
            0, self.vocab, (self.batch, self.seq), dtype=np.int32)}
        for name, (shape, dtype) in self.extra_fields.items():
            out[name] = np.zeros((self.batch, *shape), dtype)
        self._stats["generate"] += time.monotonic() - t0
        return out

    def _augment(self, b):
        t0 = time.monotonic()
        if self.extra_cost:
            time.sleep(self.extra_cost)   # models an expensive transform
        self._stats["augment"] += time.monotonic() - t0
        return b

    def _shard(self, b):
        t0 = time.monotonic()
        # host-side layout pass (device placement happens in the step fn)
        out = {k: np.ascontiguousarray(v) for k, v in b.items()}
        self._stats["shard"] += time.monotonic() - t0
        return out

    # ---- prefetch loop ------------------------------------------------------
    def _producer(self):
        while not self._stop.is_set():
            item = self._shard(self._augment(self._generate()))
            t0 = time.monotonic()
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._producer_idle += time.monotonic() - t0

    def start(self):
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        if self._thread is None:    # synchronous mode
            self._batches += 1
            return self._shard(self._augment(self._generate()))
        t0 = time.monotonic()
        item = self._q.get()
        self._consumer_wait += time.monotonic() - t0
        self._batches += 1
        return item

    # ---- plumber ------------------------------------------------------------
    def analyze(self) -> PipelineStats:
        return PipelineStats(
            stage_time_s=dict(self._stats),
            batches=self._batches,
            consumer_wait_s=self._consumer_wait,
            producer_idle_s=self._producer_idle,
        )
