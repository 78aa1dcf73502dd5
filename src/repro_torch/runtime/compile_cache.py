"""Step-preparation cache with compile-time accounting: the port's
``repro.runtime.compile_cache`` (paper §5.2: "compile on cheap hardware,
store, and skip JIT on the accelerators").

The reference lowers and compiles its jitted step ahead of time
(``fn.lower(*args).compile()``).  The port's counterpart of that
executable is the captured train step (``launch.strategy.TrainStep``),
and "compile" is what makes it: loading the kernel library (an ``nvcc``
build through ``repro_torch.kernels._build`` when the on-disk build
cache is cold), the warm-up steps and, on the card, the CUDA graph's
capture.  :class:`AotCache` keeps the ready step per key, so a second
run in the same process with the same key prepares nothing: it gets the
same captured step and loads its own state into it.

The reference's ``enable_persistent_cache`` (XLA's on-disk executable
cache) has no counterpart: a CUDA graph lives in its process.  What
persists across processes is the kernel build cache,
``build/repro_torch_kernels`` in the checkout, keyed by a hash of the
sources.

:class:`CompileClock` records the preparation's wall time per key; the
orchestrator books it as compiler-layer INIT, as the reference does.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable


class CompileClock:
    def __init__(self):
        self.events: Dict[Hashable, Dict[str, float]] = {}

    def record(self, key: Hashable, seconds: float, hit: bool):
        self.events[key] = {"seconds": seconds, "hit": float(hit)}

    @property
    def total_compile_s(self) -> float:
        return sum(e["seconds"] for e in self.events.values())


class AotCache:
    """In-process registry of ready steps with preparation-time
    accounting."""

    def __init__(self):
        self._store: Dict[Hashable, Any] = {}
        self.clock = CompileClock()

    def get_or_compile(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """``build()`` -> the step, ready to run (it loads the kernels,
        warms the step up and captures it).  A key seen before returns the
        same step object and records 0 s with ``hit=True``."""
        if key in self._store:
            self.clock.record(key, 0.0, hit=True)
            return self._store[key]
        t0 = time.monotonic()
        fn = build()
        self.clock.record(key, time.monotonic() - t0, hit=False)
        self._store[key] = fn
        return fn

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store
