"""The port's ``repro.runtime.checkpoint``: the same protocol, crash
points and on-disk layout over trees of tensors.  Leaves are flattened
in sorted-key order, as ``jax.tree.flatten`` orders them, so
``arr_%05d.npy`` holds the same leaf in both packages and a checkpoint
the port writes restores in the reference's manager to the same arrays
(bf16 leaves are written as fp32 arrays, exactly, and cast back on
restore).  Restored leaves land on the example state's device.

Checkpointing: atomic commit protocol + async (double-buffered) writes.

Paper §5.2: synchronous checkpoint writes stall the accelerators (RG loss);
async checkpointing snapshots device state quickly and persists it from a
background thread.  The manager implements:

  * write-tmp -> fsync -> rename -> manifest commit (a torn write can never
    be mistaken for a valid checkpoint — restore reads the manifest only);
  * async mode: device->host snapshot on the caller thread (the only
    device pause), disk serialization on a worker thread;
  * keep-last-k GC, never deleting the newest committed step;
  * restore() returns (state, step) from the newest *readable* committed
    manifest — a corrupted or truncated manifest (or a torn array file
    behind a committed-looking directory) is skipped, falling back to the
    previous committed step instead of raising;
  * start_restore()/finish_restore(): the disk read streams on a worker
    thread so restore overlaps program setup (compile + param init);
  * an optional :class:`FaultInjector` crashes at named protocol points,
    letting tests prove a kill mid-write or mid-restore never surfaces a
    torn checkpoint.

Storage layout:  <dir>/step_<n>/arr_<i>.npy + manifest.json (committed last).
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

PyTree = Any


def _to_host(x) -> np.ndarray:
    """A copy of one leaf in host memory (never a view of a live tensor,
    which an async write would race with); bf16 as fp32."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().to("cpu", copy=True).numpy()


class SimulatedCrash(RuntimeError):
    """Raised by a FaultInjector at its configured protocol point."""


class FaultInjector:
    """Deterministic kill switch for checkpoint fault-injection tests.

    ``crash_at`` names a protocol point (``"after_arrays"`` — arrays on
    disk, manifest not yet written; ``"before_commit"`` — manifest in the
    tmp dir, rename pending; ``"mid_restore"`` — manifest parsed, array
    reads pending) and ``skip`` lets the first N hits through, so "kill
    the K-th checkpoint write" is expressible."""

    POINTS = ("after_arrays", "before_commit", "mid_restore")

    def __init__(self, crash_at: str, skip: int = 0):
        if crash_at not in self.POINTS:
            raise ValueError(f"unknown crash point {crash_at!r}; "
                             f"choose from {self.POINTS}")
        self.crash_at = crash_at
        self.skip = skip
        self.hits = 0

    def __call__(self, point: str) -> None:
        if point != self.crash_at:
            return
        self.hits += 1
        if self.hits > self.skip:
            raise SimulatedCrash(f"injected crash at {point}")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_mode: bool = False,
                 fault_injector: Optional[Callable[[str], None]] = None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_mode = async_mode
        self._fault = fault_injector or (lambda point: None)
        self._pool = ThreadPoolExecutor(max_workers=1) if async_mode else None
        self._pending: Optional[Future] = None
        self.metrics: Dict[str, float] = {
            "device_pause_s": 0.0, "write_s": 0.0, "n_saves": 0}

    # ------------------------------------------------------------------
    def save(self, state: PyTree, step: int) -> None:
        """Checkpoint `state` at `step`; async mode returns immediately
        after the host snapshot (device pause ~ copy time only)."""
        t0 = time.monotonic()
        leaves, _ = flatten(state)
        host = [_to_host(x) for x in leaves]        # device -> host snapshot
        pause = time.monotonic() - t0
        self.metrics["device_pause_s"] += pause
        self.metrics["n_saves"] += 1

        if self.async_mode:
            self.wait()                             # one outstanding write
            self._pending = self._pool.submit(self._write, host, step)
        else:
            self._write(host, step)

    def wait(self) -> None:
        """Block until the outstanding async write (if any) is committed."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, host: List[np.ndarray], step: int) -> None:
        t0 = time.monotonic()
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, arr in enumerate(host):
            np.save(tmp / f"arr_{i:05d}.npy", arr, allow_pickle=False)
        self._fault("after_arrays")
        manifest = {"step": step, "n_arrays": len(host),
                    "time": time.time()}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        self._fault("before_commit")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                           # atomic commit
        self.metrics["write_s"] += time.monotonic() - t0
        self._gc()

    # ------------------------------------------------------------------
    def committed_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def _read_step(self, step: int) -> Optional[Tuple[List[np.ndarray], int]]:
        """Host arrays of one committed step, or None when the manifest
        (or an array behind it) is corrupt/truncated — a torn checkpoint
        must fall back, never raise."""
        d = self.dir / f"step_{step:010d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
            self._fault("mid_restore")
            loaded = [np.load(d / f"arr_{i:05d}.npy", allow_pickle=False)
                      for i in range(int(manifest["n_arrays"]))]
        except SimulatedCrash:
            raise                        # the injected kill, not corruption
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return loaded, step

    def _read_newest(self) -> Optional[Tuple[List[np.ndarray], int]]:
        for step in reversed(self.committed_steps()):
            got = self._read_step(step)
            if got is not None:
                return got
        return None

    @staticmethod
    def _assemble(got: Optional[Tuple[List[np.ndarray], int]],
                  example_state: PyTree) -> Tuple[Optional[PyTree], int]:
        if got is None:
            return None, -1
        loaded, step = got
        leaves, structure = flatten(example_state)
        if len(loaded) != len(leaves):
            raise ValueError(f"state layout changed: {len(loaded)} arrays "
                             f"on disk, {len(leaves)} leaves in the example")
        restored = [torch.from_numpy(a).to(device=l.device, dtype=l.dtype)
                    if isinstance(l, torch.Tensor) else a
                    for a, l in zip(loaded, leaves)]
        return unflatten(structure, restored), step

    def restore(self, example_state: PyTree) -> Tuple[Optional[PyTree], int]:
        """Load the newest readable committed checkpoint into
        example_state's structure; returns (state, step) or (None, -1)."""
        return self._assemble(self._read_newest(), example_state)

    # -- streaming restore (overlaps program setup) --------------------
    def start_restore(self) -> Future:
        """Begin reading the newest committed checkpoint from storage on
        a worker thread; the caller overlaps compile/param-init and joins
        via :meth:`finish_restore`."""
        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(self._timed_read)
        pool.shutdown(wait=False)
        return fut

    def _timed_read(self):
        t0 = time.monotonic()
        got = self._read_newest()
        return got, time.monotonic() - t0

    def finish_restore(self, fut: Future, example_state: PyTree
                       ) -> Tuple[Optional[PyTree], int, Dict[str, float]]:
        """Join a :meth:`start_restore` read and assemble the state.

        The stats dict carries the overlap accounting: ``read_s`` is the
        full storage-read time, ``exposed_s`` how long this join actually
        blocked, ``overlap_s`` the read time hidden behind setup work —
        the measured INIT reduction of the async restore."""
        t0 = time.monotonic()
        got, read_s = fut.result()
        exposed = time.monotonic() - t0
        state, step = self._assemble(got, example_state)
        return state, step, {"read_s": read_s, "exposed_s": exposed,
                             "overlap_s": max(0.0, read_s - exposed)}

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
