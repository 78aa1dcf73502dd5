"""One run of one cell, on whatever device it is given: set-up, the
measured window, the traced sub-window, the metrics, and the check.

``run.py`` looks for the card first and calls :func:`run_cell` on it;
the harness's tests call it on the CPU at small sizes.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, spec, traffic, weights
from portbench.dims import Dims, dims
from portbench.program import DTYPES, model_config, use_src
from portbench.trace import Tracer, warm_profiler

@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    kind: str                    # "train" or "serve"
    dims: Dims
    mix: dict
    seconds: float               # the window's length
    setup_s: float
    window: object               # serve.Window or train.Steps
    tracer: Optional[Tracer] = None
    peak: int = 0                # device memory peak, bytes

    @property
    def trace(self):
        return self.tracer.trace if self.tracer is not None else None


def _trace_span(mix: dict, seconds: float):
    t = mix.get("trace", {})
    start = t.get("start_share", 0.35) * seconds
    return start, start + min(t.get("seconds", 8.0), 0.5 * seconds)


def build_kernels(device) -> None:
    """Every kernel of the program, built into the checkout's build cache
    on a cell's first run there and loaded from it after."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(conf: dict, mix: dict, limits: Dict[str, float], seed: int,
             seconds: float, traced: bool, device,
             t_start: float, readers: Dict[str, Callable]) -> dict:
    """The result of one run, as ``run.py`` prints it (less ``device``'s
    name and count).  ``readers`` maps each metric to report to its
    reader."""
    use_src()
    ref = spec.reference(conf)
    ref.exact_fp32()
    dm = dims(conf)
    cfg = model_config(conf["name"], dm, mix)
    kind = mix["kind"]
    build_kernels(device)
    tracer = None
    if traced:
        warm_profiler()
        tracer = Tracer(*_trace_span(mix, seconds))
    if kind == "train":
        run, readings, attempted = _train(cfg, dm, mix, seed, seconds,
                                          tracer, device, t_start, ref)
    else:
        run, readings, attempted = _serve(cfg, dm, mix, seed, seconds,
                                          tracer, device, t_start, ref)
    correct, checked = check.compare(readings, limits)
    metrics = {}
    for mname, read in readers.items():
        value = read(run)
        if value is not None:
            metrics[mname] = value
    out = {"correct": correct, "attempted": attempted,
           "failed": sum(1 for c in checked.values()
                         if not (c["limit"] is not None
                                 and c["value"] <= c["limit"])),
           "metrics": metrics,
           "device": {"memory_peak_bytes": run.peak}}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
        out["trace_read"] = run.trace.summary()
    out["checked"] = checked
    return out


def _train(cfg, dm, mix, seed, seconds, tracer, device, t_start, ref):
    from portbench.train import TrainBench

    tb = TrainBench(cfg, dm, mix, seed, device)
    setup_s = time.perf_counter() - t_start
    steps = tb.run(seconds, tracer)
    run = Run("train", dm, mix, seconds, setup_s, steps, tracer,
              _peak(device))
    prog = (tb.losses, tb.first_grad, tb.change)
    initial, batches = tb.initial, tb.checked
    tb.free()
    del tb
    _free(device)
    readings = check.train_readings(
        prog, check.reference_steps(initial, batches, dm, ref,
                                    mix["optimizer"]))
    return run, readings, steps.steps


def warm_requests(mix: dict, dm: Dims) -> List[traffic.Request]:
    """Two short requests at the mix's shortest and median stratified
    prompt lengths: the first prefill capture and the decode replays
    run before the window."""
    q = traffic.quantiles(mix["prompt_len"], traffic.BLOCK)
    lens = sorted({int(q.min()), int(q[len(q) // 2])})
    return [traffic.Request(i, 0.0, torch.zeros(n, dtype=torch.int64)
                            .numpy() + (7 + i) % dm.vocab, 4)
            for i, n in enumerate(lens)]


def _serve(cfg, dm, mix, seed, seconds, tracer, device, t_start, ref):
    from portbench.serve import ServeBench, finished

    tree = weights.make(dm, seed, DTYPES[mix["param_dtype"]], device)
    sb = ServeBench(cfg, mix, tree, device)
    sb.warm(warm_requests(mix, dm))
    reqs = traffic.serve_requests(mix, seed, seconds, dm.vocab)
    setup_s = time.perf_counter() - t_start
    win = sb.run(reqs, seconds, tracer)
    run = Run("serve", dm, mix, seconds, setup_s, win, tracer,
              _peak(device))
    done = finished(win)
    del sb
    _free(device)
    readings, _ = check.serve_readings(done, tree, dm, ref, seed,
                                       mix["check"]["served_tokens"])
    return run, readings, sum(1 for r in win.requests
                              if r.t_submit < seconds)
