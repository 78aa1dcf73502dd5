"""What the metric files share: the window's operations, walls and
counts, and the device trace's reading.  A reader returns None where its
run has nothing for it to read (another kind of cell, no trace)."""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from portbench import flops

MS = 1e3


def serve_ops(run, kind: str, traced: bool = False) -> Optional[list]:
    """The window's whole operations of ``kind`` ("prefill", "decode"):
    with ``traced`` those inside the traced span, else those that ran
    with no profiler on (all of them in an untraced run).  None for a
    training run, or where the span is asked for and there is none."""
    if run.kind != "serve":
        return None
    from portbench.serve import in_window

    ops = [op for op in in_window(run.window) if op.kind == kind]
    if traced:
        if run.trace is None:
            return None
        return [op for op in ops if run.tracer.inside(op.t0, op.t1)]
    if run.tracer is None:
        return ops
    return [op for op in ops if run.tracer.outside(op.t0, op.t1)]


def outside_trace(run) -> Callable:
    """``keep(t0, t1)``: whether a span of the window ran with no profiler
    on (every span of an untraced run)."""
    if run.tracer is None:
        return lambda t0, t1: True
    return run.tracer.outside


def untraced_seconds(run) -> float:
    """The window's seconds with no profiler on."""
    t = run.tracer
    if t is None or t.t0 is None:
        return run.window.seconds
    return run.window.seconds - (min(t.t_resumed, run.window.seconds) - t.t0)


def mean_ms(ops: Sequence, per: Callable = lambda op: 1) -> Optional[float]:
    """Wall ms of the operations over their count (or ``per`` of each)."""
    n = sum(per(op) for op in ops or ())
    if not n:
        return None
    return MS * sum(op.t1 - op.t0 for op in ops) / n


def device_idle(run, kind: str) -> Optional[float]:
    """% of the traced span in which nothing ran on the device."""
    if run.kind != kind or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def roofline(run, bound_s: float, kernels: Sequence[str]) -> Optional[float]:
    """% of the kernels' device time that their work's bound takes: the
    work is counted from the operations' shapes, whatever kernels ran."""
    if run.trace is None or bound_s <= 0:
        return None
    t = run.trace.kernel_s(kernels)
    return 100.0 * bound_s / t if t > 0 else None


def first_sight_share(run) -> Optional[float]:
    if run.kind != "serve" or not run.window.prefills:
        return None
    return 100.0 * run.window.captures / run.window.prefills


def train_spans_in_trace(run) -> Optional[List]:
    if run.kind != "train" or run.trace is None:
        return None
    return [s for s in run.window.spans if run.tracer.inside(*s)]


def moe_layers(dm) -> int:
    return dm.layers - dm.first_dense if dm.moe else 0


def gmm_launch_s(dm, assignments: float, experts: float, k_in: int,
                 k_out: int, backward: bool = False) -> float:
    """The bound of one grouped product of ``assignments`` rows through
    ``experts`` experts' (k_in, k_out) matrices, bf16: forward 2 A k_in
    k_out flops, reading x and w and writing y; the backward's dX and dW
    together 4 A k_in k_out, reading x, w and dy and writing dx and dw."""
    f = 2.0 * assignments * k_in * k_out
    b = flops.BF16 * (assignments * (k_in + k_out) + experts * k_in * k_out)
    if backward:
        f *= 2.0
        b += flops.BF16 * (assignments * k_in + experts * k_in * k_out)
    return flops.bound_s(f, b)


def gmm_products_s(dm, assignments: float, experts: float,
                   backward: bool = False) -> float:
    """The three expert products (wi, wg: d -> f; wo: f -> d)."""
    return (2.0 * gmm_launch_s(dm, assignments, experts, dm.d, dm.ff,
                               backward)
            + gmm_launch_s(dm, assignments, experts, dm.ff, dm.d, backward))
