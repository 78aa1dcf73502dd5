"""Model flops of the window's prefills and decode steps over the
window's wall at the bf16 peak, %: the whole serving step's share of
the chip's peak (in a traced run, of the ops and the seconds with no
profiler on)."""
from portbench import flops, readers


def read(run):
    pre = readers.serve_ops(run, "prefill")
    dec = readers.serve_ops(run, "decode")
    if pre is None:
        return None
    dm = run.dims
    f = sum(flops.prefill_flops(dm, s) for op in pre for s in op.lengths)
    f += sum(flops.decode_flops(dm, op.lengths) for op in dec)
    return 100.0 * f / (readers.untraced_seconds(run) * flops.PEAK_BF16)
