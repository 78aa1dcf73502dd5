"""The whole prefill's share of the bf16 peak: model flops of the
prefilled prompts (the stack over every token, causal attention, the
head at the last position) over the prefill operations' wall time, %."""
from portbench import flops, readers


def read(run):
    ops = readers.serve_ops(run, "prefill")
    if not ops:
        return None
    f = sum(flops.prefill_flops(run.dims, s) for op in ops for s in op.lengths)
    wall = sum(op.t1 - op.t0 for op in ops)
    return 100.0 * f / (wall * flops.PEAK_BF16)
