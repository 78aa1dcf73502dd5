"""The whole decode step's share of its bound: each decode operation's
bound (the larger of its live rows' model flops at the bf16 peak and
the weights it reads plus the live rows' KV at the HBM rate) over the
operations' wall time, %."""
from portbench import flops, readers


def read(run):
    ops = readers.serve_ops(run, "decode")
    if not ops:
        return None
    width = run.mix["engine"]["n_slots"]
    bound = sum(flops.decode_bound_s(run.dims, op.lengths, width)
                for op in ops)
    return 100.0 * bound / sum(op.t1 - op.t0 for op in ops)
