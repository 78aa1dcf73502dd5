"""99th percentile of every gap between two consecutive output tokens
of a request, both in the window, on the wall clock; in a traced run,
of the gaps that do not overlap the profiled span."""
from portbench import readers


def read(run):
    if run.kind != "serve":
        return None
    from portbench.serve import percentile, token_gaps

    gaps = token_gaps(run.window, readers.outside_trace(run))
    return 1e3 * percentile(gaps, 99) if gaps else None
