"""90th percentile, over every request due in the window, of the wall
time from its due time to its first token (a request without one at
the close counts its wait so far); in a traced run, of the waits that
do not overlap the profiled span."""
from portbench import readers


def read(run):
    if run.kind != "serve":
        return None
    from portbench.serve import first_token_waits, percentile

    waits = first_token_waits(run.window, readers.outside_trace(run))
    return 1e3 * percentile(waits, 90) if waits else None
