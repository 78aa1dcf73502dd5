"""Mean wall time from a request's due time to its admission by the
engine, over every request due in the window (one not admitted by the
close counts its wait so far); in a traced run, of the waits that do
not overlap the profiled span."""
from portbench import readers


def read(run):
    if run.kind != "serve":
        return None
    w = run.window
    keep = readers.outside_trace(run)
    waits = []
    for r in w.requests:
        if r.t_submit >= w.seconds:
            continue
        end = min(r.t_admit, w.seconds) if r.token_times else w.seconds
        if keep(r.t_submit, end):
            waits.append(end - r.t_submit)
    return 1e3 * sum(waits) / len(waits) if waits else None
