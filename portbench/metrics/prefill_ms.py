"""Mean wall time per prefilled request: the window's prefill
operations (each prefills the requests admitted together) over the
requests they prefilled."""
from portbench import readers


def read(run):
    return readers.mean_ms(readers.serve_ops(run, "prefill"),
                           per=lambda op: len(op.lengths))
