"""Mean wall time of a decode operation (one replay of the decode graph
over every slot, its inputs' copies and the tokens' read-back)."""
from portbench import readers


def read(run):
    return readers.mean_ms(readers.serve_ops(run, "decode"))
