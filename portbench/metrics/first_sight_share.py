"""Prefill graphs captured in the window over requests prefilled in it
(the program's ``PrefillGraphs.stats()`` and executor counts), %."""
from portbench import readers


def read(run):
    return readers.first_sight_share(run)
