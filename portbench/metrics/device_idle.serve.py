"""% of the traced span of serving in which nothing ran on the device."""
from portbench import readers


def read(run):
    return readers.device_idle(run, "serve")
