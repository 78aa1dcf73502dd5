"""The train step's model flops (6 N_active tokens + 12 L b hq hd
pairs, ``flops.train_model_flops``) of every step of the window over
the window, at the bf16 peak, %; in a traced run, of the steps that
ran with no profiler on over their own time."""
from portbench import flops


def read(run):
    if run.kind != "train" or not run.window.steps:
        return None
    w = run.window
    f = flops.train_model_flops(run.dims, run.mix["batch"], run.mix["seq"])
    if run.tracer is None:
        return 100.0 * f * w.steps / (w.seconds * flops.PEAK_BF16)
    spans = [s for s in w.spans if run.tracer.outside(*s)]
    if not spans:
        return None
    wall = sum(t1 - t0 for t0, t1 in spans)
    return 100.0 * f * len(spans) / (wall * flops.PEAK_BF16)
