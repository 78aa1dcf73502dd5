"""Tokens of every train step of the window over the window, which runs
to the end of its last step."""


def read(run):
    if run.kind != "train" or not run.window.steps:
        return None
    w = run.window
    return w.steps * w.tokens_per_step / w.seconds
