"""Prompt tokens prefilled and output tokens generated in the window,
over the window (requests still running at its close count their part)."""


def read(run):
    if run.kind != "serve":
        return None
    from portbench.serve import tokens_done

    return tokens_done(run.window) / run.window.seconds
