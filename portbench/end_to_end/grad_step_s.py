"""grad_step_s: seconds of the window over the Adam steps finished in it."""


def read(run):
    return run.window_s / len(run.latencies)
