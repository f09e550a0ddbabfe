"""device_idle_pct.image: the share of the traced window in which no CUDA
kernel ran, 100 * (1 - union of the kernels' intervals / window), in a
cell whose requests are images (or denoised frames)."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
