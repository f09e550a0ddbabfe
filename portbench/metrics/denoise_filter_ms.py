"""denoise_filter_ms: milliseconds of models/denoiser.denoise_frame (the
a-trous filter and the temporal pass) a frame, inside the window's own
``render_frame`` calls: the mean over the frames of a traced run before
its profiled part, each timed by two CUDA events around the call (the
device's time from the G-buffer's last operation to the filters' last)."""


def read(run):
    spans = run.driver.filter_seconds(0, run.first_traced)
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
