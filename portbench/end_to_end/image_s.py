"""image_s: seconds of the window over the images (or denoised frames)
finished in it; the window ends at the first completion after --seconds,
so no image is cut off."""


def read(run):
    return run.window_s / len(run.latencies)
