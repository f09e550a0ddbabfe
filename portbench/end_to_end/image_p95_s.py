"""image_p95_s: the 95th percentile of the latency of every image (or
denoised frame) of the window (host clock, each request ending in a
device synchronise)."""

from portbench.common import percentile


def read(run):
    return percentile(run.latencies, 95.0)
