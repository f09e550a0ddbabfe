"""setup_s: from the start of the process to the start of the first timed
request: imports, the kernels' build (on a checkout's first run), the
scene, the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
