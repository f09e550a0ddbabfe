"""mc_polls_per_image: the host's reads of the lanes' sample counts in
models/monte_carlo.render_turbo_exact (the program's span ``mc.poll``, one
device round trip each) in the traced window, over its images.  None where
the program records no such span."""

from portbench.work.spans import within


def read(run):
    if run.trace is None or not run.n_traced:
        return None
    polls = within(run.trace, "mc.poll")
    if not polls:
        return None
    return len(polls) / run.n_traced
