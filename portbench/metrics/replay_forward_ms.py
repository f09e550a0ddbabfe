"""replay_forward_ms: milliseconds of host time a gradient step spends in
the replay forward of models/monte_carlo.render_from_trace (the program's
span ``mc.replay.forward``: the dispatch of the forward's operations; its
recomputation in the backward lies outside), summed over the traced window
and divided by its steps.  A reading under the profiler; None where the
program records no such span."""

from portbench.work.spans import ms, within


def read(run):
    if run.trace is None or not run.n_traced:
        return None
    forward = within(run.trace, "mc.replay.forward")
    if not forward:
        return None
    return ms(forward) / run.n_traced
