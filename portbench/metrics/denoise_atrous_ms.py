"""denoise_atrous_ms: milliseconds of host time a frame spends in the
a-trous filter of ops/denoise.joint_bilateral_atrous (the program's span
``denoise.atrous``: the dispatch of its levels' eager operations), summed
over the traced window and divided by its frames.  A reading under the
profiler; None where the program records no such span."""

from portbench.work.spans import ms, within


def read(run):
    if run.trace is None or not run.n_traced:
        return None
    atrous = within(run.trace, "denoise.atrous")
    if not atrous:
        return None
    return ms(atrous) / run.n_traced
