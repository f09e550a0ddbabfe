"""mc_pack_init_ms: milliseconds of host time an image spends in the scene
pack and the lane init of models/monte_carlo.render_turbo_exact (the
program's spans ``mc.pack`` and ``mc.init`` inside ``mc.render``), summed
over the traced window and divided by its images.  A reading under the
profiler; None where the program records no such span."""

from portbench.work.spans import inside, ms, within


def read(run):
    if run.trace is None or not run.n_traced:
        return None
    renders = within(run.trace, "mc.render")
    phases = inside(within(run.trace, "mc.pack")
                    + within(run.trace, "mc.init"), renders)
    if not phases:
        return None
    return ms(phases) / run.n_traced
