"""mesh_group_dispatch_ms: milliseconds of host time a request spends
dispatching the resident sweeps' grouping in ops/fused_mesh (the program's
span ``fused_mesh.group``: the grouping's allocations and its launch of
three kernels, two a bounce step), summed over the traced window and
divided by its requests.  A reading under the profiler; None where the
program records no such span."""

from portbench.work.spans import ms, within


def read(run):
    if run.trace is None or not run.n_traced:
        return None
    groups = within(run.trace, "fused_mesh.group")
    if not groups:
        return None
    return ms(groups) / run.n_traced
