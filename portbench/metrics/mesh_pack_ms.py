"""mesh_pack_ms: milliseconds of host time a request spends packing the
mesh scene in ops/fused_mesh._drive (the program's span
``fused_mesh.pack`` around ``pack_mesh_scene``), summed over the traced
window and divided by its requests.  A reading under the profiler; None
where the program records no such span."""

from portbench.work.spans import ms, within


def read(run):
    if run.trace is None or not run.n_traced:
        return None
    packs = within(run.trace, "fused_mesh.pack")
    if not packs:
        return None
    return ms(packs) / run.n_traced
