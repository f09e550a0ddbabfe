"""mesh_sweep_roofline: the least time of the bytes the shortlist
sweeps of csrc/fused_mesh.cu need (nearest and occlusion), over the time of
their launches in the traced window, in %.

The bytes are counted from the scene and from the predicate populations
that ops.fused_mesh.TRACE records for each chunk (the packed main and
shadow rays, the same whatever implements the sweep): the cluster table
once a launch, two launches a bounce step, and each packed ray read and
its result written once (work.bounds.mesh_sweep_bytes).  Chunks that
overflowed their caps and ran again are waste and count no work."""

import math

from portbench.work.bounds import PEAK_BYTES, mesh_sweep_bytes

ROW_FLOATS = 16


def _is_sweep(name: str) -> bool:
    return "sweep_kernel" in name


def read(run):
    chunks = getattr(run.driver, "chunks", None)
    if run.trace is None or not chunks:
        return None
    k_s = run.trace.kernel_s(_is_sweep)
    if k_s <= 0.0:
        return None
    main = shadow = steps = 0
    for req in chunks[run.first_traced:run.first_traced + run.n_traced]:
        for ch in req:
            if ch["overflow"] == 0:
                main += ch["npred"][0]
                shadow += ch["npred"][1]
                steps += ch["steps"]
    cs = run.ctx.config["cluster_size"]
    clusters = math.ceil(run.driver.mesh_tris / cs)
    nbytes = mesh_sweep_bytes(clusters, cs, ROW_FLOATS, 2 * steps, main,
                              shadow)
    return 100.0 * (nbytes / PEAK_BYTES) / k_s
