"""mesh_resident_sweep_roofline: the least time of the work the grouped
resident sweeps of csrc/fused_mesh.cu need (nearest and occlusion), over
the time of their launches in the traced window (the sweeps and the three
grouping kernels before each), in %.

The work is counted from the scene and from the predicate populations
that ops.fused_mesh.TRACE records for each resident chunk (the packed main
and shadow rays), as the resident route fixes it whatever implements the
sweep: each packed ray's slab test of every cluster's box (SLAB_OPS f32
operations, chip_smoke's count), and the bytes of work.bounds.
mesh_sweep_bytes (the cluster table once a launch, two launches a bounce
step, each packed ray read and its result written once); the bound is the
longer of the two at the card's peaks.  The triangle tests are not
counted: how many a ray makes depends on the sweep's cull, so this is a
floor well under the sweeps' limiting work.  Chunks that overflowed their
caps and ran again are waste and count no work.  None where no chunk was
resident, as in a program whose TRACE does not say."""

import math

from portbench.work.bounds import bound_s, mesh_sweep_bytes

ROW_FLOATS = 16
SLAB_OPS = 22               # one ray/cluster-box slab test
KERNELS = ("sweep_kernel", "group_key_kernel", "group_scan_kernel",
           "group_scatter_kernel")


def _is_resident_sweep(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(run):
    chunks = getattr(run.driver, "chunks", None)
    if run.trace is None or not chunks:
        return None
    main = shadow = steps = 0
    resident = False
    for req in chunks[run.first_traced:run.first_traced + run.n_traced]:
        for ch in req:
            if not ch.get("resident", False):
                continue
            resident = True
            if ch["overflow"] == 0:
                main += ch["npred"][0]
                shadow += ch["npred"][1]
                steps += ch["steps"]
    if not resident:
        return None
    k_s = run.trace.kernel_s(_is_resident_sweep)
    if k_s <= 0.0:
        return None
    cs = run.ctx.config["cluster_size"]
    clusters = math.ceil(run.driver.mesh_tris / cs)
    ops = (main + shadow) * clusters * SLAB_OPS
    nbytes = mesh_sweep_bytes(clusters, cs, ROW_FLOATS, 2 * steps, main,
                              shadow)
    return 100.0 * bound_s(ops, nbytes) / k_s
