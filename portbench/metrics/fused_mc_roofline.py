"""fused_mc_roofline: the least time of the work the traced images
need, over the time of the csrc/fused_mc.cu launches that did it, in %.

The work is counted by the plain reference (its full-image paths of the
checked requests: the live lane-steps and the lane-steps that traced a
shadow ray, the mean over those requests) with the frozen mc_ops; the
bytes are the lane state read and written once a launch.  The peaks are
an H100 SXM's at 700 W (the card's limit is in the result's "card")."""

from portbench.work.bounds import bound_s, mc_ops, mc_state_bytes


def _is_kernel(name: str) -> bool:
    return "fused_mc" in name


def read(run):
    w = getattr(run.driver, "work", None)
    if run.trace is None or not w or not run.n_traced:
        return None
    k_s = run.trace.kernel_s(_is_kernel)
    if k_s <= 0.0:
        return None
    ops = mc_ops(w["n_tri"], 0, w["lane_steps"], w["shadow_rays"])
    nbytes = mc_state_bytes(w["n_lanes"], run.trace.count(_is_kernel))
    return 100.0 * bound_s(ops * run.n_traced, nbytes) / k_s
