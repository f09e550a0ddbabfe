"""The least time a kernel's work can take on one NVIDIA H100 SXM (the data
sheet's peaks at the 700 W limit), and the work of the Monte Carlo
engines' kernels counted from what their inputs need.

Frozen copies of the arithmetic in ``chip_smoke.py`` (``mc_ops``,
``bound``, ``render_work``'s bytes), kept here so that a change to the
program cannot change the yardstick."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores, FMA = 2
PEAK_BYTES = 3.35e12        # HBM3


def mc_ops(n_tri: int, n_sph: int, lane_steps: int, shadow_rays: int) -> int:
    """f32 operations a run of the fused MC kernel needs: the main
    intersect (47 per triangle, 28 per sphere) on each live lane-step; the
    shadow test (50 per triangle, 28 per sphere) and 150 of shading, NEE
    and scatter on each lane-step that traced a shadow ray.  A miss's sky,
    the winner's attributes, the regeneration and the integer RNG are not
    counted: a floor."""
    return ((47 * n_tri + 28 * n_sph) * lane_steps
            + (150 + 50 * n_tri + 28 * n_sph) * shadow_rays)


def mc_state_bytes(n_lanes: int, launches: int) -> int:
    """The lane state (15 float and 4 int planes) read and written once a
    launch."""
    return (15 + 4) * 4 * 2 * n_lanes * launches


def bound_s(ops: float, nbytes: float) -> float:
    """Seconds of ``ops`` f32 operations or ``nbytes`` bytes at the peaks,
    whichever takes longer."""
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def mesh_sweep_bytes(n_clusters: int, cluster_size: int, row_floats: int,
                     launches: int, main_rays: int, shadow_rays: int) -> int:
    """Bytes the shortlist sweeps of the fused mesh engine need, counted
    from the scene and the predicate populations alone (the packed rays
    each sweep receives), whatever implements the sweep: the cluster table
    read once a launch; each packed main ray read (o, d: 6 floats) and its
    winner written (t, normal, material: 5 floats); each packed shadow ray
    read (o, d, lim: 7 floats) and its flag written (1 float)."""
    table = n_clusters * cluster_size * row_floats * 4
    return (table * launches + main_rays * (6 + 5) * 4
            + shadow_rays * (7 + 1) * 4)
