"""BVH mesh stage (port of ``cpu_based_ray_tracer_tpu.models.mesh``):
Whitted shading, and the Monte Carlo estimator, over accelerated triangle
meshes.  The renderers are ``models.whitted`` and ``models.monte_carlo``
with the intersector swapped, for every ray including the shadow rays.

Intersectors (all return the same nearest hit):

- ``packet``: the packet-culled kernel (``ops.packet``, csrc/packet.cu on
  the card);
- ``fused``: the shortlist intersector for coherent ray sets
  (``ops.coherent``, csrc/coherent.cu on the card): per-tile exact cluster
  work lists over 32 x 128 pixel tiles, the BVH stage's real-time path;
  its table must fit the JAX package's SMEM budget
  (``ops.fused_mesh.fits_resident``);
- ``brute``: the exact dense scan (``ops.intersect``), fastest below a few
  hundred triangles;
- ``sparse``: the per-lane skip-link BVH walk (``ops.bvh.traverse``), the
  literal translation of the reference's traversal; a correctness oracle,
  plain PyTorch on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo, whitted
from cpu_based_ray_tracer_tpu_torch.ops import bvh as bvh_ops
from cpu_based_ray_tracer_tpu_torch.ops import coherent as coherent_ops
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
from cpu_based_ray_tracer_tpu_torch.ops import intersect
from cpu_based_ray_tracer_tpu_torch.ops import packet as packet_ops
from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device

# Below this many triangles dense brute force beats the packet kernel.
PACKET_MIN_TRIS = 512


@dataclasses.dataclass(frozen=True)
class MeshBundle:
    """A scene and its acceleration structure (built on the host)."""

    scene: Scene
    clusters: Optional[packet_ops.Clusters]  # packet kernel (None: brute)
    method: str                    # "packet" | "brute" | "sparse" | "fused"
    bounds: Optional[tuple] = None           # ((lo xyz), (hi xyz)) floats
    coherent: Optional[coherent_ops.CoherentPack] = None   # fused
    bvh: Optional[bvh_ops.FlatBVH] = None    # sparse: the walked BVH (numpy)
    pv0: Optional[torch.Tensor] = None       # sparse: triangles in leaf order
    pe1: Optional[torch.Tensor] = None
    pe2: Optional[torch.Tensor] = None

    def to(self, device) -> "MeshBundle":
        move = lambda x: None if x is None else x.to(device)  # noqa: E731
        return dataclasses.replace(
            self, scene=self.scene.to(device), clusters=move(self.clusters),
            coherent=move(self.coherent), pv0=move(self.pv0),
            pe1=move(self.pe1), pe2=move(self.pe2))


def _verts(scene: Scene) -> np.ndarray:
    tr = scene.triangles
    v0, e1, e2 = (x.cpu().numpy().astype(np.float64)
                  for x in (tr.v0, tr.e1, tr.e2))
    return np.stack([v0, v0 + e1, v0 + e2], axis=1)


def prepare(scene: Scene, method: str = "auto") -> MeshBundle:
    """Host-side acceleration build over the scene's triangles.  ``auto``
    picks ``packet`` from ``PACKET_MIN_TRIS`` triangles up, else
    ``brute``.  ``packet`` and ``fused`` cluster 128 triangles, ``sparse``
    builds a BVH with leaves of 4.  ``fused`` raises ValueError for a
    table past the SMEM budget (use ``packet``)."""
    n = scene.triangles.count
    if method == "auto":
        method = "packet" if n >= PACKET_MIN_TRIS else "brute"
    if method == "brute":
        return MeshBundle(scene=scene, clusters=None, method="brute")
    if method == "fused":
        pack = coherent_ops.pack_coherent(scene)
        if not fused_mesh.fits_resident(pack.n_clusters, pack.cs):
            raise ValueError(
                "mesh too large for the SMEM-resident fused intersector "
                f"({pack.n_clusters} clusters); use method='packet'")
        return MeshBundle(scene=scene, clusters=None, method="fused",
                          coherent=pack)
    if method == "sparse":
        flat = bvh_ops.build_bvh(_verts(scene))
        order = torch.as_tensor(flat.order.astype(np.int64),
                                device=scene.device)
        tr = scene.triangles
        return MeshBundle(scene=scene, clusters=None, method="sparse",
                          bvh=flat, pv0=tr.v0[order], pe1=tr.e1[order],
                          pe2=tr.e2[order])
    if method != "packet":
        raise ValueError(f"unknown mesh method {method!r}")
    verts = _verts(scene)
    clusters = packet_ops.build_clusters(verts, device=scene.device)
    pts = verts.reshape(-1, 3)
    bounds = (tuple(map(float, pts.min(0))), tuple(map(float, pts.max(0))))
    return MeshBundle(scene=scene, clusters=clusters, method="packet",
                      bounds=bounds)


def _sort_order(bundle: MeshBundle, origin, direction):
    """Coherence-restoring ray order: direction octant, then a 4x4x4 cell
    of the origin over the mesh bounds.  Per-ray results do not depend on
    the order; the clusters the packet kernel stages per block and tests
    per warp do."""
    lo, hi = bundle.bounds
    i32 = torch.int32
    oct_ = ((direction[:, 0] > 0).to(i32) + 2 * (direction[:, 1] > 0).to(i32)
            + 4 * (direction[:, 2] > 0).to(i32))
    cell = 0
    for a in range(3):
        span = max(hi[a] - lo[a], 1e-6)
        cell = cell * 4 + torch.clamp(
            ((origin[:, a] - lo[a]) / torch.tensor(
                span, dtype=origin.dtype, device=origin.device) * 4).to(i32),
            0, 3)
    return torch.argsort(oct_ * 64 + cell, stable=True)


def _packet_nearest(bundle: MeshBundle, origin, direction, t_min,
                    sort_rays: bool):
    if not sort_rays:
        return packet_ops.nearest(bundle.clusters, origin, direction, t_min)
    order = _sort_order(bundle, origin, direction)
    tt_s, idx_s = packet_ops.nearest(bundle.clusters, origin[order],
                                     direction[order], t_min)
    tt = torch.empty_like(tt_s).index_copy_(0, order, tt_s)
    idx = torch.empty_like(idx_s).index_copy_(0, order, idx_s)
    return tt, idx


def _nearest(bundle: MeshBundle, origin, direction, t_min, sort_rays: bool,
             hw):
    """(t, triangle index) through the bundle's accelerated intersector.
    The kernel routes (``packet``, ``fused``) take the rays detached: the
    traversal carries no gradient on any device (their plain versions
    would carry one on the CPU, their kernels none on the card), as the
    JAX package stops gradients before its Pallas kernels.  ``sparse``
    (plain PyTorch everywhere) stays attached, as JAX's ``bvh.traverse``
    route."""
    if bundle.method == "sparse":
        return bvh_ops.traverse(bundle.bvh, bundle.pv0, bundle.pe1,
                                bundle.pe2, origin, direction, t_min)
    origin, direction = origin.detach(), direction.detach()
    if bundle.method == "packet":
        return _packet_nearest(bundle, origin, direction, t_min, sort_rays)
    return coherent_ops.nearest(bundle.coherent, origin, direction,
                                float(t_min), hw=hw)


def make_intersect_fn(bundle: MeshBundle, sort_rays: bool = False, hw=None,
                      differentiable: bool = False):
    """An ``intersect_fn(scene, o, d, t_min) -> Hit`` through the bundle's
    intersector, plus the brute-force sphere pass of ``assemble_hit``.
    ``sort_rays``: reorder the rays for block coherence first (the packet
    kernel, for the incoherent bounce rays of the MC path).  ``hw``: the
    image shape, for the ``fused`` intersector's pixel tiles.

    ``differentiable``: on the packet route, recompute the winner's t
    with the attached ``intersect.moller_trumbore_single`` at the detached
    winner index, so gradients reach the rays and the mesh geometry
    through the accelerated route while the kernel's t feeds nothing
    differentiable (detached traversal, attached shading), as the JAX
    package's packet route.  Its t may differ from the kernel's by
    rounding; one R-row gather more, off on the forward-only paths."""
    if bundle.method in ("packet", "fused", "sparse"):
        recompute = differentiable and bundle.method == "packet"

        def fn(scene, origin, direction, t_min):
            tt, idx = _nearest(bundle, origin, direction, t_min, sort_rays,
                               hw)
            if recompute:
                tr = scene.triangles
                j = torch.clamp(idx, 0, tr.count - 1).long()
                t_rec, _, _ = intersect.moller_trumbore_single(
                    origin, direction,
                    *(vec.take(x, j) for x in (tr.v0, tr.e1, tr.e2)))
                tt = torch.where(idx >= 0, t_rec, intersect.NO_HIT_T)
            return intersect.assemble_hit(scene, origin, direction, tt, idx,
                                          t_min)
        return fn
    return lambda scene, o, d, t_min: intersect.intersect_scene(
        scene, o, d, t_min=t_min)


def make_nearest_t_fn(bundle: MeshBundle, sort_rays: bool = False, hw=None):
    """A ``nearest_t_fn(scene, o, d, t_min) -> t (R,)`` shadow-ray path
    through the bundle's intersector (triangles) and the brute sphere min.
    On the kernel routes the rays are detached, the sphere pass included:
    the hard shadow test only compares this t."""
    if bundle.method in ("packet", "fused"):
        def fn(scene, origin, direction, t_min):
            origin, direction = origin.detach(), direction.detach()
            tt, _ = _nearest(bundle, origin, direction, t_min, sort_rays, hw)
            sp = scene.spheres
            ts = torch.amin(intersect.intersect_spheres(
                origin, direction, sp.center, sp.radius, t_min,
                float("inf")), -1)
            return torch.minimum(tt, ts)
        return fn
    return lambda scene, o, d, t_min: intersect.nearest_t(scene, o, d,
                                                          t_min=t_min)


def make_soft_vis_fn(scene: Scene, gate_mask=None, cap: int | None = None):
    """A ``soft_vis_fn(scene, p, w, dist, t_min, beta, tol) -> (R,)`` for
    mesh scenes: ``intersect.soft_visibility`` with the mesh triangles
    gated behind the beta-inflated mesh AABB (``fused_mesh._slab_crosses``,
    the fused shadow pass's predicate).  The other primitives stay brute
    force for every lane; the mesh triangles' soft coverage runs only on
    the lanes whose shadow segment crosses the box.  The result is the
    brute estimator's up to the sigmoid tail cut at the box (below
    sigmoid(-10) an occluder).

    The box is inflated by ``20 * beta * max(longest edge / sqrt(2A))``
    over the gated triangles: a point of a triangle's plane at distance
    delta from it has a barycentric margin of at most -delta / (2 x the
    longest edge), so a triangle the segment passes at that distance
    covers it by less than sigmoid(-10).  The JAX package inflates by
    ``10 * beta * max(sqrt(2A))``, which holds that bound only for
    triangles of a world unit or more: on the icosphere meshes of
    ``cornell_mesh_scene`` its gated visibility is off the brute one by up
    to 0.11 on lanes that pass near the mesh.

    ``gate_mask``: (N,) bool, True for a mesh triangle (default: the
    non-emissive triangles smaller than 0.15 of the scene's diagonal).
    ``cap``: the most lanes the mesh term takes a call (default all); the
    crossing lanes past the first ``cap`` keep mesh visibility 1."""
    tr0 = scene.triangles
    verts = _verts(scene)
    if gate_mask is None:
        emissive = scene.materials.emissive.cpu().numpy()[
            tr0.material.cpu().numpy()]
        pts = verts.reshape(-1, 3)
        scene_diag = float(np.linalg.norm(pts.max(0) - pts.min(0)))
        tri_diag = np.linalg.norm(verts.max(1) - verts.min(1), axis=-1)
        gate_mask = (tri_diag < 0.15 * scene_diag) & ~emissive
    gate_mask = np.asarray(gate_mask, bool)
    gidx = torch.as_tensor(np.flatnonzero(gate_mask))
    sidx = torch.as_tensor(np.flatnonzero(~gate_mask))
    g = verts[gate_mask]
    glo = torch.tensor(g.reshape(-1, 3).min(0), dtype=torch.float32)
    ghi = torch.tensor(g.reshape(-1, 3).max(0), dtype=torch.float32)
    edges = np.stack([g[:, 1] - g[:, 0], g[:, 2] - g[:, 0],
                      g[:, 2] - g[:, 1]], 1)
    longest = np.linalg.norm(edges, axis=-1).max(-1)
    two_area = np.linalg.norm(np.cross(edges[:, 0], edges[:, 1]), axis=-1)
    reach = float((longest / np.sqrt(np.maximum(two_area, 1e-12))).max())

    def fn(scene_rt, p, w, dist, t_min, beta, tol):
        dev = p.device
        tr, sp = scene_rt.triangles, scene_rt.spheres
        area = tr.area
        si, gi = sidx.to(dev), gidx.to(dev)
        vis = (intersect.soft_visibility_tris(
                   tr.v0[si], tr.e1[si], tr.e2[si], area[si], p, w, dist,
                   t_min, beta, tol)
               * intersect.soft_visibility_spheres(
                   sp.center, sp.radius, p, w, dist, t_min, beta, tol))
        r = p.shape[0]
        pad = 20.0 * beta * reach  # the cut sigmoid tail below e^-10
        pred = fused_mesh._slab_crosses(p, w, (glo - pad).to(dev),
                                        (ghi + pad).to(dev), t_min, dist)
        idx = torch.nonzero(pred).flatten()[:cap or r]
        sub = intersect.soft_visibility_tris(
            tr.v0[gi], tr.e1[gi], tr.e2[gi], area[gi], p[idx], w[idx],
            dist[idx], t_min, beta, tol)
        vis_mesh = torch.ones((r,), dtype=vis.dtype, device=dev)
        vis_mesh[idx] = sub
        return vis * vis_mesh

    return fn


def render(bundle: MeshBundle, camera: cam_mod.PerspectiveCamera,
           cfg: RenderConfig, device=None) -> torch.Tensor:
    """Whitted render of the mesh scene through the bundle's intersector,
    (H, W, 3), on ``device`` (default: the card).  The ``packet`` and
    ``fused`` intersectors take the whole image as one ray set (no
    chunking); ``fused`` tiles 32 x 128 pixel rectangles, with the image
    shape threaded through.  For ``packet`` the whole image was the
    fastest chunk of the Whitted twin: on an NVIDIA H100 (700 W),
    ``bvh_stage_scene()`` at 896x896, depth 5, took 0.0119 s a frame in one
    chunk against 0.0271, 0.0844 and 0.302 s in chunks of 200,704, 65,536
    and 16,384 rays (chip_smoke.py's packet_in_render phase): a chunk runs
    every eager operation of the twin once more, and a small launch leaves
    most of the card idle."""
    dev = resolve_device(device)
    bundle = bundle.to(dev)
    hw = None
    if bundle.method == "fused":
        hw = (cfg.height, cfg.width)
    if bundle.method in ("packet", "fused"):
        cfg = cfg.replace(ray_chunk=cfg.height * cfg.width)
    return whitted.render(bundle.scene, camera, cfg,
                          intersect_fn=make_intersect_fn(bundle, hw=hw),
                          nearest_t_fn=make_nearest_t_fn(bundle, hw=hw),
                          device=dev)


def render_mc(bundle: MeshBundle, camera: cam_mod.PerspectiveCamera,
              cfg: RenderConfig, seed: int, device=None) -> torch.Tensor:
    """Monte Carlo path trace (NEE + RR) through the bundle's intersector
    for every path and shadow ray: the fixed-depth engine, mean linear
    radiance (H, W, 3), on ``device`` (default: the card).  At
    ``cfg.soft_shadow_beta > 0`` the shadow term is brute-force
    ``intersect.soft_visibility``, as in the JAX package."""
    dev = resolve_device(device)
    bundle = bundle.to(dev)
    return monte_carlo.render(
        bundle.scene, camera, cfg, seed, device=dev,
        intersect_fn=make_intersect_fn(bundle, sort_rays=True),
        nearest_t_fn=make_nearest_t_fn(bundle, sort_rays=True))


def wavefront_mc_steps(bundle: MeshBundle, camera, cfg: RenderConfig,
                       seed: int, state: monte_carlo.WavefrontState,
                       n_steps: int) -> monte_carlo.WavefrontState:
    """The persistent-wavefront MC stepper through the bundle's intersector,
    on the device ``state`` lies on (soft shadows as ``render_mc``)."""
    bundle = bundle.to(state.s.device)
    return monte_carlo.wavefront_steps(
        bundle.scene, camera, cfg, seed, state, n_steps,
        intersect_fn=make_intersect_fn(bundle, sort_rays=True),
        nearest_t_fn=make_nearest_t_fn(bundle, sort_rays=True))
