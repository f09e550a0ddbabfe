"""Batched ray-primitive intersection (port of
``cpu_based_ray_tracer_tpu.ops.intersect``).

A dense (R rays x N primitives) t-matrix reduced with min/argmin, then the
hit attributes recomputed per ray from the winning index.  Material and
attribute lookups use tensor indexing (the JAX package's one-hot gathers in
``ops/gather.py`` work around the TPU's matrix unit and are not ported).

Gradients: the winner indices are discrete, the recomputed t, point,
normal and uv are differentiable functions of the gathered primitive data
and of the ray.  ``hit_from_record`` rebuilds a Hit from a recorded winner
alone, through per-lane twins of the t-matrix producers
(``triangle_t_single``, ``sphere_t_single``) that repeat their operations
one for one, so a recorded winner's t is bit equal to its matrix entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.scene import Scene

INF = float("inf")
NO_HIT_T = float(np.finfo(np.float32).max)  # "no hit" sentinel
_DET_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Hit:
    """Hit record over a batch of rays.  ``geom_normal`` is the outward unit
    geometric normal; ``front`` is True when the ray arrived from the side it
    points to; ``uv`` is the barycentric texture coordinate (0 on spheres)."""

    t: torch.Tensor            # (R,) distance, NO_HIT_T when miss
    hit: torch.Tensor          # (R,) bool
    is_triangle: torch.Tensor  # (R,) bool (False: sphere)
    prim: torch.Tensor         # (R,) i32 primitive index within its SoA
    material: torch.Tensor     # (R,) i32 material id
    point: torch.Tensor        # (R, 3) hit location
    geom_normal: torch.Tensor  # (R, 3)
    front: torch.Tensor        # (R,) bool
    uv: torch.Tensor           # (R, 2) interpolated texture coords

    @property
    def facing_normal(self) -> torch.Tensor:
        """Normal flipped to oppose the incident ray."""
        return torch.where(self.front[..., None], self.geom_normal,
                           -self.geom_normal)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def intersect_spheres(origin, direction, centers, radii, t_min, t_max):
    """Ray-sphere t-matrix (R, S), NO_HIT_T for miss; half-b quadratic with
    near-then-far root selection."""
    oc = origin[:, None, :] - centers[None, :, :]                  # (R, S, 3)
    d = direction
    a = _dot3(d[:, 0], d[:, 1], d[:, 2], d[:, 0], d[:, 1], d[:, 2])[:, None]
    dd = d[:, None, :]
    half_b = _dot3(oc[..., 0], oc[..., 1], oc[..., 2],
                   dd[..., 0], dd[..., 1], dd[..., 2])              # (R, S)
    c = (_dot3(oc[..., 0], oc[..., 1], oc[..., 2],
               oc[..., 0], oc[..., 1], oc[..., 2])
         - (radii * radii)[None, :])
    disc = half_b * half_b - a * c
    ok = disc > 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    t_near = (-half_b - sq) / a
    t_far = (-half_b + sq) / a
    near_ok = ok & (t_near > t_min) & (t_near < t_max)
    far_ok = ok & (t_far > t_min) & (t_far < t_max)
    return torch.where(near_ok, t_near,
                       torch.where(far_ok, t_far, NO_HIT_T))


def triangle_t_matrix(origin, direction, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore t-matrix (R, N), NO_HIT_T on miss; accept iff t, b1,
    b2, 1 - b1 - b2 >= 0 and t > t_min; degenerate triangles never hit."""
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]    # (R, 1)
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]  # (1, N)
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    det = _dot3(s1x, s1y, s1z, e1x, e1y, e1z)
    ok_det = torch.abs(det) > _DET_EPS
    inv_det = 1.0 / torch.where(ok_det, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    t = _dot3(s2x, s2y, s2z, e2x, e2y, e2z) * inv_det
    b1 = _dot3(s1x, s1y, s1z, sx, sy, sz) * inv_det
    b2 = _dot3(s2x, s2y, s2z, dx, dy, dz) * inv_det
    ok = (ok_det & (t > t_min) & (t < t_max)
          & (b1 >= 0.0) & (b2 >= 0.0) & (1.0 - b1 - b2 >= 0.0))
    return torch.where(ok, t, NO_HIT_T)


def moller_trumbore_single(origin, direction, v0, e1, e2):
    """Moller-Trumbore for one (ray, triangle) pair per lane, all inputs
    (R, 3): (t, b1, b2), each (R,).  Degenerate triangles give garbage that
    callers mask."""
    s1 = vec.cross(direction, e2)
    det = vec.dot(s1, e1)[:, 0]
    ok_det = torch.abs(det) > _DET_EPS
    inv_det = 1.0 / torch.where(ok_det, det, 1.0)
    s = origin - v0
    s2 = vec.cross(s, e1)
    t = vec.dot(s2, e2)[:, 0] * inv_det
    b1 = vec.dot(s1, s)[:, 0] * inv_det
    b2 = vec.dot(s2, direction)[:, 0] * inv_det
    return t, b1, b2


def nearest_triangle(scene: Scene, origin, direction, t_min, t_max):
    """(t, idx) of the nearest triangle per ray (first index on a tie)."""
    tr = scene.triangles
    tmat = triangle_t_matrix(origin, direction, tr.v0, tr.e1, tr.e2,
                             t_min, t_max)
    t, idx = torch.min(tmat, -1)
    return t, idx.to(torch.int32)


def intersect_scene(scene: Scene, origin, direction,
                    t_min: float = 0.0, t_max: float = INF) -> Hit:
    """Nearest hit of each ray against every primitive (exact brute force)."""
    tt, best_t = nearest_triangle(scene, origin, direction, t_min, t_max)
    return assemble_hit(scene, origin, direction, tt, best_t, t_min, t_max)


def assemble_hit(scene: Scene, origin, direction, tt, best_t,
                 t_min: float, t_max: float = INF) -> Hit:
    """The full Hit from the nearest-triangle result, adding the sphere pass.
    At a triangle/sphere tie the sphere wins (``is_tri = tt < ts``), as in
    the JAX package."""
    sp, tr = scene.spheres, scene.triangles
    t_s_mat = intersect_spheres(origin, direction, sp.center, sp.radius,
                                t_min, t_max)                       # (R, S)
    ts, best_s = torch.min(t_s_mat, -1)
    best_t = torch.clamp(best_t, 0, tr.count - 1)
    is_tri = tt < ts
    t = torch.minimum(ts, tt)
    hit = t < NO_HIT_T
    return _winner_hit(scene, origin, direction, best_t, best_s, is_tri, t,
                       hit)


def _winner_hit(scene: Scene, origin, direction, best_t, best_s, is_tri, t,
                hit, tri_g=None) -> Hit:
    """Hit record from per-lane winner data only (O(R)).  ``tri_g``: the
    winners' (v0, e1, e2), where the caller gathered them already."""
    sp, tr = scene.spheres, scene.triangles
    best_t = best_t.long()
    best_s = best_s.long()
    prim = torch.where(is_tri, best_t, best_s)
    # Miss lanes compute the point with t = 1 (the record keeps NO_HIT_T):
    # o + 3.4e38 d would overflow downstream squares and NaN the backward.
    point = origin + torch.where(hit, t, 1.0)[:, None] * direction
    r_hit = vec.take(sp.radius, best_s)
    n_sphere = ((point - vec.take(sp.center, best_s))
                / torch.where(r_hit == 0.0, 1.0, r_hit)[:, None])
    geom_n = vec.normalize(torch.where(is_tri[:, None],
                                       vec.take(tr.normal, best_t),
                                       n_sphere))
    front = vec.dot(geom_n, direction)[:, 0] < 0.0
    # Barycentric uv interpolation at the winning triangle.
    if tri_g is None:
        tri_g = [vec.take(x, best_t) for x in (tr.v0, tr.e1, tr.e2)]
    _, b1, b2 = moller_trumbore_single(origin, direction, *tri_g)
    uv = (vec.take(tr.uv0, best_t) * (1.0 - b1 - b2)[:, None]
          + vec.take(tr.uv1, best_t) * b1[:, None]
          + vec.take(tr.uv2, best_t) * b2[:, None])
    uv = torch.where(is_tri[:, None], uv, 0.0)
    mat = torch.where(is_tri, tr.material[best_t], sp.material[best_s])
    return Hit(t=torch.where(hit, t, NO_HIT_T), hit=hit, is_triangle=is_tri,
               prim=prim.to(torch.int32), material=mat.to(torch.int32),
               point=point, geom_normal=geom_n, front=front, uv=uv)


def triangle_t_single(origin, direction, v0, e1, e2, t_min, t_max=INF,
                      miss=NO_HIT_T):
    """Per-lane twin of ``triangle_t_matrix`` for one triangle a ray (all
    inputs (R, 3)), with its operations one for one, so the value at a
    recorded winner is bit equal to the matrix entry.  ``miss``: the value
    of lanes that do not accept; a caller that masks misses itself passes
    a benign one, so that no 3.4e38 meets a zero cotangent backward."""
    ox, oy, oz = origin[:, 0], origin[:, 1], origin[:, 2]
    dx, dy, dz = direction[:, 0], direction[:, 1], direction[:, 2]
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    v0x, v0y, v0z = v0[:, 0], v0[:, 1], v0[:, 2]
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    det = _dot3(s1x, s1y, s1z, e1x, e1y, e1z)
    ok_det = torch.abs(det) > _DET_EPS
    inv_det = 1.0 / torch.where(ok_det, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    t = _dot3(s2x, s2y, s2z, e2x, e2y, e2z) * inv_det
    b1 = _dot3(s1x, s1y, s1z, sx, sy, sz) * inv_det
    b2 = _dot3(s2x, s2y, s2z, dx, dy, dz) * inv_det
    ok = (ok_det & (t > t_min) & (t < t_max)
          & (b1 >= 0.0) & (b2 >= 0.0) & (1.0 - b1 - b2 >= 0.0))
    return torch.where(ok, t, miss)


def sphere_t_single(origin, direction, center, radius, t_min, t_max=INF,
                    miss=NO_HIT_T):
    """Per-lane twin of ``intersect_spheres`` for one sphere a ray (center
    (R, 3), radius (R,)), near-then-far root included, bit equal at a
    recorded winner.  ``miss``: as in ``triangle_t_single``."""
    oc = origin - center
    d = direction
    a = _dot3(d[:, 0], d[:, 1], d[:, 2], d[:, 0], d[:, 1], d[:, 2])
    half_b = _dot3(oc[:, 0], oc[:, 1], oc[:, 2], d[:, 0], d[:, 1], d[:, 2])
    c = (_dot3(oc[:, 0], oc[:, 1], oc[:, 2], oc[:, 0], oc[:, 1], oc[:, 2])
         - radius * radius)
    disc = half_b * half_b - a * c
    ok = disc > 0.0
    sq = torch.sqrt(torch.where(ok, disc, 1.0))
    t_near = (-half_b - sq) / a
    t_far = (-half_b + sq) / a
    near_ok = ok & (t_near > t_min) & (t_near < t_max)
    far_ok = ok & (t_far > t_min) & (t_far < t_max)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, miss))


def hit_from_record(scene: Scene, origin, direction, prim, is_tri, hitflag,
                    t_min: float, t_max: float = INF) -> Hit:
    """The Hit of a recorded winner (primitive index ``prim`` within its
    SoA, ``is_tri``, the raw ``hitflag``), rebuilt in O(R): no (R, N)
    producer enters, so the backward pass is O(R) too.  Every field is bit
    equal to ``intersect_scene``'s on the same rays, and the gradients
    equal the standard engine's: its min routes each lane's cotangent to
    the winner's entry, the same function of the same winner data."""
    tr, sp = scene.triangles, scene.spheres
    prim = prim.long()
    best_t = torch.where(is_tri, prim, 0)
    best_s = torch.where(is_tri, 0, prim)
    tri_g = [vec.take(x, best_t) for x in (tr.v0, tr.e1, tr.e2)]
    # miss=1.0: the recorded flags mask every miss and deselected branch.
    t_tri = triangle_t_single(origin, direction, *tri_g, t_min, t_max,
                              miss=1.0)
    t_sph = sphere_t_single(origin, direction, vec.take(sp.center, best_s),
                            vec.take(sp.radius, best_s), t_min, t_max,
                            miss=1.0)
    t = torch.where(hitflag, torch.where(is_tri, t_tri, t_sph), 1.0)
    return _winner_hit(scene, origin, direction, best_t, best_s, is_tri, t,
                       hitflag, tri_g=tri_g)


def nearest_t(scene: Scene, origin, direction,
              t_min: float = 0.0, t_max: float = INF) -> torch.Tensor:
    """Nearest-hit distance only, (R,) — the shadow-ray fast path."""
    tr, sp = scene.triangles, scene.spheres
    tt = torch.amin(triangle_t_matrix(origin, direction, tr.v0, tr.e1,
                                      tr.e2, t_min, t_max), -1)
    ts = torch.amin(intersect_spheres(origin, direction, sp.center,
                                      sp.radius, t_min, t_max), -1)
    return torch.minimum(tt, ts)


def occluded(scene: Scene, origin, direction, max_dist,
             t_min: float = 0.0, tolerance: float = 0.01) -> torch.Tensor:
    """Shadow-ray test: True when something blocks before ``max_dist``
    (the MC test ``|to_sample| < occlusion.t + 0.01``)."""
    return ~(max_dist < nearest_t(scene, origin, direction, t_min=t_min)
             + tolerance)


def soft_visibility(scene: Scene, origin, direction, max_dist,
                    t_min: float, beta: float,
                    tolerance: float = 0.01) -> torch.Tensor:
    """Differentiable shadow-ray visibility in [0, 1], (R,): the product
    over every primitive of 1 - its soft coverage.  A triangle covers by
    sigmoid(margin / beta), the margin the world-space distance of the
    ray's plane point to the triangle's nearest edge (barycentric margin
    x sqrt(2A)); a sphere by sigmoid((radius - impact parameter) / beta).
    Only occluders in the window t in (t_min, max_dist - tolerance) count.
    beta -> 0 recovers the hard test up to the edge set.  O(R x N), like
    the brute-force intersector."""
    tr, sp = scene.triangles, scene.spheres
    return (soft_visibility_tris(tr.v0, tr.e1, tr.e2, tr.area, origin,
                                 direction, max_dist, t_min, beta,
                                 tolerance)
            * soft_visibility_spheres(sp.center, sp.radius, origin,
                                      direction, max_dist, t_min, beta,
                                      tolerance))


def _soft_cover(x, beta):
    """sigmoid(clip(x / beta, -30, 30)), dividing by beta as a 0-dim
    tensor (IEEE division on every device)."""
    return torch.sigmoid(torch.clamp(vec.div(x, beta), -30.0, 30.0))


def soft_visibility_tris(v0, e1, e2, area, origin, direction, max_dist,
                         t_min: float, beta: float,
                         tolerance: float) -> torch.Tensor:
    """``prod(1 - soft_cover)`` over an explicit triangle set, (R,): the
    core of ``soft_visibility``, which ``models.mesh.make_soft_vis_fn``
    also runs over a compacted subset of the rays."""
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    det = _dot3(s1x, s1y, s1z, e1x, e1y, e1z)
    ok_det = torch.abs(det) > _DET_EPS
    inv_det = 1.0 / torch.where(ok_det, det, 1.0)  # in_window masks these
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    t = _dot3(s2x, s2y, s2z, e2x, e2y, e2z) * inv_det
    b1 = _dot3(s1x, s1y, s1z, sx, sy, sz) * inv_det
    b2 = _dot3(s2x, s2y, s2z, dx, dy, dz) * inv_det
    in_window = (ok_det & (t > t_min)
                 & (t < max_dist[:, None] - tolerance))       # (R, N)
    bary_margin = torch.minimum(torch.minimum(b1, b2), 1.0 - b1 - b2)
    height_scale = torch.sqrt(torch.clamp(2.0 * area, min=1e-12))[None, :]
    cover = _soft_cover(bary_margin * height_scale, beta)
    cover = torch.where(in_window, cover, 0.0)
    return torch.prod(1.0 - cover, -1)


def soft_visibility_spheres(center, radius, origin, direction, max_dist,
                            t_min: float, beta: float,
                            tolerance: float) -> torch.Tensor:
    """``prod(1 - soft_cover)`` over a sphere set, (R,); a sphere of radius
    0 covers nothing."""
    oc = center[None, :, :] - origin[:, None, :]               # (R, S, 3)
    dd = direction[:, None, :]
    proj = _dot3(oc[..., 0], oc[..., 1], oc[..., 2],
                 dd[..., 0], dd[..., 1], dd[..., 2])           # (R, S)
    d2 = torch.clamp(_dot3(oc[..., 0], oc[..., 1], oc[..., 2],
                           oc[..., 0], oc[..., 1], oc[..., 2])
                     - proj * proj, min=1e-12)
    impact = torch.sqrt(d2)
    r_abs = torch.abs(radius)[None, :]
    in_window = ((proj > t_min) & (proj < max_dist[:, None] - tolerance)
                 & (r_abs > 0.0))
    cover = torch.where(in_window, _soft_cover(r_abs - impact, beta), 0.0)
    return torch.prod(1.0 - cover, -1)
