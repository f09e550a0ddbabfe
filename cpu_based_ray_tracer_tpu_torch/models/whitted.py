"""Whitted-style ray tracer (port of
``cpu_based_ray_tracer_tpu.models.whitted``).

Deterministic recursive shading evaluated as a level-synchronous binary ray
tree of depth ``cfg.whitted_depth``: level k holds the live branches of
every pixel; each level shades its Diffuse_Glossy hits (Blinn-Phong with
point-light shadow rays, chessboard texture) and sky misses into the image,
and emits the next level's reflect + refract lanes weighted by the exact
polarized Fresnel term.  Dead lanes carry zero weight.

PyTorch in place of the JAX engine: ``jax.lax.cond(any(alive))`` is a host
``if`` (a dead level ends the tree), ``segment_sum`` is ``index_add_`` (on
CUDA it adds with atomics in no fixed order, so the last bits may change
from run to run), and the lane cap's sort is ``torch.argsort(...,
stable=True)``, JAX's stable order.
"""

from __future__ import annotations

import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import intersect, vec
from cpu_based_ray_tracer_tpu_torch.scene import (DIFFUSE_GLOSSY, REFLECTIVE,
                                                  REFLECTIVE_REFRACTIVE,
                                                  TEX_CHESSBOARD, Scene)
from cpu_based_ray_tracer_tpu_torch.scenes.whitted_scene import (
    CHESS_A, CHESS_B, CHESS_FREQUENCY)
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def diffuse_color(scene: Scene, material, uv):
    """Per-lane diffuse color: the chessboard (xor of the uv cells' parity)
    where the material has that texture, else its flat albedo."""
    mats = scene.materials
    m = material.long()
    albedo, tex = mats.albedo[m], mats.texture[m]
    # torch.remainder is a floor mod, as jnp.mod.
    fx = torch.remainder(uv[..., 0] * CHESS_FREQUENCY, 1.0) > 0.5
    fy = torch.remainder(uv[..., 1] * CHESS_FREQUENCY, 1.0) > 0.5
    pattern = (fx ^ fy).to(albedo.dtype)[..., None]
    a = torch.tensor(CHESS_A, dtype=albedo.dtype, device=albedo.device)
    b = torch.tensor(CHESS_B, dtype=albedo.dtype, device=albedo.device)
    chess = vec.lerp(a, b, pattern)
    return torch.where((tex == TEX_CHESSBOARD)[..., None], chess, albedo)


def _offset_origin(point, direction, normal, eps):
    """Origin offset by -eps*n or +eps*n by the sign of dot(direction, n)."""
    inside = vec.dot(direction, normal) < 0.0
    return torch.where(inside, point - normal * eps, point + normal * eps)


def _shade_diffuse_glossy(scene: Scene, hit: intersect.Hit, direction,
                          cfg: RenderConfig, nearest_t_fn, live=None):
    """Blinn-Phong direct lighting with shadow rays, (R, 3) for every lane
    (callers mask).  ``live``: the lanes whose result is used; the others'
    shadow rays are pinned to harmless segments just under each light, so
    that an accelerated intersector culls them."""
    mats = scene.materials
    n = hit.geom_normal
    m = hit.material.long()
    kd, ks, spec_exp = mats.kd[m][:, None], mats.ks[m][:, None], mats.spec_exp[m]
    color = diffuse_color(scene, hit.material, hit.uv)

    # Shading point offset toward the viewer's side.
    inside = vec.dot(direction, n) < 0.0
    p = torch.where(inside, hit.point + n * cfg.eps_offset,
                    hit.point - n * cfg.eps_offset)
    hp = hit.point
    if live is not None:
        p = torch.where(live[:, None], p, 0.0)
        hp = torch.where(live[:, None], hp, 0.0)

    diffuse_sum = torch.zeros_like(color)
    specular_sum = torch.zeros_like(color)
    lights = scene.lights
    down = torch.tensor([0.0, -1.0, 0.0], dtype=p.dtype, device=p.device)
    for li in range(lights.count):
        lpos = lights.position[li]
        lrad = lights.radiance[li]
        to_l = lpos - hp
        p_l = p
        if live is not None:
            to_l = torch.where(live[:, None], to_l, -down)
            p_l = torch.where(live[:, None], p, lpos + down)
        dist2 = vec.dot(to_l, to_l)[:, 0]
        ldir = vec.normalize(to_l)
        occ_t = nearest_t_fn(scene, p_l, ldir, cfg.t_min)
        occluded = occ_t * occ_t < dist2               # miss: t = NO_HIT_T
        cos_l = torch.abs(vec.dot(ldir, n))
        spec = torch.pow(torch.clamp(
            -vec.dot(vec.reflect(-ldir, n), direction)[:, 0], min=0.0),
            spec_exp)
        vis = (~occluded)[:, None]
        diffuse_sum = diffuse_sum + torch.where(vis, lrad * cos_l, 0.0)
        specular_sum = specular_sum + torch.where(vis, spec[:, None] * lrad,
                                                  0.0)
    return diffuse_sum * color * kd + specular_sum * ks


def _scene_has_specular(scene: Scene) -> bool:
    kinds = scene.materials.kind
    return bool(((kinds == REFLECTIVE) | (kinds == REFLECTIVE_REFRACTIVE))
                .any())


def trace(scene: Scene, origin, direction, cfg: RenderConfig,
          intersect_fn=None, nearest_t_fn=None, *,
          return_truncated: bool = False):
    """Whitted radiance for (R, 3) primary rays, (R, 3), by level-synchronous
    ray-tree evaluation on the device the rays lie on.

    ``intersect_fn(scene, o, d, t_min) -> Hit`` selects the intersector
    (default: exact brute force; the mesh stage passes the packet kernel's,
    ``models.mesh.make_intersect_fn``); ``nearest_t_fn`` is the matching
    t-only shadow-ray path.

    Lane buffers are capped at ``cfg.whitted_lane_cap * R`` lanes, live
    lanes first and by decreasing Fresnel weight; ``return_truncated`` also
    returns the total weight dropped by the cap (0 when it did not bind)."""
    if intersect_fn is None:
        intersect_fn = lambda s, o, d, t_min: intersect.intersect_scene(  # noqa: E731
            s, o, d, t_min=t_min)
    if nearest_t_fn is None:
        nearest_t_fn = lambda s, o, d, t_min: intersect.nearest_t(  # noqa: E731
            s, o, d, t_min=t_min)
    r = origin.shape[0]
    dev, dt = origin.device, origin.dtype
    mats = scene.materials
    radiance = torch.zeros((r, 3), dtype=dt, device=dev)
    truncated = torch.zeros((), dtype=dt, device=dev)
    has_specular = _scene_has_specular(scene)
    cap = cfg.whitted_lane_cap * r if cfg.whitted_lane_cap > 0 else None

    def level_body(o, d, weight, alive, pix, spawn: bool):
        """One tree level: shade this level's lanes; emit children."""
        hit = intersect_fn(scene, o, d, cfg.t_min)
        m = hit.material.long()
        kind, ior = mats.kind[m], mats.ior[m]

        # Miss -> sky at every level.
        contrib = torch.where((alive & ~hit.hit)[:, None],
                              weight * scene.sky_top, 0.0)
        # Diffuse_Glossy -> local Blinn-Phong, the path ends.
        is_diff = alive & hit.hit & (kind == DIFFUSE_GLOSSY)
        local = _shade_diffuse_glossy(scene, hit, d, cfg, nearest_t_fn,
                                      live=is_diff)
        contrib = contrib + torch.where(is_diff[:, None], weight * local, 0.0)
        if pix is None:
            rad_delta = contrib        # level 0: lane i is pixel i
        else:
            rad_delta = torch.zeros((r, 3), dtype=dt, device=dev).index_add_(
                0, pix, contrib)
        if not spawn:
            return rad_delta, None

        # Children of specular hits.
        n = hit.geom_normal
        is_refl = alive & hit.hit & (kind == REFLECTIVE)
        is_glass = alive & hit.hit & (kind == REFLECTIVE_REFRACTIVE)
        fres = vec.fresnel_whitted(d, n, ior)

        refl_dir = vec.normalize(vec.reflect(d, n))
        refl_o = _offset_origin(hit.point, refl_dir, n, cfg.eps_offset)
        refr_dir = vec.normalize(vec.snell_whitted(d, n, ior))
        refr_o = _offset_origin(hit.point, refr_dir, n, cfg.eps_offset)

        # Reflect lane: Reflective and glass; refract lane: glass, (1 - R),
        # dead under TIR (zero direction).
        refl_w = weight * torch.where((is_refl | is_glass)[:, None],
                                      fres[:, None], 0.0)
        tir = vec.dot(refr_dir, refr_dir)[:, 0] < 0.5
        refr_w = weight * torch.where(is_glass[:, None], 1.0 - fres[:, None],
                                      0.0)
        co = torch.cat([refl_o, refr_o], 0)
        cd = torch.cat([refl_dir, refr_dir], 0)
        cw = torch.cat([refl_w, refr_w], 0)
        ca = torch.cat([(is_refl | is_glass) & (refl_w[:, 0] > 0.0),
                        is_glass & ~tir & (refr_w[:, 0] > 0.0)], 0)
        pixv = pix if pix is not None else torch.arange(r, device=dev)
        cp = torch.cat([pixv, pixv], 0)
        return rad_delta, (co, cd, cw, ca, cp)

    o, d = origin, direction
    weight = torch.ones((r, 1), dtype=dt, device=dev)
    alive = torch.ones((r,), dtype=torch.bool, device=dev)
    pix = None
    for level in range(cfg.whitted_depth + 1):
        last = (level == cfg.whitted_depth) or not has_specular
        # A dead level adds nothing and spawns only dead lanes.
        if level > 0 and not bool(alive.any()):
            break
        rad_delta, children = level_body(o, d, weight, alive, pix,
                                         spawn=not last)
        radiance = radiance + rad_delta
        if last:
            break
        o, d, weight, alive, pix = children
        if cap is not None and o.shape[0] > cap:
            # Weight-priority compaction: live lanes first, largest weight
            # first; lanes past the cap are dropped and their weight is
            # counted in `truncated`.
            key = torch.where(alive, -weight[:, 0], float("inf"))
            order = torch.argsort(key, stable=True)
            truncated = truncated + torch.sum(
                torch.where(alive, weight[:, 0], 0.0)[order][cap:])
            keep = order[:cap]
            o, d, weight = o[keep], d[keep], weight[keep]
            alive, pix = alive[keep], pix[keep]

    if return_truncated:
        return radiance, truncated
    return radiance


def render(scene: Scene, camera: cam_mod.PerspectiveCamera,
           cfg: RenderConfig, intersect_fn=None, nearest_t_fn=None,
           device=None) -> torch.Tensor:
    """Deterministic Whitted render (pixel centers, 1 spp), (H, W, 3), on
    ``device`` (default: the card).  Chunked over ``cfg.ray_chunk`` rays
    (default min(H*W, 16384)); a pixel count that the chunk does not divide
    is padded with copies of pixel 0's ray, sliced away after."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    h, w = cfg.height, cfg.width
    d_all = cam_mod.perspective_rays(camera, w, h).reshape(-1, 3)
    chunk = cfg.ray_chunk or min(h * w, 16384)
    n_chunks = max(1, (h * w + chunk - 1) // chunk)
    if n_chunks == 1:
        o_all = camera.position.expand(d_all.shape)
        return trace(scene, o_all, d_all, cfg, intersect_fn,
                     nearest_t_fn).reshape(h, w, 3)
    padded = n_chunks * chunk
    if padded != h * w:
        d_all = torch.cat([d_all, d_all[0].expand(padded - h * w, 3)], 0)
    o = camera.position.expand(chunk, 3)
    rad = torch.cat([trace(scene, o, dd, cfg, intersect_fn, nearest_t_fn)
                     for dd in torch.split(d_all, chunk)], 0)
    return rad[:h * w].reshape(h, w, 3)
