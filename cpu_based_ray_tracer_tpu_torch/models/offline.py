"""RTIOW scatter integrator of the offline prototype and NPPT stages (port
of ``cpu_based_ray_tracer_tpu.models.offline``).

The reference's recursive ``ray_color`` as a fixed-depth loop over the
bounce index with an ``alive`` mask: every lane is one path; a scatter
multiplies the throughput, a miss adds throughput * sky and ends the lane,
depth exhaustion leaves the lane black.

Materials, per kind:
- LAMBERT: three diffuse models chosen by ``cfg.diffuse_model``, with the
  near-zero direction falling back to the normal;
- METAL: mirror + fuzz * in-unit-ball; absorbed when the scattered ray
  leaves below the surface;
- DIELECTRIC: attenuation 1, eta ratio by face, total internal reflection
  or a Schlick-vs-uniform coin -> reflect, else refract.

This is the plain twin of the fused kernel (``ops.fused_rtiow``): the same
pcg4d streams per (pixel, sample, bounce), so both give the same image to
float tolerance.
"""

from __future__ import annotations

import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import intersect, tonemap, vec
from cpu_based_ray_tracer_tpu_torch.scene import (DIELECTRIC,
                                                  DIFFUSE_IN_HEMISPHERE,
                                                  DIFFUSE_IN_SPHERE, LAMBERT,
                                                  METAL, Scene)
from cpu_based_ray_tracer_tpu_torch.utils import rng
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def scatter(scene: Scene, hit: intersect.Hit, direction, cfg: RenderConfig,
            seed, pixel, sample, bounce):
    """One scatter event for every lane.  Returns (new unit direction
    (R, 3), attenuation (R, 3), scattered (R,) bool)."""
    mats = scene.materials
    m = hit.material.long()
    kind, albedo, ior, fuzz = mats.kind[m], mats.albedo[m], mats.ior[m], \
        mats.fuzz[m]
    n = hit.facing_normal
    u1, u2, u3, u4 = rng.uniforms4(seed, pixel, sample, bounce, rng.SCATTER)

    if cfg.diffuse_model == DIFFUSE_IN_SPHERE:
        d_diff = n + vec.ball_from(u1, u2, u3)
    elif cfg.diffuse_model == DIFFUSE_IN_HEMISPHERE:
        d_diff = vec.hemisphere_volume_from(n, u1, u2, u3)
    else:  # DIFFUSE_ON_SPHERE: true Lambertian, the reference default
        d_diff = n + vec.sphere_from(u1, u2)
    near_zero = torch.all(torch.abs(d_diff) < 1e-8, dim=-1, keepdim=True)
    d_diff = torch.where(near_zero, n, d_diff)

    unit_d = vec.normalize(direction)
    d_metal = vec.reflect(unit_d, n) + fuzz[:, None] * vec.ball_from(u1, u2,
                                                                     u3)
    metal_ok = vec.dot(d_metal, n)[:, 0] > 0.0

    eta_ratio = torch.where(hit.front, 1.0 / ior, ior)
    cos_theta = torch.clamp(-vec.dot(unit_d, n)[:, 0], max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta_ratio * sin_theta > 1.0
    do_reflect = cannot_refract | (vec.schlick(cos_theta, eta_ratio) > u4)
    refracted, _ = vec.refract(unit_d, n, eta_ratio[:, None])
    d_diel = torch.where(do_reflect[:, None], vec.reflect(unit_d, n),
                         refracted)

    is_l = (kind == LAMBERT)[:, None]
    is_m = (kind == METAL)[:, None]
    new_dir = torch.where(is_l, d_diff, torch.where(is_m, d_metal, d_diel))
    attenuation = torch.where((kind == DIELECTRIC)[:, None], 1.0, albedo)
    scattered = torch.where(kind == METAL, metal_ok, True)
    return vec.normalize(new_dir), attenuation, scattered


def trace(scene: Scene, origin, direction, cfg: RenderConfig, *, seed, pixel,
          sample):
    """Path radiance for a batch of rays, (R, 3); ``pixel`` is the absolute
    pixel index, the RNG counter."""
    r = origin.shape[0]
    o, d = origin, direction
    throughput = torch.ones((r, 3), dtype=origin.dtype, device=origin.device)
    radiance = torch.zeros_like(throughput)
    alive = torch.ones((r,), dtype=torch.bool, device=origin.device)
    for bounce in range(cfg.max_depth):
        hit = intersect.intersect_scene(scene, o, d, t_min=cfg.t_min)
        missed = alive & ~hit.hit
        radiance = radiance + torch.where(
            missed[:, None], throughput * scene.sky(vec.normalize(d)), 0.0)
        new_d, att, scat_ok = scatter(scene, hit, d, cfg, seed, pixel,
                                      sample, bounce)
        survive = alive & hit.hit & scat_ok
        throughput = torch.where(survive[:, None], throughput * att,
                                 throughput)
        o = torch.where(survive[:, None], hit.point, o)
        d = torch.where(survive[:, None], new_d, d)
        alive = survive
    # Lanes still alive after max_depth bounces contribute black.
    return radiance


def _pixel_grid(h: int, w: int, device):
    """(x, y) float coords of every pixel in row-major order (row 0 = top)
    and the absolute pixel index."""
    pixel = torch.arange(h * w, dtype=torch.int64, device=device)
    return ((pixel % w).to(torch.float32), (pixel // w).to(torch.float32),
            pixel)


def render(scene: Scene, camera: cam_mod.ThinLensCamera, cfg: RenderConfig,
           seed: int, device=None) -> torch.Tensor:
    """Mean linear radiance per pixel, (H, W, 3), row 0 = top scanline, on
    ``device`` (default: the card).  One pass per sample index."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    h, w = cfg.height, cfg.width
    x, y, pixel = _pixel_grid(h, w, dev)
    row_from_bottom = (h - 1.0) - y      # the reference's rows run bottom-up
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        j1, j2, l1, l2 = rng.uniforms4(seed, pixel, s, 0, rng.JITTER)
        u = vec.div(x + j1, w)
        v = vec.div(row_from_bottom + j2, h)
        o, d = cam_mod.thin_lens_rays(camera, u, v, l1, l2)
        rad = trace(scene, o, d, cfg, seed=seed, pixel=pixel, sample=s)
        acc = acc + rad.reshape(h, w, 3)
    return vec.div(acc, float(cfg.spp))


def render_u8(scene, camera, cfg: RenderConfig, seed: int,
              device=None) -> torch.Tensor:
    """Quantized output, the reference's ``write_color``."""
    return tonemap.quantize_u8(render(scene, camera, cfg, seed, device),
                               cfg.gamma)
