"""The initial-framework stage, the toy energy-halving reflect loop (port of
``cpu_based_ray_tracer_tpu.models.initial``).

- 5 bounces; the path energy starts at 1 and halves per bounce;
- one hard-coded directional light normalize(-1, -1, -1): each hit adds
  ``energy * albedo * max(dot(n, -L), 0)``;
- a miss adds ``energy * sky`` with sky (0.6, 0.7, 0.9) and ends the path;
- the bounce direction reflects about (normal + roughness *
  U[-0.5, 0.5)^3), the origin nudged 1e-4 along the normal;
- spheres only, and only the NEAR quadratic root with t > 0 counts: a ray
  inside a sphere does not hit it.

Plain PyTorch; the stage has no kernel.
"""

from __future__ import annotations

import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils import rng
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device

SKY = (0.6, 0.7, 0.9)
LIGHT_DIR = (-1.0, -1.0, -1.0)
BOUNCES = 5
ENERGY_FALLOFF = 0.5
ACNE_EPS = 1e-4


def _nearest_sphere_near_root(scene: Scene, o, d):
    """Near-root-only nearest sphere: (t, index, hit), t from the smaller
    root only (inf on a miss)."""
    sp = scene.spheres
    oc = o[:, None, :] - sp.center[None, :, :]
    a = vec._sum3(d * d)[:, None]
    b = 2.0 * vec._sum3(oc * d[:, None, :])
    c = vec._sum3(oc * oc) - (sp.radius * sp.radius)[None, :]
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    t_near = (-b - torch.sqrt(torch.where(ok, disc, 0.0))) / (2.0 * a)
    t = torch.where(ok & (t_near > 0.0), t_near, float("inf"))
    tb, best = torch.min(t, -1)
    return tb, best.to(torch.int32), torch.isfinite(tb)


def trace(scene: Scene, origin, direction, cfg: RenderConfig, *, seed, pixel,
          sample):
    """(R, 3) color for a batch of rays."""
    dev = origin.device
    mats, sp = scene.materials, scene.spheres
    light = vec.normalize(torch.tensor(LIGHT_DIR, dtype=origin.dtype,
                                       device=dev))
    sky = torch.tensor(SKY, dtype=origin.dtype, device=dev)
    o, d = origin, direction
    color = torch.zeros_like(origin)
    energy = torch.ones(origin.shape[:1], dtype=origin.dtype, device=dev)
    alive = torch.ones(origin.shape[:1], dtype=torch.bool, device=dev)
    sphere_mat = sp.material.long()

    for bounce in range(BOUNCES):
        t, idx, hit = _nearest_sphere_near_root(scene, o, d)
        color = color + torch.where((alive & ~hit)[:, None],
                                    energy[:, None] * sky, 0.0)
        i = idx.long()
        albedo = mats.albedo[sphere_mat][i]
        rough = mats.fuzz[sphere_mat][i]
        center = sp.center[i]
        point = o + t[:, None] * d
        n = vec.normalize(point - center)
        intensity = torch.clamp(vec._sum3(n * (-light)), min=0.0)
        color = color + torch.where((alive & hit)[:, None],
                                    (energy * intensity)[:, None] * albedo,
                                    0.0)
        energy = torch.where(alive & hit, energy * ENERGY_FALLOFF, energy)
        u = rng.uniforms4(seed, pixel, sample, bounce, rng.SCATTER)
        perturb = torch.stack([u[0], u[1], u[2]], -1) - 0.5
        n_fuzz = n + rough[:, None] * perturb
        alive = alive & hit
        o = torch.where(alive[:, None], point + n * ACNE_EPS, o)
        d = torch.where(alive[:, None], vec.reflect(d, n_fuzz), d)
    return color


def render(scene: Scene, camera: cam_mod.PerspectiveCamera,
           cfg: RenderConfig, seed: int, device=None) -> torch.Tensor:
    """(H, W, 3) mean over ``cfg.spp`` accumulation frames of pixel-center
    rays, on ``device`` (default: the card); frames differ only where a
    roughness > 0 makes the bounce stochastic."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    h, w = cfg.height, cfg.width
    d = cam_mod.perspective_rays(camera, w, h).reshape(-1, 3)
    o = camera.position.expand(d.shape)
    pixel = torch.arange(h * w, dtype=torch.int64, device=dev)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        acc = acc + trace(scene, o, d, cfg, seed=seed, pixel=pixel,
                          sample=s).reshape(h, w, 3)
    return vec.div(acc, float(cfg.spp))
