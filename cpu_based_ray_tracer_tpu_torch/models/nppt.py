"""The non-physical path tracer stage (port of
``cpu_based_ray_tracer_tpu.models.nppt``): the offline prototype's scatter
integrator (``models.offline.trace``) driven by the GUI perspective camera
with per-frame pixel jitter and accumulation, and a display gamma before
the clamp."""

from __future__ import annotations

import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import offline
from cpu_based_ray_tracer_tpu_torch.ops import tonemap, vec
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils import rng
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def render_progressive(scene: Scene, camera: cam_mod.PerspectiveCamera,
                       cfg: RenderConfig, seed: int, accum,
                       start_sample: int):
    """Accumulate ``cfg.spp`` jittered frames (sample indices
    ``start_sample`` ..) on top of ``accum`` (on its device); returns
    ``(accum', next_sample)``."""
    h, w = cfg.height, cfg.width
    dev = accum.device
    scene, camera = scene.to(dev), camera.to(dev)
    pixel = torch.arange(h * w, dtype=torch.int64, device=dev)
    for s in range(start_sample, start_sample + cfg.spp):
        uj = rng.uniforms4(seed, pixel, s, 0, rng.JITTER)
        jitter = torch.stack([uj[0].reshape(h, w), uj[1].reshape(h, w)], -1)
        d = cam_mod.perspective_rays(camera, w, h, jitter).reshape(-1, 3)
        o = camera.position.expand(d.shape)
        rad = offline.trace(scene, o, d, cfg, seed=seed, pixel=pixel,
                            sample=s)
        accum = accum + rad.reshape(h, w, 3)
    return accum, start_sample + cfg.spp


def render(scene: Scene, camera, cfg: RenderConfig, seed: int,
           device=None) -> torch.Tensor:
    """Mean linear radiance, (H, W, 3), on ``device`` (default: the card)."""
    dev = resolve_device(device)
    acc, _ = render_progressive(
        scene, camera, cfg, seed,
        torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                    device=dev), 0)
    return vec.div(acc, float(cfg.spp))


def render_u8(scene, camera, cfg: RenderConfig, seed: int,
              device=None) -> torch.Tensor:
    """Gamma -> clamp -> quantize, the NPPT display path."""
    return tonemap.quantize_u8(render(scene, camera, cfg, seed, device),
                               cfg.gamma)
