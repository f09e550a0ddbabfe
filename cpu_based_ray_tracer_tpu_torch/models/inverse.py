"""Inverse rendering (port of ``cpu_based_ray_tracer_tpu.models.inverse``):
recover scene parameters from an image by gradient descent through the
differentiable Monte Carlo estimator.

The forward model is ``monte_carlo.render`` (the reverse-differentiable
fixed-depth engine: detached traversal, attached shading) or its record /
replay twin, the loss a pixel MSE against a target image, the optimizer
Adam (``torch.optim.Adam`` at optax's defaults: beta 0.9 / 0.999, eps
1e-8; the same update, rounded in another order).

The counter-based RNG makes the problem well posed at low spp: the target
and the iterates rendered with the same seed share their Monte Carlo
noise, so the loss is a deterministic function of the parameters with its
minimum at the true values (common random numbers).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class OptResult:
    params: torch.Tensor   # the recovered parameter table
    losses: torch.Tensor   # (n_steps,) loss before each step
    image: torch.Tensor    # the final render


def _with_albedo(scene: Scene, albedo) -> Scene:
    return scene.replace(materials=scene.materials.replace(albedo=albedo))


def _with_emission(scene: Scene, emission) -> Scene:
    return scene.replace(materials=scene.materials.replace(
        emission=emission))


def _use_replay(engine: str, cfg: RenderConfig) -> bool:
    if engine not in ("auto", "replay", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine == "replay" or (engine == "auto"
                                  and cfg.soft_shadow_beta == 0.0)


def _adam_loop(param, loss_fn, n_steps: int, lr: float):
    """Adam over ``param`` for ``n_steps``; the losses before each step."""
    param = param.clone().requires_grad_(True)
    opt = torch.optim.Adam([param], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(param)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return param.detach(), torch.stack(losses)


def render_with_albedo(scene: Scene, camera, cfg: RenderConfig, seed: int,
                       albedo, intersect_fn=None, nearest_t_fn=None,
                       device=None) -> torch.Tensor:
    """The forward model: the scene with its albedo table swapped, on
    ``device`` (default: the card).  Mesh scenes pass the accelerated
    intersectors (``models.mesh.make_intersect_fn(differentiable=True)``)."""
    return monte_carlo.render(_with_albedo(scene, albedo), camera, cfg, seed,
                              device, intersect_fn=intersect_fn,
                              nearest_t_fn=nearest_t_fn)


def recover_albedo(scene: Scene, camera, cfg: RenderConfig, seed: int,
                   target, *, n_steps: int = 80, lr: float = 0.1,
                   init_albedo=None, intersect_fn=None, nearest_t_fn=None,
                   engine: str = "auto", device=None) -> OptResult:
    """Recover the material albedo table from a rendered target image, on
    ``device`` (default: the card).

    Albedos are parameterized by a sigmoid (logit space), so iterates stay
    in (0, 1); emissive rows are frozen at their true value (emission
    dominates them).  ``engine``: ``"replay"`` records the trace once
    (albedo moves no discrete hit) and differentiates the O(R x depth)
    replay each step; ``"scan"`` differentiates the standard engine;
    ``"auto"`` takes the replay wherever it applies (hard shadows)."""
    dev = resolve_device(device)
    scene, camera, target = scene.to(dev), camera.to(dev), target.to(dev)
    mats = scene.materials
    if init_albedo is None:
        init_albedo = torch.full_like(mats.albedo, 0.5)
    free = ~mats.emissive
    a0 = torch.clamp(init_albedo.to(dev), 1e-4, 1 - 1e-4)
    logit = torch.log(a0 / (1 - a0))

    def albedo_of(lg):
        return torch.where(free[:, None], torch.sigmoid(lg), mats.albedo)

    if _use_replay(engine, cfg):
        recs = monte_carlo.record_trace(scene, camera, cfg, seed, dev,
                                        intersect_fn=intersect_fn,
                                        nearest_t_fn=nearest_t_fn)

        def loss_fn(lg):
            img = monte_carlo.render_from_trace(
                _with_albedo(scene, albedo_of(lg)), camera, cfg, seed, recs,
                dev)
            return torch.mean((img - target) ** 2)
    else:
        def loss_fn(lg):
            img = render_with_albedo(scene, camera, cfg, seed, albedo_of(lg),
                                     intersect_fn, nearest_t_fn, dev)
            return torch.mean((img - target) ** 2)

    logit, losses = _adam_loop(logit, loss_fn, n_steps, lr)
    albedo = albedo_of(logit)
    with torch.no_grad():
        image = render_with_albedo(scene, camera, cfg, seed, albedo,
                                   intersect_fn, nearest_t_fn, dev)
    return OptResult(params=albedo, losses=losses, image=image)


def recover_emission(scene: Scene, camera, cfg: RenderConfig, seed: int,
                     target, *, n_steps: int = 60, lr: float = 0.2,
                     engine: str = "auto", device=None) -> OptResult:
    """Recover the light's emission from a target image, on ``device``
    (default: the card).  Parameterized in log space (emission spans
    orders of magnitude); the loss is relative to the target.
    ``engine``: as in ``recover_albedo`` (emission moves no discrete hit
    either)."""
    dev = resolve_device(device)
    scene, camera, target = scene.to(dev), camera.to(dev), target.to(dev)
    mats = scene.materials
    em_mask = mats.emissive
    use_replay = _use_replay(engine, cfg)
    recs = (monte_carlo.record_trace(scene, camera, cfg, seed, dev)
            if use_replay else None)

    def emission_of(raw):
        return torch.where(em_mask[:, None], torch.exp(raw), mats.emission)

    def loss_fn(raw):
        sc = _with_emission(scene, emission_of(raw))
        if use_replay:
            img = monte_carlo.render_from_trace(sc, camera, cfg, seed, recs,
                                                dev)
        else:
            img = monte_carlo.render(sc, camera, cfg, seed, dev)
        return torch.mean(((img - target) / (target + 0.1)) ** 2)

    raw0 = torch.full_like(mats.emission, math.log(10.0))
    raw, losses = _adam_loop(raw0, loss_fn, n_steps, lr)
    emission = emission_of(raw)
    with torch.no_grad():
        image = monte_carlo.render(_with_emission(scene, emission), camera,
                                   cfg, seed, dev)
    return OptResult(params=emission, losses=losses, image=image)
