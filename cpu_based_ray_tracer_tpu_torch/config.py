"""Unified render configuration (port of ``cpu_based_ray_tracer_tpu.config``).

One frozen dataclass with the same fields and defaults as the JAX package's
``RenderConfig``; see that module for where each default comes from in the
reference renderer.
"""

from __future__ import annotations

import dataclasses

# scene.DIFFUSE_ON_SPHERE: the true-Lambertian RTIOW diffuse model, the
# reference's default (main.cpp DiffuseMode 1).  Kept local so this module
# imports nothing else of the package.
DIFFUSE_ON_SPHERE = 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 400
    height: int = 225
    spp: int = 8
    max_depth: int = 50
    t_min: float = 1e-3
    eps_offset: float = 1e-5
    gamma: float = 2.0
    diffuse_model: int = DIFFUSE_ON_SPHERE
    # Monte Carlo stage:
    rr_survival: float = 0.8
    shadow_tolerance: float = 1e-2
    # 0 = the reference's hard shadow test; > 0 = sigmoid-relaxed visibility
    # (the differentiable mode, ops.intersect.soft_visibility) in the plain
    # MC engines; the fused steppers raise NotImplementedError for it.
    soft_shadow_beta: float = 0.0
    # Whitted stage:
    whitted_depth: int = 5
    whitted_lane_cap: int = 2
    # Engine knob: 0 = auto, else rays per chunk.
    ray_chunk: int = 0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
