"""Area-light sampling (port of ``cpu_based_ray_tracer_tpu.ops.sampling``).

Uniform-by-area samples on the scene's emissive triangles: a triangle-area
prefix sum picks the triangle, the reference's barycentric parameterization
picks the point; pdf = 1 / total emissive area.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.scene import Scene


class LightSample(NamedTuple):
    position: torch.Tensor   # (R, 3)
    normal: torch.Tensor     # (R, 3) light-surface unit geometric normal
    emission: torch.Tensor   # (R, 3) radiance Le of the sampled emitter
    pdf: torch.Tensor        # (R,) = 1 / total emissive area
    valid: torch.Tensor      # (R,) bool — False when the scene has no emitter


def sample_area_light(scene: Scene, u_choice, u_tri1, u_tri2) -> LightSample:
    """One uniform-by-area sample per lane from (R,) U[0,1) draws: the
    triangle by area CDF (the count of CDF entries <= budget, found by a
    binary search: the JAX package's dense (R, N) compare-and-sum gives the
    same index, but materializes R x N integers here), then the point."""
    tr, mats = scene.triangles, scene.materials
    tmat = tr.material.long()
    emissive_tri = mats.emissive[tmat]                          # (N,)
    areas = torch.where(emissive_tri, tr.area, 0.0)             # (N,)
    total = torch.sum(areas)
    valid = total > 0.0
    cdf = torch.cumsum(areas, 0)
    budget = u_choice * total
    idx = torch.searchsorted(cdf.detach(), budget.detach(), right=True)
    idx = torch.clamp(idx, 0, tr.count - 1)
    v0, e1, e2 = (vec.take(x, idx) for x in (tr.v0, tr.e1, tr.e2))
    w = vec.triangle_from(u_tri1, u_tri2)                       # (R, 3)
    p = v0 + w[:, 1:2] * e1 + w[:, 2:3] * e2
    n = u_choice.shape[0]
    pdf = torch.where(valid, 1.0 / torch.clamp(total, min=1e-20),
                      torch.zeros_like(total))
    return LightSample(
        position=p, normal=vec.take(tr.normal, idx),
        emission=vec.take(vec.take(mats.emission, tmat), idx),
        pdf=pdf * torch.ones((n,), dtype=v0.dtype, device=v0.device),
        valid=valid & torch.ones((n,), dtype=torch.bool, device=v0.device))
