"""Vector math and direction sampling, the MC and Whitted subsets
(port of ``cpu_based_ray_tracer_tpu.ops.vec``).

Functions over (..., 3) tensors.  Three-element sums are written out as
``x0 + x1 + x2``, the order in which the JAX package's ``jnp.sum`` over a
3-vector adds, so results round the same way.
"""

from __future__ import annotations

import math

import torch


def _sum3(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0] + p[..., 1] + p[..., 2]


def dot(a, b):
    return _sum3(a * b).unsqueeze(-1)


def cross(a, b):
    """Componentwise cross product over the last axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def norm(a):
    return torch.sqrt(torch.clamp(_sum3(a * a), min=0.0)).unsqueeze(-1)


def normalize(a):
    """Zero-safe normalize: a / sqrt(max(|a|^2, 1e-24))."""
    n2 = torch.clamp(_sum3(a * a), min=1e-12 * 1e-12).unsqueeze(-1)
    return a / torch.sqrt(n2)


def lerp(a, b, t):
    """Whitted::lerp."""
    return a * (1.0 - t) + b * t


def reflect(d, n):
    """Mirror reflection of direction d about unit normal n."""
    return d - 2.0 * dot(d, n) * n


def fresnel_exact(cos_incident, eta_in, eta_out):
    """Exact unpolarized Fresnel reflectance, the mean of Rs and Rp;
    ``cos_incident`` >= 0 in the incident medium of index ``eta_in``.
    1.0 under total internal reflection."""
    cos_i = torch.clamp(cos_incident, 0.0, 1.0)
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    sin_t = eta_in / eta_out * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    rs = (eta_in * cos_i - eta_out * cos_t) / (eta_in * cos_i + eta_out * cos_t)
    rp = (eta_in * cos_t - eta_out * cos_i) / (eta_in * cos_t + eta_out * cos_i)
    r = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, r)


def snell_whitted(d, n, ior):
    """Whitted-convention refraction: unit incident ``d`` toward the
    surface, *outward* unit normal ``n``, inside/outside by the sign of
    dot(d, n) (0 counts as inside).  The unit refracted direction, or the
    zero vector under total internal reflection."""
    cos_i = torch.clamp(dot(d, n), -1.0, 1.0)
    outside = cos_i < 0.0
    eta_ratio = torch.where(outside, 1.0 / ior[..., None], ior[..., None])
    cos_abs = torch.abs(cos_i)
    normal = torch.where(outside, n, -n)
    k = 1.0 - eta_ratio * eta_ratio * (1.0 - cos_abs * cos_abs)
    out = (eta_ratio * d
           + (eta_ratio * cos_abs - torch.sqrt(torch.clamp(k, min=0.0)))
           * normal)
    return torch.where(k < 0.0, 0.0, out)


def fresnel_whitted(d, n, ior):
    """Whitted-convention exact (polarized) Fresnel reflectance: incident
    ``d`` toward the surface, outward normal ``n``, index ``ior``; 1.0
    under TIR."""
    cos_i = torch.clamp(dot(d, n), -1.0, 1.0)[..., 0]
    outside = cos_i < 0.0
    one = torch.ones_like(ior)
    eta_in = torch.where(outside, one, ior)
    eta_out = torch.where(outside, ior, one)
    return fresnel_exact(torch.abs(cos_i), eta_in, eta_out)


def orthonormal_frame(n):
    """Tangent frame (X, Y) completing unit normal n, with the reference's
    |n.x| > |n.y| branch."""
    use_x = torch.abs(n[..., 0:1]) > torch.abs(n[..., 1:2])
    zero = torch.zeros_like(n[..., 0])
    y_a = torch.stack([n[..., 2], zero, -n[..., 0]], -1)
    y_b = torch.stack([zero, n[..., 2], -n[..., 1]], -1)
    y = normalize(torch.where(use_x, y_a, y_b))
    x = cross(y, n)
    return x, y


def hemisphere_surface_from(normal, u1, u2):
    """Uniform (by area) on the hemisphere around unit ``normal``, pdf 1/2pi."""
    z = u1[..., None]
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2[..., None]
    x, y = orthonormal_frame(normal)
    return r_xy * torch.cos(phi) * x + r_xy * torch.sin(phi) * y + z * normal


def triangle_from(u1, u2):
    """Barycentric weights (wa, wb, wc) uniform over a triangle with the
    reference's parameterization x = 1 - sqrt(u), then split (1-x) by v."""
    x = 1.0 - torch.sqrt(u1)
    return torch.stack([x, (1.0 - x) * u2, (1.0 - x) * (1.0 - u2)], -1)
