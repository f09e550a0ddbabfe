"""Vector math and direction sampling (port of
``cpu_based_ray_tracer_tpu.ops.vec``).

Functions over (..., 3) tensors.  Three-element sums are written out as
``x0 + x1 + x2``, the order in which the JAX package's ``jnp.sum`` over a
3-vector adds, so results round the same way.
"""

from __future__ import annotations

import math

import torch

from cpu_based_ray_tracer_tpu_torch.utils import consts


def _sum3(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0] + p[..., 1] + p[..., 2]


def div(x: torch.Tensor, c) -> torch.Tensor:
    """x / c for a Python number c, divided as a 0-dim tensor: CUDA builds
    of PyTorch turn a division by a Python scalar into a multiplication by
    its reciprocal, which rounds differently from the IEEE division of the
    JAX package and of the kernels.  The divisor is built once
    (``utils.consts``)."""
    return x / consts.scalar(c, x.dtype, x.device)


def take(table, idx):
    """``table[idx]`` along the first axis (idx (R,) integer), by
    ``index_select``: the same values, and a backward pass that adds the
    lanes' cotangents into the table with atomics (``index_add_``).
    Indexing's backward sorts the indices and walks each row's lanes in
    turn, which on the card takes milliseconds a gather when 200k lanes
    share a few rows (a material, a light triangle)."""
    return torch.index_select(table, 0, idx)


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


def refract(d, n, eta_ratio):
    """Snell refraction of unit incident d through unit normal n with
    eta_ratio = eta_in / eta_out (broadcast over the last axis).  Returns
    the refracted direction (the zero vector under total internal
    reflection) and the TIR mask."""
    cos_theta = torch.clamp(-dot(d, n), max=1.0)
    sin2 = torch.clamp(1.0 - cos_theta * cos_theta, min=0.0)
    sin2_refr = eta_ratio * eta_ratio * sin2
    tir = sin2_refr > 1.0
    cos_refr = torch.sqrt(torch.clamp(1.0 - sin2_refr, min=0.0))
    out = eta_ratio * d + (eta_ratio * cos_theta - cos_refr) * n
    return torch.where(tir, 0.0, out), tir[..., 0]


def pow5(x):
    """x ** 5 as the products XLA expands an integer power into:
    x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def schlick(cos_theta, eta_ratio):
    """Schlick reflectance approximation."""
    r0 = (1.0 - eta_ratio) / (1.0 + eta_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * pow5(1.0 - cos_theta)


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


# --- Samplers: explicit U[0,1) draws from utils.rng.uniforms4 ---------------

def sphere_from(u1, u2):
    """Uniform on the unit sphere, (..., 3)."""
    z = 1.0 - 2.0 * u1
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([r_xy * torch.cos(phi), r_xy * torch.sin(phi), z], -1)


def cube_root_radius(u3):
    """u3 ** (1/3), the radius of a uniform ball sample."""
    return torch.pow(u3, 1.0 / 3.0)


def ball_from(u1, u2, u3):
    """Uniform in the unit ball: a sphere sample scaled by u3 ** (1/3)."""
    return sphere_from(u1, u2) * cube_root_radius(u3)[..., None]


def hemisphere_volume_from(normal, u1, u2, u3):
    """Uniform in the unit half-ball around ``normal``."""
    d = ball_from(u1, u2, u3)
    return torch.where(dot(d, normal) > 0.0, d, -d)


def disk_from(u1, u2):
    """Uniform in the unit xy-disk (thin-lens depth of field), (..., 2)."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


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
