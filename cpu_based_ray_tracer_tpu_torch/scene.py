"""SoA scene representation (port of ``cpu_based_ray_tracer_tpu.scene``).

Frozen dataclasses of tensors in place of the JAX package's pytrees; every
constructor takes an explicit ``device``.  Field names, shapes, dtypes and
the constructors' float64-then-float32 arithmetic are those of the JAX
package, so the same inputs give the same leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# --- Material kinds (one enum for every material system of the reference) ---
LAMBERT = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_GLOSSY = 3  # Whitted Diffuse_Glossy / MC diffuse
REFLECTIVE = 4
REFLECTIVE_REFRACTIVE = 5

DIFFUSE_IN_SPHERE = 0
DIFFUSE_ON_SPHERE = 1
DIFFUSE_IN_HEMISPHERE = 2

TEX_NONE = 0
TEX_CHESSBOARD = 1

F32 = torch.float32


def flatten(obj) -> list:
    """The tensors of a (nested) dataclass of tensors, in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for f in dataclasses.fields(obj)
            for t in flatten(getattr(obj, f.name))]


def unflatten(obj, tensors):
    """``obj`` with its tensors, in ``flatten`` order, taken from the
    iterator ``tensors``."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    return dataclasses.replace(obj, **{
        f.name: unflatten(getattr(obj, f.name), tensors)
        for f in dataclasses.fields(obj)})


def to_device(obj, device):
    """``obj`` with every tensor field (recursively) moved to ``device``."""
    return unflatten(obj, (t.to(device) for t in flatten(obj)))


class _Tensors:
    def to(self, device):
        return to_device(self, device)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Triangles(_Tensors):
    """Triangle SoA: ``e1 = v1 - v0``, ``e2 = v2 - v0``, unit geometric
    ``normal = normalize(cross(e1, e2))``."""

    v0: torch.Tensor      # (N, 3) f32
    e1: torch.Tensor      # (N, 3) f32
    e2: torch.Tensor      # (N, 3) f32
    normal: torch.Tensor  # (N, 3) f32
    uv0: torch.Tensor     # (N, 2) f32
    uv1: torch.Tensor     # (N, 2)
    uv2: torch.Tensor     # (N, 2)
    material: torch.Tensor  # (N,) i32

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @property
    def area(self) -> torch.Tensor:
        """|e1 x e2| / 2, componentwise cross as the JAX package."""
        from cpu_based_ray_tracer_tpu_torch.ops import vec

        c = vec.cross(self.e1, self.e2)
        return 0.5 * torch.sqrt(c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1]
                                + c[:, 2] * c[:, 2])


@dataclasses.dataclass(frozen=True)
class Spheres(_Tensors):
    """Sphere SoA; a negative radius flips the outward normal."""

    center: torch.Tensor    # (M, 3) f32
    radius: torch.Tensor    # (M,) f32
    material: torch.Tensor  # (M,) i32

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass(frozen=True)
class Materials(_Tensors):
    """One flat material table; for MC diffuse, ``albedo`` is the diffuse
    coefficient and ``emission`` the area-light radiance."""

    kind: torch.Tensor      # (K,) i32
    albedo: torch.Tensor    # (K, 3) f32
    emission: torch.Tensor  # (K, 3) f32
    ior: torch.Tensor       # (K,) f32
    fuzz: torch.Tensor      # (K,) f32
    kd: torch.Tensor        # (K,) f32
    ks: torch.Tensor        # (K,) f32
    spec_exp: torch.Tensor  # (K,) f32
    texture: torch.Tensor   # (K,) i32

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    @property
    def emissive(self) -> torch.Tensor:
        """(K,) bool — the reference's emissive test |emission| > 1e-5."""
        e = self.emission
        return torch.sqrt(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]
                          + e[:, 2] * e[:, 2]) > 1e-5


@dataclasses.dataclass(frozen=True)
class PointLights(_Tensors):
    """Whitted-stage point lights {position, radiance}."""

    position: torch.Tensor  # (L, 3) f32
    radiance: torch.Tensor  # (L, 3) f32

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene(_Tensors):
    triangles: Triangles
    spheres: Spheres
    materials: Materials
    lights: PointLights
    sky_bottom: torch.Tensor  # (3,) f32 color at ray.y == -1
    sky_top: torch.Tensor     # (3,) f32 color at ray.y == +1

    @property
    def device(self) -> torch.device:
        return self.sky_top.device

    def sky(self, direction: torch.Tensor) -> torch.Tensor:
        """Miss-shader radiance for unit ray ``direction`` (..., 3)."""
        t = 0.5 * (direction[..., 1:2] + 1.0)
        return (1.0 - t) * self.sky_bottom + t * self.sky_top


# --- Constructors -------------------------------------------------------------

def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def make_triangles(vertices, material, uv=None, device="cpu") -> Triangles:
    """(N, 3, 3) per-triangle vertices + (N,) material ids; edges and normals
    in float64, stored as float32."""
    vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3, 3)
    v0, v1, v2 = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm > 0, norm, 1.0)
    if uv is None:
        uv = np.zeros((len(v0), 3, 2))
    uv = np.asarray(uv, dtype=np.float64).reshape(-1, 3, 2)
    return Triangles(
        v0=_f32(v0, device), e1=_f32(e1, device), e2=_f32(e2, device),
        normal=_f32(n, device), uv0=_f32(uv[:, 0], device),
        uv1=_f32(uv[:, 1], device), uv2=_f32(uv[:, 2], device),
        material=_i32(material, device))


def empty_triangles(device="cpu") -> Triangles:
    """One degenerate triangle that can never be hit (keeps shapes static)."""
    z3 = torch.zeros((1, 3), dtype=F32, device=device)
    z2 = torch.zeros((1, 2), dtype=F32, device=device)
    return Triangles(v0=z3, e1=z3, e2=z3, normal=z3, uv0=z2, uv1=z2, uv2=z2,
                     material=torch.zeros((1,), dtype=torch.int32,
                                          device=device))


def make_spheres(center, radius, material, device="cpu") -> Spheres:
    return Spheres(
        center=_f32(np.atleast_2d(np.asarray(center, np.float64)), device),
        radius=_f32(np.atleast_1d(np.asarray(radius, np.float64)), device),
        material=_i32(np.atleast_1d(material), device))


def empty_spheres(device="cpu") -> Spheres:
    """One radius-0 sphere at the origin (the never-hit placeholder)."""
    return Spheres(center=torch.zeros((1, 3), dtype=F32, device=device),
                   radius=torch.zeros((1,), dtype=F32, device=device),
                   material=torch.zeros((1,), dtype=torch.int32,
                                        device=device))


def empty_lights(device="cpu") -> PointLights:
    return PointLights(position=torch.zeros((1, 3), dtype=F32, device=device),
                       radiance=torch.zeros((1, 3), dtype=F32, device=device))


class MaterialBuilder:
    """Assemble the Materials SoA from per-material rows."""

    def __init__(self):
        self.rows = []

    def add(self, kind, albedo=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
            ior=1.0, fuzz=0.0, kd=0.8, ks=0.2, spec_exp=25.0,
            texture=TEX_NONE) -> int:
        """Returns the material id (Whitted defaults kd/ks/spec_exp)."""
        self.rows.append(dict(kind=kind, albedo=albedo, emission=emission,
                              ior=ior, fuzz=fuzz, kd=kd, ks=ks,
                              spec_exp=spec_exp, texture=texture))
        return len(self.rows) - 1

    def build(self, device="cpu") -> Materials:
        if not self.rows:
            self.add(LAMBERT)
        g = lambda k: [r[k] for r in self.rows]  # noqa: E731
        return Materials(
            kind=_i32(g("kind"), device), albedo=_f32(g("albedo"), device),
            emission=_f32(g("emission"), device), ior=_f32(g("ior"), device),
            fuzz=_f32(g("fuzz"), device), kd=_f32(g("kd"), device),
            ks=_f32(g("ks"), device), spec_exp=_f32(g("spec_exp"), device),
            texture=_i32(g("texture"), device))


def make_scene(triangles: Optional[Triangles] = None,
               spheres: Optional[Spheres] = None,
               materials: Optional[Materials] = None,
               lights: Optional[PointLights] = None,
               sky_bottom=(1.0, 1.0, 1.0), sky_top=(0.5, 0.7, 1.0),
               device="cpu") -> Scene:
    """A Scene on ``device``; missing parts get never-hit placeholders."""
    return Scene(
        triangles=(triangles if triangles is not None
                   else empty_triangles(device)).to(device),
        spheres=(spheres if spheres is not None
                 else empty_spheres(device)).to(device),
        materials=(materials if materials is not None
                   else MaterialBuilder().build(device)).to(device),
        lights=(lights if lights is not None
                else empty_lights(device)).to(device),
        sky_bottom=_f32(sky_bottom, device), sky_top=_f32(sky_top, device))
