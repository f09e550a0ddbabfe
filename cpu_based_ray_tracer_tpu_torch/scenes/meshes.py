"""Procedural meshes and the BVH-stage scene (port of
``cpu_based_ray_tracer_tpu.scenes.meshes``).

The reference's mesh stage loads the Stanford bunny (scale 2, translate
(-1, 6.1, 0)) and the Utah teapot (scale 1, translate (-1, 3, 0)).  The
stand-ins here have the same layout and complexity class and need no asset
file; the real OBJ files load through ``utils.objio`` from the directory
that ``$CRT_REFERENCE_DIR`` names.
"""

from __future__ import annotations

import os

import numpy as np

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.scene import (DIFFUSE_GLOSSY,
                                                  MaterialBuilder,
                                                  PointLights, Scene, _f32,
                                                  make_scene, make_triangles)
from cpu_based_ray_tracer_tpu_torch.utils import objio


def icosphere(subdivisions: int = 4, radius: float = 1.0) -> np.ndarray:
    """Geodesic sphere triangle soup (T, 3, 3); subdivisions=4 -> 5120
    triangles."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    tris = v[f]
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tris = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)])
        n = np.linalg.norm(tris, axis=-1, keepdims=True)
        tris = tris / n
    return tris * radius


def torus(major: float = 1.0, minor: float = 0.35,
          n_u: int = 48, n_v: int = 24) -> np.ndarray:
    """Torus triangle soup, 2 * n_u * n_v triangles."""
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")

    def pt(uu, vv):
        x = (major + minor * np.cos(vv)) * np.cos(uu)
        y = minor * np.sin(vv)
        z = (major + minor * np.cos(vv)) * np.sin(uu)
        return np.stack([x, y, z], -1)

    u_next = np.roll(uu, -1, 0)
    v_next = np.roll(vv, -1, 1)
    p00 = pt(uu, vv)
    p10 = pt(u_next, vv)
    p01 = pt(uu, v_next)
    p11 = pt(u_next, v_next)
    quads_a = np.stack([p00, p10, p11], -2).reshape(-1, 3, 3)
    quads_b = np.stack([p00, p11, p01], -2).reshape(-1, 3, 3)
    return np.concatenate([quads_a, quads_b])


def transform(tris: np.ndarray, scale: float = 1.0,
              translate=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The reference mesh loader's uniform scale + translate."""
    return tris * scale + np.asarray(translate, np.float64)


def reference_asset_dir() -> str | None:
    """The reference checkout's directory of BVH-stage OBJ assets under
    ``$CRT_REFERENCE_DIR``; None when the variable is unset or the
    directory is missing."""
    root = os.environ.get("CRT_REFERENCE_DIR")
    if not root:
        return None
    p = os.path.join(root, "BVH Ray Tracer", "8599RayTracerGUI", "src")
    return p if os.path.isdir(p) else None


def _mesh_scene(tris: np.ndarray, device="cpu") -> Scene:
    """The BVH-stage materials and lights: grey Diffuse_Glossy (albedo 0.5,
    kd 0.6, ks 0, exponent 0) and two white point lights at (+-20, 70,
    20)."""
    mb = MaterialBuilder()
    grey = mb.add(DIFFUSE_GLOSSY, albedo=(0.5, 0.5, 0.5), ior=1.3,
                  kd=0.6, ks=0.0, spec_exp=0.0)
    mats = np.full(len(tris), grey, np.int32)
    lights = PointLights(
        position=_f32([[-20.0, 70.0, 20.0], [20.0, 70.0, 20.0]], device),
        radiance=_f32([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]], device))
    return make_scene(triangles=make_triangles(tris, mats, device=device),
                      materials=mb.build(device), lights=lights,
                      sky_bottom=(0.2, 0.7, 0.8), sky_top=(0.2, 0.7, 0.8),
                      device=device)


def bunny_teapot_scene(device="cpu") -> Scene:
    """The reference BVH stage's own scene: ``stanford_bunny.obj`` at scale
    2, translate (-1, 6.1, 0) and ``utah_teapot.obj`` at scale 1, translate
    (-1, 3, 0).  Raises FileNotFoundError without the assets."""
    src = reference_asset_dir()
    if src is None:
        raise FileNotFoundError("reference OBJ assets unavailable "
                                "(set $CRT_REFERENCE_DIR)")
    bunny, _ = objio.load_obj(os.path.join(src, "stanford_bunny.obj"),
                              scale=2.0, translate=(-1.0, 6.1, 0.0))
    teapot, _ = objio.load_obj(os.path.join(src, "utah_teapot.obj"),
                               scale=1.0, translate=(-1.0, 3.0, 0.0))
    return _mesh_scene(np.concatenate([bunny, teapot]), device)


def bvh_stage_scene(subdivisions: int = 3, device="cpu") -> Scene:
    """The BVH stage's layout with stand-ins: an icosphere for the bunny at
    scale 2, translate (-1, 6.1, 0), a torus for the teapot at scale 1,
    translate (-1, 3, 0) (3,584 triangles at the default subdivision)."""
    bunny = transform(icosphere(subdivisions, radius=1.0), 2.0, (-1, 6.1, 0))
    teapot = transform(torus(1.6, 0.6), 1.0, (-1, 3, 0))
    return _mesh_scene(np.concatenate([bunny, teapot]), device)


def bvh_stage_camera(device="cpu") -> cam_mod.PerspectiveCamera:
    """Camera at (-1, 5, 10) facing -z, vfov 35."""
    return cam_mod.make_perspective_camera((-1, 5, 10), (0, 0, -1),
                                           vfov_degrees=35.0, device=device)


def mesh_scene_from_obj(path, scale: float = 1.0,
                        translate=(0.0, 0.0, 0.0), device="cpu") -> Scene:
    """A scene straight from an OBJ and its .mtl: each group's Kd as the
    diffuse albedo and its Ke as emission, as the vendored loader's
    LoadMaterials allows (the reference itself overrides mesh materials in
    code; this constructor honours the files instead).  Black sky."""
    tris, _uv, tri_mtl, mtls = objio.load_obj_with_materials(
        path, scale=scale, translate=translate)
    mb = MaterialBuilder()
    ids = [mb.add(DIFFUSE_GLOSSY, albedo=m["kd"], emission=m["ke"],
                  ior=max(m["ni"], 1.0), kd=0.8, ks=0.2,
                  spec_exp=max(m["ns"], 1.0)) for m in mtls]
    mats = np.asarray([ids[j] for j in tri_mtl], np.int32)
    return make_scene(triangles=make_triangles(tris, mats, device=device),
                      materials=mb.build(device),
                      sky_bottom=(0.0, 0.0, 0.0), sky_top=(0.0, 0.0, 0.0),
                      device=device)
