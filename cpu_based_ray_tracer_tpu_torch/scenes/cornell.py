"""The Cornell box (port of ``cpu_based_ray_tracer_tpu.scenes.cornell``).

The standard Cornell-box data set (graphics.cornell.edu/online/box/data.html),
scaled by 0.01 like the reference mesh loader, with the reference MC
renderer's materials and camera; ``cornell_mesh_scene`` puts a triangle
mesh in place of the short box.
"""

from __future__ import annotations

import os

import numpy as np

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.scene import (DIFFUSE_GLOSSY,
                                                  MaterialBuilder, Scene,
                                                  make_scene, make_triangles)
from cpu_based_ray_tracer_tpu_torch.scenes import meshes
from cpu_based_ray_tracer_tpu_torch.utils import objio

MESH_SCALE = 0.01  # TriangleMesh.h:150

# Standard Cornell-box quads, one (4, 3) array per surface, in the original
# 552.8-unit coordinates.  Triangulation below matches the reference OBJ
# face order (floor.obj / light.obj / left.obj / right.obj faces).
_FLOOR = [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
          (549.6, 0.0, 559.2)]
_CEILING = [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2),
            (0.0, 548.8, 0.0)]
_BACK = [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2),
         (556.0, 548.8, 559.2)]
_LIGHT = [(343.0, 548.7, 227.0), (343.0, 548.7, 332.0), (213.0, 548.7, 332.0),
          (213.0, 548.7, 227.0)]
_LEFT_WALL = [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2),
              (556.0, 548.8, 0.0)]           # red in the reference
_RIGHT_WALL = [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0),
               (0.0, 548.8, 559.2)]          # green

# The two boxes: 5 visible quads each (no bottom face), as in the standard
# data / the reference shortbox.obj / tallbox.obj.
_SHORT_BOX = [
    [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0),
     (290.0, 165.0, 114.0)],                                     # top
    [(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0),
     (240.0, 0.0, 272.0)],
    [(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0),
     (290.0, 0.0, 114.0)],
    [(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0),
     (130.0, 0.0, 65.0)],
    [(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0),
     (82.0, 0.0, 225.0)],
]
_TALL_BOX = [
    [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0),
     (472.0, 330.0, 406.0)],                                     # top
    [(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0),
     (472.0, 0.0, 406.0)],
    [(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0),
     (314.0, 0.0, 456.0)],
    [(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0),
     (265.0, 0.0, 296.0)],
    [(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0),
     (423.0, 0.0, 247.0)],
]

# Reference material constants (Renderer.cpp:28-35).
RED = (0.63, 0.065, 0.05)
GREEN = (0.1, 0.5, 0.1)
WHITE = (0.7, 0.7, 0.7)
LIGHT_EMISSION = (47.8, 38.6, 31.1)
# Miss shader: night sky (Renderer.cpp:146).
NIGHT_SKY = (12 / 255.0, 20 / 255.0, 69 / 255.0)


def _quad_tris(quad) -> list:
    """Quad (a,b,c,d) -> triangles (a,b,c), (a,c,d) — the reference OBJ face
    pattern `f 1 2 3 / f 1 3 4` (floor.obj uses `f 3 4 1` for its second
    triangle, the same triangle up to rotation)."""
    a, b, c, d = quad
    return [[a, b, c], [a, c, d]]


def cornell_triangles() -> tuple[np.ndarray, list[str]]:
    """(N=32, 3, 3) triangle vertices (scaled) + per-triangle surface tag."""
    tris, tags = [], []
    for quad, tag in [(_FLOOR, "white"), (_CEILING, "white"), (_BACK, "white"),
                      (_LIGHT, "light"), (_LEFT_WALL, "red"),
                      (_RIGHT_WALL, "green")]:
        for t in _quad_tris(quad):
            tris.append(t)
            tags.append(tag)
    for box in (_SHORT_BOX, _TALL_BOX):
        for quad in box:
            for t in _quad_tris(quad):
                tris.append(t)
                tags.append("white")
    return np.asarray(tris, np.float64) * MESH_SCALE, tags


def _materials():
    """The reference MC renderer's materials, by surface tag."""
    mb = MaterialBuilder()
    ids = {
        "white": mb.add(DIFFUSE_GLOSSY, albedo=WHITE),
        "red": mb.add(DIFFUSE_GLOSSY, albedo=RED),
        "green": mb.add(DIFFUSE_GLOSSY, albedo=GREEN),
        "light": mb.add(DIFFUSE_GLOSSY, albedo=WHITE,
                        emission=LIGHT_EMISSION),
    }
    return mb, ids


def cornell_scene(device="cpu") -> Scene:
    """32-triangle Cornell box with the reference's materials; the only light
    is the emissive ceiling quad (area-light sampling targets it)."""
    mb, ids = _materials()
    verts, tags = cornell_triangles()
    mats = np.array([ids[t] for t in tags], np.int32)
    return make_scene(triangles=make_triangles(verts, mats, device=device),
                      materials=mb.build(device),
                      sky_bottom=NIGHT_SKY, sky_top=NIGHT_SKY, device=device)


def cornell_mesh_scene(mesh_tris: np.ndarray | None = None,
                       height: float = 1.8, device="cpu") -> Scene:
    """The Cornell box with a triangle MESH in place of the short box: the
    workload of the accelerated intersectors inside the MC estimator
    (``models.mesh.render_mc``).

    ``mesh_tris``: (T, 3, 3) triangle soup in any coordinates, scaled to
    ``height`` and stood on the floor at the short box's footprint center.
    Default: ``stanford_bunny.obj`` where ``$CRT_REFERENCE_DIR`` holds the
    reference assets, else the icosphere stand-in (1,280 triangles)."""
    if mesh_tris is None:
        src = meshes.reference_asset_dir()
        if src is not None:
            mesh_tris, _ = objio.load_obj(
                os.path.join(src, "stanford_bunny.obj"))
        else:
            mesh_tris = meshes.icosphere(3, radius=1.0)
    mesh_tris = np.asarray(mesh_tris, np.float64)
    lo = mesh_tris.reshape(-1, 3).min(0)
    hi = mesh_tris.reshape(-1, 3).max(0)
    scale = height / max(hi[1] - lo[1], 1e-9)
    center = (lo + hi) / 2.0
    # Short-box footprint center (scaled): x 1.86, z 1.685.
    target = np.array([1.86, 0.0, 1.685])
    offset = target - np.array([center[0], lo[1], center[2]]) * scale
    mesh_tris = mesh_tris * scale + offset

    mb, ids = _materials()
    verts, tags = cornell_triangles()
    # 12 wall/light triangles, the short box's 10, the tall box's 10: drop
    # the short box.
    keep = list(range(0, 12)) + list(range(22, 32))
    verts = np.concatenate([verts[keep], mesh_tris])
    tags = [tags[i] for i in keep] + ["white"] * len(mesh_tris)
    mats = np.array([ids[t] for t in tags], np.int32)
    return make_scene(triangles=make_triangles(verts, mats, device=device),
                      materials=mb.build(device),
                      sky_bottom=NIGHT_SKY, sky_top=NIGHT_SKY, device=device)


def cornell_camera(device="cpu") -> cam_mod.PerspectiveCamera:
    """MC/Denoiser camera pose (reference Camera.h:19-20), vfov 35."""
    return cam_mod.make_perspective_camera(
        position=(2.81432, 4.20749, -9.11751),
        forward=(0.00209191, -0.148299, 0.988941),
        vfov_degrees=35.0, device=device)
