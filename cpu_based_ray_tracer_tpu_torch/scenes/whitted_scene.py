"""The Whitted-stage scene (port of
``cpu_based_ray_tracer_tpu.scenes.whitted_scene``): a diffuse sphere, a
glass sphere, a two-triangle chessboard floor and two point lights under a
constant sky (0.2, 0.7, 0.8)."""

from __future__ import annotations

import numpy as np

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.scene import (DIFFUSE_GLOSSY,
                                                  REFLECTIVE_REFRACTIVE,
                                                  TEX_CHESSBOARD,
                                                  MaterialBuilder,
                                                  PointLights, Scene, _f32,
                                                  make_scene, make_spheres,
                                                  make_triangles)

SKY = (0.2, 0.7, 0.8)
# Chessboard palette and frequency of the floor texture.
CHESS_A = (0.815, 0.235, 0.031)
CHESS_B = (0.937, 0.937, 0.231)
CHESS_FREQUENCY = 5.0


def whitted_scene(device="cpu") -> Scene:
    mb = MaterialBuilder()
    # Entity defaults: ior 1.3, kd 0.8, ks 0.2, exponent 25.
    diffuse = mb.add(DIFFUSE_GLOSSY, albedo=(0.6, 0.7, 0.8), ior=1.3)
    glass = mb.add(REFLECTIVE_REFRACTIVE, ior=1.5)
    floor = mb.add(DIFFUSE_GLOSSY, ior=1.3, texture=TEX_CHESSBOARD)

    spheres = make_spheres(center=[[-1.0, 0.0, -12.0], [0.5, -0.5, -8.0]],
                           radius=[2.0, 1.5], material=[diffuse, glass],
                           device=device)

    # Floor quad with uv (0,0) (1,0) (1,1) (0,1), triangles (0,1,3) (1,2,3).
    v = np.array([[-5, -3, -6], [5, -3, -6], [5, -3, -16], [-5, -3, -16]],
                 np.float64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    idx = np.array([[0, 1, 3], [1, 2, 3]])
    tris = make_triangles(v[idx], np.array([floor, floor]), uv=uv[idx],
                          device=device)

    lights = PointLights(
        position=_f32([[-20.0, 70.0, 20.0], [30.0, 50.0, -12.0]], device),
        radiance=_f32([[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]], device))

    return make_scene(triangles=tris, spheres=spheres,
                      materials=mb.build(device), lights=lights,
                      sky_bottom=SKY, sky_top=SKY, device=device)


def whitted_camera(device="cpu") -> cam_mod.PerspectiveCamera:
    """Camera at (0, 0, 6) facing -z, vfov 35."""
    return cam_mod.make_perspective_camera((0, 0, 6), (0, 0, -1),
                                           vfov_degrees=35.0, device=device)
