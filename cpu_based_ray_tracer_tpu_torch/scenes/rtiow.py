"""RTIOW sphere scenes and cameras of the offline prototype and NPPT stages
(port of ``cpu_based_ray_tracer_tpu.scenes.rtiow``)."""

from __future__ import annotations

import numpy as np

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.scene import (DIELECTRIC, LAMBERT, METAL,
                                                  MaterialBuilder, Scene,
                                                  make_scene, make_spheres)

# The RTIOW sky gradient.
SKY_BOTTOM = (1.0, 1.0, 1.0)
SKY_TOP = (0.5, 0.7, 1.0)


def offline_two_sphere_scene(device="cpu") -> Scene:
    """The offline prototype's active scene: two touching r = cos(pi/4)
    diffuse spheres, blue left, red right."""
    mb = MaterialBuilder()
    blue = mb.add(LAMBERT, albedo=(0.0, 0.0, 1.0))
    red = mb.add(LAMBERT, albedo=(1.0, 0.0, 0.0))
    r = float(np.cos(np.pi / 4.0))
    spheres = make_spheres(center=[[-r, 0.0, -1.0], [r, 0.0, -1.0]],
                           radius=[r, r], material=[blue, red])
    return make_scene(spheres=spheres, materials=mb.build(),
                      sky_bottom=SKY_BOTTOM, sky_top=SKY_TOP, device=device)


def offline_camera(aspect_ratio: float = 16.0 / 9.0, aperture: float = 0.0,
                   device="cpu") -> cam_mod.ThinLensCamera:
    """90-degree camera at the origin looking down -z."""
    return cam_mod.make_thin_lens_camera((0, 0, 0), (0, 0, -1), (0, 1, 0),
                                         90.0, aspect_ratio, aperture,
                                         device=device)


def offline_dof_camera(aspect_ratio: float = 16.0 / 9.0,
                       device="cpu") -> cam_mod.ThinLensCamera:
    """The depth-of-field configuration: from (3, 3, 2) toward a point 1/8
    of the way to (0, 0, -1), vfov 20, aperture 2."""
    at = (np.array([3.0, 3.0, 2.0]) - np.array([0.0, 0.0, -1.0])) / 8.0 \
        + np.array([0.0, 0.0, -1.0])
    return cam_mod.make_thin_lens_camera((3, 3, 2), tuple(at), (0, 1, 0),
                                         20.0, aspect_ratio, aperture=2.0,
                                         device=device)


def rtiow_classic_scene(device="cpu") -> Scene:
    """The RTIOW ground / center / glass with a hollow bubble / metal
    scene."""
    mb = MaterialBuilder()
    ground = mb.add(LAMBERT, albedo=(0.8, 0.8, 0.0))
    center = mb.add(LAMBERT, albedo=(0.1, 0.2, 0.5))
    glass = mb.add(DIELECTRIC, ior=1.5)
    metal = mb.add(METAL, albedo=(0.8, 0.6, 0.2), fuzz=0.0)
    spheres = make_spheres(
        center=[[0.0, -100.5, -1.0], [0.0, 0.0, -1.0], [-1.0, 0.0, -1.0],
                [-1.0, 0.0, -1.0], [1.0, 0.0, -1.0]],
        radius=[100.0, 0.5, 0.5, -0.45, 0.5],   # -0.45: hollow bubble
        material=[ground, center, glass, glass, metal])
    return make_scene(spheres=spheres, materials=mb.build(),
                      sky_bottom=SKY_BOTTOM, sky_top=SKY_TOP, device=device)


def nppt_scene(device="cpu") -> Scene:
    """The NPPT GUI scene: ground, back diffuse, left mirror metal, hollow
    glass above, right fuzzy metal."""
    mb = MaterialBuilder()
    ground = mb.add(LAMBERT, albedo=(0.8, 0.8, 0.0))
    back = mb.add(LAMBERT, albedo=(0.1, 0.2, 0.5))
    glass = mb.add(DIELECTRIC, ior=1.5)
    left = mb.add(METAL, albedo=(0.8, 0.2, 0.2), fuzz=0.0)
    right = mb.add(METAL, albedo=(0.8, 0.6, 0.2), fuzz=0.5)
    spheres = make_spheres(
        center=[[0.0, -100.5, -1.0], [0.0, 0.0, -3.0], [-1.0, 0.0, -1.0],
                [0.0, 2.0, -2.0], [0.0, 2.0, -2.0], [1.0, 0.0, -1.0]],
        radius=[100.0, 0.5, 0.5, 0.5, -0.05, 0.5],
        material=[ground, back, left, glass, glass, right])
    return make_scene(spheres=spheres, materials=mb.build(),
                      sky_bottom=SKY_BOTTOM, sky_top=SKY_TOP, device=device)


def nppt_camera(device="cpu") -> cam_mod.PerspectiveCamera:
    """The NPPT camera: (0, 0, 6) facing -z, vfov 35."""
    return cam_mod.make_perspective_camera((0, 0, 6), (0, 0, -1),
                                           vfov_degrees=35.0, device=device)
