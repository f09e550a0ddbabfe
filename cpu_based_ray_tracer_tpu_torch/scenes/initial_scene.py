"""The initial-framework scene (port of
``cpu_based_ray_tracer_tpu.scenes.initial_scene``): a magenta unit sphere
at the origin (roughness 0) and a blue r = 100 ground sphere at
(0, -101, 0) (roughness 0.1); camera (0, 0, 6) facing -z, vfov 35."""

from __future__ import annotations

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.scene import (LAMBERT, MaterialBuilder,
                                                  Scene, make_scene,
                                                  make_spheres)


def initial_scene(device="cpu") -> Scene:
    mb = MaterialBuilder()
    # The stage's roughness rides the shared ``fuzz`` field.
    magenta = mb.add(LAMBERT, albedo=(1.0, 0.0, 1.0), fuzz=0.0)
    blue = mb.add(LAMBERT, albedo=(0.2, 0.3, 1.0), fuzz=0.1)
    spheres = make_spheres(center=[[0.0, 0.0, 0.0], [0.0, -101.0, 0.0]],
                           radius=[1.0, 100.0], material=[magenta, blue])
    return make_scene(spheres=spheres, materials=mb.build(),
                      sky_bottom=(0.6, 0.7, 0.9), sky_top=(0.6, 0.7, 0.9),
                      device=device)


def initial_camera(device="cpu") -> cam_mod.PerspectiveCamera:
    return cam_mod.make_perspective_camera((0, 0, 6), (0, 0, -1),
                                           vfov_degrees=35.0, device=device)
