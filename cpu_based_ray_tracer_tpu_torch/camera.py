"""Cameras and ray generation (port of ``cpu_based_ray_tracer_tpu.camera``).

- ``ThinLensCamera``: the RTIOW look-from/look-at camera with an aperture
  (the offline prototype's depth of field);
- ``PerspectiveCamera``: the interactive GUI camera;
- ``FlyCameraController``: the host-side WASD / mouse fly camera that moves
  it between frames (numpy).

Same floating-point operation order as the JAX package: the fused kernels'
in-kernel camera rays (``ops.fused``, ``ops.fused_rtiow``) rely on it.
Row 0 is the TOP scanline.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.scene import to_device


class _Fields:
    def to(self, device):
        return to_device(self, device)


@dataclasses.dataclass(frozen=True)
class ThinLensCamera(_Fields):
    """RTIOW thin-lens camera: focus distance |look_at - look_from|,
    aperture 0 disables depth of field."""

    origin: torch.Tensor       # (3,)
    lower_left: torch.Tensor   # (3,) lower-left corner of the image plane
    horizontal: torch.Tensor   # (3,) full-width image-plane vector
    vertical: torch.Tensor     # (3,) full-height image-plane vector
    u: torch.Tensor            # (3,) camera basis (right)
    v: torch.Tensor            # (3,) camera basis (up)
    lens_radius: torch.Tensor  # () aperture / 2


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def make_thin_lens_camera(look_from, look_at, up, vfov_degrees, aspect_ratio,
                          aperture=0.0, device="cpu") -> ThinLensCamera:
    """Built in float64 numpy, stored as float32 (as the JAX package)."""
    look_from = np.asarray(look_from, np.float64)
    look_at = np.asarray(look_at, np.float64)
    up = np.asarray(up, np.float64)
    half_h = np.tan(np.radians(vfov_degrees) / 2.0)
    half_w = aspect_ratio * half_h
    w = look_from - look_at
    focus = np.linalg.norm(w)
    w = w / focus
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    lower_left = look_from - half_w * focus * u - half_h * focus * v - focus * w
    return ThinLensCamera(
        origin=_f32(look_from, device), lower_left=_f32(lower_left, device),
        horizontal=_f32(2 * half_w * focus * u, device),
        vertical=_f32(2 * half_h * focus * v, device),
        u=_f32(u, device), v=_f32(v, device),
        lens_radius=_f32(aperture / 2.0, device))


def thin_lens_rays(cam: ThinLensCamera, s, t, lens_u1, lens_u2):
    """Rays for image-plane coords s (left to right) and t (bottom to top)
    in [0, 1]: the origin jittered on the lens disk by the U[0,1) draws
    ``lens_u1`` / ``lens_u2``, the unit direction to the focus-plane point.
    Returns (origin, direction), each (..., 3)."""
    disk = vec.disk_from(lens_u1, lens_u2) * cam.lens_radius
    offset = cam.u * disk[..., 0:1] + cam.v * disk[..., 1:2]
    origin = cam.origin + offset
    target = (cam.lower_left + s[..., None] * cam.horizontal
              + t[..., None] * cam.vertical)
    return origin, vec.normalize(target - origin)


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera(_Fields):
    """GUI fly-camera pose; width/height are arguments of the ray-gen."""

    position: torch.Tensor      # (3,)
    forward: torch.Tensor       # (3,) unit
    up: torch.Tensor            # (3,) world up
    vfov_degrees: torch.Tensor  # ()


def make_perspective_camera(position, forward, up=(0.0, 1.0, 0.0),
                            vfov_degrees=45.0, device="cpu"
                            ) -> PerspectiveCamera:
    fwd = np.asarray(forward, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    return PerspectiveCamera(
        position=_f32(position, device), forward=_f32(fwd, device),
        up=_f32(np.asarray(up, np.float64), device),
        vfov_degrees=_f32(vfov_degrees, device))


def camera_basis(cam: PerspectiveCamera):
    """Right/up'/forward orthonormal basis (glm::lookAt convention)."""
    right = vec.normalize(vec.cross(cam.forward, cam.up))
    true_up = vec.cross(right, cam.forward)
    return right, true_up, cam.forward


def tan_half_fov(cam: PerspectiveCamera) -> torch.Tensor:
    """tan(radians(vfov) / 2) in float32, as ``jnp.radians`` / ``jnp.tan``."""
    return torch.tan(cam.vfov_degrees * (math.pi / 180.0) / 2.0)


def _dirs(cam, width, height, x, y, jx, jy):
    ndc_x = vec.div(x + jx, width) * 2.0 - 1.0
    ndc_y = -(vec.div(y + jy, height) * 2.0 - 1.0)  # row 0 = top scanline
    t = tan_half_fov(cam)
    aspect = width / height
    right, true_up, fwd = camera_basis(cam)
    d = (ndc_x[..., None] * (t * aspect) * right
         + ndc_y[..., None] * t * true_up + fwd)
    return vec.normalize(d)


def perspective_rays(cam: PerspectiveCamera, width: int, height: int,
                     jitter: torch.Tensor | None = None):
    """World-space unit ray directions for every pixel, (H, W, 3).

    ``jitter``: (H, W, 2) uniforms in [0,1) for in-pixel jitter; None =
    pixel centers."""
    return perspective_rays_slab(cam, width, height, 0, height, jitter)


def perspective_rays_slab(cam: PerspectiveCamera, width: int, height: int,
                          row0: int, n_rows: int,
                          jitter: torch.Tensor | None = None):
    """Ray directions for the row slab [row0, row0 + n_rows), (n_rows, W, 3)."""
    dev = cam.position.device
    x = torch.arange(width, dtype=torch.float32, device=dev)
    y = torch.arange(n_rows, dtype=torch.float32, device=dev) + row0
    yy, xx = torch.meshgrid(y, x, indexing="ij")  # (n_rows, W)
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    return _dirs(cam, width, height, xx, yy, jx, jy)


def perspective_ray_at(cam: PerspectiveCamera, width: int, height: int,
                       pixel: torch.Tensor, jx: torch.Tensor,
                       jy: torch.Tensor):
    """Unit ray direction for flat row-major ``pixel`` indices, (R, 3);
    ``jx``/``jy``: in-pixel jitter in [0, 1)."""
    pixel = pixel.to(torch.int64)
    x = (pixel % width).to(torch.float32)
    y = (pixel // width).to(torch.float32)
    return _dirs(cam, width, height, x, y, jx, jy)


def view_proj_matrices(cam: PerspectiveCamera, width: int, height: int,
                       near: float = 0.1, far: float = 100.0):
    """(view, proj) 4x4 float32 matrices matching glm::lookAt and
    glm::perspectiveFov (right-handed, NDC z in [-1, 1]); row-major, so
    ``view @ [p; 1]``.  The temporal denoiser reprojects through the
    previous frame's pair."""
    right, true_up, fwd = camera_basis(cam)
    eye = cam.position
    one = torch.ones((1,), dtype=eye.dtype, device=eye.device)
    view = torch.stack([
        torch.cat([right, -vec.dot(right, eye)]),
        torch.cat([true_up, -vec.dot(true_up, eye)]),
        torch.cat([-fwd, vec.dot(fwd, eye)]),
        torch.cat([torch.zeros((3,), dtype=eye.dtype, device=eye.device),
                   one])])
    f = 1.0 / tan_half_fov(cam)
    aspect = width / height
    proj = torch.zeros((4, 4), dtype=eye.dtype, device=eye.device)
    proj[0, 0] = vec.div(f, aspect)
    proj[1, 1] = f
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    return view, proj


@dataclasses.dataclass(frozen=True)
class FlyCameraController:
    """Host-side WASD / mouse fly-camera state machine mirroring the
    reference's interactive camera (``initial framework/.../Camera.cpp:
    23-87``): speed 5, pitch and yaw from mouse deltas.  Plain numpy in
    float64, run between frames; ``camera`` gives the pose as a
    ``PerspectiveCamera``."""

    position: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    vfov_degrees: float = 45.0
    speed: float = 5.0           # Camera.cpp:44
    rotation_speed: float = 0.3  # mouse sensitivity

    def moved(self, keys: set[str], mouse_delta=(0.0, 0.0), dt: float = 0.016
              ) -> "FlyCameraController":
        fwd = self.forward / np.linalg.norm(self.forward)
        up = np.asarray(self.up, np.float64)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        pos = np.asarray(self.position, np.float64).copy()
        step = self.speed * dt
        for key, axis, sign in (("w", fwd, 1), ("s", fwd, -1),
                                ("a", right, -1), ("d", right, 1),
                                ("space", up, 1), ("shift", up, -1)):
            if key in keys:
                pos = pos + axis * step if sign > 0 else pos - axis * step
        dx, dy = mouse_delta
        if dx or dy:
            yaw = -dx * self.rotation_speed
            pitch = -dy * self.rotation_speed
            fwd = _rotate(fwd, up, yaw)
            right = np.cross(fwd, up)
            right /= np.linalg.norm(right)
            fwd = _rotate(fwd, right, pitch)
        return dataclasses.replace(self, position=pos, forward=fwd)

    def camera(self, device="cpu") -> PerspectiveCamera:
        return make_perspective_camera(self.position, self.forward, self.up,
                                       self.vfov_degrees, device=device)


def _rotate(v: np.ndarray, axis: np.ndarray, angle_rad: float) -> np.ndarray:
    """Rodrigues' rotation of ``v`` about ``axis`` by ``angle_rad``."""
    axis = axis / np.linalg.norm(axis)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return (v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c))
