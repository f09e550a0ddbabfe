"""Scenes and cameras of the benchmark's configurations, in plain NumPy and
PyTorch, for the reference renderers.

The Cornell box is the standard data set (graphics.cornell.edu/online/box/
data.html) scaled by 0.01, with the reference MC renderer's materials; the
mesh configuration puts a triangle soup in place of the short box, scaled
to a height of 1.8 and stood on the floor at the short box's footprint.
Every array is built as the system under test documents its construction
(vertices in float64, edges and unit normals in float64, stored as
float32), so the same inputs give the same float32 triangles.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

MESH_SCALE = 0.01
_FLOOR = [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
          (549.6, 0.0, 559.2)]
_CEILING = [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2),
            (0.0, 548.8, 0.0)]
_BACK = [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2),
         (556.0, 548.8, 559.2)]
_LIGHT = [(343.0, 548.7, 227.0), (343.0, 548.7, 332.0), (213.0, 548.7, 332.0),
          (213.0, 548.7, 227.0)]
_LEFT_WALL = [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2),
              (556.0, 548.8, 0.0)]
_RIGHT_WALL = [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0),
               (0.0, 548.8, 559.2)]
_SHORT_BOX = [
    [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0),
     (290.0, 165.0, 114.0)],
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
     (472.0, 330.0, 406.0)],
    [(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0),
     (472.0, 0.0, 406.0)],
    [(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0),
     (314.0, 0.0, 456.0)],
    [(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0),
     (265.0, 0.0, 296.0)],
    [(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0),
     (423.0, 0.0, 247.0)],
]
# Material rows: white, red, green, light (albedo, emission).
ALBEDO = ((0.7, 0.7, 0.7), (0.63, 0.065, 0.05), (0.1, 0.5, 0.1),
          (0.7, 0.7, 0.7))
EMISSION = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
            (47.8, 38.6, 31.1))
MAT_ID = {"white": 0, "red": 1, "green": 2, "light": 3}
NIGHT_SKY = (12 / 255.0, 20 / 255.0, 69 / 255.0)
CAMERA_POSITION = (2.81432, 4.20749, -9.11751)
CAMERA_FORWARD = (0.00209191, -0.148299, 0.988941)
CAMERA_VFOV = 35.0


def cornell_triangles() -> tuple[np.ndarray, np.ndarray]:
    """(32, 3, 3) float64 vertices (scaled) and (32,) material ids."""
    tris, mats = [], []
    for quad, tag in [(_FLOOR, "white"), (_CEILING, "white"), (_BACK, "white"),
                      (_LIGHT, "light"), (_LEFT_WALL, "red"),
                      (_RIGHT_WALL, "green")] + [
            (q, "white") for box in (_SHORT_BOX, _TALL_BOX) for q in box]:
        a, b, c, d = quad
        for t in ([a, b, c], [a, c, d]):
            tris.append(t)
            mats.append(MAT_ID[tag])
    return np.asarray(tris, np.float64) * MESH_SCALE, np.asarray(mats)


def icosphere(subdivisions: int) -> np.ndarray:
    """Geodesic sphere triangle soup (20 * 4**subdivisions, 3, 3)."""
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
        tris = tris / np.linalg.norm(tris, axis=-1, keepdims=True)
    return tris


def mesh_soup(spec: dict) -> np.ndarray:
    """The raw triangle soup a mesh configuration names: icospheres, each
    ``{"subdivisions", "scale", "offset"}``, concatenated in order."""
    parts = [icosphere(int(s["subdivisions"])) * float(s["scale"])
             + np.asarray(s["offset"], np.float64) for s in spec["icospheres"]]
    return np.concatenate(parts)


def cornell_mesh_triangles(mesh_tris: np.ndarray, height: float
                           ) -> tuple[np.ndarray, np.ndarray]:
    """The Cornell box without its short box, and ``mesh_tris`` scaled to
    ``height`` and stood on the floor at the short box's footprint center
    (1.86, 0, 1.685): the room's 22 triangles first, then the mesh."""
    mesh_tris = np.asarray(mesh_tris, np.float64)
    lo = mesh_tris.reshape(-1, 3).min(0)
    hi = mesh_tris.reshape(-1, 3).max(0)
    scale = height / max(hi[1] - lo[1], 1e-9)
    center = (lo + hi) / 2.0
    target = np.array([1.86, 0.0, 1.685])
    offset = target - np.array([center[0], lo[1], center[2]]) * scale
    mesh_tris = mesh_tris * scale + offset
    verts, mats = cornell_triangles()
    keep = list(range(0, 12)) + list(range(22, 32))
    return (np.concatenate([verts[keep], mesh_tris]),
            np.concatenate([mats[keep],
                            np.full(len(mesh_tris), MAT_ID["white"])]))


def config_triangles(config: dict):
    """(vertices, material ids, the raw mesh soup that the program is
    given or None) of a configuration's scene, which has to hold the
    configuration's ``triangles``."""
    if config["scene"] == "cornell":
        verts, mats = cornell_triangles()
        soup = None
    else:
        soup = mesh_soup(config["mesh"])
        verts, mats = cornell_mesh_triangles(soup, config["mesh"]["height"])
    if len(verts) != config["triangles"]:
        raise ValueError(f"{len(verts)} triangles, the configuration states "
                         f"{config['triangles']}")
    return verts, mats, soup


@dataclasses.dataclass(frozen=True)
class RefScene:
    """Triangles only (the configurations hold no sphere), per triangle its
    material's planes, and the NEE light table."""

    v0: torch.Tensor        # (N, 3)
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor    # (N, 3) unit geometric normal
    albedo: torch.Tensor    # (N, 3)
    emission: torch.Tensor  # (N, 3)
    emissive: torch.Tensor  # (N,) bool
    mat: torch.Tensor       # (N,) int64 material id
    light: torch.Tensor     # (Le, 16): v0 e1 e2 normal emission cdf
    light_total: torch.Tensor  # () float
    sky: torch.Tensor       # (6,): bottom, top

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    def cast(self, dtype) -> "RefScene":
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if v.is_floating_point():
                kw[k] = v.to(dtype)
        return RefScene(**kw)


def ref_scene(verts: np.ndarray, mats: np.ndarray, device) -> RefScene:
    """The float32 scene planes of (N, 3, 3) float64 vertices and (N,)
    material ids, with the light table of the emissive triangles (their
    float32 areas' running sum in triangle order)."""
    verts = np.asarray(verts, np.float64)
    v0 = verts[:, 0]
    e1, e2 = verts[:, 1] - v0, verts[:, 2] - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm > 0, norm, 1.0)
    v0, e1, e2, n = (x.astype(np.float32) for x in (v0, e1, e2, n))
    alb = np.asarray(ALBEDO, np.float32)[mats]
    emi_table = np.asarray(EMISSION, np.float32)
    emi = emi_table[mats]
    emf = (np.linalg.norm(emi_table, axis=-1) > 1e-5)[mats]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).astype(np.float32)
    lidx = np.flatnonzero(emf)
    masked = np.where(emf, area, np.float32(0.0)).astype(np.float32)
    cdf_full = np.cumsum(masked, dtype=np.float32)
    light = np.zeros((len(lidx), 16), np.float32)
    light[:, 0:3], light[:, 3:6], light[:, 6:9] = v0[lidx], e1[lidx], e2[lidx]
    light[:, 9:12], light[:, 12:15] = n[lidx], emi[lidx]
    light[:, 15] = cdf_full[lidx]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return RefScene(
        v0=t(v0), e1=t(e1), e2=t(e2), normal=t(n), albedo=t(alb),
        emission=t(emi), emissive=t(emf), mat=t(np.asarray(mats, np.int64)),
        light=t(light), light_total=t(cdf_full[-1]),
        sky=t(np.asarray(NIGHT_SKY * 2, np.float32)))


@dataclasses.dataclass(frozen=True)
class RefCamera:
    position: torch.Tensor  # (3,)
    right: torch.Tensor
    true_up: torch.Tensor
    forward: torch.Tensor
    tan_half: torch.Tensor  # ()

    def cast(self, dtype) -> "RefCamera":
        return RefCamera(*(getattr(self, f.name).to(dtype)
                           for f in dataclasses.fields(self)))


def _normalize(a: torch.Tensor) -> torch.Tensor:
    n2 = torch.clamp(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                     + a[..., 2] * a[..., 2], min=1e-12 * 1e-12)
    return a / torch.sqrt(n2)[..., None]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def ref_camera(position, forward, vfov_degrees, device) -> RefCamera:
    """A pinhole camera (glm::lookAt basis, world up +y): the forward
    vector normalized in float64, the basis and tan(vfov / 2) in float32."""
    fwd = np.asarray(forward, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    pos, fwd_t, up = f32(position), f32(fwd), f32((0.0, 1.0, 0.0))
    right = _normalize(_cross(fwd_t, up))
    true_up = _cross(right, fwd_t)
    tan_half = torch.tan(f32(vfov_degrees) * (math.pi / 180.0) / 2.0)
    return RefCamera(pos, right, true_up, fwd_t, tan_half)


def camera_dirs(cam: RefCamera, width: int, height: int, pixel, jx, jy,
                rsqrt: bool) -> torch.Tensor:
    """Unit directions (R, 3) through flat row-major ``pixel`` at in-pixel
    offsets (jx, jy).  ``rsqrt``: normalize by x * rsqrt(|x|^2) (how a lane
    regenerates its camera ray) instead of x / sqrt(|x|^2) (how the first
    sample's rays and the pixel-center rays are made)."""
    dt = cam.tan_half.dtype
    x = (pixel % width).to(dt)
    y = (pixel // width).to(dt)
    w_t = torch.tensor(width, dtype=dt, device=x.device)
    h_t = torch.tensor(height, dtype=dt, device=x.device)
    ndc_x = (x + jx) / w_t * 2.0 - 1.0
    ndc_y = -((y + jy) / h_t * 2.0 - 1.0)
    a = ndc_x * (cam.tan_half * (width / height))
    b = ndc_y * cam.tan_half
    d = (a[:, None] * cam.right + b[:, None] * cam.true_up) + cam.forward
    n2 = torch.clamp(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2],
                     min=1e-24)
    if rsqrt:
        return d * torch.rsqrt(n2)[:, None]
    return d / torch.sqrt(n2)[:, None]


def view_proj(cam: RefCamera, width: int, height: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """glm::lookAt and glm::perspectiveFov (near 0.1, far 100) as
    row-major 4x4 matrices."""
    near, far = 0.1, 100.0
    r, u, f, eye = cam.right, cam.true_up, cam.forward, cam.position
    dot = lambda a, b: (a[0] * b[0] + a[1] * b[1] + a[2] * b[2])[None]  # noqa: E731
    one = torch.ones((1,), dtype=eye.dtype, device=eye.device)
    view = torch.stack([torch.cat([r, -dot(r, eye)]),
                        torch.cat([u, -dot(u, eye)]),
                        torch.cat([-f, dot(f, eye)]),
                        torch.cat([torch.zeros_like(eye), one])])
    fl = 1.0 / cam.tan_half
    proj = torch.zeros((4, 4), dtype=eye.dtype, device=eye.device)
    proj[0, 0] = fl / torch.tensor(width / height, dtype=eye.dtype,
                                   device=eye.device)
    proj[1, 1] = fl
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = -(2.0 * far * near) / (far - near)
    proj[3, 2] = -1.0
    return view, proj
