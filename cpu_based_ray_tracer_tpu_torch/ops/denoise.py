"""Joint-bilateral spatial and motion-vector temporal denoising (port of
``cpu_based_ray_tracer_tpu.ops.denoise``).  The JAX package has no kernel
here; the port has one, the a-trous level.

- Joint bilateral: the K^2 window offsets are a loop over shifted images,
  each one elementwise pass over the frame (``joint_bilateral``, the dense
  oracle), or the edge-avoiding a-trous approximation with 5x5 dilated taps
  (``joint_bilateral_atrous``, the default).  On the card each a-trous
  level is one launch of ``csrc/denoise.cu`` (counter ``LAUNCHES``), bit
  equal to its plain twin ``_atrous_level_plain``, which runs on the CPU.
- Temporal: reprojection through the previous frame's view/projection
  matrices, a primitive-id consistency test, then history clamped to
  mean +- tolerance * RMS-deviation-from-center over the current frame's
  window (box sums by cumulative sums), blended with the current color.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.utils import kernels, profiling

# Heuristic sigmas of the reference denoiser.
SIGMA_POSITION = 32.0
SIGMA_COLOR = 0.6
SIGMA_NORMAL = 0.1
SIGMA_COPLANARITY = 0.1


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """Per-frame G-buffer: ``color`` is the 1-spp radiance, the aux planes
    describe the primary hit; ``view``/``proj`` are the matrices the frame
    was rendered with (the next frame reprojects through them)."""

    color: torch.Tensor        # (H, W, 3)
    world_pos: torch.Tensor    # (H, W, 3)
    normal: torch.Tensor       # (H, W, 3) unit, flipped toward the viewer
    contributor: torch.Tensor  # (H, W) bool: the primary ray hit something
    prim_id: torch.Tensor      # (H, W) i32 global primitive id, -1 on miss
    view: torch.Tensor         # (4, 4)
    proj: torch.Tensor         # (4, 4)

    def replace(self, **kw) -> "GBuffer":
        return dataclasses.replace(self, **kw)


def _pad(a: torch.Tensor, k: int) -> torch.Tensor:
    """Zero (False) border of k pixels around the two leading axes."""
    out = torch.zeros((a.shape[0] + 2 * k, a.shape[1] + 2 * k) + a.shape[2:],
                      dtype=a.dtype, device=a.device)
    out[k:k + a.shape[0], k:k + a.shape[1]] = a
    return out


def _inv2(sigma: float) -> float:
    return 1.0 / (2.0 * sigma * sigma)


def _tap_weight(g: GBuffer, color, nb_c, nb_p, nb_n, wp, wc, wn, wcp):
    """exp(-(|dp|^2 wp + |dc|^2 wc + acos(n.n')^2 wn + (n.normalize(dp))^2
    wcp)) of one off-center tap, (H, W)."""
    dp = nb_p - g.world_pos
    d_pos = vec._sum3(dp * dp) * wp
    dc = nb_c - color
    d_col = vec._sum3(dc * dc) * wc
    ang = torch.arccos(torch.clamp(vec._sum3(nb_n * g.normal), 0.0, 1.0))
    d_nrm = ang * ang * wn
    cop = vec._sum3(g.normal * vec.normalize(dp))
    d_cop = cop * cop * wcp
    return torch.exp(-(d_pos + d_col + d_nrm + d_cop))


def joint_bilateral(g: GBuffer, half_size: int, clamp: bool = True,
                    sigma_position: float = SIGMA_POSITION,
                    sigma_color: float = SIGMA_COLOR,
                    sigma_normal: float = SIGMA_NORMAL,
                    sigma_coplanarity: float = SIGMA_COPLANARITY
                    ) -> torch.Tensor:
    """Joint-bilateral filtered color (H, W, 3), the dense window.
    Non-contributor neighbors are skipped, a non-contributor center passes
    through unfiltered, the center tap has weight exactly 1, and the result
    is optionally clamped to [0, 1]."""
    h, w, _ = g.color.shape
    k = half_size
    size = 2 * k + 1
    color_p, pos_p, nrm_p = (_pad(x, k) for x in (g.color, g.world_pos,
                                                  g.normal))
    con_p = _pad(g.contributor, k)
    wts = _weights(sigma_position, sigma_color, sigma_normal,
                   sigma_coplanarity)
    c_sum = torch.zeros_like(g.color)
    w_sum = torch.zeros((h, w), dtype=g.color.dtype, device=g.color.device)
    for i in range(size * size):
        dy, dx = i // size, i % size
        nb_c = color_p[dy:dy + h, dx:dx + w]
        if dy == k and dx == k:
            weight = torch.ones_like(w_sum)
        else:
            weight = _tap_weight(g, g.color, nb_c, pos_p[dy:dy + h, dx:dx + w],
                                 nrm_p[dy:dy + h, dx:dx + w], *wts)
        weight = torch.where(con_p[dy:dy + h, dx:dx + w], weight, 0.0)
        c_sum = c_sum + weight[..., None] * nb_c
        w_sum = w_sum + weight
    out = c_sum / torch.clamp(w_sum, min=1e-20)[..., None]
    if clamp:
        out = torch.clamp(out, 0.0, 1.0)
    return torch.where(g.contributor[..., None], out, g.color)


def _levels(half_size: int) -> int:
    """The a-trous levels L: the smallest with footprint 2 (2^L - 1) >=
    half_size, at least 1."""
    n = 1
    while 2 * ((1 << n) - 1) < half_size:
        n += 1
    return n


def _weights(sigma_position: float = SIGMA_POSITION,
             sigma_color: float = SIGMA_COLOR,
             sigma_normal: float = SIGMA_NORMAL,
             sigma_coplanarity: float = SIGMA_COPLANARITY) -> tuple:
    return (_inv2(sigma_position), _inv2(sigma_color), _inv2(sigma_normal),
            _inv2(sigma_coplanarity))


def _atrous_level_plain(g: GBuffer, color: torch.Tensor, level: int,
                        wts: tuple, clamp: bool | None = None
                        ) -> torch.Tensor:
    """One a-trous level of ``color`` (H, W, 3): 5x5 taps dilated by
    2^level, guided by ``g`` and by ``color`` itself.  ``clamp`` not None
    makes it the filter's last level: clamped to [0, 1] if ``clamp``, then
    ``g.color`` at non-contributor pixels."""
    h, w, _ = color.shape
    step = 1 << level
    kpad = 2 * step
    color_p, pos_p, nrm_p = (_pad(x, kpad) for x in (color, g.world_pos,
                                                     g.normal))
    con_p = _pad(g.contributor, kpad)
    c_sum = torch.zeros_like(color)
    w_sum = torch.zeros((h, w), dtype=color.dtype, device=color.device)
    for ty in range(5):
        for tx in range(5):
            dy, dx = ty * step, tx * step
            nb_c = color_p[dy:dy + h, dx:dx + w]
            nb_ok = con_p[dy:dy + h, dx:dx + w]
            if ty == 2 and tx == 2:
                weight = torch.where(nb_ok, 1.0, 0.0).to(color.dtype)
            else:
                weight = torch.where(nb_ok, _tap_weight(
                    g, color, nb_c, pos_p[dy:dy + h, dx:dx + w],
                    nrm_p[dy:dy + h, dx:dx + w], *wts), 0.0)
            c_sum = c_sum + weight[..., None] * nb_c
            w_sum = w_sum + weight
    out = c_sum / torch.clamp(w_sum, min=1e-20)[..., None]
    if clamp is None:
        return out
    if clamp:
        out = torch.clamp(out, 0.0, 1.0)
    return torch.where(g.contributor[..., None], out, g.color)


# Launches of csrc/denoise.cu since the last reset, one an a-trous level.
LAUNCHES = profiling.Counter("denoise", ("atrous",))
LIB = kernels.Library("denoise", {"denoise_atrous_level": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # color pos normal
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # contributor orig out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # h w step
    ctypes.c_float, ctypes.c_float, ctypes.c_float,      # wp wc wn
    ctypes.c_float,                                      # wcp
    ctypes.c_int, ctypes.c_int,                          # last clamp
    ctypes.c_void_p]}, LAUNCHES)                         # stream


def _atrous_level_kernel(g: GBuffer, color: torch.Tensor, level: int,
                         wts: tuple, clamp: bool | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """``_atrous_level_plain`` by one launch of csrc/denoise.cu into
    ``out`` (H, W, 3; default a new ``torch.empty``), not ``color``."""
    f32 = torch.float32
    if out is None:
        out = torch.empty_like(color)
    kernels.check("denoise", dict(
        color=(color, f32), world_pos=(g.world_pos, f32),
        normal=(g.normal, f32), contributor=(g.contributor, torch.bool),
        orig=(g.color, f32), out=(out, f32)))
    h, w, _ = color.shape
    if not (color.shape == g.world_pos.shape == g.normal.shape
            == g.color.shape == out.shape == (h, w, 3)
            and g.contributor.shape == (h, w)):
        raise ValueError("denoise takes (H, W, 3) planes and an (H, W) "
                         "contributor plane of one frame")
    if h * w:
        LIB.launch("denoise_atrous_level", color.data_ptr(),
                   g.world_pos.data_ptr(), g.normal.data_ptr(),
                   g.contributor.data_ptr(), g.color.data_ptr(),
                   out.data_ptr(), h, w, 1 << level, *wts,
                   int(clamp is not None), int(bool(clamp)),
                   kernels.stream(color), key="atrous")
    return out


def _atrous(g: GBuffer, half_size: int, clamp: bool, wts: tuple,
            on_card: bool) -> torch.Tensor:
    """The a-trous filter by the kernel (``on_card``: one launch a level)
    or by the plain twin."""
    n_iters = _levels(half_size)
    level_fn = _atrous_level_kernel if on_card else _atrous_level_plain
    with profiling.span("denoise.atrous"):
        out = g.color
        for level in range(n_iters):
            with profiling.span("denoise.atrous.level"):
                out = level_fn(g, out, level, wts,
                               clamp if level == n_iters - 1 else None)
        return out


def joint_bilateral_atrous(g: GBuffer, half_size: int, clamp: bool = True,
                           sigma_position: float = SIGMA_POSITION,
                           sigma_color: float = SIGMA_COLOR,
                           sigma_normal: float = SIGMA_NORMAL,
                           sigma_coplanarity: float = SIGMA_COPLANARITY
                           ) -> torch.Tensor:
    """Edge-avoiding a-trous approximation of ``joint_bilateral``: L
    iterations of a 5x5 kernel whose taps are dilated by 2^i, L the
    smallest with footprint 2 (2^L - 1) >= half_size; each iteration
    filters the previous one's color (the color guidance updates with it).
    Same guidance terms, contributor skipping, center tap and
    pass-through as the dense filter.  On the card one kernel launch a
    level (the planes contiguous), elsewhere the plain twin."""
    return _atrous(g, half_size, clamp,
                   _weights(sigma_position, sigma_color, sigma_normal,
                            sigma_coplanarity),
                   g.color.device.type == "cuda")


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over the (2k+1)^2 window clipped to the frame, per pixel, of an
    (H, W, C) tensor, by cumulative sums (O(H W))."""

    def along(a, axis):
        n = a.shape[axis]
        c = torch.cumsum(a, dim=axis)
        zero = torch.zeros_like(c.narrow(axis, 0, 1))
        c = torch.cat([zero, c], dim=axis)          # c[i] = sum(a[:i])
        i = torch.arange(n, device=a.device)
        up = c.index_select(axis, torch.clamp(i + k + 1, max=n))
        lo = c.index_select(axis, torch.clamp(i - k, min=0))
        return up - lo

    return along(along(x, 0), 1)


def reproject(world_pos: torch.Tensor, view: torch.Tensor, proj: torch.Tensor,
              height: int, width: int):
    """World position -> (row, col) pixel coords under (view, proj), and
    the strict in-bounds mask.  Row 0 = top scanline.  The 4x4 products are
    explicit float32 multiply-adds, never a matmul that could run in TF32."""
    p = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    pv = sum(proj[:, j:j + 1] * view[j:j + 1, :] for j in range(4))
    clip = torch.stack([sum(pv[i, j] * p[..., j] for j in range(4))
                        for i in range(4)], -1)
    w_ = clip[..., 3:4]
    ndc = clip[..., :3] / torch.where(torch.abs(w_) > 1e-20, w_, 1e-20)
    px = (ndc[..., 0] + 1.0) * 0.5 * width
    py = (1.0 - (ndc[..., 1] + 1.0) * 0.5) * height
    ok = (px > 0.0) & (px < width) & (py > 0.0) & (py < height)
    return py, px, ok


def temporal(cur: GBuffer, prev: GBuffer, half_size: int, tolerance: float,
             current_frame_weighting: float) -> torch.Tensor:
    """Reproject through the PREVIOUS frame's matrices, accept history where
    in bounds and the primitive id matches, clamp it to mean +- tolerance *
    RMS-center-deviation over the current (2k+1)^2 window, blend
    (1 - a) * history + a * current."""
    with profiling.span("denoise.temporal"):
        h, w, _ = cur.color.shape
        py, px, in_bounds = reproject(cur.world_pos, prev.view, prev.proj,
                                      h, w)
        # Truncate toward zero, then clip (the float clamp first only keeps
        # the int32 conversion in range; it changes no clipped result).
        iy = torch.clamp(torch.clamp(py, -1.0, float(h)).to(torch.int32), 0,
                         h - 1)
        ix = torch.clamp(torch.clamp(px, -1.0, float(w)).to(torch.int32), 0,
                         w - 1)
        flat = (iy * w + ix).reshape(-1).long()
        prev_color = prev.color.reshape(-1, 3)[flat].reshape(h, w, 3)
        prev_id = prev.prim_id.reshape(-1)[flat].reshape(h, w)
        valid = (cur.prim_id != -1) & in_bounds & (cur.prim_id == prev_id)

        ones = torch.ones((h, w, 1), dtype=cur.color.dtype,
                          device=cur.color.device)
        n = _box_sum(ones, half_size)
        mean = _box_sum(cur.color, half_size) / n
        mean_sq = _box_sum(cur.color * cur.color, half_size) / n
        dev = torch.sqrt(torch.clamp(
            mean_sq - 2.0 * cur.color * mean + cur.color * cur.color,
            min=0.0))
        clamped_prev = torch.minimum(torch.maximum(prev_color,
                                                   mean - tolerance * dev),
                                     mean + tolerance * dev)
        alpha = torch.where(valid, current_frame_weighting, 1.0)[..., None]
        history = torch.where(valid[..., None], clamped_prev, 0.0)
        return (1.0 - alpha) * history + alpha * cur.color
