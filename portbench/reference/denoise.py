"""The plain reference of the Denoiser's filters: the edge-avoiding a-trous
joint-bilateral filter (5 x 5 taps dilated by 2^level; guidance by world
position, color, normal angle and coplanarity; non-contributors skipped,
the center tap weight 1, a non-contributor passes through) and the
temporal filter (reprojection through the previous frame's view and
projection, a primitive-id test, the history clamped to the current
window's mean +- tolerance * RMS deviation, then blended)."""

from __future__ import annotations

import torch

SIGMA_POSITION = 32.0
SIGMA_COLOR = 0.6
SIGMA_NORMAL = 0.1
SIGMA_COPLANARITY = 0.1


def _sum3(p):
    return p[..., 0] + p[..., 1] + p[..., 2]


def _normalize(a):
    n2 = torch.clamp(_sum3(a * a), min=1e-12 * 1e-12).unsqueeze(-1)
    return a / torch.sqrt(n2)


def _pad(a, k: int):
    out = torch.zeros((a.shape[0] + 2 * k, a.shape[1] + 2 * k) + a.shape[2:],
                      dtype=a.dtype, device=a.device)
    out[k:k + a.shape[0], k:k + a.shape[1]] = a
    return out


def _inv2(sigma: float) -> float:
    return 1.0 / (2.0 * sigma * sigma)


def atrous(g: dict, half_size: int, clamp: bool) -> torch.Tensor:
    """The spatial filter of G-buffer ``g`` (color, world_pos, normal (H,
    W, 3); contributor (H, W) bool)."""
    color0, pos, nrm, con = g["color"], g["world_pos"], g["normal"], \
        g["contributor"]
    h, w, _ = color0.shape
    n_iters = 1
    while 2 * ((1 << n_iters) - 1) < half_size:
        n_iters += 1
    wp, wc, wn, wcp = (_inv2(SIGMA_POSITION), _inv2(SIGMA_COLOR),
                       _inv2(SIGMA_NORMAL), _inv2(SIGMA_COPLANARITY))
    out = color0
    for level in range(n_iters):
        step = 1 << level
        kp = 2 * step
        color = out
        color_p, pos_p, nrm_p = (_pad(x, kp) for x in (color, pos, nrm))
        con_p = _pad(con, kp)
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
                    dp = pos_p[dy:dy + h, dx:dx + w] - pos
                    d_pos = _sum3(dp * dp) * wp
                    dc = nb_c - color
                    d_col = _sum3(dc * dc) * wc
                    ang = torch.arccos(torch.clamp(
                        _sum3(nrm_p[dy:dy + h, dx:dx + w] * nrm), 0.0, 1.0))
                    d_nrm = ang * ang * wn
                    cop = _sum3(nrm * _normalize(dp))
                    d_cop = cop * cop * wcp
                    weight = torch.where(
                        nb_ok, torch.exp(-(d_pos + d_col + d_nrm + d_cop)),
                        0.0)
                c_sum = c_sum + weight[..., None] * nb_c
                w_sum = w_sum + weight
        out = c_sum / torch.clamp(w_sum, min=1e-20)[..., None]
    if clamp:
        out = torch.clamp(out, 0.0, 1.0)
    return torch.where(con[..., None], out, color0)


def _box_sum(x, k: int):
    def along(a, axis):
        n = a.shape[axis]
        c = torch.cumsum(a, dim=axis)
        c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
        i = torch.arange(n, device=a.device)
        return (c.index_select(axis, torch.clamp(i + k + 1, max=n))
                - c.index_select(axis, torch.clamp(i - k, min=0)))

    return along(along(x, 0), 1)


def temporal(cur: dict, prev: dict, half_size: int, tolerance: float,
             weighting: float) -> torch.Tensor:
    """The temporal filter of frame ``cur`` against the history ``prev``
    (its color, prim_id, view and proj)."""
    color = cur["color"]
    h, w, _ = color.shape
    wp_ = cur["world_pos"]
    p = torch.cat([wp_, torch.ones_like(wp_[..., :1])], -1)
    view, proj = prev["view"], prev["proj"]
    pv = sum(proj[:, j:j + 1] * view[j:j + 1, :] for j in range(4))
    clip = torch.stack([sum(pv[i, j] * p[..., j] for j in range(4))
                        for i in range(4)], -1)
    w_ = clip[..., 3:4]
    ndc = clip[..., :3] / torch.where(torch.abs(w_) > 1e-20, w_, 1e-20)
    px = (ndc[..., 0] + 1.0) * 0.5 * w
    py = (1.0 - (ndc[..., 1] + 1.0) * 0.5) * h
    in_bounds = (px > 0.0) & (px < w) & (py > 0.0) & (py < h)
    iy = torch.clamp(torch.clamp(py, -1.0, float(h)).to(torch.int32), 0,
                     h - 1)
    ix = torch.clamp(torch.clamp(px, -1.0, float(w)).to(torch.int32), 0,
                     w - 1)
    flat = (iy * w + ix).reshape(-1).long()
    prev_color = prev["color"].reshape(-1, 3)[flat].reshape(h, w, 3)
    prev_id = prev["prim_id"].reshape(-1)[flat].reshape(h, w)
    pid = cur["prim_id"]
    valid = (pid != -1) & in_bounds & (pid == prev_id)
    ones = torch.ones((h, w, 1), dtype=color.dtype, device=color.device)
    n = _box_sum(ones, half_size)
    mean = _box_sum(color, half_size) / n
    mean_sq = _box_sum(color * color, half_size) / n
    dev = torch.sqrt(torch.clamp(mean_sq - 2.0 * color * mean + color * color,
                                 min=0.0))
    clamped = torch.minimum(torch.maximum(prev_color, mean - tolerance * dev),
                            mean + tolerance * dev)
    alpha = torch.where(valid, weighting, 1.0).to(color.dtype)[..., None]
    history = torch.where(valid[..., None], clamped, 0.0)
    return (1.0 - alpha) * history + alpha * color
