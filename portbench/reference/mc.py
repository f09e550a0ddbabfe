"""The plain reference of the Monte Carlo estimator that the fused engines
run, path by path, in PyTorch.

Per (pixel, sample) path, at most ``max_depth`` bounces: the nearest
triangle by Moller-Trumbore (the first triangle at the least t wins); a
primary miss adds the night sky and a primary emissive hit its emission;
at every other hit one uniform-by-area sample of the emissive triangles
(next-event estimation) with a hard shadow test (any triangle hit within
(t_min, dist - tolerance], by the division-free accept), then Russian
roulette and a uniform-hemisphere bounce.  All randomness is the pcg4d
hash of (pixel, sample, bounce, stream) (``rng``), so a path does not
depend on which other paths run beside it: the reference traces any
subset of the pixels, each path once, and sums each pixel's samples in
sample order.  Every operation is written in the order of the engines'
documented arithmetic (the kernels are built without FMA contraction), so
the reference reproduces a correct engine to the last bits or nearly.

``dtype`` runs the whole estimator in another floating type: the control
of the comparison (bfloat16 in place of float32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import rng
from portbench.reference.geometry import RefCamera, RefScene, camera_dirs

DET_EPS = 1e-12
# (rays x triangles) elements per block of the brute-force tests
BLOCK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class Settings:
    width: int
    height: int
    spp: int
    max_depth: int
    t_min: float = 1e-3
    eps_offset: float = 1e-5
    rr_survival: float = 0.8
    shadow_tolerance: float = 1e-2


def _edges(o, d, v0, e1, e2):
    """The terms of Moller-Trumbore shared by both tests, for rays (R, 3)
    against triangles (N, 3): broadcast (R, N)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    det = s1x * e1x + s1y * e1y + s1z * e1z
    okd = torch.abs(det) > DET_EPS
    sx, sy, sz = ox - v0[None, :, 0], oy - v0[None, :, 1], oz - v0[None, :, 2]
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    tn = s2x * e2x + s2y * e2y + s2z * e2z
    b1n = s1x * sx + s1y * sy + s1z * sz
    b2n = s2x * dx + s2y * dy + s2z * dz
    return det, okd, tn, b1n, b2n


def _blocks(r: int, n: int):
    tb = max(1, min(n, BLOCK_ELEMS // max(r, 1)))
    rb = max(1, min(r, BLOCK_ELEMS // tb))
    for r0 in range(0, r, rb):
        yield slice(r0, min(r, r0 + rb)), [
            slice(t0, min(n, t0 + tb)) for t0 in range(0, n, tb)]


def nearest(sc: RefScene, o, d, t_min: float):
    """(t, index) of the nearest triangle per ray, the type's largest
    finite value / -1 on a miss; the first index at the least t."""
    r = o.shape[0]
    no_hit = float(torch.finfo(o.dtype).max)     # NO_HIT in float32
    best_t = torch.full((r,), no_hit, dtype=o.dtype, device=o.device)
    best_n = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    for rs, tss in _blocks(r, sc.count):
        for ts in tss:
            det, okd, tn, b1n, b2n = _edges(o[rs], d[rs], sc.v0[ts],
                                            sc.e1[ts], sc.e2[ts])
            inv = 1.0 / torch.where(okd, det, 1.0)
            t, b1, b2 = tn * inv, b1n * inv, b2n * inv
            ok = (okd & (t > t_min) & (b1 >= 0.0) & (b2 >= 0.0)
                  & (1.0 - b1 - b2 >= 0.0))
            tm = torch.where(ok, t, no_hit)
            bi = torch.argmin(tm, 1)        # the first index at the least t
            bt = tm.gather(1, bi[:, None])[:, 0]
            better = bt < best_t[rs]
            best_t[rs] = torch.where(better, bt, best_t[rs])
            best_n[rs] = torch.where(better, bi + ts.start, best_n[rs])
    hit = best_t < no_hit
    return best_t, torch.where(hit, best_n, -1)


def occluded(sc: RefScene, p, w, lim, t_min: float):
    """Any triangle hit at t in (t_min, lim] along the unit directions w,
    by the division-free accept (signs against |det|-scaled bounds)."""
    r = p.shape[0]
    occ = torch.zeros((r,), dtype=torch.bool, device=p.device)
    for rs, tss in _blocks(r, sc.count):
        lm = lim[rs][:, None]
        for ts in tss:
            det, okd, tn, b1n, b2n = _edges(p[rs], w[rs], sc.v0[ts],
                                            sc.e1[ts], sc.e2[ts])
            sd = torch.where(det >= 0.0, 1.0, -1.0).to(det.dtype)
            adet = det * sd
            tsd = tn * sd
            hit = (okd & (tsd > t_min * adet) & (tsd <= lm * adet)
                   & (b1n * sd >= 0.0) & (b2n * sd >= 0.0)
                   & ((det - b1n - b2n) * sd >= 0.0))
            occ[rs] |= hit.any(1)
    return occ


def _norm3(v):
    inv = torch.rsqrt(torch.clamp(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                                  + v[:, 2] * v[:, 2], min=1e-24))
    return v * inv[:, None]


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


@dataclasses.dataclass
class Traced:
    """What ``trace`` returns: per traced pixel the summed radiance of its
    samples, and the work the paths needed."""

    radiance: torch.Tensor          # (P, 3) sum over the pixel's samples
    lane_steps: int                 # bounce steps of every path
    shadow_rays: int                # steps that traced a shadow ray
    gbuffer: dict | None = None     # single-path mode: the primary hit


def trace(sc: RefScene, cam: RefCamera, st: Settings, seed: int, pixel,
          *, frame: int | None = None, dtype=torch.float32) -> Traced:
    """The paths of the pixels ``pixel`` (P,) int64.

    ``frame is None``: samples 0 .. spp - 1 through jittered camera rays
    (the first sample's normalized by a division, later samples' as a lane
    regenerates them), the pixel's radiance the sum over samples.
    ``frame = k``: one path per pixel through its pixel center with every
    draw at sample k (the Denoiser's frame), and its primary hit's
    G-buffer (position, facing normal, primitive id from 1, contributor)."""
    dev = pixel.device
    sc, cam = sc.cast(dtype), cam.cast(dtype)
    n_pix = pixel.shape[0]
    if frame is None:
        samples = list(range(st.spp))
        pix = pixel.repeat(st.spp)
        smp = torch.arange(st.spp, device=dev).repeat_interleave(n_pix)
        uj = rng.uniforms4(seed, pix, smp, 0, rng.JITTER, dtype)
        d = torch.empty((pix.shape[0], 3), dtype=dtype, device=dev)
        first = smp == 0
        d[first] = camera_dirs(cam, st.width, st.height, pix[first],
                               uj[0][first], uj[1][first], rsqrt=False)
        d[~first] = camera_dirs(cam, st.width, st.height, pix[~first],
                                uj[0][~first], uj[1][~first], rsqrt=True)
    else:
        samples = [frame]
        pix = pixel
        smp = torch.full_like(pix, frame)
        d = camera_dirs(cam, st.width, st.height, pix, 0.5, 0.5, rsqrt=False)
    r = pix.shape[0]
    o = cam.position.expand(r, 3).clone()
    tp = torch.ones((r, 3), dtype=dtype, device=dev)
    cur = torch.zeros((r, 3), dtype=dtype, device=dev)
    out = torch.zeros((r, 3), dtype=dtype, device=dev)
    lane = torch.arange(r, device=dev)
    skyb, skyt = sc.sky[0:3], sc.sky[3:6]
    light_valid = sc.light_total > 0.0
    light_pdf = torch.where(light_valid,
                            1.0 / torch.clamp(sc.light_total, min=1e-20),
                            torch.zeros_like(sc.light_total))
    two_pi = torch.tensor(2.0 * np.pi, dtype=dtype, device=dev)
    inv_pi = torch.tensor(1.0 / np.pi, dtype=dtype, device=dev)
    inv_rr = 1.0 / st.rr_survival
    lcdf = sc.light[:, 15]
    steps = shadows = 0
    gb = None
    for b in range(st.max_depth):
        if lane.numel() == 0:
            break
        steps += lane.numel()
        best_t, best_n = nearest(sc, o, d, st.t_min)
        hit = best_n >= 0
        idx = best_n.clamp(min=0)
        nrm = torch.where(hit[:, None], sc.normal[idx], 0.0)
        bal = torch.where(hit[:, None], sc.albedo[idx], 0.0)
        bem = torch.where(hit[:, None], sc.emission[idx], 0.0)
        hit_emissive = hit & sc.emissive[idx]

        if b == 0:
            du = _norm3(d)
            skyw = 0.5 * (du[:, 1] + 1.0)
            sky = (1.0 - skyw)[:, None] * skyb + skyw[:, None] * skyt
            dr = (torch.where(~hit[:, None], sky, 0.0)
                  + torch.where(hit_emissive[:, None], bem, 0.0))
            cur = cur + tp * dr
        alive = hit & ~hit_emissive

        front = _dot(nrm, d) < 0.0
        gn = _norm3(nrm)
        n = torch.where(front[:, None], gn, -gn)
        t_pt = torch.where(hit, best_t, 1.0)
        hp = o + t_pt[:, None] * d
        if frame is not None and b == 0:
            gb = {"world_pos": hp.clone(), "normal": n.clone(),
                  "prim_id": torch.where(hit, best_n + 1, -1),
                  "contributor": hit.clone()}
        h = hp + n * st.eps_offset

        # NEE: one area-light sample, then the shadow ray.
        s_l = smp[lane]
        p_l = pix[lane]
        ul0, ul1, ul2, _ = rng.uniforms4(seed, p_l, s_l, b, rng.LIGHT, dtype)
        budget = ul0 * sc.light_total
        k = (lcdf[None, :-1] <= budget[:, None]).sum(1)
        row = sc.light[k]
        xw = 1.0 - torch.sqrt(ul1)
        w1 = (1.0 - xw) * ul2
        w2 = (1.0 - xw) * (1.0 - ul2)
        lp = row[:, 0:3] + w1[:, None] * row[:, 3:6] + w2[:, None] * row[:, 6:9]
        tl = lp - h
        dist = torch.sqrt(torch.clamp(_dot(tl, tl), min=0.0))
        wl = tl * (1.0 / torch.clamp(dist, min=1e-20))[:, None]
        ln = row[:, 9:12]
        flip = _dot(ln, -wl) < 0.0
        ln = torch.where(flip[:, None], -ln, ln)
        occ = torch.zeros_like(alive)
        if bool(alive.any()):
            a_idx = torch.nonzero(alive)[:, 0]
            occ[a_idx] = occluded(sc, h[a_idx], wl[a_idx],
                                  dist[a_idx] - st.shadow_tolerance,
                                  st.t_min)
        shadows += int(alive.sum())
        vis = (~occ).to(dtype)
        cos_s = _dot(wl, n)
        cos_l = -_dot(wl, ln)
        geom = cos_s * cos_l / torch.clamp(dist * dist, min=1e-20)
        brdf_ok = (cos_s >= 0.0).to(dtype) * inv_pi
        scale = (geom / torch.clamp(light_pdf, min=1e-20)) * vis * brdf_ok
        use = alive & light_valid
        cur = cur + torch.where(use[:, None],
                                tp * (row[:, 12:15] * bal * scale[:, None]),
                                0.0)

        # Russian roulette, then the uniform-hemisphere bounce.
        us0, us1, us2, _ = rng.uniforms4(seed, p_l, s_l, b, rng.SCATTER,
                                         dtype)
        survive = us2 < st.rr_survival
        nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
        use_x = torch.abs(nx) > torch.abs(ny)
        zero = torch.zeros_like(nx)
        yv = _norm3(torch.stack([torch.where(use_x, nz, zero),
                                 torch.where(use_x, zero, nz),
                                 torch.where(use_x, -nx, -ny)], 1))
        yx, yy, yz = yv[:, 0], yv[:, 1], yv[:, 2]
        xv = torch.stack([yy * nz - yz * ny, yz * nx - yx * nz,
                          yx * ny - yy * nx], 1)
        z = us0
        r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = two_pi * us1
        wi = ((r_xy * torch.cos(phi))[:, None] * xv
              + (r_xy * torch.sin(phi))[:, None] * yv + z[:, None] * n)
        cos_i = _dot(wi, n)
        w_ok = (cos_i >= 0.0).to(dtype) * inv_pi
        wt = cos_i * two_pi * inv_rr * w_ok
        continues = alive & survive
        tp = torch.where(continues[:, None], tp * (bal * wt[:, None]), tp)
        cont = continues & (b + 1 < st.max_depth)
        done = ~cont
        out[lane[done]] = cur[done]
        keep = torch.nonzero(cont)[:, 0]
        lane, o, d, tp, cur = lane[keep], h[keep], wi[keep], tp[keep], cur[keep]
    # A pixel's samples summed in sample order, from +0.0.
    per = out.reshape(len(samples), n_pix, 3)
    acc = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    for i in range(len(samples)):
        acc = acc + per[i]
    return Traced(acc, steps, shadows, gb)
