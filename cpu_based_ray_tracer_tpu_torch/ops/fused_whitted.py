"""Fused Whitted ray-tree kernel (port of
``cpu_based_ray_tracer_tpu.ops.fused_whitted``), the real-time Whitted
stage.

Each lane (pixel) evaluates the whole depth-``whitted_depth`` both-branch
ray tree with a priority queue of Q live branches (origin, direction,
Fresnel throughput).  Per level and slot: nearest hit over every triangle
and sphere (with the triangle's uv) -> a miss adds w * sky, a
Diffuse_Glossy hit adds w * Blinn-Phong (shadow rays to every point light,
chessboard texture), a specular hit emits reflect + refract candidates
weighted by the exact polarized Fresnel term.  The 2Q candidates go through
a Batcher sorting network by weight and the top Q survive; the weight of
the rest is summed into ``truncated`` (0 on the reference scene for Q >= 4:
then the result is the tree of ``models.whitted.trace``).

- ``csrc/fused_whitted.cu`` is the kernel (CUDA C++ for sm_90a: a block of
  128 pixels traces its live slots compacted, level by level);
  ``render_fused`` launches it for CUDA tensors.
- ``render_fused_plain`` is the same Q-slot algorithm in PyTorch,
  vectorized over lanes, with the same sorting network.  The wrapper runs
  it for CPU tensors only; ``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.scene import (DIFFUSE_GLOSSY, REFLECTIVE,
                                                  REFLECTIVE_REFRACTIVE,
                                                  TEX_CHESSBOARD, Scene)
from cpu_based_ray_tracer_tpu_torch.scenes.whitted_scene import (
    CHESS_A, CHESS_B, CHESS_FREQUENCY)
from cpu_based_ray_tracer_tpu_torch.utils import kernels
from cpu_based_ray_tracer_tpu_torch.utils import profiling

_DET_EPS = 1e-12
NO_HIT = float(np.finfo(np.float32).max)

# Launches of csrc/fused_whitted.cu since the last reset.
LAUNCHES = profiling.Counter("fused_whitted")

# Batcher odd-even merge sorting networks (descending by weight).
_NET8 = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
         (1, 2), (3, 4), (5, 6)]
_NET4 = [(0, 1), (2, 3), (0, 2), (1, 3), (1, 2)]
_NETS = {4: _NET4, 8: _NET8}


@dataclasses.dataclass(frozen=True)
class WhittedPack:
    """Kernel-ready tables of a Whitted scene, built by
    ``pack_whitted_scene`` (byte-equal to the JAX package's pack)."""

    tri: torch.Tensor    # (max(N,1), 20) f32: v0 e1 e2 n mid uv0 uv1 uv2 pad
    sph: torch.Tensor    # (max(S,1), 8) f32: center radius mid pad
    mat: torch.Tensor    # (K, 12) f32: kind albedo ior kd ks spec_exp tex pad
    light: torch.Tensor  # (max(L,1), 8) f32: position radiance pad
    sky: torch.Tensor    # (8,) f32: sky(3) pad
    chess: torch.Tensor  # (8,) f32: chess_a(3) chess_b(3) frequency pad
    n_tri: int
    n_sph: int
    n_mat: int
    n_light: int

    def to(self, device) -> "WhittedPack":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ("tri", "sph", "mat", "light", "sky", "chess")})


def pack_whitted_scene(scene: Scene) -> WhittedPack:
    """Host-side (numpy) pack of the scene tables.  Zero-radius spheres,
    the never-hit placeholders, are dropped."""
    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
    tr, sp, mats = scene.triangles, scene.spheres, scene.materials
    n = tr.count
    tri = np.zeros((max(n, 1), 20), np.float32)
    tri[:n, 0:3] = np_(tr.v0)
    tri[:n, 3:6] = np_(tr.e1)
    tri[:n, 6:9] = np_(tr.e2)
    tri[:n, 9:12] = np_(tr.normal)
    tri[:n, 12] = np_(tr.material)
    tri[:n, 13:15] = np_(tr.uv0)
    tri[:n, 15:17] = np_(tr.uv1)
    tri[:n, 17:19] = np_(tr.uv2)

    c, r, smat = np_(sp.center), np_(sp.radius), np_(sp.material)
    live = r != 0.0
    c, r, smat = c[live], r[live], smat[live]
    s = len(c)
    sph = np.zeros((max(s, 1), 8), np.float32)
    sph[:s, 0:3] = c
    sph[:s, 3] = r
    sph[:s, 4] = smat

    k = mats.count
    mat = np.zeros((k, 12), np.float32)
    mat[:, 0] = np_(mats.kind)
    mat[:, 1:4] = np_(mats.albedo)
    mat[:, 4] = np_(mats.ior)
    mat[:, 5] = np_(mats.kd)
    mat[:, 6] = np_(mats.ks)
    mat[:, 7] = np_(mats.spec_exp)
    mat[:, 8] = np_(mats.texture)

    nl = scene.lights.count
    light = np.zeros((max(nl, 1), 8), np.float32)
    light[:nl, 0:3] = np_(scene.lights.position)
    light[:nl, 3:6] = np_(scene.lights.radiance)

    sky = np.zeros((8,), np.float32)
    sky[0:3] = np_(scene.sky_top)
    chess = np.zeros((8,), np.float32)
    chess[0:3] = CHESS_A
    chess[3:6] = CHESS_B
    chess[6] = CHESS_FREQUENCY
    t = lambda a: torch.as_tensor(a, device=scene.device)  # noqa: E731
    return WhittedPack(tri=t(tri), sph=t(sph), mat=t(mat), light=t(light),
                       sky=t(sky), chess=t(chess), n_tri=n, n_sph=s,
                       n_mat=k, n_light=nl)


# --- plain version: the kernel's arithmetic in PyTorch ----------------------

def _norm3(x, y, z):
    inv = 1.0 / torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-24))
    return x * inv, y * inv, z * inv


def _tree_plain(wp: WhittedPack, cam3, dirs, depth: int, queue: int,
                t_min: float, eps: float, counts: dict | None = None):
    """The Q-slot tree of every lane; dirs (3, R) f32 primary directions
    from the camera position cam3 (3,).  Returns (4, R): rgb, truncated.
    ``counts``: a dict that receives the work this data needs — live slot
    evaluations, and of those the Diffuse_Glossy and the specular hits —
    and under "levels" for each level the same by kind ("live", "miss",
    "diffuse", "specular"), the lanes with a live slot ("lanes") and with
    every slot live ("full_lanes"), the specular hits whose refracted
    child total internal reflection kills ("tir"), and what 32-lane warps
    of consecutive lanes would run one slot at a time:
    "warp_slots", the (warp, slot) pairs with a live lane, and
    "warp_branches", the (warp, slot, kind) triples with a lane of that
    kind.  Only chip_smoke.py reads it; it changes nothing computed."""
    where = torch.where
    dev = dirs.device
    r = dirs.shape[1]
    net = _NETS.get(2 * queue)
    if net is None:
        raise NotImplementedError(f"no sorting network for queue={queue}")
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    zero, one, no_hit = f32(0.0), f32(1.0), f32(NO_HIT)
    TRI = [[wp.tri[i, j] for j in range(19)] for i in range(wp.n_tri)]
    SPH = [[wp.sph[i, j] for j in range(5)] for i in range(wp.n_sph)]
    MAT = [[wp.mat[i, j] for j in range(9)] for i in range(wp.n_mat)]
    LGT = [[wp.light[i, j] for j in range(6)] for i in range(wp.n_light)]
    sky = [wp.sky[k] for k in range(3)]
    chess_a = [wp.chess[k] for k in range(3)]
    chess_b = [wp.chess[3 + k] for k in range(3)]
    chess_f = wp.chess[6]
    full = lambda v: torch.full((r,), v, dtype=torch.float32, device=dev)  # noqa: E731

    def sphere_t(ox, oy, oz, dx, dy, dz, scx, scy, scz, rad):
        ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
        a_q = dx * dx + dy * dy + dz * dz
        hb = ocx * dx + ocy * dy + ocz * dz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = hb * hb - a_q * c_q
        okq = disc > 0.0
        sq = torch.sqrt(where(okq, disc, one))
        t_near = (-hb - sq) / a_q
        t_far = (-hb + sq) / a_q
        return where(okq & (t_near > t_min), t_near,
                     where(okq & (t_far > t_min), t_far, no_hit))

    def tri_tbb(ox, oy, oz, dx, dy, dz, T):
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = T[:9]
        s1x = dy * e2z - dz * e2y
        s1y = dz * e2x - dx * e2z
        s1z = dx * e2y - dy * e2x
        det = s1x * e1x + s1y * e1y + s1z * e1z
        okd = torch.abs(det) > _DET_EPS
        inv = 1.0 / where(okd, det, one)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        s2x = sy * e1z - sz * e1y
        s2y = sz * e1x - sx * e1z
        s2z = sx * e1y - sy * e1x
        t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
        b1 = (s1x * sx + s1y * sy + s1z * sz) * inv
        b2 = (s2x * dx + s2y * dy + s2z * dz) * inv
        ok = (okd & (t > t_min) & (b1 >= 0.0) & (b2 >= 0.0)
              & (1.0 - b1 - b2 >= 0.0))
        return t, b1, b2, ok

    def intersect(ox, oy, oz, dx, dy, dz):
        """Nearest hit -> (t, raw n, material id, u, v)."""
        best_t = full(NO_HIT)
        bnx, bny, bnz = full(0.0), full(0.0), full(0.0)
        bmid, bu, bv = full(-1.0), full(0.0), full(0.0)
        for T in TRI:
            t, b1, b2, ok = tri_tbb(ox, oy, oz, dx, dy, dz, T)
            ok = ok & (t < best_t)
            (nx, ny, nz, mid, u0x, u0y, u1x, u1y, u2x, u2y) = T[9:19]
            b0 = 1.0 - b1 - b2
            uvx = u0x * b0 + u1x * b1 + u2x * b2
            uvy = u0y * b0 + u1y * b1 + u2y * b2
            best_t = where(ok, t, best_t)
            bnx, bny, bnz = where(ok, nx, bnx), where(ok, ny, bny), where(ok, nz, bnz)
            bmid = where(ok, mid, bmid)
            bu, bv = where(ok, uvx, bu), where(ok, uvy, bv)
        for (scx, scy, scz, rad, mid) in SPH:
            ts = sphere_t(ox, oy, oz, dx, dy, dz, scx, scy, scz, rad)
            ok = ts < best_t
            inv_r = 1.0 / where(rad == 0.0, one, rad)
            hx, hy, hz = ox + ts * dx, oy + ts * dy, oz + ts * dz
            best_t = where(ok, ts, best_t)
            bnx = where(ok, (hx - scx) * inv_r, bnx)
            bny = where(ok, (hy - scy) * inv_r, bny)
            bnz = where(ok, (hz - scz) * inv_r, bnz)
            bmid = where(ok, mid, bmid)
            bu, bv = where(ok, zero, bu), where(ok, zero, bv)
        return best_t, bnx, bny, bnz, bmid, bu, bv

    def nearest_t(ox, oy, oz, dx, dy, dz):
        best_t = full(NO_HIT)
        for T in TRI:
            t, _, _, ok = tri_tbb(ox, oy, oz, dx, dy, dz, T)
            best_t = where(ok & (t < best_t), t, best_t)
        for (scx, scy, scz, rad, _mid) in SPH:
            best_t = torch.minimum(
                best_t, sphere_t(ox, oy, oz, dx, dy, dz, scx, scy, scz, rad))
        return best_t

    def warps_with(m):
        """How many 32-lane warps of consecutive lanes have m set."""
        pad = torch.zeros((-(-r // 32) * 32,), dtype=torch.bool, device=dev)
        pad[:r] = m
        return int(pad.view(-1, 32).any(1).sum())

    def level(slots, rad, trunc):
        cand = []
        tally = dict(live=0, miss=0, diffuse=0, specular=0, tir=0,
                     warp_slots=0, warp_branches=0)
        any_live = torch.zeros((r,), dtype=torch.bool, device=dev)
        all_live = torch.ones((r,), dtype=torch.bool, device=dev)
        for (ox, oy, oz, dx, dy, dz, w) in slots:
            live = w > 0.0
            t, nxr, nyr, nzr, mid, bu, bv = intersect(ox, oy, oz, dx, dy, dz)
            hit = t < no_hit
            nx, ny, nz = _norm3(nxr, nyr, nzr)
            t_pt = where(hit, t, one)
            hx, hy, hz = ox + t_pt * dx, oy + t_pt * dy, oz + t_pt * dz

            # material row
            kind, alr, alg, alb = full(-1.0), full(0.0), full(0.0), full(0.0)
            ior, kd, ks = full(1.0), full(0.0), full(0.0)
            sxp, tex = full(1.0), full(0.0)
            for k, (kk, ar, ag, ab, io, kdd, kss, se, tx) in enumerate(MAT):
                take = mid == float(k)
                kind, alr = where(take, kk, kind), where(take, ar, alr)
                alg, alb = where(take, ag, alg), where(take, ab, alb)
                ior, kd = where(take, io, ior), where(take, kdd, kd)
                ks, sxp = where(take, kss, ks), where(take, se, sxp)
                tex = where(take, tx, tex)

            # chessboard (torch.remainder is a floor mod, as jnp.mod)
            fx = torch.remainder(bu * chess_f, 1.0) > 0.5
            fy = torch.remainder(bv * chess_f, 1.0) > 0.5
            pat = (fx ^ fy).to(torch.float32)
            use_chess = tex == float(TEX_CHESSBOARD)
            col = [where(use_chess, chess_a[c] + (chess_b[c] - chess_a[c])
                         * pat, al) for c, al in enumerate((alr, alg, alb))]

            # miss -> sky
            miss = live & ~hit
            rad = [rad[c] + where(miss, w * sky[c], zero) for c in range(3)]

            # Diffuse_Glossy -> Blinn-Phong with shadow rays
            is_diff = live & hit & (kind == float(DIFFUSE_GLOSSY))
            inside = (dx * nx + dy * ny + dz * nz) < 0.0
            sgn = where(inside, one, -one)
            px = hx + sgn * nx * eps
            py = hy + sgn * ny * eps
            pz = hz + sgn * nz * eps
            ds = [full(0.0), full(0.0), full(0.0)]
            ss = [full(0.0), full(0.0), full(0.0)]
            for (lx, ly, lz, lr, lg, lb) in LGT:
                tlx, tly, tlz = lx - hx, ly - hy, lz - hz
                dist2 = tlx * tlx + tly * tly + tlz * tlz
                inv_l = 1.0 / torch.sqrt(torch.clamp(dist2, min=1e-24))
                ldx, ldy, ldz = tlx * inv_l, tly * inv_l, tlz * inv_l
                occ_t = nearest_t(px, py, pz, ldx, ldy, ldz)
                vis = ~(occ_t * occ_t < dist2)
                cos_l = torch.abs(ldx * nx + ldy * ny + ldz * nz)
                mdn = -(ldx * nx + ldy * ny + ldz * nz)
                rx = -ldx - 2.0 * mdn * nx
                ry = -ldy - 2.0 * mdn * ny
                rz = -ldz - 2.0 * mdn * nz
                spec = torch.pow(torch.clamp(-(rx * dx + ry * dy + rz * dz),
                                             min=0.0), sxp)
                visf = vis.to(torch.float32)
                ds = [ds[c] + visf * lc * cos_l
                      for c, lc in enumerate((lr, lg, lb))]
                ss = [ss[c] + visf * spec * lc
                      for c, lc in enumerate((lr, lg, lb))]
            rad = [rad[c] + where(is_diff, w * (ds[c] * col[c] * kd
                                                + ss[c] * ks), zero)
                   for c in range(3)]

            # specular children: exact polarized Fresnel, reflect, Snell
            is_refl = live & hit & (kind == float(REFLECTIVE))
            is_glass = live & hit & (kind == float(REFLECTIVE_REFRACTIVE))
            if counts is not None:
                for k, m in (("live", live), ("diffuse", is_diff),
                             ("specular", is_refl | is_glass)):
                    counts[k] = counts.get(k, 0) + int(m.sum())
                kinds = {"miss": miss, "diffuse": is_diff,
                         "specular": is_refl | is_glass}
                for k, m in [("live", live)] + list(kinds.items()):
                    tally[k] += int(m.sum())
                tally["warp_slots"] += warps_with(live)
                tally["warp_branches"] += sum(warps_with(m)
                                              for m in kinds.values())
                any_live |= live
                all_live &= live
            cos_i = torch.clamp(dx * nx + dy * ny + dz * nz, -1.0, 1.0)
            outside = cos_i < 0.0
            eta_in, eta_out = where(outside, one, ior), where(outside, ior, one)
            ci = torch.abs(cos_i)
            si = torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
            st = eta_in / eta_out * si
            tir_f = st >= 1.0
            ct = torch.sqrt(torch.clamp(1.0 - st * st, min=0.0))
            rs = (eta_in * ci - eta_out * ct) / (eta_in * ci + eta_out * ct)
            rp = (eta_in * ct - eta_out * ci) / (eta_in * ct + eta_out * ci)
            fres = where(tir_f, one, 0.5 * (rs * rs + rp * rp))

            ddn = dx * nx + dy * ny + dz * nz
            rfx, rfy, rfz = _norm3(dx - 2.0 * ddn * nx, dy - 2.0 * ddn * ny,
                                   dz - 2.0 * ddn * nz)
            eta_r = where(outside, 1.0 / ior, ior)
            nsx = where(outside, nx, -nx)
            nsy = where(outside, ny, -ny)
            nsz = where(outside, nz, -nz)
            kk_ = 1.0 - eta_r * eta_r * (1.0 - ci * ci)
            sq_ = torch.sqrt(torch.clamp(kk_, min=0.0))
            tir2 = kk_ < 0.0
            ttx = where(tir2, zero, eta_r * dx + (eta_r * ci - sq_) * nsx)
            tty = where(tir2, zero, eta_r * dy + (eta_r * ci - sq_) * nsy)
            ttz = where(tir2, zero, eta_r * dz + (eta_r * ci - sq_) * nsz)
            tnorm2 = ttx * ttx + tty * tty + ttz * ttz
            rrx, rry, rrz = _norm3(ttx, tty, ttz)
            tir = tnorm2 < 0.5

            def child_origin(cdx, cdy, cdz):
                ins = (cdx * nx + cdy * ny + cdz * nz) < 0.0
                sg = where(ins, -one, one)
                return (hx + sg * nx * eps, hy + sg * ny * eps,
                        hz + sg * nz * eps)

            rox, roy, roz = child_origin(rfx, rfy, rfz)
            tox, toy, toz = child_origin(rrx, rry, rrz)
            refl_w = where(is_refl | is_glass, w * fres, zero)
            refr_w = where(is_glass & ~tir, w * (1.0 - fres), zero)
            if counts is not None:
                tally["tir"] += int((is_glass & tir).sum())
            cand.append((refl_w, rox, roy, roz, rfx, rfy, rfz))
            cand.append((refr_w, tox, toy, toz, rrx, rry, rrz))

        # top-Q by throughput: descending sorting network, strict swap
        for (a, b) in net:
            swap = cand[b][0] > cand[a][0]
            na = tuple(where(swap, x, y) for x, y in zip(cand[b], cand[a]))
            nb = tuple(where(swap, x, y) for x, y in zip(cand[a], cand[b]))
            cand[a], cand[b] = na, nb
        for q in range(queue, 2 * queue):
            trunc = trunc + cand[q][0]
        if counts is not None:
            tally["lanes"] = int(any_live.sum())
            tally["full_lanes"] = int(all_live.sum())
            counts.setdefault("levels", []).append(tally)
        slots = [(c[1], c[2], c[3], c[4], c[5], c[6], c[0])
                 for c in cand[:queue]]
        return slots, rad, trunc

    z = full(0.0)
    slots = [(cam3[0] + z, cam3[1] + z, cam3[2] + z, dirs[0], dirs[1],
              dirs[2], z + 1.0)]
    slots += [(z,) * 7 for _ in range(queue - 1)]
    rad, trunc = [z, z, z], z
    for _ in range(depth + 1):
        # A level with no live slot on any lane adds nothing.
        if not bool(torch.stack([s[6] for s in slots]).gt(0.0).any()):
            break
        slots, rad, trunc = level(slots, rad, trunc)
    return torch.stack([rad[0], rad[1], rad[2], trunc])


# --- the kernel -------------------------------------------------------------

LIB = kernels.Library("fused_whitted", {"fused_whitted_tree": [
    ctypes.c_void_p, ctypes.c_int,                   # tables, words
    ctypes.c_int, ctypes.c_int, ctypes.c_int,        # n_tri n_sph n_mat
    ctypes.c_int,                                    # n_light
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # dirs out n_pix
    ctypes.c_int, ctypes.c_int,                      # depth queue
    ctypes.c_float, ctypes.c_float,                  # t_min eps
    ctypes.c_void_p]}, LAUNCHES)                     # stream


def _tree_kernel(wp: WhittedPack, cam3, dirs, depth: int, queue: int,
                 t_min: float, eps: float):
    """Launch csrc/fused_whitted.cu on CUDA tensors -> (4, R)."""
    kernels.check("fused_whitted", dict(dirs=(dirs, torch.float32)))
    if dirs.dim() != 2 or dirs.shape[0] != 3:
        raise ValueError(f"fused_whitted takes (3, R) ray directions, not "
                         f"{tuple(dirs.shape)}")
    if queue not in (2, 4):
        raise NotImplementedError(f"no sorting network for queue={queue}")
    n_pix = dirs.shape[1]
    out = torch.empty((4, n_pix), dtype=torch.float32, device=dirs.device)
    if n_pix == 0:
        return out
    cam8 = torch.cat([cam3, torch.zeros((5,), dtype=torch.float32,
                                        device=cam3.device)])
    tables = torch.cat([wp.tri.reshape(-1), wp.sph.reshape(-1),
                        wp.mat.reshape(-1), wp.light.reshape(-1), wp.sky,
                        wp.chess, cam8]).to(device=dirs.device,
                                            dtype=torch.float32).contiguous()
    LIB.launch("fused_whitted_tree", tables.data_ptr(), tables.numel(),
               wp.n_tri, wp.n_sph, wp.n_mat, wp.n_light, dirs.data_ptr(),
               out.data_ptr(), n_pix, depth, queue, t_min, eps,
               kernels.stream(dirs))
    return out


# --- wrappers ---------------------------------------------------------------

def _run(core, scene: Scene, camera, cfg: RenderConfig, queue: int, dev,
         **kw):
    h, w = cfg.height, cfg.width
    wp = pack_whitted_scene(scene).to(dev)
    camera = camera.to(dev)
    dirs = cam_mod.perspective_rays(camera, w, h).reshape(-1, 3).T
    out = core(wp, camera.position.to(torch.float32), dirs.contiguous(),
               int(cfg.whitted_depth), int(queue), float(cfg.t_min),
               float(cfg.eps_offset), **kw)
    return out[0:3].T.reshape(h, w, 3), torch.sum(out[3])


def render_fused(scene: Scene, camera, cfg: RenderConfig, *, queue: int = 4,
                 device=None):
    """Fused Whitted render on ``device`` (default: the card) ->
    (linear image (H, W, 3), truncated weight ()).

    ``truncated`` is the total Fresnel throughput dropped by the per-lane
    Q-slot queue: 0 means the kernel evaluated the exact tree; otherwise
    raise ``queue`` (2 or 4).  On CUDA this launches
    csrc/fused_whitted.cu; on the CPU it runs the plain version."""
    dev = kernels.resolve_device(device)
    core = _tree_kernel if dev.type == "cuda" else _tree_plain
    return _run(core, scene, camera, cfg, queue, dev)


def render_fused_plain(scene: Scene, camera, cfg: RenderConfig, *,
                       queue: int = 4, device=None, counts=None):
    """The plain PyTorch version of ``render_fused`` on ``device``
    (default: the card): the kernel's Q-slot algorithm vectorized over
    lanes.  ``counts``: the work tally that only the kernel's speed bound
    reads, see ``_tree_plain``."""
    dev = kernels.resolve_device(device)
    return _run(_tree_plain, scene, camera, cfg, queue, dev, counts=counts)
