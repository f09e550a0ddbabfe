"""Fused RTIOW path tracer of the offline prototype and NPPT stages (port
of ``cpu_based_ray_tracer_tpu.ops.fused_rtiow``).

One launch advances every lane through its pixel's samples with the path
state held in registers, in equal-spp mode: each lane traces exactly
``spp`` paths of its (pixel, sample) pcg4d streams, the streams of
``models.offline.trace``, so the result matches the plain scan twin
(``models.offline.render`` / ``models.nppt.render``) to float tolerance.

Two camera modes, picked by the camera's type:
- ``ThinLensCamera`` ("thinlens"): the offline prototype's camera, pixel
  jitter and lens disk from the JITTER stream's four draws;
- ``PerspectiveCamera`` ("perspective"): the NPPT stage's camera with
  per-sample pixel jitter, the regeneration of ``ops.fused``.

Sphere scenes only (negative radii are hollow-glass bubbles); materials
LAMBERT (the three diffuse models), METAL, DIELECTRIC.

- ``csrc/fused_rtiow.cu`` is the kernel (CUDA C++ for sm_90a, loaded with
  ``ctypes``); ``rtiow_steps`` launches it for CUDA tensors.
- ``_steps_plain`` is the same arithmetic in PyTorch, vectorized over
  lanes, looping over spheres.  ``rtiow_steps`` runs it for CPU tensors
  only; ``chip_smoke.py`` holds the kernel against it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.ops.fused import NO_HIT, _norm3, lanes
from cpu_based_ray_tracer_tpu_torch.scene import (DIELECTRIC,
                                                  DIFFUSE_IN_HEMISPHERE,
                                                  DIFFUSE_IN_SPHERE, LAMBERT,
                                                  METAL, Scene)
from cpu_based_ray_tracer_tpu_torch.utils import kernels
from cpu_based_ray_tracer_tpu_torch.utils import rng as rng_mod

# Launches of csrc/fused_rtiow.cu since the last reset (callers set it to 0).
LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class RtiowPack:
    """Kernel-ready tables of a sphere scene, built by ``pack_rtiow_scene``."""

    sph: torch.Tensor  # (max(S, 1), 8) f32: center radius material_id pad
    mat: torch.Tensor  # (K, 8) f32: kind albedo(3) ior fuzz pad
    sky: torch.Tensor  # (8,) f32: sky_bottom(3) sky_top(3) pad
    n_sph: int
    n_mat: int

    def to(self, device) -> "RtiowPack":
        return dataclasses.replace(self, sph=self.sph.to(device),
                                   mat=self.mat.to(device),
                                   sky=self.sky.to(device))


def pack_rtiow_scene(scene: Scene) -> RtiowPack:
    """(sph, mat, sky) tables of a sphere scene; zero-radius spheres, the
    never-hit placeholders, are dropped (byte-equal to the JAX pack)."""
    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
    if scene.triangles.count and np_(scene.triangles.v0).any():
        raise ValueError("the fused RTIOW kernel takes sphere scenes only")
    sp, mats = scene.spheres, scene.materials
    c, r, smat = np_(sp.center), np_(sp.radius), np_(sp.material)
    live = r != 0.0
    c, r, smat = c[live], r[live], smat[live]
    s = len(c)
    sph = np.zeros((max(s, 1), 8), np.float32)
    sph[:s, 0:3] = c
    sph[:s, 3] = r
    sph[:s, 4] = smat
    k = mats.count
    mat = np.zeros((k, 8), np.float32)
    mat[:, 0] = np_(mats.kind)
    mat[:, 1:4] = np_(mats.albedo)
    mat[:, 4] = np_(mats.ior)
    mat[:, 5] = np_(mats.fuzz)
    sky = np.zeros((8,), np.float32)
    sky[0:3] = np_(scene.sky_bottom)
    sky[3:6] = np_(scene.sky_top)
    t = lambda a: torch.as_tensor(a, device=scene.device)  # noqa: E731
    return RtiowPack(sph=t(sph), mat=t(mat), sky=t(sky), n_sph=s, n_mat=k)


def _thinlens_words(camera: cam_mod.ThinLensCamera) -> torch.Tensor:
    """(24,) f32: origin lower_left horizontal vertical u v lens_radius pad."""
    c = camera
    return torch.cat([c.origin, c.lower_left, c.horizontal, c.vertical, c.u,
                      c.v, c.lens_radius.reshape(1),
                      torch.zeros((5,), dtype=torch.float32,
                                  device=c.origin.device)]).to(torch.float32)


def _perspective_words(camera: cam_mod.PerspectiveCamera) -> torch.Tensor:
    """(24,) f32: position right true_up forward tan_half pad."""
    right, true_up, fwd = cam_mod.camera_basis(camera)
    t = cam_mod.tan_half_fov(camera)
    return torch.cat([camera.position, right, true_up, fwd, t[None],
                      torch.zeros((11,), dtype=torch.float32,
                                  device=t.device)]).to(torch.float32)


class _Params(NamedTuple):
    n_steps: int
    width: int
    height: int
    n_pix: int
    t_min: float
    max_depth: int
    spp: int
    diffuse_model: int
    thinlens: bool


# --- plain version: the kernel's arithmetic in PyTorch ----------------------

def _primary(cam24, p: _Params, seed: int, ln, s):
    """The regenerated primary ray of sample ``s`` of every lane through the
    stage's camera -> (ox, oy, oz, dx, dy, dz)."""
    j1, j2, l1, l2 = rng_mod.uniforms4(seed, ln.pix, s, 0, rng_mod.JITTER)
    c = cam24.unbind(0)
    if p.thinlens:
        (cox, coy, coz, llx, lly, llz, hx, hy, hz, vx, vy, vz,
         ux, uy, uz, vvx, vvy, vvz, lens_r) = c[:19]
        u = vec.div(ln.pxf + j1, float(p.width))
        v = vec.div((float(p.height) - 1.0 - ln.pyf) + j2, float(p.height))
        r_d = torch.sqrt(l1) * lens_r
        phi = (2.0 * math.pi) * l2
        dx_, dy_ = r_d * torch.cos(phi), r_d * torch.sin(phi)
        ox = cox + (ux * dx_ + vvx * dy_)
        oy = coy + (uy * dx_ + vvy * dy_)
        oz = coz + (uz * dx_ + vvz * dy_)
        return (ox, oy, oz) + _norm3(llx + u * hx + v * vx - ox,
                                     lly + u * hy + v * vy - oy,
                                     llz + u * hz + v * vz - oz)
    px_, py_, pz_, rx_, ry_, rz_, ux_, uy_, uz_, fx_, fy_, fz_, tan_half = \
        c[:13]
    aspect = float(p.width) / float(p.height)
    ndc_x = vec.div(ln.pxf + j1, float(p.width)) * 2.0 - 1.0
    ndc_y = -(vec.div(ln.pyf + j2, float(p.height)) * 2.0 - 1.0)
    a = ndc_x * (tan_half * aspect)
    b = ndc_y * tan_half
    z = torch.zeros_like(a)
    return (px_ + z, py_ + z, pz_ + z) + _norm3(
        a * rx_ + b * ux_ + fx_, a * ry_ + b * uy_ + fy_,
        a * rz_ + b * uz_ + fz_)


def _steps_plain(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """``n_steps`` steps of every lane; sf (12, R) f32 = o d tp acc, si
    (3, R) i32 = s b n_done, in the kernel's layout.  Returns new (sf, si)."""
    where = torch.where
    dev = sf.device
    r = sf.shape[1]
    SPH = [pk.sph[m, :5].unbind(0) for m in range(pk.n_sph)]
    MAT = [pk.mat[k, :6].unbind(0) for k in range(pk.n_mat)]
    skyb, skyt = pk.sky[0:3], pk.sky[3:6]
    ln = lanes(r, p.width, p.n_pix, 0, dev)
    s, bb, nd = si[0], si[1], si[2]
    ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, axp, ayp, azp = sf.unbind(0)
    for _ in range(p.n_steps):
        alive = ln.valid & (nd < p.spp)

        # --- nearest sphere, near-then-far roots ---------------------------
        best_t = torch.full((r,), NO_HIT, dtype=torch.float32, device=dev)
        bnx = torch.zeros_like(ox)
        bny = torch.zeros_like(ox)
        bnz = torch.zeros_like(ox)
        bmid = torch.full_like(ox, -1.0)
        for cx, cy, cz, rad, mid in SPH:
            ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
            a_q = dx * dx + dy * dy + dz * dz
            hb = ocx * dx + ocy * dy + ocz * dz
            c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
            disc = hb * hb - a_q * c_q
            okq = disc > 0.0
            sq = torch.sqrt(where(okq, disc, 1.0))
            t_near = (-hb - sq) / a_q
            t_far = (-hb + sq) / a_q
            ts = where(okq & (t_near > p.t_min), t_near,
                       where(okq & (t_far > p.t_min), t_far, NO_HIT))
            ok = ts < best_t
            # The sign of the radius flips the normal: hollow bubbles.
            inv_r = 1.0 / where(rad == 0.0, 1.0, rad)
            best_t = where(ok, ts, best_t)
            bnx = where(ok, (ox + ts * dx - cx) * inv_r, bnx)
            bny = where(ok, (oy + ts * dy - cy) * inv_r, bny)
            bnz = where(ok, (oz + ts * dz - cz) * inv_r, bnz)
            bmid = where(ok, mid, bmid)
        hit = best_t < NO_HIT

        # --- a miss adds throughput * sky ----------------------------------
        dux, duy, duz = _norm3(dx, dy, dz)
        skyw = 0.5 * (duy + 1.0)
        add_sky = alive & ~hit
        axp = axp + where(add_sky, tpx * ((1.0 - skyw) * skyb[0]
                                          + skyw * skyt[0]), 0.0)
        ayp = ayp + where(add_sky, tpy * ((1.0 - skyw) * skyb[1]
                                          + skyw * skyt[1]), 0.0)
        azp = azp + where(add_sky, tpz * ((1.0 - skyw) * skyb[2]
                                          + skyw * skyt[2]), 0.0)

        # --- facing normal, material row by id -----------------------------
        gnx, gny, gnz = _norm3(bnx, bny, bnz)
        front = (gnx * dx + gny * dy + gnz * dz) < 0.0
        nx, ny, nz = (where(front, gnx, -gnx), where(front, gny, -gny),
                      where(front, gnz, -gnz))
        kind = torch.full_like(ox, -1.0)
        alr, alg, alb = (torch.zeros_like(ox) for _ in range(3))
        ior, fuzz = torch.ones_like(ox), torch.zeros_like(ox)
        for k, (kk, ar, ag, ab, io, fz) in enumerate(MAT):
            take = bmid == float(k)
            kind = where(take, kk, kind)
            alr, alg, alb = (where(take, ar, alr), where(take, ag, alg),
                             where(take, ab, alb))
            ior, fuzz = where(take, io, ior), where(take, fz, fuzz)

        u1, u2, u3, u4 = rng_mod.uniforms4(seed, ln.pix, s, bb,
                                           rng_mod.SCATTER)
        spx, spy, spz = vec.sphere_from(u1, u2).unbind(-1)
        cbrt = vec.cube_root_radius(u3)
        blx, bly, blz = spx * cbrt, spy * cbrt, spz * cbrt

        # --- LAMBERT: the diffuse model chosen by the config ---------------
        if p.diffuse_model == DIFFUSE_IN_SPHERE:
            ldx, ldy, ldz = nx + blx, ny + bly, nz + blz
        elif p.diffuse_model == DIFFUSE_IN_HEMISPHERE:
            inh = (blx * nx + bly * ny + blz * nz) > 0.0
            ldx, ldy, ldz = (where(inh, blx, -blx), where(inh, bly, -bly),
                             where(inh, blz, -blz))
        else:                       # DIFFUSE_ON_SPHERE, the default
            ldx, ldy, ldz = nx + spx, ny + spy, nz + spz
        near0 = ((torch.abs(ldx) < 1e-8) & (torch.abs(ldy) < 1e-8)
                 & (torch.abs(ldz) < 1e-8))
        ldx, ldy, ldz = (where(near0, nx, ldx), where(near0, ny, ldy),
                         where(near0, nz, ldz))

        # --- METAL: mirror + fuzz, absorbed below the surface --------------
        ddn = dux * nx + duy * ny + duz * nz
        rfx = dux - 2.0 * ddn * nx
        rfy = duy - 2.0 * ddn * ny
        rfz = duz - 2.0 * ddn * nz
        mdx, mdy, mdz = rfx + fuzz * blx, rfy + fuzz * bly, rfz + fuzz * blz
        metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

        # --- DIELECTRIC: Schlick coin or total internal reflection ---------
        eta = where(front, 1.0 / ior, ior)
        cos_t = torch.clamp(-(dux * nx + duy * ny + duz * nz), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot = eta * sin_t > 1.0
        do_refl = cannot | (vec.schlick(cos_t, eta) > u4)
        sin2r = eta * eta * torch.clamp(1.0 - cos_t * cos_t, min=0.0)
        cosr = torch.sqrt(torch.clamp(1.0 - sin2r, min=0.0))
        tir = sin2r > 1.0
        rrx = where(tir, 0.0, eta * dux + (eta * cos_t - cosr) * nx)
        rry = where(tir, 0.0, eta * duy + (eta * cos_t - cosr) * ny)
        rrz = where(tir, 0.0, eta * duz + (eta * cos_t - cosr) * nz)
        gdx, gdy, gdz = (where(do_refl, rfx, rrx), where(do_refl, rfy, rry),
                         where(do_refl, rfz, rrz))

        is_l, is_m, is_g = (kind == float(LAMBERT), kind == float(METAL),
                            kind == float(DIELECTRIC))
        sdx, sdy, sdz = _norm3(where(is_l, ldx, where(is_m, mdx, gdx)),
                               where(is_l, ldy, where(is_m, mdy, gdy)),
                               where(is_l, ldz, where(is_m, mdz, gdz)))
        survive = alive & hit & (metal_ok | ~is_m)
        tpx = where(survive, tpx * where(is_g, 1.0, alr), tpx)
        tpy = where(survive, tpy * where(is_g, 1.0, alg), tpy)
        tpz = where(survive, tpz * where(is_g, 1.0, alb), tpz)
        t_pt = where(hit, best_t, 1.0)

        # --- the lane continues its path or starts its next sample ---------
        cont = survive & (bb + 1 < p.max_depth)
        done = (alive & ~cont).to(torch.int32)
        nd = nd + done
        s = s + done
        pox, poy, poz, pdx, pdy, pdz = _primary(cam24, p, seed, ln, s)
        ox, oy, oz = (where(cont, ox + t_pt * dx, pox),
                      where(cont, oy + t_pt * dy, poy),
                      where(cont, oz + t_pt * dz, poz))
        dx, dy, dz = (where(cont, sdx, pdx), where(cont, sdy, pdy),
                      where(cont, sdz, pdz))
        tpx, tpy, tpz = (where(cont, tpx, 1.0), where(cont, tpy, 1.0),
                         where(cont, tpz, 1.0))
        bb = where(cont, bb + 1, 0).to(torch.int32)
    sf_out = torch.stack([ox, oy, oz, dx, dy, dz, tpx, tpy, tpz,
                          axp, ayp, azp])
    return sf_out, torch.stack([s, bb, nd]).to(torch.int32)


# --- the kernel -------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int,             # scene words
             ctypes.c_int, ctypes.c_int,                # n_sph n_mat
             ctypes.c_uint32,                           # seed
             ctypes.c_void_p, ctypes.c_void_p,          # sf si
             ctypes.c_int, ctypes.c_int,                # R n_pix
             ctypes.c_int, ctypes.c_int, ctypes.c_int,  # width height n_steps
             ctypes.c_float, ctypes.c_float,            # t_min aspect
             ctypes.c_int, ctypes.c_int,                # max_depth spp
             ctypes.c_int, ctypes.c_int,                # diffuse thinlens
             ctypes.c_void_p]                           # stream


def _lib():
    lib = kernels.load("fused_rtiow")
    fn = lib.fused_rtiow_steps
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _steps_kernel(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """Launch csrc/fused_rtiow.cu on CUDA tensors; updates sf/si in place."""
    global LAUNCHES
    for x, dt in ((sf, torch.float32), (si, torch.int32)):
        if not (x.is_cuda and x.dtype == dt and x.is_contiguous()):
            raise ValueError("fused_rtiow takes contiguous CUDA state planes "
                             "(12, R) float32 and (3, R) int32")
    r = sf.shape[1]
    if sf.shape != (12, r) or si.shape != (3, r):
        raise ValueError(f"bad state plane shapes {tuple(sf.shape)}, "
                         f"{tuple(si.shape)}")
    if r == 0:
        return sf, si
    scene = torch.cat([pk.sph.reshape(-1), pk.mat.reshape(-1), pk.sky,
                       cam24]).to(device=sf.device, dtype=torch.float32)
    rc = _lib().fused_rtiow_steps(
        scene.data_ptr(), scene.numel(), pk.n_sph, pk.n_mat, seed,
        sf.data_ptr(), si.data_ptr(), r, p.n_pix, p.width, p.height,
        p.n_steps, p.t_min, float(p.width) / float(p.height), p.max_depth,
        p.spp, p.diffuse_model, int(p.thinlens),
        torch.cuda.current_stream(sf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_rtiow kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return sf, si


def rtiow_steps(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """``p.n_steps`` steps of the (12, R) / (3, R) lane state: the kernel
    for CUDA tensors (in place), the plain version for CPU tensors."""
    core = _steps_kernel if sf.is_cuda else _steps_plain
    return core(pk, cam24, int(seed) & 0xFFFFFFFF, sf, si, p)


# --- the render -------------------------------------------------------------

def _setup(scene: Scene, camera, cfg: RenderConfig, seed: int, dev):
    """The pack, camera words, parameters (for ``n_steps`` = 0) and the
    initial lane state: every lane on its pixel's sample-0 primary ray,
    built by the stage's ray generation (``thin_lens_rays`` /
    ``perspective_rays``), not the kernel's regeneration."""
    thinlens = isinstance(camera, cam_mod.ThinLensCamera)
    camera = camera.to(dev)
    h, w = cfg.height, cfg.width
    n_pix = h * w
    pk = pack_rtiow_scene(scene).to(dev)
    cam24 = (_thinlens_words(camera) if thinlens
             else _perspective_words(camera))
    pixel = torch.arange(n_pix, dtype=torch.int64, device=dev)
    j = rng_mod.uniforms4(seed, pixel, 0, 0, rng_mod.JITTER)
    if thinlens:
        x = (pixel % w).to(torch.float32)
        y = (pixel // w).to(torch.float32)
        u = vec.div(x + j[0], float(w))
        v = vec.div((h - 1.0) - y + j[1], float(h))
        o, d = cam_mod.thin_lens_rays(camera, u, v, j[2], j[3])
    else:
        uj = torch.stack([j[0].reshape(h, w), j[1].reshape(h, w)], -1)
        d = cam_mod.perspective_rays(camera, w, h, uj).reshape(-1, 3)
        o = camera.position.expand(d.shape)
    ones = torch.ones((n_pix, 3), dtype=torch.float32, device=dev)
    sf = torch.cat([o.T, d.T, ones.T, torch.zeros_like(ones).T]).contiguous()
    si = torch.zeros((3, n_pix), dtype=torch.int32, device=dev)
    p = _Params(n_steps=0, width=w, height=h, n_pix=n_pix,
                t_min=float(cfg.t_min), max_depth=int(cfg.max_depth),
                spp=int(cfg.spp), diffuse_model=int(cfg.diffuse_model),
                thinlens=thinlens)
    return pk, cam24, sf, si, p


def render_fused(scene: Scene, camera, cfg: RenderConfig, seed: int,
                 device=None) -> torch.Tensor:
    """Equal-spp fused render of an RTIOW stage -> mean linear (H, W, 3),
    on ``device`` (default: the card).  ``camera``: ``ThinLensCamera``
    (offline prototype) or ``PerspectiveCamera`` (NPPT stage)."""
    dev = kernels.resolve_device(device)
    pk, cam24, sf, si, p = _setup(scene, camera, cfg, seed, dev)
    # Chunk doubling: each poll of min(n_done) is a device round trip.
    chunk = max(32, cfg.max_depth)
    for _ in range(cfg.spp * cfg.max_depth):
        sf, si = rtiow_steps(pk, cam24, seed, sf, si,
                             p._replace(n_steps=chunk))
        if int(torch.min(si[2])) >= cfg.spp:
            break
        chunk = min(2 * chunk, 4096)
    acc = sf[9:12].T
    return vec.div(acc, float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
