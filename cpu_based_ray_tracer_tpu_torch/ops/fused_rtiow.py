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
  ``ctypes``).  ``render_fused`` runs a whole render on the card in one
  launch: each thread steps pixels to their last sample and takes the next
  from a counter.  ``rtiow_steps`` launches its step mode (``n_steps``
  steps of every lane) for CUDA tensors.
- ``_steps_plain`` is the same arithmetic in PyTorch, vectorized over
  lanes, looping over spheres.  ``rtiow_steps`` runs it for CPU tensors
  only, and ``render_fused`` on the CPU steps every lane with it under the
  JAX package's chunk schedule (``render_lockstep``); ``chip_smoke.py``
  holds the kernel against it.  ``render_refill_plain`` is the one-launch
  render's schedule in PyTorch (pixels run to completion from a queue, each
  step computing only the branch a lane needs), for the tests.
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
from cpu_based_ray_tracer_tpu_torch.ops.fused import (NO_HIT, Lanes, _norm3,
                                                      lanes)
from cpu_based_ray_tracer_tpu_torch.scene import (DIELECTRIC,
                                                  DIFFUSE_IN_HEMISPHERE,
                                                  DIFFUSE_IN_SPHERE, LAMBERT,
                                                  METAL, Scene)
from cpu_based_ray_tracer_tpu_torch.utils import kernels, profiling
from cpu_based_ray_tracer_tpu_torch.utils import rng as rng_mod

# Launches of csrc/fused_rtiow.cu (step and render modes) since the last
# reset.
LAUNCHES = profiling.Counter("fused_rtiow")
# Work items (pixel, sample chunk) per resident thread that the render
# mode asks for (render_chunks).
RENDER_ITEMS_PER_THREAD = 16
_ONE_THIRD = float(np.float32(1.0 / 3.0))   # the kernel's exponent


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


def _cube_root(u):
    """u ** f32(1/3) (``vec.cube_root_radius``).  On the CPU in float64,
    rounded to float32: PyTorch's float32 ``pow`` there rounds the elements
    of a vector loop and of its scalar tail differently, so a lane's value
    would hang on how many lanes the call holds.  On the card the float32
    ``pow``, as the kernel's ``powf``."""
    if u.is_cuda:
        return vec.cube_root_radius(u)
    return torch.pow(u.double(), _ONE_THIRD).float()


def _nearest_sphere(pk: RtiowPack, ray, t_min: float):
    """The nearest sphere of each ray (near-then-far roots) -> (t, the
    winner's normal (p - c) / radius, its material id); NO_HIT, 0 and -1 on
    a miss."""
    where = torch.where
    ox, oy, oz, dx, dy, dz = ray
    best_t = torch.full_like(ox, NO_HIT)
    bnx = torch.zeros_like(ox)
    bny = torch.zeros_like(ox)
    bnz = torch.zeros_like(ox)
    bmid = torch.full_like(ox, -1.0)
    for m in range(pk.n_sph):
        cx, cy, cz, rad, mid = pk.sph[m, :5].unbind(0)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a_q = dx * dx + dy * dy + dz * dz
        hb = ocx * dx + ocy * dy + ocz * dz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = hb * hb - a_q * c_q
        okq = disc > 0.0
        sq = torch.sqrt(where(okq, disc, 1.0))
        t_near = (-hb - sq) / a_q
        t_far = (-hb + sq) / a_q
        ts = where(okq & (t_near > t_min), t_near,
                   where(okq & (t_far > t_min), t_far, NO_HIT))
        ok = ts < best_t
        # The sign of the radius flips the normal: hollow bubbles.
        inv_r = 1.0 / where(rad == 0.0, 1.0, rad)
        best_t = where(ok, ts, best_t)
        bnx = where(ok, (ox + ts * dx - cx) * inv_r, bnx)
        bny = where(ok, (oy + ts * dy - cy) * inv_r, bny)
        bnz = where(ok, (oz + ts * dz - cz) * inv_r, bnz)
        bmid = where(ok, mid, bmid)
    return best_t, bnx, bny, bnz, bmid


def _steps_plain(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """``n_steps`` steps of every lane; sf (12, R) f32 = o d tp acc, si
    (3, R) i32 = s b n_done, in the kernel's layout.  Returns new (sf, si)."""
    where = torch.where
    dev = sf.device
    r = sf.shape[1]
    MAT = [pk.mat[k, :6].unbind(0) for k in range(pk.n_mat)]
    skyb, skyt = pk.sky[0:3], pk.sky[3:6]
    ln = lanes(r, p.width, p.n_pix, 0, dev)
    s, bb, nd = si[0], si[1], si[2]
    ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, axp, ayp, azp = sf.unbind(0)
    for _ in range(p.n_steps):
        alive = ln.valid & (nd < p.spp)

        best_t, bnx, bny, bnz, bmid = _nearest_sphere(
            pk, (ox, oy, oz, dx, dy, dz), p.t_min)
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
        cbrt = _cube_root(u3)
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


def _step_branchy(pk: RtiowPack, cam24, seed: int, p: _Params, ln, sf, si):
    """One step of the lanes (12, n) / (3, n) of the pixels ``ln`` (all
    valid and live), each computing only what its ray needs, as the
    kernel's step does: a miss the sky term; a hit below the depth cap the
    facing normal and its material's branch.  In place; returns the lanes
    that added a sky term and the terms (3, m) they added."""
    where = torch.where
    dev = sf.device
    ox, oy, oz, dx, dy, dz = sf[0:6].clone()
    s, bb = si[0].clone(), si[1].clone()
    n = sf.shape[1]
    best_t, bnx, bny, bnz, bmid = _nearest_sphere(
        pk, (ox, oy, oz, dx, dy, dz), p.t_min)
    hit = best_t < NO_HIT
    cont = torch.zeros((n,), dtype=torch.bool, device=dev)
    sd = torch.zeros((3, n), dtype=torch.float32, device=dev)

    # --- a miss adds throughput * sky ---------------------------------------
    m = torch.nonzero(~hit)[:, 0]
    dux, duy, duz = _norm3(dx[m], dy[m], dz[m])
    skyw = 0.5 * (duy + 1.0)
    terms = torch.stack([sf[6 + c, m] * ((1.0 - skyw) * pk.sky[c]
                                         + skyw * pk.sky[3 + c])
                         for c in range(3)])
    sf[9:12, m] = sf[9:12, m] + terms

    # --- a hit below the depth cap: facing normal, its material's branch ---
    h = torch.nonzero(hit & (bb + 1 < p.max_depth))[:, 0]
    gnx, gny, gnz = _norm3(bnx[h], bny[h], bnz[h])
    hdx, hdy, hdz = dx[h], dy[h], dz[h]
    front = (gnx * hdx + gny * hdy + gnz * hdz) < 0.0
    nx, ny, nz = (where(front, gnx, -gnx), where(front, gny, -gny),
                  where(front, gnz, -gnz))
    mid = bmid[h]
    kind = torch.full_like(mid, -1.0)
    al = torch.zeros((3, h.numel()), dtype=torch.float32, device=dev)
    ior, fuzz = torch.ones_like(mid), torch.zeros_like(mid)
    for k in range(pk.n_mat):
        take = mid == float(k)
        kind = where(take, pk.mat[k, 0], kind)
        al = where(take, pk.mat[k, 1:4, None], al)
        ior, fuzz = where(take, pk.mat[k, 4], ior), where(take, pk.mat[k, 5],
                                                          fuzz)
    u = rng_mod.uniforms4(seed, ln.pix[h], s[h], bb[h], rng_mod.SCATTER)
    hcont = torch.zeros_like(front)
    hsd = torch.zeros((3, h.numel()), dtype=torch.float32, device=dev)

    def ball(i, sp):
        cbrt = _cube_root(u[2][i])
        return [c * cbrt for c in sp]

    lam = torch.nonzero(kind == float(LAMBERT))[:, 0]
    if lam.numel():
        sp = list(vec.sphere_from(u[0][lam], u[1][lam]).unbind(-1))
        n3 = [nx[lam], ny[lam], nz[lam]]
        if p.diffuse_model == DIFFUSE_IN_SPHERE:
            ld = [a + b for a, b in zip(n3, ball(lam, sp))]
        elif p.diffuse_model == DIFFUSE_IN_HEMISPHERE:
            bl = ball(lam, sp)
            inh = (bl[0] * n3[0] + bl[1] * n3[1] + bl[2] * n3[2]) > 0.0
            ld = [where(inh, b, -b) for b in bl]
        else:                       # DIFFUSE_ON_SPHERE, the default
            ld = [a + b for a, b in zip(n3, sp)]
        near0 = ((torch.abs(ld[0]) < 1e-8) & (torch.abs(ld[1]) < 1e-8)
                 & (torch.abs(ld[2]) < 1e-8))
        hsd[:, lam] = torch.stack([where(near0, a, b) for a, b in zip(n3, ld)])
        hcont[lam] = True
    rest = torch.nonzero(kind != float(LAMBERT))[:, 0]
    if rest.numel():
        du = _norm3(hdx[rest], hdy[rest], hdz[rest])
        n3 = [nx[rest], ny[rest], nz[rest]]
        ddn = du[0] * n3[0] + du[1] * n3[1] + du[2] * n3[2]
        rf = [a - 2.0 * ddn * b for a, b in zip(du, n3)]
        is_m = kind[rest] == float(METAL)
        met = torch.nonzero(is_m)[:, 0]
        if met.numel():
            i = rest[met]
            bl = ball(i, list(vec.sphere_from(u[0][i], u[1][i]).unbind(-1)))
            md = [r[met] + fuzz[i] * b for r, b in zip(rf, bl)]
            hsd[:, i] = torch.stack(md)
            hcont[i] = (md[0] * nx[i] + md[1] * ny[i] + md[2] * nz[i]) > 0.0
        gl = torch.nonzero(~is_m)[:, 0]
        if gl.numel():
            i = rest[gl]
            dg = [x[gl] for x in du]
            ng = [x[gl] for x in n3]
            eta = where(front[i], 1.0 / ior[i], ior[i])
            cos_t = torch.clamp(-(dg[0] * ng[0] + dg[1] * ng[1]
                                  + dg[2] * ng[2]), max=1.0)
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            do_refl = (eta * sin_t > 1.0) | (vec.schlick(cos_t, eta) > u[3][i])
            gd = torch.stack([r[gl] for r in rf])
            t = torch.nonzero(~do_refl)[:, 0]
            if t.numel():
                et, ct = eta[t], cos_t[t]
                sin2r = et * et * torch.clamp(1.0 - ct * ct, min=0.0)
                cosr = torch.sqrt(torch.clamp(1.0 - sin2r, min=0.0))
                tir = sin2r > 1.0
                gd[:, t] = torch.stack([
                    where(tir, 0.0, et * a[t] + (et * ct - cosr) * b[t])
                    for a, b in zip(dg, ng)])
            hsd[:, i] = gd
            hcont[i] = True
    c = torch.nonzero(hcont)[:, 0]
    hc = h[c]
    sd[:, hc] = torch.stack(_norm3(*hsd[:, c]))
    is_g = kind[c] == float(DIELECTRIC)
    for k in range(3):
        sf[6 + k, hc] = sf[6 + k, hc] * where(is_g, 1.0, al[k, c])
    cont[hc] = True

    # --- the lane continues its path or starts its next sample -------------
    done = ~cont
    si[2] += done.to(torch.int32)
    si[0] += done.to(torch.int32)
    k = torch.nonzero(cont)[:, 0]
    for j, x in enumerate((ox, oy, oz)):
        sf[j, k] = x[k] + best_t[k] * sf[3 + j, k]
    sf[3:6, k] = sd[:, k]
    si[1, k] += 1
    e = torch.nonzero(done)[:, 0]
    if e.numel():
        ln_e = lanes_of(ln.pix[e], p.width, p.n_pix)
        sf[0:6, e] = torch.stack(_primary(cam24, p, seed, ln_e, si[0, e]))
        sf[6:9, e] = 1.0
        si[1, e] = 0
    return m, terms


def lanes_of(pix, width: int, n_pix: int):
    """The ``ops.fused.Lanes`` of the pixel ids ``pix``."""
    return Lanes(pix, pix < n_pix, (pix % width).to(torch.float32),
                 (pix // width).to(torch.float32))


_POOL = 128     # slots of render_refill_plain


def render_refill_plain(pk: RtiowPack, cam24, seed: int, sf, si,
                        p: _Params, chunks: int = 1):
    """The one-launch render's schedule in PyTorch.  Work items are
    (pixel, chunk): chunk k of a pixel is its samples [spp k / chunks,
    spp (k + 1) / chunks), items pixel by pixel, the image's pixels last
    to first (an order other than the lockstep one).  ``_POOL`` slots each
    step one item until its last sample is done (skipping the branches its
    rays do not need), then take the next.  Chunk 0 starts from the planes and accumulates; a
    later chunk starts from its first sample's regenerated ray and records
    its sky terms, which are added to chunk 0's sum in sample order at the
    end.  From ``_setup``'s planes (12, P) / (3, P); returns the final
    planes, which the lockstep schedule (``render_lockstep``) gives too."""
    sf, si = sf.clone(), si.clone()
    dev = sf.device
    r = sf.shape[1]
    item_pix = torch.arange(r - 1, -1, -1, device=dev).repeat_interleave(
        chunks)
    item_k = torch.arange(chunks, device=dev).repeat(r)
    terms = torch.zeros((r, max(p.spp, 1), 3), dtype=torch.float32,
                        device=dev)
    has = torch.zeros((r, max(p.spp, 1)), dtype=torch.bool, device=dev)
    lane = torch.full((_POOL,), -1, dtype=torch.int64, device=dev)
    kk = torch.zeros((_POOL,), dtype=torch.int64, device=dev)
    s1 = torch.zeros((_POOL,), dtype=torch.int32, device=dev)
    fsl = torch.zeros((12, _POOL), dtype=torch.float32, device=dev)
    isl = torch.zeros((3, _POOL), dtype=torch.int32, device=dev)
    nxt = 0
    while True:
        fin = torch.nonzero((lane >= 0) & (isl[2] >= s1))[:, 0]
        pf, kf = lane[fin], kk[fin]
        if chunks == 1:
            sf[:, pf], si[:, pf] = fsl[:, fin], isl[:, fin]
        else:
            first, last = fin[kf == 0], fin[kf == chunks - 1]
            sf[9:12, lane[first]] = fsl[9:12, first]
            sf[0:9, lane[last]] = fsl[0:9, last]
            si[:, lane[last]] = isl[:, last]
        lane[fin] = -1
        free = torch.nonzero(lane < 0)[:, 0]
        take = slice(nxt, nxt + free.numel())
        tp_, tk = item_pix[take], item_k[take]
        nxt += tp_.numel()
        free = free[:tp_.numel()]
        lane[free], kk[free] = tp_, tk
        s1[free] = (p.spp * (tk + 1) // chunks).to(torch.int32)
        fsl[:, free], isl[:, free] = sf[:, tp_], si[:, tp_]
        later = free[tk > 0]
        if later.numel():
            s0 = (p.spp * kk[later] // chunks).to(torch.int32)
            isl[:, later] = torch.stack([s0, torch.zeros_like(s0), s0])
            fsl[0:6, later] = torch.stack(_primary(
                cam24, p, seed, lanes_of(lane[later], p.width, p.n_pix), s0))
            fsl[6:9, later] = 1.0
            fsl[9:12, later] = 0.0
        act = torch.nonzero((lane >= 0) & (isl[2] < s1))[:, 0]
        if act.numel() == 0:
            if bool((lane < 0).all()) and nxt >= item_pix.numel():
                break
            continue
        f, i = fsl[:, act], isl[:, act]
        s_now = i[0].clone()
        m, t = _step_branchy(pk, cam24, seed, p, lanes_of(
            lane[act], p.width, p.n_pix), f, i)
        fsl[:, act], isl[:, act] = f, i
        rec = m[kk[act[m]] > 0]
        terms[lane[act[rec]], s_now[rec].long()] = t[:, kk[act[m]] > 0].T
        has[lane[act[rec]], s_now[rec].long()] = True
    acc = sf[9:12].clone()
    for s in range(p.spp):
        acc = torch.where(has[:, s], acc + terms[:, s].T, acc)
    sf[9:12] = acc
    return sf, si


# --- the kernel -------------------------------------------------------------

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
LIB = kernels.Library("fused_rtiow", {
    # (scene, words, n_sph, n_mat, seed, sf, si, R, n_pix, width, height,
    #  n_steps, t_min, aspect, max_depth, spp, diffuse, thinlens, stream)
    "fused_rtiow_steps": [_P, _I, _I, _I, ctypes.c_uint32, _P, _P, _I, _I,
                          _I, _I, _I, _F, _F, _I, _I, _I, _I, _P],
    # (scene, words, n_sph, n_mat, seed, sf, si, R, width, height, t_min,
    #  aspect, max_depth, spp, diffuse, thinlens, chunks, cap, contrib,
    #  counts, tickets, next, stream)
    "fused_rtiow_render": [_P, _I, _I, _I, ctypes.c_uint32, _P, _P, _I, _I,
                           _I, _F, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P],
    # (words, diffuse, thinlens, out)
    "fused_rtiow_render_slots": [_I] * 3 + [_P],
}, LAUNCHES)


def _state_lanes(sf, si) -> int:
    """The lanes of the state planes sf (12, R) f32 and si (3, R) i32,
    contiguous CUDA tensors, or ValueError."""
    kernels.check("fused_rtiow", dict(sf=(sf, torch.float32),
                                      si=(si, torch.int32)))
    r = sf.shape[1]
    if sf.shape != (12, r) or si.shape != (3, r):
        raise ValueError(f"bad state plane shapes {tuple(sf.shape)}, "
                         f"{tuple(si.shape)}")
    return r


def _scene_words(pk: RtiowPack, cam24, dev) -> torch.Tensor:
    return torch.cat([pk.sph.reshape(-1), pk.mat.reshape(-1), pk.sky,
                      cam24]).to(device=dev, dtype=torch.float32)


def _steps_kernel(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """Launch csrc/fused_rtiow.cu's step mode on CUDA tensors; updates
    sf/si in place."""
    r = _state_lanes(sf, si)
    if r == 0:
        return sf, si
    scene = _scene_words(pk, cam24, sf.device)
    LIB.launch(
        "fused_rtiow_steps", scene.data_ptr(), scene.numel(), pk.n_sph,
        pk.n_mat, seed, sf.data_ptr(), si.data_ptr(), r, p.n_pix, p.width,
        p.height, p.n_steps, p.t_min, float(p.width) / float(p.height),
        p.max_depth, p.spp, p.diffuse_model, int(p.thinlens),
        kernels.stream(sf))
    return sf, si


def render_chunks(n_pix: int, spp: int, threads: int,
                  scratch_bytes: int) -> int:
    """Sample chunks per pixel of the render mode: enough (pixel, chunk)
    work items for ``RENDER_ITEMS_PER_THREAD`` per resident thread, 1 to
    ``spp``, and no more than keep the chunks' recorded terms (16 bytes a
    sample of every chunk but the first) within ``scratch_bytes``.  A
    pixel's samples run one after another in one thread, so the slowest
    pixel's chain of steps bounds the render's time; chunks cut the
    chain."""
    if n_pix <= 0:
        return 1
    c = max(1, min(spp, -(-RENDER_ITEMS_PER_THREAD * threads // n_pix)))
    while c > 1 and (c - 1) * n_pix * -(-spp // c) * 16 > scratch_bytes:
        c -= 1
    return c


def _render_kernel(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params,
                   chunks: int | None = None):
    """Launch csrc/fused_rtiow.cu's render mode on CUDA tensors: every
    pixel of ``_setup``'s planes to its last sample in one launch, in
    place; each pixel's samples in ``chunks`` chunks (default
    ``default_chunks``)."""
    r = _state_lanes(sf, si)
    if r != p.n_pix:
        raise ValueError(f"the render runs the image's {p.n_pix} pixels, "
                         f"not {r} lanes")
    if r == 0:
        return sf, si
    dev = sf.device
    if chunks is None:
        chunks = default_chunks(pk, p, dev)
    scene = _scene_words(pk, cam24, dev)
    nxt = torch.zeros((1,), dtype=torch.int32, device=dev)
    cap = -(-p.spp // chunks)
    later = (chunks - 1) * r
    contrib = torch.empty((later * cap * 4,), dtype=torch.float32, device=dev)
    counts = torch.empty((later,), dtype=torch.int32, device=dev)
    tickets = torch.zeros((r if chunks > 1 else 0,), dtype=torch.int32,
                          device=dev)
    LIB.launch(
        "fused_rtiow_render", scene.data_ptr(), scene.numel(), pk.n_sph,
        pk.n_mat, seed, sf.data_ptr(), si.data_ptr(), r, p.width, p.height,
        p.t_min, float(p.width) / float(p.height), p.max_depth, p.spp,
        p.diffuse_model, int(p.thinlens), chunks, cap, contrib.data_ptr(),
        counts.data_ptr(), tickets.data_ptr(), nxt.data_ptr(),
        kernels.stream(sf))
    return sf, si


def default_chunks(pk: RtiowPack, p: _Params, dev) -> int:
    """``render_chunks`` on this card: its resident render threads (blocks
    of 256 per SM, for the scene's words), the scratch within a quarter of
    its free memory."""
    per_sm, n_sm = LIB.occupancy(
        "fused_rtiow_render_slots", pk.sph.numel() + pk.mat.numel() + 8 + 24,
        p.diffuse_model, int(p.thinlens))
    return render_chunks(p.n_pix, p.spp, per_sm * n_sm * 256,
                         torch.cuda.mem_get_info(dev)[0] // 4)


def rtiow_steps(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """``p.n_steps`` steps of the (12, R) / (3, R) lane state: the kernel
    for CUDA tensors (in place), the plain version for CPU tensors."""
    core = _steps_kernel if sf.is_cuda else _steps_plain
    return core(pk, cam24, int(seed) & 0xFFFFFFFF, sf, si, p)


def render_lockstep(pk: RtiowPack, cam24, seed: int, sf, si, p: _Params):
    """The JAX package's schedule: every lane steps together, in chunks
    doubling from max(32, max_depth) to 4,096 steps, one poll of
    min(n_done) between chunks, until every pixel has its ``p.spp``
    samples (``rtiow_steps``: the step-mode kernel on the card)."""
    chunk = max(32, p.max_depth)
    for _ in range(p.spp * p.max_depth):
        sf, si = rtiow_steps(pk, cam24, seed, sf, si,
                             p._replace(n_steps=chunk))
        if int(torch.min(si[2])) >= p.spp:
            break
        chunk = min(2 * chunk, 4096)
    return sf, si


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
    (offline prototype) or ``PerspectiveCamera`` (NPPT stage).  On the card
    one launch renders every pixel; on the CPU the plain stepper runs the
    lockstep schedule, which gives the same image."""
    dev = kernels.resolve_device(device)
    pk, cam24, sf, si, p = _setup(scene, camera, cfg, seed, dev)
    seed = int(seed) & 0xFFFFFFFF
    # No step at all without samples or depth, as the lockstep schedule.
    if cfg.spp * cfg.max_depth > 0:
        run = _render_kernel if dev.type == "cuda" else render_lockstep
        sf, si = run(pk, cam24, seed, sf, si, p)
    acc = sf[9:12].T
    return vec.div(acc, float(cfg.spp)).reshape(cfg.height, cfg.width, 3)
