"""Fused persistent-wavefront Monte Carlo bounce kernel (port of
``cpu_based_ray_tracer_tpu.ops.fused``).

One launch advances every lane through ``n_steps`` bounces with its path
state held in registers: main intersect (Moller-Trumbore over every
triangle, sphere quadratics) -> emissive/sky termination -> area-light
sample -> NEE shadow ray (division-free accept) -> Lambertian NEE -> RR +
uniform-hemisphere scatter -> regeneration of the camera ray for the
lane's next sample.  Lane-for-lane the semantics of the JAX package's
Pallas kernel and of ``models.monte_carlo.wavefront_steps``: the same
pcg4d streams, the same estimator, the same masking.

- ``csrc/fused_mc.cu`` is the kernel (CUDA C++ for sm_90a, loaded with
  ``ctypes``); ``wavefront_steps_fused`` launches it for CUDA tensors.
  In the gated modes persistent threads take lanes from a counter and a
  lane retires once its quota is met (the step's fixed point), so
  finished lanes cost no steps.
- ``wavefront_steps_fused_plain`` is the same arithmetic in PyTorch,
  vectorized over lanes, looping over primitives.  The wrapper runs it for
  CPU tensors only; ``chip_smoke.py`` holds the kernel against it.
  ``_steps_plain(retire=True)`` runs the kernel's retiring schedule; the
  tests hold it bit equal to the lockstep one.

Modes: plain (lanes regenerate forever — equal-time progressive),
``stop_after`` (a lane that has completed that many samples idles — the
equal-spp estimator) and ``single_path`` (the Denoiser frame: one sample
per lane with its sample index pinned, and the primary hit's 8-plane
G-buffer written at the launch's first step — ``single_sample_gbuffer``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils import kernels
from cpu_based_ray_tracer_tpu_torch.utils import profiling
from cpu_based_ray_tracer_tpu_torch.utils import rng as rng_mod

_DET_EPS = 1e-12
NO_HIT = float(np.finfo(np.float32).max)
TRI_W, SPH_W, LIGHT_W = 20, 16, 16

# Launches of csrc/fused_mc.cu since the last reset.
LAUNCHES = profiling.Counter("fused_mc")


# --- the lane state -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WavefrontState:
    """Carryable lane state of the persistent wavefront integrator."""

    s: torch.Tensor       # (R,) i32 current sample index per lane
    b: torch.Tensor       # (R,) i32 current bounce of the in-flight path
    o: torch.Tensor       # (R, 3) ray origin
    d: torch.Tensor       # (R, 3) ray direction
    tp: torch.Tensor      # (R, 3) path throughput
    cur: torch.Tensor     # (R, 3) partial radiance of the in-flight path
    acc: torch.Tensor     # (R, 3) summed radiance of completed samples
    n_done: torch.Tensor  # (R,) i32 completed samples per lane
    nrays: torch.Tensor   # () i32 traced-ray counter (wraps like int32)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (JAX's int32 sums)."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def state_planes(state: WavefrontState):
    """A ``WavefrontState`` as the kernels' contiguous planes: sf (15, R)
    f32 [o d tp cur acc], si (4, R) i32 [s b n_done shadow-ray tally=0]."""
    sf = torch.cat([x.T for x in (state.o, state.d, state.tp, state.cur,
                                  state.acc)], 0).to(torch.float32)
    si = torch.stack([state.s, state.b, state.n_done,
                      torch.zeros_like(state.s)]).to(torch.int32)
    return sf.contiguous(), si.contiguous()


def planes_state(state: WavefrontState, sf, si,
                 n_steps: int) -> WavefrontState:
    """The state that ``n_steps`` steps from ``state`` left in the planes
    sf / si (``state_planes``'s layout, si[3] the shadow rays traced).
    Every lane traces a main ray each step; the ray counter wraps modulo
    2^31 per call and modulo 2^32 overall, as the JAX package's int32
    counter."""
    r = sf.shape[1]
    v3 = lambda k: sf[3 * k:3 * k + 3].T                          # noqa: E731
    nrays = wrap_i32(state.nrays.to(torch.int64)
                     + (int(n_steps) * r) % (1 << 31)
                     + si[3].to(torch.int64).sum())
    return WavefrontState(s=si[0], b=si[1], o=v3(0), d=v3(1), tp=v3(2),
                          cur=v3(3), acc=v3(4), n_done=si[2], nrays=nrays)


@dataclasses.dataclass(frozen=True)
class FusedScene:
    """Kernel-ready pack of a (small) scene, built by ``pack_scene``."""

    tri: torch.Tensor    # (N, 20) f32: v0 e1 e2 normal albedo emission emissive pad
    sph: torch.Tensor    # (max(S,1), 16) f32: center radius albedo emission emissive pad*
    light: torch.Tensor  # (Le, 16) f32: v0 e1 e2 normal emission cdf
    sky: torch.Tensor    # (8,) f32: sky_bottom(3) sky_top(3) light_total pad
    n_tri: int
    n_sph: int
    n_light: int

    def to(self, device) -> "FusedScene":
        return dataclasses.replace(self, tri=self.tri.to(device),
                                   sph=self.sph.to(device),
                                   light=self.light.to(device),
                                   sky=self.sky.to(device))


def pack_scene(scene: Scene) -> FusedScene:
    """Flatten scene + material tables into per-primitive rows (host-side,
    numpy; byte-equal to the JAX package's pack).  Zero-radius spheres, the
    never-hit placeholders, are dropped; one ignored zero row stays so the
    array is never empty.  The light CDF is the cumsum of emissive-triangle
    areas in triangle order."""
    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731
    tr, sp, mats = scene.triangles, scene.spheres, scene.materials
    v0, e1, e2, nrm = np_(tr.v0), np_(tr.e1), np_(tr.e2), np_(tr.normal)
    tmat = np_(tr.material)
    m_alb, m_emi = np_(mats.albedo), np_(mats.emission)
    m_emf = np.linalg.norm(m_emi, axis=-1) > 1e-5
    alb, emi = m_alb[tmat], m_emi[tmat]
    emf = m_emf[tmat].astype(np.float32)
    n = v0.shape[0]
    tri = np.zeros((n, TRI_W), np.float32)
    tri[:, 0:3] = v0; tri[:, 3:6] = e1; tri[:, 6:9] = e2
    tri[:, 9:12] = nrm; tri[:, 12:15] = alb; tri[:, 15:18] = emi
    tri[:, 18] = emf

    c, r, smat = np_(sp.center), np_(sp.radius), np_(sp.material)
    live = r != 0.0
    c, r, smat = c[live], r[live], smat[live]
    s = c.shape[0]
    sph = np.zeros((max(s, 1), SPH_W), np.float32)
    sph[:s, 0:3] = c; sph[:s, 3] = r
    sph[:s, 4:7] = m_alb[smat]
    sph[:s, 7:10] = m_emi[smat]
    sph[:s, 10] = m_emf[smat].astype(np.float32)

    area = 0.5 * np.linalg.norm(
        np.cross(e1.astype(np.float32), e2.astype(np.float32)), axis=-1
    ).astype(np.float32)
    lidx = np.flatnonzero(emf > 0.5)
    if len(lidx) == 0:
        lidx = np.array([0])
        light_total = np.float32(0.0)
        cdf = np.zeros((1,), np.float32)
    else:
        masked = np.where(emf > 0.5, area, np.float32(0.0)).astype(np.float32)
        cdf_full = np.cumsum(masked, dtype=np.float32)
        cdf = cdf_full[lidx].astype(np.float32)
        light_total = cdf_full[-1]
    le = len(lidx)
    light = np.zeros((le, LIGHT_W), np.float32)
    light[:, 0:3] = v0[lidx]; light[:, 3:6] = e1[lidx]
    light[:, 6:9] = e2[lidx]; light[:, 9:12] = nrm[lidx]
    light[:, 12:15] = emi[lidx]
    light[:, 15] = cdf

    sky = np.zeros((8,), np.float32)
    sky[0:3] = np_(scene.sky_bottom)
    sky[3:6] = np_(scene.sky_top)
    sky[6] = light_total
    dev = scene.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return FusedScene(tri=t(tri), sph=t(sph), light=t(light), sky=t(sky),
                      n_tri=n, n_sph=s, n_light=le)


def _camera_words(camera: cam_mod.PerspectiveCamera) -> torch.Tensor:
    """(16,) f32: position(3) right(3) true_up(3) forward(3) tan_half pad."""
    right, true_up, fwd = cam_mod.camera_basis(camera)
    t = cam_mod.tan_half_fov(camera)
    return torch.cat([camera.position, right, true_up, fwd, t[None],
                      torch.zeros((3,), dtype=torch.float32,
                                  device=t.device)]).to(torch.float32)


class _Params(NamedTuple):
    n_steps: int
    width: int
    height: int
    n_pix: int
    t_min: float
    eps_offset: float
    rr_survival: float
    shadow_tol: float
    max_depth: int
    stop_after: int
    single_path: bool = False


# --- plain version: the kernel's arithmetic in PyTorch ----------------------

def _norm3(x, y, z, floor=1e-24):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=floor))
    return x * inv, y * inv, z * inv


def _light_sample(light, n_light: int, light_total, seed, pix, s, bb,
                  px, py, pz):
    """One area-light sample (LIGHT stream, CDF select, 1 - sqrt(u1)
    barycentrics) seen from the points p -> (unit w_l, dist, the chosen
    light row's 15 planes: v0 e1 e2 normal emission)."""
    where = torch.where
    ul0, ul1, ul2, _ = rng_mod.uniforms4(seed, pix, s, bb, rng_mod.LIGHT)
    budget = ul0 * light_total
    lgt = [list(light[e].unbind(0)) for e in range(n_light)]
    row = lgt[0][:15]
    for e in range(1, n_light):
        take = lgt[e - 1][15] <= budget
        row = [where(take, v, o) for v, o in zip(lgt[e][:15], row)]
    (lv0x, lv0y, lv0z, le1x, le1y, le1z, le2x, le2y, le2z) = row[:9]
    xw = 1.0 - torch.sqrt(ul1)
    w1 = (1.0 - xw) * ul2
    w2 = (1.0 - xw) * (1.0 - ul2)
    lpx = lv0x + w1 * le1x + w2 * le2x
    lpy = lv0y + w1 * le1y + w2 * le2y
    lpz = lv0z + w1 * le1z + w2 * le2z
    tlx, tly, tlz = lpx - px, lpy - py, lpz - pz
    dist = torch.sqrt(torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=0.0))
    invd = 1.0 / torch.clamp(dist, min=1e-20)
    return (tlx * invd, tly * invd, tlz * invd), dist, row


class Lanes(NamedTuple):
    """Per-lane constants of a step: absolute pixel id, validity, (x, y)."""

    pix: torch.Tensor
    valid: torch.Tensor
    pxf: torch.Tensor
    pyf: torch.Tensor


def lanes(r: int, width: int, n_pix: int, pixel_offset: int, device) -> Lanes:
    pix = torch.arange(r, dtype=torch.int64, device=device) + pixel_offset
    return Lanes(pix, pix < n_pix, (pix % width).to(torch.float32),
                 (pix // width).to(torch.float32))


def _camera_ray(cam16, seed: int, p, ln: Lanes, s):
    """The camera ray of sample ``s`` of each lane's pixel (the JITTER
    stream), in the operation order of camera.perspective_ray_at: the ray
    a lane regenerates when its path ends."""
    dev = s.device
    c = cam16.unbind(0)
    rx_, ry_, rz_ = c[3:6]
    ux_, uy_, uz_ = c[6:9]
    fx_, fy_, fz_ = c[9:12]
    tan_half = c[12]
    aspect = float(p.width) / float(p.height)
    width_f = torch.tensor(p.width, dtype=torch.float32, device=dev)
    height_f = torch.tensor(p.height, dtype=torch.float32, device=dev)
    uj0, uj1, _, _ = rng_mod.uniforms4(seed, ln.pix, s, 0, rng_mod.JITTER)
    ndc_x = (ln.pxf + uj0) / width_f * 2.0 - 1.0
    ndc_y = -((ln.pyf + uj1) / height_f * 2.0 - 1.0)
    a = ndc_x * (tan_half * aspect)
    b = ndc_y * tan_half
    return _norm3(a * rx_ + b * ux_ + fx_, a * ry_ + b * uy_ + fy_,
                  a * rz_ + b * uz_ + fz_)


def _shade_advance(occ, light, n_light: int, sky, cam16, seed: int, p,
                   ln: Lanes, planes, s, bb, nd, hit, mat, nrm, pt, occluded,
                   single_path: bool = False):
    """A bounce step after its intersection, lane for lane as the kernels:
    sky/emissive on primary bounces, NEE (the shadow ray tested against
    the occluders ``occ`` = (tri rows, n_tri, sphere rows, n_sph), ORed
    with ``occluded``), RR + hemisphere scatter, regeneration.

    ``planes``: the 15 state planes [o d tp cur acc]; ``hit``: the main ray
    hit something; ``mat``: the hit's (albedo 3, emission 3, emissive
    flag); ``nrm``/``pt``: the facing unit normal and the shading point.
    ``p`` carries width, height, t_min, shadow_tol, rr_survival, max_depth
    and stop_after; ``single_path`` sets the quota to 1 and pins ``s``
    (the Denoiser's G-buffer pass).  Returns (the 15
    next planes, s, b, n_done, the lanes that traced a shadow ray)."""
    where = torch.where
    dev = s.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    px_, py_, pz_ = cam16.unbind(0)[0:3]
    skyb, skyt = sky[0:3], sky[3:6]
    light_total = sky[6]
    light_valid = light_total > 0.0
    light_pdf = where(light_valid, 1.0 / torch.clamp(light_total, min=1e-20),
                      f32(0.0))
    two_pi, inv_pi = f32(2.0 * np.pi), f32(1.0 / np.pi)
    inv_rr = 1.0 / p.rr_survival

    (_, _, _, dx, dy, dz, tpx, tpy, tpz,
     cux, cuy, cuz, axp, ayp, azp) = planes
    bal, bem, bef = mat
    nxp, nyp, nzp = nrm
    hx, hy, hz = pt
    quota = 1 if single_path else p.stop_after
    gated = quota > 0
    armed = nd < quota
    alive0 = (ln.valid & armed) if gated else ln.valid
    hit_emissive = hit & (bef > 0.5)
    is_primary = bb == 0

    # Primary miss -> sky; primary emissive hit -> emission.
    dux, duy, duz = _norm3(dx, dy, dz)
    skyw = 0.5 * (duy + 1.0)
    add_sky = alive0 & ~hit & is_primary
    add_emi = alive0 & hit_emissive & is_primary
    dr = [where(add_sky, (1.0 - skyw) * skyb[k] + skyw * skyt[k], 0.0)
          + where(add_emi, bem[k], 0.0) for k in range(3)]
    cux, cuy, cuz = cux + tpx * dr[0], cuy + tpy * dr[1], cuz + tpz * dr[2]

    alive = alive0 & hit & ~hit_emissive

    # --- NEE: one area-light sample ------------------------------------------
    (wlx, wly, wlz), dist, row = _light_sample(light, n_light, light_total,
                                               seed, ln.pix, s, bb, hx, hy, hz)
    lnx, lny, lnz, lemr, lemg, lemb = row[9:15]
    flip_l = (lnx * -wlx + lny * -wly + lnz * -wlz) < 0.0
    lnx2, lny2, lnz2 = where(flip_l, -lnx, lnx), where(flip_l, -lny, lny), where(flip_l, -lnz, lnz)

    # Shadow ray: occluded iff any hit lands at t <= dist - tol, with the
    # division-free accept (sign tests against |det|-scaled bounds).
    tri, n_tri, sph, n_sph = occ
    lim = dist - p.shadow_tol
    for n in range(n_tri):
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z) = tri[n, :9].unbind(0)
        s1x = wly * e2z - wlz * e2y
        s1y = wlz * e2x - wlx * e2z
        s1z = wlx * e2y - wly * e2x
        det = s1x * e1x + s1y * e1y + s1z * e1z
        okd = torch.abs(det) > _DET_EPS
        sd = where(det >= 0.0, 1.0, -1.0)
        adet = det * sd
        sx, sy, sz = hx - v0x, hy - v0y, hz - v0z
        s2x = sy * e1z - sz * e1y
        s2y = sz * e1x - sx * e1z
        s2z = sx * e1y - sy * e1x
        tn = s2x * e2x + s2y * e2y + s2z * e2z
        b1n = s1x * sx + s1y * sy + s1z * sz
        b2n = s2x * wlx + s2y * wly + s2z * wlz
        tsd = tn * sd
        occluded = occluded | (
            okd & (tsd > p.t_min * adet) & (tsd <= lim * adet)
            & (b1n * sd >= 0.0) & (b2n * sd >= 0.0)
            & ((det - b1n - b2n) * sd >= 0.0))
    for m in range(n_sph):
        (cx, cy, cz, rad) = sph[m, :4].unbind(0)
        ocx, ocy, ocz = hx - cx, hy - cy, hz - cz
        a_q = wlx * wlx + wly * wly + wlz * wlz
        hb = ocx * wlx + ocy * wly + ocz * wlz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = hb * hb - a_q * c_q
        okq = disc > 0.0
        sq = torch.sqrt(where(okq, disc, 1.0))
        t_near = (-hb - sq) / a_q
        t_far = (-hb + sq) / a_q
        ts = where(okq & (t_near > p.t_min), t_near,
                   where(okq & (t_far > p.t_min), t_far, NO_HIT))
        occluded = occluded | (ts <= lim)
    vis = (~occluded).to(torch.float32)

    cos_s = wlx * nxp + wly * nyp + wlz * nzp
    cos_l = -(wlx * lnx2 + wly * lny2 + wlz * lnz2)
    geom = cos_s * cos_l / torch.clamp(dist * dist, min=1e-20)
    brdf_ok = (cos_s >= 0.0).to(torch.float32) * inv_pi
    scale = (geom / torch.clamp(light_pdf, min=1e-20)) * vis * brdf_ok
    use = alive & light_valid
    cux = cux + where(use, tpx * (lemr * bal[0] * scale), 0.0)
    cuy = cuy + where(use, tpy * (lemg * bal[1] * scale), 0.0)
    cuz = cuz + where(use, tpz * (lemb * bal[2] * scale), 0.0)

    # --- indirect: RR + uniform hemisphere -----------------------------------
    us0, us1, us2, _ = rng_mod.uniforms4(seed, ln.pix, s, bb, rng_mod.SCATTER)
    survive = us2 < p.rr_survival
    use_x = torch.abs(nxp) > torch.abs(nyp)
    yx = where(use_x, nzp, 0.0)
    yy = where(use_x, 0.0, nzp)
    yz = where(use_x, -nxp, -nyp)
    yx, yy, yz = _norm3(yx, yy, yz)
    xx = yy * nzp - yz * nyp
    xy = yz * nxp - yx * nzp
    xz = yx * nyp - yy * nxp
    z = us0
    r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = two_pi * us1
    cp, sp_ = torch.cos(phi), torch.sin(phi)
    wix = r_xy * cp * xx + r_xy * sp_ * yx + z * nxp
    wiy = r_xy * cp * xy + r_xy * sp_ * yy + z * nyp
    wiz = r_xy * cp * xz + r_xy * sp_ * yz + z * nzp
    cos_i = wix * nxp + wiy * nyp + wiz * nzp
    w_ok = (cos_i >= 0.0).to(torch.float32) * inv_pi
    wt = cos_i * two_pi * inv_rr * w_ok
    continues = alive & survive
    tpx = where(continues, tpx * (bal[0] * wt), tpx)
    tpy = where(continues, tpy * (bal[1] * wt), tpy)
    tpz = where(continues, tpz * (bal[2] * wt), tpz)

    # --- persistent-wavefront bookkeeping --------------------------------------
    cont = continues & (bb + 1 < p.max_depth)
    done = (~cont & armed) if gated else ~cont
    axp = axp + where(done, cux, 0.0)
    ayp = ayp + where(done, cuy, 0.0)
    azp = azp + where(done, cuz, 0.0)
    nd = nd + done.to(torch.int32)
    if not single_path:
        s = s + done.to(torch.int32)
    pdx, pdy, pdz = _camera_ray(cam16, seed, p, ln, s)
    planes = [
        where(cont, hx, px_), where(cont, hy, py_), where(cont, hz, pz_),
        where(cont, wix, pdx), where(cont, wiy, pdy), where(cont, wiz, pdz),
        where(cont, tpx, 1.0), where(cont, tpy, 1.0), where(cont, tpz, 1.0),
        where(done, 0.0, cux), where(done, 0.0, cuy), where(done, 0.0, cuz),
        axp, ayp, azp]
    bb = where(cont, bb + 1, 0).to(torch.int32)
    return planes, s, bb, nd, alive


def _step_plain(fs: FusedScene, cam16, seed: int, p: _Params, ln: Lanes,
                planes, s, bb, nd, gb_lanes=None):
    """One bounce step of the lanes ``ln`` (any subset of the launch's
    lanes, with their 15 state planes and s, b, n_done): the kernel's
    arithmetic, lane for lane.  ``gb_lanes``: (gb, their columns), to
    write their single_path G-buffer (the launch's first step).  Returns
    (planes, s, b, n_done, the lanes that traced a shadow ray)."""
    where = torch.where
    dev = s.device
    r = s.shape[0]
    ox, oy, oz, dx, dy, dz = planes[0:6]

    # --- main intersect: Moller-Trumbore over triangles, then spheres ------
    # The winning triangle's index is tracked and its attributes read once
    # after the loop (the kernel selects them per triangle; the result is
    # the same).
    best_t = torch.full((r,), NO_HIT, dtype=torch.float32, device=dev)
    best_n = torch.full((r,), -1, dtype=torch.int64, device=dev)
    for n in range(fs.n_tri):
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y,
         e2z) = fs.tri[n, :9].unbind(0)
        s1x = dy * e2z - dz * e2y
        s1y = dz * e2x - dx * e2z
        s1z = dx * e2y - dy * e2x
        det = s1x * e1x + s1y * e1y + s1z * e1z
        okd = torch.abs(det) > _DET_EPS
        inv = 1.0 / where(okd, det, 1.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        s2x = sy * e1z - sz * e1y
        s2y = sz * e1x - sx * e1z
        s2z = sx * e1y - sy * e1x
        t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
        b1 = (s1x * sx + s1y * sy + s1z * sz) * inv
        b2 = (s2x * dx + s2y * dy + s2z * dz) * inv
        ok = (okd & (t > p.t_min) & (b1 >= 0.0) & (b2 >= 0.0)
              & (1.0 - b1 - b2 >= 0.0) & (t < best_t))
        best_t = where(ok, t, best_t)
        best_n = where(ok, n, best_n)
    attrs = where((best_n >= 0)[:, None], fs.tri[best_n.clamp(min=0), 9:19],
                  0.0)
    bnx, bny, bnz, ar, ag, ab, er, eg, eb, bef = attrs.unbind(1)
    bal, bem = [ar, ag, ab], [er, eg, eb]
    bpid = (best_n + 1).to(torch.float32)
    for m in range(fs.n_sph):
        (cx, cy, cz, rad, ar, ag, ab, er, eg, eb,
         ef) = fs.sph[m, :11].unbind(0)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a_q = dx * dx + dy * dy + dz * dz
        hb = ocx * dx + ocy * dy + ocz * dz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = hb * hb - a_q * c_q
        okq = disc > 0.0
        sq = torch.sqrt(where(okq, disc, 1.0))
        t_near = (-hb - sq) / a_q
        t_far = (-hb + sq) / a_q
        near_ok = okq & (t_near > p.t_min)
        far_ok = okq & (t_far > p.t_min)
        ts = where(near_ok, t_near, where(far_ok, t_far, NO_HIT))
        ok = ts < best_t
        inv_r = 1.0 / where(rad == 0.0, 1.0, rad)
        hpx, hpy, hpz = ox + ts * dx, oy + ts * dy, oz + ts * dz
        best_t = where(ok, ts, best_t)
        bnx = where(ok, (hpx - cx) * inv_r, bnx)
        bny = where(ok, (hpy - cy) * inv_r, bny)
        bnz = where(ok, (hpz - cz) * inv_r, bnz)
        bal = [where(ok, v, o) for v, o in zip((ar, ag, ab), bal)]
        bem = [where(ok, v, o) for v, o in zip((er, eg, eb), bem)]
        bef = where(ok, ef, bef)
        bpid = where(ok, float(fs.n_tri + m + 1), bpid)
    hit = best_t < NO_HIT

    # Facing normal + epsilon-offset shading point.
    front = (bnx * dx + bny * dy + bnz * dz) < 0.0
    gnx, gny, gnz = _norm3(bnx, bny, bnz)
    nxp, nyp, nzp = where(front, gnx, -gnx), where(front, gny, -gny), where(front, gnz, -gnz)
    t_pt = where(hit, best_t, 1.0)
    hx = ox + t_pt * dx + nxp * p.eps_offset
    hy = oy + t_pt * dy + nyp * p.eps_offset
    hz = oz + t_pt * dz + nzp * p.eps_offset
    if gb_lanes is not None:
        gb, cols = gb_lanes
        gb[:, cols] = torch.stack([
            ox + t_pt * dx, oy + t_pt * dy, oz + t_pt * dz, nxp, nyp, nzp,
            where(hit, bpid, -1.0), hit.to(torch.float32)])

    return _shade_advance(
        (fs.tri, fs.n_tri, fs.sph, fs.n_sph), fs.light, fs.n_light, fs.sky,
        cam16, seed, p, ln, planes, s, bb, nd, hit, (bal, bem, bef),
        (nxp, nyp, nzp), (hx, hy, hz),
        torch.zeros((r,), dtype=torch.bool, device=dev), p.single_path)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _adds_zero_exactly(x):
    """x + 0 == x bit for bit, lane by lane over the rows of x (false for
    -0.0 and for a NaN whose bits the add would change).  x (k, n) ->
    (n,)."""
    return (_bits(x + 0.0) == _bits(x)).all(0)


def _sums_settled(planes):
    """The lanes whose cur and acc adding 0 leaves as they are: what a
    step of a lane whose quota is met adds to each."""
    return _adds_zero_exactly(torch.stack(planes[9:15]))


def _at_fixed_point(cam16, seed: int, p: _Params, ln: Lanes, planes, s, bb,
                    nd):
    """The lanes that a ``stop_after`` step leaves as they are, bit for
    bit: the quota met, the path just regenerated (b = 0, o the camera, d
    the camera ray of sample s, tp = 1), and the sums settled.  Such a
    lane also counts nothing, and regenerates the same ray at every later
    step."""
    ok = (nd >= p.stop_after) & (bb == 0) & _sums_settled(planes)
    for k in range(3):
        ok &= _bits(planes[k]) == _bits(cam16[k].expand_as(planes[k]))
        ok &= _bits(planes[6 + k]) == _bits(torch.ones_like(planes[6 + k]))
    for k, dk in enumerate(_camera_ray(cam16, seed, p, ln, s)):
        ok &= _bits(planes[3 + k]) == _bits(dk)
    return ok


def _steps_plain(fs: FusedScene, cam16, seed: int, sf, si, p: _Params,
                 gb=None, retire: bool = False):
    """``n_steps`` bounces of every lane; sf (15, R) f32, si (4, R) i32 in
    the kernel's layout.  Returns new (sf, si) with si[3] = per-lane shadow
    rays traced.  ``single_path`` mode writes the (8, R) f32 G-buffer
    ``gb`` in place: world position, facing normal, global primitive id
    (triangle n -> n+1, live sphere m -> n_tri+m+1, miss -> -1) and the
    contributor flag of each lane's ray at the first step.

    ``retire``: the kernel's schedule in the gated modes (``stop_after``,
    ``single_path``).  A lane stops stepping after a step at whose end its
    quota is met and its sums are settled: that step regenerated its path,
    so every later step leaves it as it is (``_at_fixed_point``).  The
    step that meets the quota adds cur to acc, where -0.0 + -0.0 stays
    -0.0: such a lane takes one more step, which adds +0.  A
    ``stop_after`` lane that enters the launch at that fixed point takes
    no step.  The planes are those of the lockstep
    schedule (retire=False), bit for bit."""
    dev = sf.device
    r = sf.shape[1]
    ln = lanes(r, p.width, p.n_pix, 0, dev)
    s, bb, nd = si[0], si[1], si[2]
    nsh = torch.zeros_like(s)
    planes = list(sf.unbind(0))
    quota = 1 if p.single_path else p.stop_after
    retire = retire and quota > 0
    if not retire:
        for step in range(p.n_steps):
            first = p.single_path and step == 0
            gb_lanes = (gb, slice(None)) if first else None
            planes, s, bb, nd, alive = _step_plain(fs, cam16, seed, p, ln,
                                                   planes, s, bb, nd, gb_lanes)
            nsh = nsh + alive.to(torch.int32)
        return (torch.stack(planes),
                torch.stack([s, bb, nd, nsh]).to(torch.int32))

    sf_out, si_out = sf.clone(), si.clone()
    si_out[3] = 0
    live = torch.ones((r,), dtype=torch.bool, device=dev)
    if not p.single_path:
        live = ~_at_fixed_point(cam16, seed, p, ln, planes, s, bb, nd)
    for step in range(p.n_steps):
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        sub = Lanes(*(x[idx] for x in ln))
        gb_lanes = (gb, idx) if p.single_path and step == 0 else None
        pl, s2, b2, nd2, alive = _step_plain(
            fs, cam16, seed, p, sub, [x[idx] for x in sf_out.unbind(0)],
            si_out[0, idx], si_out[1, idx], si_out[2, idx], gb_lanes)
        sf_out[:, idx] = torch.stack(pl)
        si_out[:, idx] = torch.stack(
            [s2, b2, nd2, si_out[3, idx] + alive.to(torch.int32)]
        ).to(torch.int32)
        live[idx] = (nd2 < quota) | ~_sums_settled(pl)
    return sf_out, si_out


# --- the kernel -------------------------------------------------------------

LIB = kernels.Library("fused_mc", {"fused_mc_steps": [
    ctypes.c_void_p, ctypes.c_int,             # scene words
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n_tri n_sph n_light
    ctypes.c_uint32,                           # seed
    ctypes.c_void_p, ctypes.c_void_p,          # sf si
    ctypes.c_int, ctypes.c_int,                # R n_pix
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # width height n_steps
    ctypes.c_float, ctypes.c_float,            # t_min eps_offset
    ctypes.c_float, ctypes.c_float,            # rr_survival 1/rr
    ctypes.c_float, ctypes.c_float,            # shadow_tol aspect
    ctypes.c_int, ctypes.c_int,                # max_depth stop_after
    ctypes.c_int, ctypes.c_void_p,             # single_path gb
    ctypes.c_void_p,                           # lane counter
    ctypes.c_void_p]}, LAUNCHES)               # stream


def _steps_kernel(fs: FusedScene, cam16, seed: int, sf, si, p: _Params,
                  gb=None):
    """Launch csrc/fused_mc.cu on CUDA tensors; updates sf/si (and, in
    ``single_path`` mode, the (8, R) G-buffer ``gb``) in place, as
    ``_steps_plain``."""
    planes = {"sf": (sf, torch.float32), "si": (si, torch.int32)}
    if p.single_path:
        planes["the single_path G-buffer"] = (gb, torch.float32)
    kernels.check("fused_mc", planes)
    r = sf.shape[1]
    if (sf.shape != (15, r) or si.shape != (4, r)
            or (p.single_path and gb.shape != (8, r))):
        raise ValueError(f"bad state plane shapes {tuple(sf.shape)}, "
                         f"{tuple(si.shape)}")
    gated = p.single_path or p.stop_after > 0
    if r == 0:
        return sf, si
    if p.n_steps == 0:
        si[3] = 0
        return sf, si
    scene = torch.cat([fs.tri.reshape(-1), fs.sph.reshape(-1),
                       fs.light.reshape(-1), fs.sky.reshape(-1),
                       cam16.reshape(-1)]).to(device=sf.device,
                                              dtype=torch.float32)
    # the gated modes' lane counter (persistent threads)
    counter = (torch.zeros((1,), dtype=torch.int32, device=sf.device)
               if gated else None)
    LIB.launch(
        "fused_mc_steps", scene.data_ptr(), scene.numel(), fs.n_tri,
        fs.n_sph, fs.n_light, seed, sf.data_ptr(), si.data_ptr(), r,
        p.n_pix, p.width, p.height, p.n_steps, p.t_min, p.eps_offset,
        p.rr_survival, 1.0 / p.rr_survival, p.shadow_tol,
        float(p.width) / float(p.height), p.max_depth, p.stop_after,
        int(p.single_path), gb.data_ptr() if p.single_path else None,
        None if counter is None else counter.data_ptr(), kernels.stream(sf))
    return sf, si


# --- wrappers ---------------------------------------------------------------

def _run(core, fs: FusedScene, camera, cfg: RenderConfig, seed: int, state,
         n_steps: int, stop_after: int):
    if cfg.soft_shadow_beta > 0.0:
        raise NotImplementedError("the fused stepper implements the "
                                  "reference's hard shadow test only")
    n_pix = cfg.height * cfg.width
    r = state.s.shape[0]
    if r != n_pix:
        raise ValueError("fused stepper expects full-image lane state")
    dev = state.s.device
    cam16 = _camera_words(camera.to(dev))
    sf, si = state_planes(state)
    p = _Params(n_steps=int(n_steps), width=cfg.width, height=cfg.height,
                n_pix=n_pix, t_min=float(cfg.t_min),
                eps_offset=float(cfg.eps_offset),
                rr_survival=float(cfg.rr_survival),
                shadow_tol=float(cfg.shadow_tolerance),
                max_depth=int(cfg.max_depth), stop_after=int(stop_after))
    sf2, si2 = core(fs.to(dev), cam16, int(seed) & 0xFFFFFFFF, sf, si, p)
    return planes_state(state, sf2, si2, n_steps)


def wavefront_steps_fused(fs: FusedScene, camera, cfg: RenderConfig,
                          seed: int, state, n_steps: int, *,
                          stop_after: int = 0, device=None):
    """Advance every lane of ``state`` (a full-image ``WavefrontState``) by ``n_steps`` bounce steps.

    ``device`` (default: the card) must be where ``state`` lies.  For CUDA
    tensors this launches csrc/fused_mc.cu; for CPU tensors it runs the
    plain version.  ``stop_after > 0``: equal-spp mode."""
    dev = kernels.resolve_device(device)
    if state.s.device.type != dev.type:
        raise ValueError(f"state lies on {state.s.device}, not on {dev}")
    core = _steps_kernel if state.s.is_cuda else _steps_plain
    return _run(core, fs, camera, cfg, seed, state, n_steps, stop_after)


def wavefront_steps_fused_plain(fs: FusedScene, camera, cfg: RenderConfig,
                                seed: int, state, n_steps: int, *,
                                stop_after: int = 0):
    """The plain PyTorch version of ``wavefront_steps_fused`` on any device
    (the kernel's arithmetic, vectorized over lanes)."""
    return _run(_steps_plain, fs, camera, cfg, seed, state, n_steps,
                stop_after)


def _gbuffer_setup(camera, cfg: RenderConfig, frame_index: int, dev):
    """Camera words, lane state, G-buffer and parameters of a single-path
    launch: every lane on its pixel-center primary ray of sample
    ``frame_index``."""
    h, w = cfg.height, cfg.width
    n_pix = h * w
    camera = camera.to(dev)
    d = cam_mod.perspective_rays(camera, w, h).reshape(-1, 3)
    o = camera.position.expand(d.shape)
    ones = torch.ones((n_pix, 3), dtype=torch.float32, device=dev)
    zeros = torch.zeros_like(ones)
    sf = torch.cat([o.T, d.T, ones.T, zeros.T, zeros.T]).contiguous()
    si = torch.zeros((4, n_pix), dtype=torch.int32, device=dev)
    si[0] = int(frame_index)
    gb = torch.empty((8, n_pix), dtype=torch.float32, device=dev)
    p = _Params(n_steps=int(cfg.max_depth), width=w, height=h, n_pix=n_pix,
                t_min=float(cfg.t_min), eps_offset=float(cfg.eps_offset),
                rr_survival=float(cfg.rr_survival),
                shadow_tol=float(cfg.shadow_tolerance),
                max_depth=int(cfg.max_depth), stop_after=0, single_path=True)
    return _camera_words(camera), sf, si, gb, p


def _gbuffer(core, fs: FusedScene, camera, cfg: RenderConfig, seed: int,
             frame_index: int, dev):
    cam16, sf, si, gb, p = _gbuffer_setup(camera, cfg, frame_index, dev)
    sf2, _ = core(fs.to(dev), cam16, int(seed) & 0xFFFFFFFF, sf, si, p,
                  gb=gb)
    return (sf2[12:15].T, gb[0:3].T, gb[3:6].T, gb[6].to(torch.int32),
            gb[7] > 0.5)


def single_sample_gbuffer(fs: FusedScene, camera, cfg: RenderConfig,
                          seed: int, frame_index: int, *, device=None):
    """ONE sample per pixel and the primary hit's G-buffer, fused: the
    Denoiser stage's frame (pixel-center primaries, the full path radiance
    of sample ``frame_index``) in ``single_path`` mode, one launch of
    ``cfg.max_depth`` steps (the depth cap retires every lane), on
    ``device`` (default: the card; the plain version on the CPU).

    Returns ``(color (R, 3), world_pos (R, 3), normal (R, 3), prim_id (R,)
    i32, contributor (R,) bool)`` in row-major pixel order; ``prim_id`` as
    ``models.denoiser.global_prim_id`` over the pack's live spheres."""
    dev = kernels.resolve_device(device)
    core = _steps_kernel if dev.type == "cuda" else _steps_plain
    return _gbuffer(core, fs, camera, cfg, seed, frame_index, dev)
