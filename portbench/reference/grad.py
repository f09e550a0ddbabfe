"""The plain reference of an inverse-rendering step: the fixed-depth Monte
Carlo estimator (every lane runs every bounce, dead lanes masked) made
differentiable in the material albedos by PyTorch autograd, a pixel MSE
against the step's target image, and Adam.

The estimator is the reference renderer's: a primary miss adds the sky, a
primary emissive hit its emission; at each hit one uniform-by-area light
sample with the hard shadow test ``dist < nearest occluder t + tolerance``
and the Lambertian BRDF albedo / pi, then Russian roulette and a
uniform-hemisphere bounce weighted by BRDF * cos / pdf / survival.  The
traversal (which triangle each ray hits) carries no gradient; the shading
does.  The albedo table is a sigmoid of the optimised logits, with the
emissive rows held at their true value.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import rng
from portbench.reference.geometry import RefCamera, RefScene, camera_dirs
from portbench.reference.mc import Settings, nearest


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def _normalize(a):
    n2 = torch.clamp(_sum3(a * a), min=1e-12 * 1e-12).unsqueeze(-1)
    return a / torch.sqrt(n2)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _brdf(albedo, cos_in):
    pi = torch.tensor(math.pi, dtype=albedo.dtype, device=albedo.device)
    return torch.where(cos_in[..., None] >= 0.0, albedo / pi, 0.0)


def render(sc: RefScene, cam: RefCamera, st: Settings, seed: int,
           albedo_table, mat_emissive) -> torch.Tensor:
    """Mean linear radiance (H, W, 3) over ``st.spp`` jittered samples, a
    differentiable function of ``albedo_table`` (K, 3) (the rows of the
    scene's materials, ``sc.mat`` indexing them)."""
    dt = albedo_table.dtype
    dev = albedo_table.device
    h, w = st.height, st.width
    pixel = torch.arange(h * w, dtype=torch.int64, device=dev)
    tri = sc
    c = _cross(tri.e1, tri.e2)
    area = 0.5 * torch.sqrt(_sum3(c * c))
    em_tri = mat_emissive[tri.mat]
    areas = torch.where(em_tri, area, 0.0)
    total = torch.sum(areas)
    valid = total > 0.0
    cdf = torch.cumsum(areas, 0)
    pdf = torch.where(valid, 1.0 / torch.clamp(total, min=1e-20),
                      torch.zeros_like(total))
    pdf_scatter = torch.tensor(1.0 / (2.0 * math.pi), dtype=dt, device=dev)
    rr = torch.tensor(st.rr_survival, dtype=dt, device=dev)
    acc = torch.zeros((h, w, 3), dtype=dt, device=dev)
    for s in range(st.spp):
        uj = rng.uniforms4(seed, pixel, s, 0, rng.JITTER, dt)
        d = camera_dirs(cam, w, h, pixel, uj[0], uj[1], rsqrt=False)
        o = cam.position.expand(d.shape)
        tp = torch.ones((h * w, 3), dtype=dt, device=dev)
        rad = torch.zeros_like(tp)
        alive = torch.ones((h * w,), dtype=torch.bool, device=dev)
        for b in range(st.max_depth):
            t, idx = nearest(sc, o, d, st.t_min)
            hit = idx >= 0
            idx = idx.clamp(min=0)
            m = torch.where(hit, tri.mat[idx], 0)
            emit = torch.index_select(sc.emission, 0, idx)
            albedo = torch.index_select(albedo_table, 0, m)
            hit_emissive = hit & em_tri[idx]
            if b == 0:
                dn = _normalize(d)
                ty = 0.5 * (dn[:, 1:2] + 1.0)
                sky = (1.0 - ty) * sc.sky[0:3] + ty * sc.sky[3:6]
                rad = rad + torch.where((alive & ~hit)[:, None], tp * sky,
                                        0.0)
                rad = rad + torch.where((alive & hit_emissive)[:, None],
                                        tp * emit, 0.0)
            alive = alive & hit & ~hit_emissive
            point = o + torch.where(hit, t, 1.0)[:, None] * d
            gn = _normalize(tri.normal[idx])
            front = _sum3(gn * d) < 0.0
            n = torch.where(front[:, None], gn, -gn)
            p = point + n * st.eps_offset

            ul = rng.uniforms4(seed, pixel, s, b, rng.LIGHT, dt)
            budget = ul[0] * total
            li = torch.clamp(torch.searchsorted(cdf, budget, right=True), 0,
                             tri.count - 1)
            x = 1.0 - torch.sqrt(ul[1])
            wb = (1.0 - x) * ul[2]
            wc = (1.0 - x) * (1.0 - ul[2])
            lpos = tri.v0[li] + wb[:, None] * tri.e1[li] + wc[:, None] * tri.e2[li]
            to_l = lpos - p
            dist = torch.sqrt(torch.clamp(_sum3(to_l * to_l), min=0.0))
            wi_l = to_l / torch.clamp(dist, min=1e-20)[:, None]
            lnrm = tri.normal[li]
            ln = torch.where((_sum3(lnrm * -wi_l) < 0.0)[:, None], -lnrm, lnrm)
            occ_t, _ = nearest(sc, p, wi_l, st.t_min)
            vis = (dist < occ_t + st.shadow_tolerance).to(dt)
            cos_s = _sum3(wi_l * n)
            cos_l = _sum3(-wi_l * ln)
            geom = cos_s * cos_l / torch.clamp(dist * dist, min=1e-20)
            direct = (sc.emission[li] * _brdf(albedo, cos_s)
                      * (geom / torch.clamp(pdf, min=1e-20))[:, None]
                      * vis[:, None])
            rad = rad + torch.where((alive & valid)[:, None], tp * direct, 0.0)

            us = rng.uniforms4(seed, pixel, s, b, rng.SCATTER, dt)
            survive = us[2] < st.rr_survival
            z = us[0][:, None]
            r_xy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
            phi = (2.0 * math.pi) * us[1][:, None]
            use_x = torch.abs(n[:, 0:1]) > torch.abs(n[:, 1:2])
            zero = torch.zeros_like(n[:, 0])
            ya = torch.stack([n[:, 2], zero, -n[:, 0]], -1)
            yb = torch.stack([zero, n[:, 2], -n[:, 1]], -1)
            yv = _normalize(torch.where(use_x, ya, yb))
            xv = _cross(yv, n)
            wi = r_xy * torch.cos(phi) * xv + r_xy * torch.sin(phi) * yv + z * n
            cos_i = _sum3(wi * n)
            weight = _brdf(albedo, cos_i) * cos_i[:, None] / pdf_scatter / rr
            cont = alive & survive
            tp = torch.where(cont[:, None], tp * weight, tp)
            o = torch.where(cont[:, None], p, o)
            d = torch.where(cont[:, None], wi, d)
            alive = cont
        acc = acc + rad.reshape(h, w, 3)
    return acc / torch.tensor(float(st.spp), dtype=dt, device=dev)


def adam_steps(sc: RefScene, cam: RefCamera, st: Settings, seed: int,
               albedo_true, mat_emissive, targets, lr: float,
               dtype=torch.float32, fault: str | None = None, start=None):
    """Adam (beta 0.9 / 0.999, eps 1e-8) over the albedo logits, one step a
    target, from ``start`` = (logits, first moment, second moment, steps
    taken), by default from logits 0 (albedo 0.5) and no steps.  Returns
    (the losses, the first step's gradient, the logits after the last
    step).

    ``fault`` plants a fault, for the checks' own tests: "half_batch" (the
    loss the mean over the image's top half rows only), "altered" (one
    logit moved by 0.01 after each update)."""
    sc, cam = sc.cast(dtype), cam.cast(dtype)
    free = ~mat_emissive
    albedo_true = albedo_true.to(dtype)
    if start is None:
        lg = torch.zeros_like(albedo_true)
        m, v, t0 = torch.zeros_like(lg), torch.zeros_like(lg), 0
    else:
        lg, m, v = (x.to(dtype) for x in start[:3])
        t0 = int(start[3])
    losses, g1 = [], None
    for i, target in enumerate(targets):
        x = lg.clone().requires_grad_(True)
        table = torch.where(free[:, None], torch.sigmoid(x), albedo_true)
        img = render(sc, cam, st, seed, table, mat_emissive)
        sq = (img - target.to(dtype)) ** 2
        if fault == "half_batch":
            sq = sq[:st.height // 2]
        loss = torch.mean(sq)
        (g,) = torch.autograd.grad(loss, x)
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = g.clone()
        t = t0 + i + 1
        m = m * 0.9 + 0.1 * g
        v = v * 0.999 + 0.001 * g * g
        denom = torch.sqrt(v) / math.sqrt(1.0 - 0.999 ** t) + 1e-8
        lg = lg - (lr / (1.0 - 0.9 ** t)) * m / denom
        if fault == "altered":
            lg[0, 0] += 0.01
    return losses, g1, lg

