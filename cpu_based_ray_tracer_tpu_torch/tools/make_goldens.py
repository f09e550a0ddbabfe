"""Render the golden images of every reference stage with the port (port of
the repository's ``tools/make_goldens.py``).

Two tiers, as the JAX package's:

- ``test``     — small, CPU-renderable in seconds; the committed copies are
  ``goldens/test/`` (``tests/test_golden.py`` pins them);
- ``showcase`` — full-size reference-matched renders (the 883x900
  viewport; offline at its native 400x225/100spp), ``goldens/showcase/``.

The artifacts are written under ``--outdir`` (default ``build/goldens/``
at the root of the checkout), never into ``goldens/``.  ``--check``
renders a tier and compares it with the committed ``goldens/<tier>/``
instead: the test tier at ``tests/test_golden.py``'s tolerances, the
showcase tier as the JAX tool's drift guard (whitted and bunny_teapot
tight, MC Cornell at 64 spp as 8x8 box means against the 1024-spp image).
Without the reference's OBJ assets the bunny_teapot artifact raises
FileNotFoundError as the JAX tool's does; ``--check`` reports it skipped,
as ``tests/test_golden.py`` intends.

Each builder uses the engine the JAX tool uses on the same backend; the
card is the default, ``--cpu`` the CPU.

Usage: python -m cpu_based_ray_tracer_tpu_torch.tools.make_goldens
           [--tier test|showcase|all] [--only NAME] [--cpu] [--check]
           [--outdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
GOLDEN_DIR = os.path.join(ROOT, "goldens")
OUT_DIR = os.path.join(ROOT, "build", "goldens")


def _u8(img, gamma=2.0) -> np.ndarray:
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap

    return tonemap.quantize_u8(img, gamma).cpu().numpy()


def _seed(k: int) -> int:
    from cpu_based_ray_tracer_tpu_torch.utils import rng

    return rng.seed_word(k)


def _save(outdir: str, tier: str, name: str, u8: np.ndarray, meta: dict,
          manifest: dict, ppm: bool = False):
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    d = os.path.join(outdir, tier)
    os.makedirs(d, exist_ok=True)
    im.write_png(os.path.join(d, name + ".png"), u8)
    if ppm:
        im.write_ppm(os.path.join(d, name + ".ppm"), u8)
    manifest[name] = dict(meta, shape=list(u8.shape))
    print(f"[{tier}] {name}: {u8.shape[1]}x{u8.shape[0]} {meta}", flush=True)


# --------------------------------------------------------------------------
# Artifact builders.  Each returns (u8_image, meta) for a given size.
# --------------------------------------------------------------------------

def offline_rtiow(w, h, spp, device):
    """Offline prototype: RTIOW two-sphere scene, depth 50, gamma 2."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import offline
    from cpu_based_ray_tracer_tpu_torch.scenes import rtiow

    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50)
    u8 = offline.render_u8(rtiow.offline_two_sphere_scene(device),
                           rtiow.offline_camera(w / h, device=device), cfg,
                           _seed(0), device=device).cpu().numpy()
    return u8, dict(spp=spp, depth=50)


def offline_dof(w, h, spp, device):
    """The offline prototype's depth-of-field configuration: the RTIOW
    classic scene through the aperture-2 thin-lens camera."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import offline
    from cpu_based_ray_tracer_tpu_torch.scenes import rtiow

    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50)
    u8 = offline.render_u8(rtiow.rtiow_classic_scene(device),
                           rtiow.offline_dof_camera(w / h, device=device),
                           cfg, _seed(4), device=device).cpu().numpy()
    return u8, dict(spp=spp, depth=50, aperture=2.0)


def nppt(w, h, spp, device):
    """NPPT stage: the RTIOW 6-sphere scene with the hollow glass bubble,
    display gamma 1 (the stage's default)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import nppt as nppt_model
    from cpu_based_ray_tracer_tpu_torch.scenes import rtiow

    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=50, gamma=1.0)
    u8 = nppt_model.render_u8(rtiow.nppt_scene(device),
                              rtiow.nppt_camera(device), cfg, _seed(1),
                              device=device).cpu().numpy()
    return u8, dict(spp=spp, depth=50, gamma=1)


def whitted(w, h, device):
    """Whitted stage, depth 5, deterministic; linear display."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import whitted as wmodel
    from cpu_based_ray_tracer_tpu_torch.scenes import whitted_scene

    cfg = RenderConfig(width=w, height=h, whitted_depth=5, ray_chunk=65536)
    img = wmodel.render(whitted_scene.whitted_scene(device),
                        whitted_scene.whitted_camera(device), cfg,
                        device=device)
    return _u8(img, gamma=1.0), dict(depth=5)


def bunny_teapot(w, h, device, method="auto"):
    """BVH stage: the reference's stanford_bunny + utah_teapot OBJs through
    the mesh intersector (FileNotFoundError without the assets)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh as mesh_model
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes

    scene = meshes.bunny_teapot_scene(device)
    bundle = mesh_model.prepare(scene, method=method)
    cfg = RenderConfig(width=w, height=h, whitted_depth=5, ray_chunk=262144)
    img = mesh_model.render(bundle, meshes.bvh_stage_camera(device), cfg,
                            device=device)
    return _u8(img, gamma=1.0), dict(depth=5, tris=int(scene.triangles.count),
                                     method=bundle.method)


def mc_bunny_cornell(w, h, spp, device, rr=0.8):
    """MC path tracing over the mesh Cornell box: the fused mesh engine in
    equal-spp mode on the card, the packet engine on the CPU."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh as mesh_model
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene = cornell.cornell_mesh_scene(device=device)
    cam = cornell.cornell_camera(device)
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=16,
                       rr_survival=rr)
    if device.type == "cuda":
        img = fused_mesh.render_turbo_mesh_exact(scene, cam, cfg, _seed(0),
                                                 device=device)
        engine = "fused_mesh_exact"
    else:
        bundle = mesh_model.prepare(scene, method="packet")
        img = mesh_model.render_mc(bundle, cam, cfg, _seed(0), device=device)
        engine = "packet"
    return _u8(img, gamma=1.0), dict(
        spp=spp, rr=rr, tris=int(scene.triangles.count), engine=engine)


def mc_cornell(w, h, spp, rr, device, chunk_spp=32, engine="wavefront"):
    """MC Cornell (the north star).  ``engine``: "wavefront" = the
    equal-spp wavefront engine in chunks of ``chunk_spp`` (the test tier,
    CPU-reproducible); "turbo" = the fused kernel in equal-spp mode (the
    showcase tier on the card)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(device), cornell.cornell_camera(device)
    seed = _seed(2)
    t0 = time.time()
    if engine == "turbo":
        cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=16,
                           rr_survival=rr)
        img = monte_carlo.render_turbo_exact(scene, cam, cfg, seed,
                                             device=device)
        print(f"    mc rr={rr}: exactly {spp} spp everywhere "
              f"({time.time() - t0:.0f}s, turbo_exact)", flush=True)
        return _u8(img, gamma=1.0), dict(spp=spp, rr=rr, depth=16,
                                         engine="turbo_exact")
    cfg = RenderConfig(width=w, height=h, spp=chunk_spp, max_depth=16,
                       rr_survival=rr)
    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    s = 0
    while s < spp:
        acc, s = monte_carlo.render_wavefront(scene, cam, cfg, seed, acc, s,
                                              device=device)
        print(f"    mc rr={rr}: {s}/{spp} spp ({time.time() - t0:.0f}s)",
              flush=True)
    return _u8(acc / float(spp), gamma=1.0), dict(spp=spp, rr=rr, depth=16)


def denoiser_triple(w, h, device, n_frames=8):
    """Denoiser stage: 1-SPP Cornell frames -> (noisy, denoised, denoised
    without immediate clamping), after ``n_frames`` static-camera frames."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dmodel
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(device), cornell.cornell_camera(device)
    cfg = RenderConfig(width=w, height=h, max_depth=16, rr_survival=0.8)
    seed = _seed(3)
    params = dmodel.DenoiserParams(jbf_half_size=16)
    out = {}
    g = dmodel.render_gbuffer(scene, cam, cfg, seed, n_frames - 1, True,
                              device=device)
    out["denoiser_noisy_1spp"] = (_u8(g.color, gamma=1.0), dict(spp=1))
    for tag, p in [("denoiser_denoised", params),
                   ("denoiser_denoised_noclamp",
                    params.replace(immediate_clamping=False))]:
        prev = None
        for i in range(n_frames):
            color, prev = dmodel.render_frame(scene, cam, cfg, seed, i, prev,
                                              p, device=device)
        out[tag] = (_u8(color, gamma=1.0), dict(
            spp=1, frames=n_frames, jbf=p.jbf_half_size,
            clamp=p.immediate_clamping))
    return out


# --------------------------------------------------------------------------
# Tiers
# --------------------------------------------------------------------------

def test_tier(device) -> list:
    """The test tier as [(name, thunk, (mean_tol, p99_tol), ppm)]: a thunk
    renders {artifact: (u8, meta)}; the tolerances are
    tests/test_golden.py's."""
    def single(name, fn):
        return lambda: {name: fn()}

    return [
        ("offline_rtiow", single("offline_rtiow", lambda: offline_rtiow(
            200, 112, 16, device)), (1.5, 8), True),
        ("offline_dof", single("offline_dof", lambda: offline_dof(
            200, 112, 32, device)), (2.0, 16), False),
        ("nppt", single("nppt", lambda: nppt(128, 128, 16, device)),
         (1.5, 8), False),
        ("whitted", single("whitted", lambda: whitted(128, 128, device)),
         (1.0, 4), False),
        ("bunny_teapot", single("bunny_teapot", lambda: bunny_teapot(
            160, 96, device)), (1.0, 4), False),
        ("mc_cornell", single("mc_cornell", lambda: mc_cornell(
            128, 128, 64, 0.8, device, chunk_spp=64)), (2.0, 16), False),
        ("denoiser", lambda: denoiser_triple(128, 128, device, n_frames=4),
         (2.0, 16), False)]


def make_test_tier(manifest, device, outdir=OUT_DIR, only=None):
    for name, fn, _tol, ppm in test_tier(device):
        if only is None or only in name:
            for art, (u8, m) in fn().items():
                _save(outdir, "test", art, u8, m, manifest, ppm=ppm)


def make_showcase_tier(manifest, device, outdir=OUT_DIR, only=None):
    def want(name):
        return only is None or only in name

    def save(name, res, **kw):
        _save(outdir, "showcase", name, *res, manifest, **kw)

    w, h = 883, 900  # the reference viewport
    card = device.type == "cuda"
    if want("offline"):
        save("offline_rtiow_400x225_100spp",
             offline_rtiow(400, 225, 100, device), ppm=True)
        save("offline_dof_400x225_100spp", offline_dof(400, 225, 100, device))
    if want("nppt"):
        save("nppt_256spp", nppt(883, 824, 256, device))
    if want("whitted"):
        save("whitted", whitted(w, h, device))
    if want("mesh"):
        save("bunny_teapot", bunny_teapot(w, h, device))
    if want("mc"):
        eng = "turbo" if card else "wavefront"
        save("mc_cornell_1024spp",
             mc_cornell(w, h, 1024, 0.8, device, engine=eng))
        if card:
            save("mc_cornell_10000spp",
                 mc_cornell(w, h, 10000, 0.8, device, engine=eng))
        for rr in (0.5, 0.8, 0.9):
            save(f"mc_cornell_rr{int(rr * 100)}_300spp",
                 mc_cornell(w, h, 300, rr, device, chunk_spp=50, engine=eng))
    if want("meshmc"):
        save("mc_bunny_cornell_256spp", mc_bunny_cornell(w, h, 256, device))
    if want("denoiser"):
        for name, res in denoiser_triple(w, h, device).items():
            save(name, res)


def _diff(ref: np.ndarray, got: np.ndarray) -> tuple:
    d = np.abs(ref.astype(np.float32) - got.astype(np.float32))
    return float(d.mean()), float(np.percentile(d, 99))


def _committed(tier: str, name: str):
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    path = os.path.join(GOLDEN_DIR, tier, f"{name}.png")
    return im.read_png(path) if os.path.isfile(path) else None


def _verdict(tier, name, ref, got, mean_tol, p99_tol, what="") -> int:
    if ref is None:
        print(f"[check] {name}: MISSING committed artifact", flush=True)
        return 1
    if ref.shape != got.shape:
        print(f"[check] {name}: shape {got.shape} != {ref.shape}", flush=True)
        return 1
    mean, p99 = _diff(ref, got)
    ok = mean <= mean_tol and p99 <= p99_tol
    print(f"[check] {name}{what}: mean|d|={mean:.3f} p99={p99:.1f} "
          f"(<= {mean_tol}, {p99_tol}) {'OK' if ok else 'DRIFT'}", flush=True)
    return 0 if ok else 1


def check_test(device, only=None) -> int:
    """Render the test tier and compare each artifact with goldens/test/ at
    tests/test_golden.py's tolerances; returns the failed checks."""
    fails = 0
    for name, fn, (mean_tol, p99_tol), _ppm in test_tier(device):
        if only is not None and only not in name:
            continue
        try:
            arts = fn()
        except FileNotFoundError as e:
            print(f"[check] {name}: SKIPPED ({e})", flush=True)
            continue
        for art, (u8, _m) in arts.items():
            fails += _verdict("test", art, _committed("test", art), u8,
                              mean_tol, p99_tol)
    return fails


def check_showcase(device, only=None) -> int:
    """The JAX tool's showcase drift guard: whitted and bunny_teapot at full
    resolution (mean 0.5, p99 2), MC Cornell at 64 spp as 8x8 box means
    against the committed 1024-spp image (mean 2.5, p99 8)."""
    fails = 0
    w, h = 883, 900

    def want(name):
        return only is None or only in name

    if want("whitted"):
        u8, _ = whitted(w, h, device)
        fails += _verdict("showcase", "whitted",
                          _committed("showcase", "whitted"), u8, 0.5, 2.0)
    if want("bunny"):
        try:
            u8, _ = bunny_teapot(w, h, device)
            fails += _verdict("showcase", "bunny_teapot",
                              _committed("showcase", "bunny_teapot"), u8,
                              0.5, 2.0)
        except FileNotFoundError as e:
            print(f"[check] bunny_teapot: SKIPPED ({e})", flush=True)
    if want("mc"):
        eng = "turbo" if device.type == "cuda" else "wavefront"
        u8, _ = mc_cornell(w, h, 64, 0.8, device, engine=eng)
        ref = _committed("showcase", "mc_cornell_1024spp")
        k = 8

        def down(x):
            hh, ww = x.shape[0] // k * k, x.shape[1] // k * k
            return x[:hh, :ww].astype(np.float32).reshape(
                hh // k, k, ww // k, k, 3).mean((1, 3))

        fails += _verdict("showcase", "mc_cornell",
                          None if ref is None else down(ref), down(u8),
                          2.5, 8.0, "(64spp vs 1024spp, 8x8 means)")
    return fails


def main(argv=None) -> int:
    from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", choices=["test", "showcase", "all"],
                    default="test")
    ap.add_argument("--only", default=None, help="substring filter")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the card)")
    ap.add_argument("--check", action="store_true",
                    help="compare the tier with the committed goldens/<tier>/"
                         " instead of writing it")
    ap.add_argument("--outdir", default=OUT_DIR,
                    help="where the artifacts go (default build/goldens/)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    print("device:", device, flush=True)
    tiers = ["test", "showcase"] if args.tier == "all" else [args.tier]
    if args.check:
        fails = sum((check_test if t == "test" else check_showcase)(
            device, args.only) for t in tiers)
        print(f"golden check ({', '.join(tiers)}): {fails} failure(s)",
              flush=True)
        return 1 if fails else 0
    for tier in tiers:
        mpath = os.path.join(args.outdir, tier, "MANIFEST.json")
        manifest = {}
        if os.path.isfile(mpath):
            with open(mpath) as f:
                manifest = json.load(f)
        t0 = time.time()
        (make_test_tier if tier == "test" else make_showcase_tier)(
            manifest, device, args.outdir, args.only)
        manifest["_backend"] = device.type
        os.makedirs(os.path.dirname(mpath), exist_ok=True)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        print(f"{tier} tier done in {time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
