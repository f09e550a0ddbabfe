"""The port's RTIOW stages (offline prototype, initial framework, NPPT)
against the JAX package: the new samplers, the thin-lens camera, the
scenes, the scan twins (``models.offline``, ``nppt``, ``initial``), and the
fused RTIOW kernel's plain version against the JAX Pallas kernel run in
interpret mode (integer lane state exact, floats to 2e-3), then the
``offline_rtiow``, ``offline_dof`` and ``nppt`` goldens through the fused
render."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu import camera as jcam
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import initial as jinitial
from cpu_based_ray_tracer_tpu.models import nppt as jnppt
from cpu_based_ray_tracer_tpu.models import offline as joffline
from cpu_based_ray_tracer_tpu.ops import fused_rtiow as jfr
from cpu_based_ray_tracer_tpu.ops import vec as jvec
from cpu_based_ray_tracer_tpu.ops.fused import LANES_PER_TILE
from cpu_based_ray_tracer_tpu.scenes import initial_scene as jinit_scene
from cpu_based_ray_tracer_tpu.scenes import rtiow as jrtiow
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import camera, interop
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import initial, nppt, offline
from cpu_based_ray_tracer_tpu_torch.ops import fused_rtiow as fr
from cpu_based_ray_tracer_tpu_torch.ops import tonemap, vec
from cpu_based_ray_tracer_tpu_torch.scene import (DIFFUSE_IN_HEMISPHERE,
                                                  DIFFUSE_IN_SPHERE)
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, initial_scene
from cpu_based_ray_tracer_tpu_torch.scenes import rtiow
from cpu_based_ray_tracer_tpu_torch.utils import image as im

import torch_ref as ref
from test_golden import GOLD, assert_close_u8
from torch_ref import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _draws(rng_np, n=4096):
    u = rng_np.uniform(0.0, 1.0, size=(4, n)).astype(np.float32)
    nrm = rng_np.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    return u, nrm


SAMPLERS = {
    "sphere_from": (lambda m, u, n: m.sphere_from(u[0], u[1])),
    "ball_from": (lambda m, u, n: m.ball_from(u[0], u[1], u[2])),
    "hemisphere_volume_from": (
        lambda m, u, n: m.hemisphere_volume_from(n, u[0], u[1], u[2])),
    "disk_from": (lambda m, u, n: m.disk_from(u[0], u[1])),
    "schlick": (lambda m, u, n: m.schlick(u[0], 0.5 + 2.0 * u[1])),
    "refract": (lambda m, u, n: m.refract(
        -n * (0.2 + u[:3].T), n, (0.5 + u[3])[:, None])[0]),
    "refract_tir": (lambda m, u, n: m.refract(
        -n * (0.2 + u[:3].T), n, (0.5 + u[3])[:, None])[1]),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_vec_matches_jax(rng_np, name):
    u, n = _draws(rng_np)
    fn = SAMPLERS[name]
    want = np.asarray(fn(jvec, jnp.asarray(u), jnp.asarray(n)))
    got = fn(vec, torch.as_tensor(u), torch.as_tensor(n)).numpy()
    assert got.shape == want.shape
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
        assert 0 < want.sum() < want.size
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


CAMERAS = {
    "offline": (lambda m: m.offline_camera(1.5)),
    "offline_aperture": (lambda m: m.offline_camera(1.0, aperture=0.4)),
    "offline_dof": (lambda m: m.offline_dof_camera(200 / 112)),
}


@pytest.mark.parametrize("name", list(CAMERAS))
def test_thin_lens_camera_matches_jax(rng_np, name):
    want = CAMERAS[name](jrtiow)
    got = CAMERAS[name](rtiow)
    leaves = ref.camera_arrays(want)
    for k, v in leaves.items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)
    carried = interop.camera_from_arrays(leaves)
    assert isinstance(carried, camera.ThinLensCamera)
    for k, v in interop.camera_to_arrays(carried).items():
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)
    u, _ = _draws(rng_np)
    o_w, d_w = jcam.thin_lens_rays(want, *(jnp.asarray(x) for x in u))
    o_g, d_g = camera.thin_lens_rays(got, *(torch.as_tensor(x) for x in u))
    np.testing.assert_allclose(o_g.numpy(), np.asarray(o_w), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(d_g.numpy(), np.asarray(d_w), rtol=1e-6,
                               atol=1e-6)


SCENES = [(jrtiow, rtiow, "offline_two_sphere_scene"),
          (jrtiow, rtiow, "rtiow_classic_scene"),
          (jrtiow, rtiow, "nppt_scene"),
          (jinit_scene, initial_scene, "initial_scene")]


@pytest.mark.parametrize("jmod,mod,name", SCENES,
                         ids=[s[2] for s in SCENES])
def test_scene_arrays_match_jax(jmod, mod, name):
    want = ref.scene_arrays(getattr(jmod, name)())
    got = interop.scene_to_arrays(getattr(mod, name)())
    for part in ("triangles", "spheres", "materials", "lights"):
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v,
                                          err_msg=f"{part}.{k}")
    for k in ("sky_bottom", "sky_top"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("jmod,mod,name", [
    (jrtiow, rtiow, "nppt_camera"),
    (jinit_scene, initial_scene, "initial_camera")])
def test_perspective_cameras_match_jax(jmod, mod, name):
    want = ref.camera_arrays(getattr(jmod, name)())
    got = interop.camera_to_arrays(getattr(mod, name)())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# name -> (JAX render, port render, scene, camera factory, config, key)
RENDERS = {
    "offline": (joffline.render, offline.render, "offline_two_sphere_scene",
                lambda m: m.offline_camera(36 / 24),
                dict(width=36, height=24, spp=3, max_depth=8), 3),
    "offline_dof": (joffline.render, offline.render, "rtiow_classic_scene",
                    lambda m: m.offline_dof_camera(1.0),
                    dict(width=32, height=32, spp=2, max_depth=8), 4),
    "nppt": (jnppt.render, nppt.render, "nppt_scene",
             lambda m: m.nppt_camera(),
             dict(width=40, height=32, spp=3, max_depth=8), 7),
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_scan_render_matches_jax(case):
    jrender, render, scene, cam, kw, k = RENDERS[case]
    want = np.asarray(jrender(getattr(jrtiow, scene)(), cam(jrtiow),
                              JConfig(**kw), jrng.render_key(k)))
    got = render(getattr(rtiow, scene)(), cam(rtiow), RenderConfig(**kw),
                 ref.seed_word(k), device="cpu")
    assert got.shape == (kw["height"], kw["width"], 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


def test_initial_render_matches_jax():
    kw = dict(width=40, height=32, spp=2)
    want = np.asarray(jinitial.render(
        jinit_scene.initial_scene(), jinit_scene.initial_camera(),
        JConfig(**kw), jrng.render_key(3)))
    got = initial.render(initial_scene.initial_scene(),
                         initial_scene.initial_camera(), RenderConfig(**kw),
                         ref.seed_word(3), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)
    # A ray starting inside the unit sphere does not hit it (near root only).
    o = torch.zeros((1, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]])
    _, _, hit = initial._nearest_sphere_near_root(
        initial_scene.initial_scene(), o, d)
    assert not bool(hit[0])


def _jax_kernel_steps(scene, cam, cfg, key, n_steps):
    """The JAX Pallas kernel in interpret mode from render_fused's initial
    state -> (initial sf, sf, si) as numpy, sliced to the image's lanes."""
    mode = ("thinlens" if isinstance(cam, jcam.ThinLensCamera)
            else "perspective")
    h, w = cfg.height, cfg.width
    n_pix = h * w
    rp = -(-n_pix // LANES_PER_TILE) * LANES_PER_TILE
    sph, mat, sky, n_sph, n_mat = jfr.pack_rtiow_scene(scene)
    seed = jrng.seed_from_key(key)
    cam24 = (jfr._thinlens_words(cam) if mode == "thinlens"
             else jfr._perspective_words(cam))

    def plane(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((rp - n_pix,) + x.shape[1:], fill, x.dtype)], 0)

    pixel = plane(jnp.arange(n_pix, dtype=jnp.uint32), jnp.uint32(n_pix))
    pxy = jnp.stack([(pixel % jnp.uint32(w)).astype(jnp.float32),
                     (pixel // jnp.uint32(w)).astype(jnp.float32)], 0)
    s0 = jnp.zeros((n_pix,), jnp.int32)
    j = jrng.uniforms4(seed, pixel[:n_pix], s0, 0, jrng.JITTER)
    if mode == "thinlens":
        x, y = pxy[0, :n_pix], pxy[1, :n_pix]
        o, d = jcam.thin_lens_rays(cam, (x + j[0]) / w,
                                   ((h - 1.0) - y + j[1]) / h, j[2], j[3])
    else:
        uj = jnp.stack([j[0].reshape(h, w), j[1].reshape(h, w)], -1)
        d = jcam.perspective_rays(cam, w, h, uj).reshape(-1, 3)
        o = jnp.broadcast_to(cam.position, d.shape)
    ones = jnp.ones((n_pix, 3), jnp.float32)
    sf = jnp.concatenate([plane(o).T, plane(d).T, plane(ones).T,
                          plane(0.0 * ones).T], 0)
    si = jnp.stack([plane(s0)] * 3, 0)
    sf2, si2 = jfr._run(
        sph, mat, sky, seed[None, None].astype(jnp.uint32), cam24,
        pixel.reshape(1, rp // 128, 128), pxy.reshape(2, rp // 128, 128),
        sf.reshape(12, rp // 128, 128), si.reshape(3, rp // 128, 128),
        n_sph=n_sph, n_mat=n_mat, n_steps=n_steps, width=w, height=h,
        n_pix=n_pix, t_min=float(cfg.t_min), max_depth=int(cfg.max_depth),
        spp=int(cfg.spp), diffuse_model=int(cfg.diffuse_model),
        camera_mode=mode, interpret=True)
    cut = lambda a, k: np.asarray(a).reshape(k, rp)[:, :n_pix]  # noqa: E731
    return cut(sf, 12), cut(sf2, 12), cut(si2, 3)


# name -> (scene, camera factory, config kwargs, key): both camera modes,
# the lens aperture, the hollow bubbles, the three diffuse models.
STEPPER = {
    "thinlens_aperture_in_sphere": (
        "rtiow_classic_scene", lambda m: m.offline_camera(1.0, aperture=0.4),
        dict(width=32, height=32, spp=3, max_depth=6,
             diffuse_model=DIFFUSE_IN_SPHERE), 5),
    "perspective_nppt": ("nppt_scene", lambda m: m.nppt_camera(),
                         dict(width=40, height=32, spp=3, max_depth=8), 7),
    "thinlens_in_hemisphere": (
        "rtiow_classic_scene", lambda m: m.offline_camera(1.0),
        dict(width=24, height=24, spp=2, max_depth=6,
             diffuse_model=DIFFUSE_IN_HEMISPHERE), 11),
}


@pytest.mark.parametrize("case", list(STEPPER))
def test_plain_stepper_matches_jax_kernel(case):
    scene, cam, kw, k = STEPPER[case]
    n_steps = 12
    sf0, want_f, want_i = _jax_kernel_steps(
        getattr(jrtiow, scene)(), cam(jrtiow), JConfig(**kw),
        jrng.render_key(k), n_steps)
    pk, cam24, sf, si, p = fr._setup(getattr(rtiow, scene)(), cam(rtiow),
                                     RenderConfig(**kw), ref.seed_word(k),
                                     torch.device("cpu"))
    np.testing.assert_allclose(sf.numpy(), sf0, rtol=1e-6, atol=1e-6)
    launches = fr.LAUNCHES["fused_rtiow"]
    sf2, si2 = fr.rtiow_steps(pk, cam24, ref.seed_word(k), sf, si,
                              p._replace(n_steps=n_steps))
    assert fr.LAUNCHES["fused_rtiow"] == launches
    for i, name in enumerate(("s", "b", "n_done")):
        np.testing.assert_array_equal(si2[i].numpy(), want_i[i],
                                      err_msg=name)
    np.testing.assert_allclose(sf2.numpy(), want_f, rtol=ref.RTOL,
                               atol=ref.ATOL)
    assert 0 < want_i[2].mean() <= kw["spp"]


@pytest.mark.parametrize("case", ["offline_aperture", "nppt"])
def test_render_fused_matches_scan_twin(case):
    if case == "nppt":
        scene, cam = rtiow.nppt_scene(), rtiow.nppt_camera()
        cfg, twin = RenderConfig(width=40, height=32, spp=3,
                                 max_depth=8), nppt.render
    else:
        scene, cam = (rtiow.offline_two_sphere_scene(),
                      rtiow.offline_camera(1.0, aperture=0.4))
        cfg, twin = RenderConfig(width=32, height=32, spp=4,
                                 max_depth=6), offline.render
    want = twin(scene, cam, cfg, ref.seed_word(5), device="cpu")
    got = fr.render_fused(scene, cam, cfg, ref.seed_word(5), device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ref.RTOL,
                               atol=ref.ATOL)


# The one-launch render's schedule (pixels in sample chunks, refilled from a
# queue, each step computing only what its ray needs): name -> (scene,
# camera factory, diffuse model).  Thin lens and perspective, the three
# diffuse models.
REFILL = {
    "thinlens_on_sphere": ("offline_two_sphere_scene",
                           lambda m: m.offline_camera(40 / 36), 1),
    "thinlens_aperture_in_sphere": (
        "rtiow_classic_scene",
        lambda m: m.offline_camera(40 / 36, aperture=0.4), DIFFUSE_IN_SPHERE),
    "perspective_on_sphere": ("nppt_scene", lambda m: m.nppt_camera(), 1),
    "perspective_in_hemisphere": ("nppt_scene", lambda m: m.nppt_camera(),
                                  DIFFUSE_IN_HEMISPHERE),
}


def _refill_case(case, spp=8):
    scene, cam, model = REFILL[case]
    cfg = RenderConfig(width=40, height=36, spp=spp, max_depth=8,
                       diffuse_model=model)
    return fr._setup(getattr(rtiow, scene)(), cam(rtiow), cfg,
                     ref.seed_word(5), torch.device("cpu"))


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("case", list(REFILL))
def test_refill_twin_matches_lockstep(case, chunks):
    """The refill twin against the lockstep schedule (``_steps_plain`` to
    completion): every state plane bit equal, so the image and n_done."""
    pk, cam24, sf, si, p = _refill_case(case)
    want_f, want_i = fr.render_lockstep(pk, cam24, ref.seed_word(5),
                                        sf.clone(), si.clone(), p)
    got_f, got_i = fr.render_refill_plain(pk, cam24, ref.seed_word(5), sf,
                                          si, p, chunks=chunks)
    assert bool((want_i[2] == p.spp).all())
    assert torch.equal(got_i, want_i) and torch.equal(got_f, want_f)


def test_refill_twin_matches_jax_render_fused():
    """The refill twin's image against JAX ``render_fused`` (its Pallas
    kernel in interpret mode), 40x36, 8 spp: within 2e-3."""
    pk, cam24, sf, si, p = _refill_case("perspective_on_sphere")
    got_f, _ = fr.render_refill_plain(pk, cam24, ref.seed_word(5), sf, si, p,
                                      chunks=3)
    got = (got_f[9:12].T / 8.0).reshape(36, 40, 3).numpy()
    want = np.asarray(jfr.render_fused(
        jrtiow.nppt_scene(), jrtiow.nppt_camera(),
        JConfig(width=40, height=36, spp=8, max_depth=8), jrng.render_key(5)))
    np.testing.assert_allclose(got, want, rtol=ref.RTOL, atol=ref.ATOL)
    assert want.mean() > 0.0


def test_render_chunks_rule():
    """Sample chunks: enough work items for the resident threads, at most
    spp, within the scratch budget."""
    threads, free = 132 * 4 * 256, 20 << 30
    assert fr.render_chunks(400 * 225, 100, threads, free) > 1
    assert fr.render_chunks(400 * 225, 4, threads, free) == 4
    assert fr.render_chunks(3840 * 2160, 4096, threads, free) == 1
    assert fr.render_chunks(0, 8, threads, free) == 1
    # NPPT: 3 chunks take 2 x 727,592 x 86 x 16 bytes; 2 would take 1.49 GB
    assert fr.render_chunks(883 * 824, 256, threads, free) == 3
    assert fr.render_chunks(883 * 824, 256, threads, 1 << 30) == 1


# tools/make_goldens.py's test tier: name -> (scene, camera, config, key)
GOLDENS = {
    "offline_rtiow": (rtiow.offline_two_sphere_scene,
                      lambda: rtiow.offline_camera(200 / 112),
                      dict(width=200, height=112, spp=16, max_depth=50), 0),
    "offline_dof": (rtiow.rtiow_classic_scene,
                    lambda: rtiow.offline_dof_camera(200 / 112),
                    dict(width=200, height=112, spp=32, max_depth=50), 4),
    "nppt": (rtiow.nppt_scene, rtiow.nppt_camera,
             dict(width=128, height=128, spp=16, max_depth=50, gamma=1.0), 1),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_render_fused_matches_golden(tmp_path, name):
    scene, cam, kw, k = GOLDENS[name]
    cfg = RenderConfig(**kw)
    img = fr.render_fused(scene(), cam(), cfg, ref.seed_word(k), device="cpu")
    u8 = tonemap.quantize_u8(img, cfg.gamma).numpy()
    path = tmp_path / f"{name}.png"
    im.write_png(path, u8)
    assert_close_u8(im.read_png(path), im.read_png(f"{GOLD}/{name}.png"),
                    mean_tol=1.5, p99_tol=8)
    if name == "offline_rtiow":
        im.write_ppm(tmp_path / f"{name}.ppm", u8)
        assert_close_u8(im.read_ppm(tmp_path / f"{name}.ppm"),
                        im.read_ppm(f"{GOLD}/{name}.ppm"), mean_tol=1.5,
                        p99_tol=8)


def test_wrappers_refuse():
    scene, cam = rtiow.nppt_scene(), rtiow.nppt_camera()
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    if not torch.cuda.is_available():
        for fn in (fr.render_fused, offline.render, nppt.render,
                   initial.render):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                fn(scene, cam, cfg, 1)
    with pytest.raises(ValueError, match="sphere scenes only"):
        fr.pack_rtiow_scene(cornell.cornell_scene())
    pk, cam24, sf, si, p = fr._setup(scene, cam, cfg, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fr._steps_kernel(pk, cam24, 1, sf, si, p)
