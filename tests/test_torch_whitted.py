"""The port's Whitted stage against the JAX package: the optics helpers of
``ops.vec``, ``Hit.uv``, the scene, ``models.whitted.trace`` / ``render``
(the lane cap and its truncated weight included), the fused kernel's plain
version against the JAX ``render_fused`` (its Pallas kernel in interpret
mode), and the ``whitted.png`` golden.

Tolerances: the helpers rtol 1e-6 (atol 1e-6 at the critical angle); uv
atol 1e-6; the ray tree rtol 1e-5, atol 1e-6 (``tests/test_whitted.py:117``)
on every pixel but knife-edge ones, fewer than 0.5%: the two packages round
a few operations differently (fusion, rsqrt), and a ray that grazes a
silhouette or a chessboard cell edge can flip its discrete outcome.  The
fused kernel's plain version is held to ``tests/test_fused_whitted.py``'s
gate at its size, 64x64: p99 < 1e-4, pixels off by more than 1e-3 below
0.5% (at 32x32 the same few knife-edge pixels are 0.8% of the image)."""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cpu_based_ray_tracer_tpu import camera as jcam
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import whitted as jwhitted
from cpu_based_ray_tracer_tpu.ops import fused_whitted as jfw
from cpu_based_ray_tracer_tpu.ops import intersect as jintersect
from cpu_based_ray_tracer_tpu.ops import vec as jvec
from cpu_based_ray_tracer_tpu.scene import REFLECTIVE_REFRACTIVE
from cpu_based_ray_tracer_tpu.scene import MaterialBuilder as JMB
from cpu_based_ray_tracer_tpu.scene import make_scene as jmake_scene
from cpu_based_ray_tracer_tpu.scene import make_spheres as jmake_spheres
from cpu_based_ray_tracer_tpu.scenes import whitted_scene as jws

from cpu_based_ray_tracer_tpu_torch import camera, interop
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import whitted
from cpu_based_ray_tracer_tpu_torch.ops import fused_whitted as fw
from cpu_based_ray_tracer_tpu_torch.ops import intersect, tonemap, vec
from cpu_based_ray_tracer_tpu_torch.scene import (REFLECTIVE, MaterialBuilder,
                                                  make_scene, make_spheres)
from cpu_based_ray_tracer_tpu_torch.scenes import whitted_scene
from cpu_based_ray_tracer_tpu_torch.utils import image as im

import torch_ref as ref
from test_golden import assert_close_u8

GOLD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "test", "whitted.png")
KNIFE_EDGE_SHARE = 0.005


def _port_scene():
    return interop.scene_from_arrays(ref.scene_arrays(jws.whitted_scene()))


def _assert_tree_close(got, want, rtol=1e-5, atol=1e-6):
    """allclose on all but a knife-edge share of pixels (see module doc)."""
    bad = (np.abs(got - want) > atol + rtol * np.abs(want)).any(-1)
    assert bad.mean() < KNIFE_EDGE_SHARE, f"{bad.sum()} of {bad.size} pixels"


def _assert_fused_gate(got, want):
    diff = np.abs(got - want)
    assert float(np.percentile(diff, 99)) < 1e-4
    assert (diff.max(-1) > 1e-3).mean() < KNIFE_EDGE_SHARE


# --- optics helpers and hit records -------------------------------------------

def test_vec_optics_match_jax(rng_np):
    n_ = 4000
    d = rng_np.normal(size=(n_, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    n = rng_np.normal(size=(n_, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    ior = rng_np.uniform(1.05, 2.4, n_).astype(np.float32)
    cos = rng_np.uniform(-0.1, 1.1, n_).astype(np.float32)
    eta_in = np.where(rng_np.random(n_) < 0.5, 1.0, ior).astype(np.float32)
    eta_out = np.where(eta_in == 1.0, ior, 1.0).astype(np.float32)
    t = rng_np.random((n_, 1), dtype=np.float32)
    cases = [
        ("reflect", (d, n)), ("snell_whitted", (d, n, ior)),
        ("fresnel_whitted", (d, n, ior)), ("lerp", (d, n, t)),
        ("fresnel_exact", (cos, eta_in, eta_out)),
    ]
    for name, args in cases:
        want = np.asarray(getattr(jvec, name)(*map(jnp.asarray, args)))
        got = getattr(vec, name)(*map(torch.as_tensor, args)).numpy()
        assert got.shape == want.shape, name
        # atol: at the critical angle dR/dcos is unbounded, so a last-ulp
        # difference in dot(d, n) moves the Fresnel term by ~1e-6.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    tir = vec.snell_whitted(*map(torch.as_tensor, (d, n, ior)))
    assert (tir.abs().sum(-1) == 0).any()       # TIR lanes are exact zeros


def test_whitted_scene_leaves_equal_jax():
    a = interop.scene_to_arrays(whitted_scene.whitted_scene())
    b = ref.scene_arrays(jws.whitted_scene())
    for k, v in b.items():
        for f, x in (v.items() if isinstance(v, dict) else [(k, v)]):
            y = a[k][f] if isinstance(v, dict) else a[k]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (k, f)
    for f, x in ref.camera_arrays(jws.whitted_camera()).items():
        np.testing.assert_array_equal(
            interop.camera_to_arrays(whitted_scene.whitted_camera())[f], x)


def test_hit_uv_matches_jax(rng_np):
    cam = jws.whitted_camera()
    jit = rng_np.random((40, 40, 2), dtype=np.float32)
    d = np.array(jcam.perspective_rays(cam, 40, 40, jnp.asarray(jit))
                 ).reshape(-1, 3)
    o = np.broadcast_to(np.asarray(cam.position), d.shape).copy()
    jh = jintersect.intersect_scene(jws.whitted_scene(), jnp.asarray(o),
                                    jnp.asarray(d), t_min=1e-3)
    h = intersect.intersect_scene(_port_scene(), torch.as_tensor(o),
                                  torch.as_tensor(d), t_min=1e-3)
    np.testing.assert_array_equal(h.material.numpy(), np.asarray(jh.material))
    np.testing.assert_allclose(h.uv.numpy(), np.asarray(jh.uv), rtol=0,
                               atol=1e-6)
    floor = h.is_triangle & h.hit
    assert floor.sum() > 100 and (h.uv[floor] > 0).all()
    assert (h.uv[~h.is_triangle] == 0).all()


def test_diffuse_color_matches_jax(rng_np):
    uv = rng_np.random((500, 2), dtype=np.float32)
    mat = rng_np.integers(0, 3, 500).astype(np.int32)
    want = np.asarray(jwhitted.diffuse_color(jws.whitted_scene(),
                                             jnp.asarray(mat),
                                             jnp.asarray(uv)))
    got = whitted.diffuse_color(_port_scene(), torch.as_tensor(mat),
                                torch.as_tensor(uv)).numpy()
    np.testing.assert_array_equal(got, want)


# --- the ray tree ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_trace48():
    scene, cam = jws.whitted_scene(), jws.whitted_camera()
    d = jcam.perspective_rays(cam, 48, 48).reshape(-1, 3)
    o = jnp.broadcast_to(cam.position, d.shape)
    rad, trunc = jwhitted.trace(scene, o, d, JConfig(width=48, height=48),
                                return_truncated=True)
    return np.asarray(rad), float(trunc)


def test_trace_matches_jax():
    want, want_trunc = _jax_trace48()
    cam = whitted_scene.whitted_camera()
    d = camera.perspective_rays(cam, 48, 48).reshape(-1, 3)
    o = cam.position.expand(d.shape)
    got, trunc = whitted.trace(_port_scene(), o, d,
                               RenderConfig(width=48, height=48),
                               return_truncated=True)
    assert float(trunc) == want_trunc == 0.0   # the cap never binds here
    _assert_tree_close(got.numpy(), want)
    exact = whitted.trace(_port_scene(), o, d,
                          RenderConfig(width=48, height=48,
                                       whitted_lane_cap=0))
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_lane_cap_truncated_weight_matches_jax():
    """Glass fills the view and a cap of one lane multiple binds: the
    dropped Fresnel weight is reported, and agrees with JAX's."""
    mb = JMB()
    glass = mb.add(REFLECTIVE_REFRACTIVE, ior=1.5)
    jscene = jmake_scene(spheres=jmake_spheres([[0.0, 0.0, -3.0]], [2.0],
                                               [glass]),
                         materials=mb.build())
    jc = jcam.make_perspective_camera((0, 0, 2), (0, 0, -1),
                                      vfov_degrees=30.0)
    kw = dict(width=24, height=24, whitted_depth=4, whitted_lane_cap=1)
    d = jcam.perspective_rays(jc, 24, 24).reshape(-1, 3)
    o = jnp.broadcast_to(jc.position, d.shape)
    want, want_trunc = jwhitted.trace(jscene, o, d, JConfig(**kw),
                                      return_truncated=True)
    scene = interop.scene_from_arrays(ref.scene_arrays(jscene))
    got, trunc = whitted.trace(scene, torch.as_tensor(np.array(o)),
                               torch.as_tensor(np.array(d)),
                               RenderConfig(**kw), return_truncated=True)
    assert float(want_trunc) > 0.0
    np.testing.assert_allclose(float(trunc), float(want_trunc), rtol=1e-5)
    _assert_tree_close(got.numpy(), np.asarray(want))


def test_render_matches_jax_with_ragged_chunks():
    """48x48 in one chunk; 37x23 in chunks of 300 rays, the last one padded.
    Per-ray results do not depend on the chunking, so the chunked render is
    held to the unchunked JAX render (JAX's own ``lax.map`` over chunks
    compiles with other fusions and moves knife-edge pixels) and equals the
    port's unchunked render exactly."""
    want, _ = _jax_trace48()
    got = whitted.render(_port_scene(), whitted_scene.whitted_camera(),
                         RenderConfig(width=48, height=48), device="cpu")
    assert got.shape == (48, 48, 3)
    _assert_tree_close(got.numpy().reshape(-1, 3), want)
    want = np.asarray(jwhitted.render(jws.whitted_scene(),
                                      jws.whitted_camera(),
                                      JConfig(width=37, height=23)))
    cfg = RenderConfig(width=37, height=23)
    got = whitted.render(_port_scene(), whitted_scene.whitted_camera(),
                         cfg.replace(ray_chunk=300), device="cpu")
    _assert_tree_close(got.numpy(), want)
    assert torch.equal(got, whitted.render(
        _port_scene(), whitted_scene.whitted_camera(), cfg, device="cpu"))


# --- the fused kernel's plain version -------------------------------------------

def test_pack_whitted_scene_byte_equal():
    want = jfw.pack_whitted_scene(jws.whitted_scene())
    got = fw.pack_whitted_scene(_port_scene())
    for f in ("tri", "sph", "mat", "light", "sky", "chess"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for f in ("n_tri", "n_sph", "n_mat", "n_light"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("queue", [4, 2])
def test_render_fused_plain_matches_jax(queue):
    cfg = dict(width=64, height=64)
    want, want_trunc = jfw.render_fused(jws.whitted_scene(),
                                        jws.whitted_camera(), JConfig(**cfg),
                                        queue=queue)
    scene, cam = _port_scene(), whitted_scene.whitted_camera()
    got, trunc = fw.render_fused_plain(scene, cam, RenderConfig(**cfg),
                                       queue=queue, device="cpu")
    _assert_fused_gate(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(trunc), float(want_trunc), rtol=1e-5)
    if queue == 4:
        assert float(trunc) == 0.0
    # On CPU tensors the wrapper runs exactly the plain version.
    launches = fw.LAUNCHES["fused_whitted"]
    img, t2 = fw.render_fused(scene, cam, RenderConfig(**cfg), queue=queue,
                              device="cpu")
    assert fw.LAUNCHES["fused_whitted"] == launches
    assert torch.equal(img, got) and torch.equal(t2, trunc)


def test_render_fused_plain_reports_truncation():
    """A glass sphere in front of a mirror sphere: light leaving the glass
    hits the mirror while the glass still spawns two branches, so Q=2 must
    drop weight and report it, never silently."""
    mb = MaterialBuilder()
    glass = mb.add(REFLECTIVE_REFRACTIVE, ior=1.5)
    mirror = mb.add(REFLECTIVE)
    scene = make_scene(spheres=make_spheres([[0.0, 0.0, -3.0],
                                             [0.0, 0.0, -9.0]], [1.2, 4.0],
                                            [glass, mirror]),
                       materials=mb.build())
    cam = camera.make_perspective_camera((0, 0, 2), (0, 0, -1),
                                         vfov_degrees=30.0)
    cfg = RenderConfig(width=16, height=16, whitted_depth=4)
    img2, t2 = fw.render_fused_plain(scene, cam, cfg, queue=2, device="cpu")
    img4, t4 = fw.render_fused_plain(scene, cam, cfg, queue=4, device="cpu")
    assert float(t2) > 0.0 and float(t4) <= float(t2)
    assert torch.isfinite(img2).all() and (img2 <= img4 + 1e-6).all()


def test_whitted_golden(tmp_path):
    """The port's Whitted render and the fused kernel's plain version
    against ``goldens/test/whitted.png`` (``tools/make_goldens.whitted``:
    128x128, depth 5, gamma 1) with ``test_golden.py``'s gate."""
    scene, cam = whitted_scene.whitted_scene(), whitted_scene.whitted_camera()
    cfg = RenderConfig(width=128, height=128, whitted_depth=5,
                       ray_chunk=65536)
    gold = im.read_png(GOLD)
    for img in (whitted.render(scene, cam, cfg, device="cpu"),
                fw.render_fused(scene, cam, cfg, device="cpu")[0]):
        path = tmp_path / "whitted.png"
        im.write_png(path, tonemap.quantize_u8(img, gamma=1.0).numpy())
        assert_close_u8(im.read_png(path), gold, mean_tol=1.0, p99_tol=4)


def test_whitted_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam = whitted_scene.whitted_scene(), whitted_scene.whitted_camera()
    cfg = RenderConfig(width=8, height=8)
    with pytest.raises(RuntimeError):
        whitted.render(scene, cam, cfg)
    with pytest.raises(RuntimeError):
        fw.render_fused(scene, cam, cfg)
    with pytest.raises(RuntimeError):
        fw.render_fused_plain(scene, cam, cfg)


def test_fused_kernel_wrapper_refuses_cpu_tensors():
    wp = fw.pack_whitted_scene(whitted_scene.whitted_scene())
    with pytest.raises(ValueError):
        fw._tree_kernel(wp, torch.zeros(3), torch.zeros((3, 16)), 5, 4,
                        1e-3, 1e-5)



@pytest.mark.parametrize("queue", [4, 2])
def test_full_queue_scene_fills_every_slot(queue):
    """The data of ``test_torch_cuda.py::
    test_whitted_kernel_matches_plain_on_full_queues``: on
    ``full_queue_scene`` at 96x80 some pixel has every slot of the queue
    live and total internal reflection kills some refracted child (the
    plain version's tally); the tally's levels add up to its totals, and
    the warps' slot sections cover the live slots."""
    from test_torch_cuda import full_queue_scene

    counts = {}
    fw.render_fused_plain(full_queue_scene(), whitted_scene.whitted_camera(),
                          RenderConfig(width=96, height=80), queue=queue,
                          device="cpu", counts=counts)
    levels = counts["levels"]
    assert max(lv["full_lanes"] for lv in levels) > 0
    assert sum(lv["tir"] for lv in levels) > 0
    for k in ("live", "diffuse", "specular"):
        assert sum(lv[k] for lv in levels) == counts[k]
    for lv in levels:
        assert lv["miss"] + lv["diffuse"] + lv["specular"] <= lv["live"]
        assert lv["warp_slots"] * 32 >= lv["live"] >= lv["lanes"]
        assert lv["lanes"] >= lv["full_lanes"]
