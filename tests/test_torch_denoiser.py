"""The port's Denoiser stage against the JAX package: the camera matrices,
the filters of ``ops.denoise`` on a numpy-made G-buffer, the fixed-depth
G-buffer render, the fused single-path render against the fixed-depth one,
and the three ``denoiser_*`` goldens.  The single-path plain stepper
against the JAX Pallas kernel in interpret mode is in
``test_torch_denoiser_interpret.py``."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu import camera as jcam
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import denoiser as jdn
from cpu_based_ray_tracer_tpu.ops import denoise as jde
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import camera
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import denoiser as dn
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import denoise as de
from cpu_based_ray_tracer_tpu_torch.ops import fused, intersect, tonemap
from cpu_based_ray_tracer_tpu_torch.scenes import cornell
from cpu_based_ray_tracer_tpu_torch.utils import image as im

import torch_ref as ref
from test_golden import GOLD, assert_close_u8
from torch_ref import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 24, 32
# The filters' float tolerance: XLA's and PyTorch's exp / arccos / cumsum
# round differently by a few ulp.
FILTER_RTOL, FILTER_ATOL = 1e-5, 1e-5


def _camera_pair(moved: float):
    """A JAX camera and the same pose in the port, ``moved`` along +x."""
    pos = np.asarray(jcornell.cornell_camera().position) + [moved, 0.0, 0.0]
    fwd = np.asarray(jcornell.cornell_camera().forward)
    return (jcam.make_perspective_camera(pos, fwd, vfov_degrees=40.0),
            camera.make_perspective_camera(pos, fwd, vfov_degrees=40.0))


def _gbuffer_arrays(seed: int, moved: float = 0.0) -> dict:
    """A G-buffer made with numpy: world positions along the camera's
    pixel rays at random depths, random unit normals facing the viewer,
    ~85% contributors with ids in 1..5."""
    g = np.random.default_rng(seed)
    jc, _ = _camera_pair(moved)
    d = np.asarray(jcam.perspective_rays(jc, W, H))
    depth = g.uniform(3.0, 8.0, (H, W, 1))
    pos = np.asarray(jc.position) + d * depth
    n = g.normal(size=(H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(np.sum(n * d, -1, keepdims=True) > 0, -n, n)
    contrib = g.uniform(size=(H, W)) < 0.85
    pid = np.where(contrib, g.integers(1, 6, (H, W)), -1)
    view, proj = jcam.view_proj_matrices(jc, W, H)
    return dict(color=g.uniform(0.0, 1.2, (H, W, 3)).astype(np.float32),
                world_pos=pos.astype(np.float32),
                normal=n.astype(np.float32), contributor=contrib,
                prim_id=pid.astype(np.int32), view=np.array(view),
                proj=np.array(proj))


def _jax_g(a):
    return jde.GBuffer(**{k: jnp.asarray(v) for k, v in a.items()})


def _port_g(a):
    return de.GBuffer(**{k: torch.as_tensor(v) for k, v in a.items()})


@pytest.mark.parametrize("size,moved", [((40, 32), 0.0), ((896, 896), 0.3)])
def test_view_proj_matrices_match_jax(size, moved):
    jc, pc = _camera_pair(moved)
    for want, got in zip(jcam.view_proj_matrices(jc, *size),
                         camera.view_proj_matrices(pc, *size)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_box_sum_matches_jax(rng_np, k):
    x = rng_np.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    want = np.asarray(jde._box_sum(jnp.asarray(x), k))
    got = de._box_sum(torch.as_tensor(x), k).numpy()
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)


def test_reproject_matches_jax():
    a, prev = _gbuffer_arrays(1), _gbuffer_arrays(2, moved=0.3)
    want = jde.reproject(jnp.asarray(a["world_pos"]), jnp.asarray(prev["view"]),
                         jnp.asarray(prev["proj"]), H, W)
    got = de.reproject(torch.as_tensor(a["world_pos"]),
                       torch.as_tensor(prev["view"]),
                       torch.as_tensor(prev["proj"]), H, W)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0 < np.asarray(want[2]).mean() < 1
    for i in (0, 1):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("clamp", [True, False])
def test_joint_bilateral_matches_jax(clamp):
    a = _gbuffer_arrays(3)
    want = np.asarray(jde.joint_bilateral(_jax_g(a), 3, clamp=clamp))
    got = de.joint_bilateral(_port_g(a), 3, clamp=clamp).numpy()
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)


def _border_misses(a: dict, width: int = 2) -> dict:
    """``a`` with misses on a ``width``-pixel ring along the frame's border
    (no contributor, position and normal zero, id -1)."""
    ring = np.ones((H, W), dtype=bool)
    ring[width:H - width, width:W - width] = False
    return dict(a, contributor=a["contributor"] & ~ring,
                world_pos=np.where(ring[..., None], 0.0,
                                   a["world_pos"]).astype(np.float32),
                normal=np.where(ring[..., None], 0.0,
                                a["normal"]).astype(np.float32),
                prim_id=np.where(ring, -1, a["prim_id"]).astype(np.int32))


@pytest.mark.parametrize("half_size,border", [
    pytest.param(3, False, id="3"), pytest.param(7, False, id="7"),
    pytest.param(16, False, id="16"), pytest.param(32, False, id="32"),
    pytest.param(7, True, id="7-border"),
    pytest.param(32, True, id="32-border")])
def test_joint_bilateral_atrous_matches_jax(half_size, border):
    a = _gbuffer_arrays(4)
    if border:
        a = _border_misses(a)
    want = np.asarray(jde.joint_bilateral_atrous(_jax_g(a), half_size))
    got = de.joint_bilateral_atrous(_port_g(a), half_size).numpy()
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)


@pytest.mark.parametrize("moved", [0.0, 0.3])
def test_temporal_matches_jax(moved):
    cur, prev = _gbuffer_arrays(5), _gbuffer_arrays(6, moved=moved)
    want = np.asarray(jde.temporal(_jax_g(cur), _jax_g(prev), 3, 1.0, 0.2))
    got = de.temporal(_port_g(cur), _port_g(prev), 3, 1.0, 0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=FILTER_RTOL, atol=FILTER_ATOL)
    # Some history was accepted and some rejected.
    assert 0.0 < np.mean(np.abs(got - cur["color"]) > 1e-6) < 1.0


def test_trace_first_hit_is_identical():
    scene, cam = ref.port_scene("cornell_sphere"), ref.port_camera()
    cfg = RenderConfig(width=24, height=20, max_depth=4, rr_survival=0.8)
    d = camera.perspective_rays(cam, 24, 20).reshape(-1, 3)
    o = cam.position.expand(d.shape)
    pixel = torch.arange(24 * 20)
    kw = dict(seed=ref.seed_word(2), pixel=pixel, sample=1)
    plain = mc.trace(scene, o, d, cfg, **kw)
    hit = intersect.intersect_scene(scene, o, d, t_min=cfg.t_min)
    peeled = mc.trace(scene, o, d, cfg, first_hit=hit, **kw)
    assert torch.equal(plain, peeled)


def test_global_prim_id():
    scene, cam = ref.port_scene("cornell_sphere"), ref.port_camera()
    d = camera.perspective_rays(cam, 32, 32).reshape(-1, 3)
    hit = intersect.intersect_scene(scene, cam.position.expand(d.shape), d,
                                    t_min=1e-3)
    pid = dn.global_prim_id(hit, scene.triangles.count)
    n_tri = scene.triangles.count
    assert pid.dtype == torch.int32
    assert torch.equal(pid[hit.is_triangle & hit.hit],
                       hit.prim[hit.is_triangle & hit.hit] + 1)
    assert bool((pid[~hit.is_triangle & hit.hit] == n_tri + 1).all())
    assert bool((pid[~hit.hit] == -1).all())


def test_render_gbuffer_matches_jax():
    kw = dict(width=40, height=40, max_depth=6, rr_survival=0.8)
    want = jdn.render_gbuffer(jcornell.cornell_scene(),
                              jcornell.cornell_camera(), JConfig(**kw),
                              jrng.render_key(3), 2, False)
    got = dn.render_gbuffer(cornell.cornell_scene(), cornell.cornell_camera(),
                            RenderConfig(**kw), ref.seed_word(3), 2, False,
                            device="cpu")
    for f in ("prim_id", "contributor"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    for f in ("color", "world_pos", "normal", "view", "proj"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=ref.RTOL, atol=ref.ATOL, err_msg=f)


def test_fused_frames_match_scan():
    """The single-path engine against the fixed-depth one through the
    whole frame pipeline over two frames (tests/test_denoise.py's gate)."""
    cfg = RenderConfig(width=40, height=40, max_depth=6, rr_survival=0.8)
    params = dn.DenoiserParams()
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    frames = {engine: dn.render_sequence(scene, [cam] * 2, cfg,
                                         ref.seed_word(3), params,
                                         engine=engine, device="cpu")
              for engine in ("scan", "fused")}
    for fused_frame, scan_frame in zip(frames["fused"], frames["scan"]):
        assert fused_frame.shape == (40, 40, 3)
        np.testing.assert_allclose(fused_frame.numpy(), scan_frame.numpy(),
                                   rtol=5e-3, atol=5e-3)
    with pytest.raises(ValueError, match="unknown engine"):
        dn.render_frame(scene, cam, cfg, 1, 0, None, params, engine="xla",
                        device="cpu")


@functools.lru_cache(maxsize=None)
def _golden_gbuffers(n_frames=4):
    """tools/make_goldens.denoiser_triple's frames (128x128, a static
    camera, ``render_key(3)``) as unclamped G-buffers of the fused engine:
    rendered once for the three goldens, which differ only in the clamp."""
    cfg = RenderConfig(width=128, height=128, max_depth=16, rr_survival=0.8)
    return tuple(dn.render_gbuffer_fused(
        cornell.cornell_scene(), cornell.cornell_camera(), cfg,
        ref.seed_word(3), i, immediate_clamping=False, device="cpu")
        for i in range(n_frames))


@pytest.mark.parametrize("name", ["denoiser_noisy_1spp", "denoiser_denoised",
                                  "denoiser_denoised_noclamp"])
def test_denoiser_goldens(tmp_path, name):
    """The three goldens (4 frames, JBF half-size 16) through the fused
    engine; ``immediate_clamping`` clamps the G-buffer color, as
    ``render_frame`` does."""
    params = dn.DenoiserParams(jbf_half_size=16,
                               immediate_clamping=not name.endswith("noclamp"))
    clamp = (lambda g: g.replace(color=torch.clamp(g.color, 0.0, 1.0))
             if params.immediate_clamping else g)
    gbufs = [clamp(g) for g in _golden_gbuffers()]
    if name == "denoiser_noisy_1spp":
        img = gbufs[-1].color
    else:
        prev = None
        for g in gbufs:
            img, prev = dn.denoise_frame(g, prev, params)
    path = tmp_path / f"{name}.png"
    im.write_png(path, tonemap.quantize_u8(img, gamma=1.0).numpy())
    assert_close_u8(im.read_png(path), im.read_png(f"{GOLD}/{name}.png"),
                    mean_tol=2.0, p99_tol=16)


def test_wrappers_refuse():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=8, height=8, max_depth=2)
    fs = fused.pack_scene(scene)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused.single_sample_gbuffer(fs, cam, cfg, 1, 0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dn.render_frame(scene, cam, cfg, 1, 0, None, dn.DenoiserParams(),
                            engine="fused")
    p = fused._Params(2, 8, 8, 64, 1e-3, 1e-5, 0.8, 1e-2, 2, 0,
                      single_path=True)
    sf = torch.zeros((15, 64))
    si = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fused._steps_kernel(fs, fused._camera_words(cam), 1, sf, si, p,
                            gb=torch.zeros((8, 64)))
