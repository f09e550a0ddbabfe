"""The port's Monte Carlo slice against the JAX package: the PyTorch twin of
the XLA wavefront engine, the fused kernel's plain version (the CPU path of
``wavefront_steps_fused``), and ``render_turbo_exact`` against the JAX scan
engine.  The plain version's ``stop_after`` mode against the JAX Pallas
kernel itself is in ``test_torch_fused_interpret.py``.

Integer lane state (s, b, n_done) and the ray counter must match exactly;
float state and images to the JAX package's own 2e-3."""

import functools

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused

import torch_ref as ref

# name -> (scene, config kwargs, n_steps, key)
CASES = {
    "cornell_48": ("cornell", dict(width=48, height=48, spp=4, max_depth=4,
                                   rr_survival=0.8), 6, 7),
    "ragged_41x37": ("cornell", dict(width=41, height=37, spp=2, max_depth=3,
                                     rr_survival=0.5), 4, 7),
    "sphere_40x32": ("cornell_sphere", dict(width=40, height=32, spp=4,
                                            max_depth=4, rr_survival=0.8),
                     6, 11),
}


def _port_inputs(case):
    name, kw, n_steps, k = CASES[case]
    return (ref.port_scene(name), ref.port_camera(), RenderConfig(**kw),
            ref.seed_word(k), n_steps)


@functools.lru_cache(maxsize=None)
def _jax_steps(case):
    """JAX XLA engine: (initial state, state after n_steps) as numpy."""
    name, kw, n_steps, k = CASES[case]
    scene, cam = ref.jax_scene(name), jcornell.cornell_camera()
    cfg, key = JConfig(**kw), jrng.render_key(k)
    st0 = jmc.wavefront_init(scene, cam, cfg, key)
    st1 = jmc.wavefront_steps(scene, cam, cfg, key, st0, n_steps)
    return ref.state_numpy(st0), ref.state_numpy(st1)


@pytest.mark.parametrize("case", list(CASES))
def test_wavefront_init_matches_jax(case):
    scene, cam, cfg, seed, _ = _port_inputs(case)
    want, _ = _jax_steps(case)
    got = ref.state_numpy(mc.wavefront_init(scene, cam, cfg, seed,
                                            device="cpu"))
    ref.assert_states_match(want, got)
    np.testing.assert_allclose(got["d"], want["d"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_wavefront_steps_matches_jax(case):
    scene, cam, cfg, seed, n_steps = _port_inputs(case)
    _, want = _jax_steps(case)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    got = ref.state_numpy(mc.wavefront_steps(scene, cam, cfg, seed, st,
                                             n_steps))
    ref.assert_states_match(want, got)
    assert got["nrays"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_fused_plain_matches_jax_wavefront(case):
    scene, cam, cfg, seed, n_steps = _port_inputs(case)
    _, want = _jax_steps(case)
    fs = fused.pack_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    plain = fused.wavefront_steps_fused_plain(fs, cam, cfg, seed, st, n_steps)
    ref.assert_states_match(want, ref.state_numpy(plain))
    # On CPU tensors the wrapper runs exactly the plain version.
    launches = fused.LAUNCHES["fused_mc"]
    wrapped = fused.wavefront_steps_fused(fs, cam, cfg, seed, st, n_steps,
                                          device="cpu")
    assert fused.LAUNCHES["fused_mc"] == launches
    for a, b in zip(ref.state_numpy(plain).values(),
                    ref.state_numpy(wrapped).values()):
        np.testing.assert_array_equal(a, b)


def test_render_turbo_exact_matches_jax_render():
    """The whole slice: the port's equal-spp fused render (plain version on
    the CPU) against the JAX scan engine, as tests/test_fused.py holds the
    JAX fused render."""
    kw = dict(width=32, height=32, spp=3, max_depth=5, rr_survival=0.8)
    want = np.asarray(jmc.render(jcornell.cornell_scene(),
                                 jcornell.cornell_camera(), JConfig(**kw),
                                 jrng.render_key(8)))
    got = mc.render_turbo_exact(ref.port_scene("cornell"), ref.port_camera(),
                                RenderConfig(**kw), ref.seed_word(8),
                                device="cpu")
    assert got.shape == (32, 32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


def test_fixed_depth_render_and_ray_count_match_jax():
    kw = dict(width=24, height=20, spp=2, max_depth=4, rr_survival=0.8)
    jscene, jcam = jcornell.cornell_scene(), jcornell.cornell_camera()
    key = jrng.render_key(6)
    want = np.asarray(jmc.render(jscene, jcam, JConfig(**kw), key))
    n_want = int(jmc.count_rays(jscene, jcam, JConfig(**kw), key))
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg, seed = RenderConfig(**kw), ref.seed_word(6)
    got = mc.render(scene, cam, cfg, seed, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)
    assert int(mc.count_rays(scene, cam, cfg, seed)) == n_want
    acc, nxt = mc.render_progressive(scene, cam, cfg, seed,
                                     torch.zeros((20, 24, 3)), 0)
    assert nxt == 2
    torch.testing.assert_close(acc / 2.0, got)


def test_occluded_matches_jax(rng_np):
    from cpu_based_ray_tracer_tpu.ops import intersect as jintersect
    from cpu_based_ray_tracer_tpu_torch.ops import intersect

    o = rng_np.uniform(0.3, 5.0, size=(2000, 3)).astype(np.float32)
    d = rng_np.normal(size=(2000, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dist = rng_np.uniform(0.1, 6.0, size=2000).astype(np.float32)
    want = np.asarray(jintersect.occluded(ref.jax_scene("cornell_sphere"),
                                          o, d, dist, t_min=1e-3))
    got = intersect.occluded(ref.port_scene("cornell_sphere"),
                             torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(dist), t_min=1e-3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_render_turbo_reaches_min_spp():
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=4)
    img = mc.render_turbo(scene, cam, cfg, ref.seed_word(1), device="cpu")
    assert img.shape == (12, 16, 3)
    assert torch.isfinite(img).all() and img.mean() > 0


def test_wavefront_image_is_mean_of_completed_samples():
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=16, height=12, spp=2, max_depth=4)
    st = mc.wavefront_init(scene, cam, cfg, 3, device="cpu")
    st = mc.wavefront_steps(scene, cam, cfg, 3, st, 8)
    img = mc.wavefront_image(st, cfg).reshape(-1, 3)
    n = st.n_done.clamp(min=1).to(torch.float32)[:, None]
    torch.testing.assert_close(img, st.acc / n)
