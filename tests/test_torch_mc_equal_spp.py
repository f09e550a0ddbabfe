"""The rest of the port's Monte Carlo forward path against the JAX package:
the equal-spp wavefront engine (``render_wavefront``, ``render_fast``),
the slab arguments of the plain stepper (``_primary_rays(pixel_offset,
height)``, ``wavefront_init(pixel_offset, n_lanes)``,
``wavefront_steps(pixel_offset)``) and ``render_turbo(min_spp)``.

Integer lane state and ray counts exactly; radiance and float state to the
JAX package's 2e-3; the wavefront engine against the port's scan engine to
1e-5 (``tests/test_mc.py:110-118``); slabs concatenate bit for bit."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused

import torch_ref as ref

# name -> (config kwargs, key, start_sample)
CASES = {
    "cornell_24x16": (dict(width=24, height=16, spp=3, max_depth=5), 5, 0),
    "ragged_41x37": (dict(width=41, height=37, spp=2, max_depth=3,
                          rr_survival=0.5), 7, 3),
}


def _accum(kw, start):
    """The accumulator to add onto: zeros at start_sample 0, else seeded."""
    shape = (kw["height"], kw["width"], 3)
    if start == 0:
        return np.zeros(shape, np.float32)
    return np.random.default_rng(1).random(shape).astype(np.float32)


# The JAX oracles are jitted: one compile, not one for each eager operation.
@functools.lru_cache(maxsize=None)
def _jax_wavefront(case):
    kw, k, start = CASES[case]
    acc, nxt, n = jax.jit(lambda a: jmc.render_wavefront(
        jcornell.cornell_scene(), jcornell.cornell_camera(), JConfig(**kw),
        jrng.render_key(k), a, start, return_rays=True))(
            jnp.asarray(_accum(kw, start)))
    return np.asarray(acc), int(nxt), int(n)


@pytest.mark.parametrize("case", list(CASES))
def test_render_wavefront_matches_jax(case):
    kw, k, start = CASES[case]
    want, want_next, want_rays = _jax_wavefront(case)
    got, nxt, n = mc.render_wavefront(
        ref.port_scene("cornell"), ref.port_camera(), RenderConfig(**kw),
        ref.seed_word(k), torch.as_tensor(_accum(kw, start)), start,
        return_rays=True, device="cpu")
    assert nxt == want_next == start + kw["spp"]
    assert n.dtype == torch.int32 and int(n) == want_rays > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_render_fast_matches_jax(case):
    kw, k, _ = CASES[case]
    want = np.asarray(jax.jit(lambda: jmc.render_fast(
        jcornell.cornell_scene(), jcornell.cornell_camera(), JConfig(**kw),
        jrng.render_key(k)))())
    got = mc.render_fast(ref.port_scene("cornell"), ref.port_camera(),
                         RenderConfig(**kw), ref.seed_word(k), device="cpu")
    assert got.shape == want.shape and float(got.mean()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


def test_render_fast_matches_scan_render():
    """The two engines trace the same paths; only the order of the sums
    differs (``tests/test_mc.py:110-118``)."""
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=24, height=16, spp=3, max_depth=5)
    a = mc.render(scene, cam, cfg, ref.seed_word(5), device="cpu")
    b = mc.render_fast(scene, cam, cfg, ref.seed_word(5), device="cpu")
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_wavefront_rays_at_one_spp_equal_count_rays():
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=5)
    n_scan = mc.count_rays(scene, cam, cfg, ref.seed_word(6))
    _, _, n_wf = mc.render_wavefront(scene, cam, cfg, ref.seed_word(6),
                                     torch.zeros((16, 16, 3)), 0,
                                     return_rays=True, device="cpu")
    assert int(n_wf) == int(n_scan) > 0


def test_render_wavefront_lane_past_quota_adds_nothing():
    """A lane past its quota traces no ray and adds +0.0: the engine's ray
    count over spp samples is the scan engine's, sample by sample, and no
    radiance sum is -0.0."""
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=8, height=6, spp=2, max_depth=6)
    seed = ref.seed_word(3)
    acc, _, n = mc.render_wavefront(scene, cam, cfg, seed,
                                    torch.zeros((6, 8, 3)), 0,
                                    return_rays=True, device="cpu")
    total = 0
    for s in range(cfg.spp):
        o, d, pixel = mc._primary_rays(cam, cfg, seed, s)
        _, k = mc.trace(scene, o, d, cfg, seed=seed, pixel=pixel, sample=s,
                        count_rays=True)
        total += int(k)
    assert int(n) == total
    assert not torch.signbit(acc).any()


# --- slabs ----------------------------------------------------------------

SLAB_CFG = dict(width=24, height=16, spp=2, max_depth=4, rr_survival=0.8)
SLAB_KEY, SLAB_STEPS = 9, 5
# (pixel_offset, n_lanes): 4 whole rows from row 2; 100 lanes from pixel 37
SLABS = {"rows": (48, 96), "ragged": (37, 100)}


@functools.lru_cache(maxsize=None)
def _jax_slab(name):
    off, n = SLABS[name]
    scene, cam = jcornell.cornell_scene(), jcornell.cornell_camera()
    cfg, key = JConfig(**SLAB_CFG), jrng.render_key(SLAB_KEY)

    def init_and_steps():
        st0 = jmc.wavefront_init(scene, cam, cfg, key, pixel_offset=off,
                                 n_lanes=n)
        return st0, jmc.wavefront_steps(scene, cam, cfg, key, st0,
                                        SLAB_STEPS, pixel_offset=off)

    st0, st1 = jax.jit(init_and_steps)()
    return ref.state_numpy(st0), ref.state_numpy(st1)


@pytest.mark.parametrize("name", list(SLABS))
def test_wavefront_init_slab_matches_jax(name):
    off, n = SLABS[name]
    want, _ = _jax_slab(name)
    got = mc.wavefront_init(ref.port_scene("cornell"), ref.port_camera(),
                            RenderConfig(**SLAB_CFG), ref.seed_word(SLAB_KEY),
                            pixel_offset=off, n_lanes=n, device="cpu")
    assert got.s.shape == (n,)
    ref.assert_states_match(want, ref.state_numpy(got))
    np.testing.assert_allclose(got.d.numpy(), want["d"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(SLABS))
def test_wavefront_steps_slab_matches_jax(name):
    off, n = SLABS[name]
    _, want = _jax_slab(name)
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg, seed = RenderConfig(**SLAB_CFG), ref.seed_word(SLAB_KEY)
    st = mc.wavefront_init(scene, cam, cfg, seed, pixel_offset=off,
                           n_lanes=n, device="cpu")
    got = mc.wavefront_steps(scene, cam, cfg, seed, st, SLAB_STEPS,
                             pixel_offset=off)
    ref.assert_states_match(want, ref.state_numpy(got))
    assert int(got.nrays) > 0


@pytest.mark.parametrize("off,height", [(0, None), (48, 5)])
def test_primary_rays_slab_matches_jax(off, height):
    cfg = RenderConfig(**SLAB_CFG)
    seed = ref.seed_word(SLAB_KEY)
    jo, jd, jp = jmc._primary_rays(jcornell.cornell_camera(),
                                   JConfig(**SLAB_CFG), np.uint32(seed), 1,
                                   pixel_offset=off, height=height)
    o, d, p = mc._primary_rays(ref.port_camera(), cfg, seed, 1,
                               pixel_offset=off, height=height)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cut", [96, 100], ids=["rows", "ragged"])
def test_slabs_concatenate_bit_equal(cut):
    """Two slabs, initialised and stepped on their own, are the whole
    image's state bit for bit; their ray counts sum to its count."""
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg, seed = RenderConfig(**SLAB_CFG), ref.seed_word(SLAB_KEY)
    r = cfg.width * cfg.height
    whole = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    parts0, parts1 = [], []
    for a, b in ((0, cut), (cut, r)):
        st = mc.wavefront_init(scene, cam, cfg, seed, pixel_offset=a,
                               n_lanes=b - a, device="cpu")
        parts0.append(st)
        parts1.append(mc.wavefront_steps(scene, cam, cfg, seed, st,
                                         SLAB_STEPS, pixel_offset=a))
    stepped = mc.wavefront_steps(scene, cam, cfg, seed, whole, SLAB_STEPS)
    for want, parts in ((whole, parts0), (stepped, parts1)):
        for f in ("s", "b", "n_done", "o", "d", "tp", "cur", "acc"):
            got = torch.cat([getattr(p, f) for p in parts])
            w = getattr(want, f)
            if w.is_floating_point():
                got, w = got.view(torch.int32), w.contiguous().view(
                    torch.int32)
            assert torch.equal(got, w), f
        assert int(sum(p.nrays for p in parts)) == int(want.nrays)


# --- render_turbo(min_spp) ---------------------------------------------------

@pytest.mark.parametrize("spp,min_spp", [(1, 3), (4, 1)])
def test_render_turbo_min_spp(spp, min_spp):
    """``render_turbo(min_spp=k)`` steps the fused stepper in chunks until
    every pixel has k samples: the same image as stepping its plain version
    in those chunks, bit for bit."""
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=16, height=12, spp=spp, max_depth=4)
    seed = ref.seed_word(1)
    got = mc.render_turbo(scene, cam, cfg, seed, min_spp=min_spp,
                          device="cpu")
    fs = fused.pack_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    chunks = 0
    while int(st.n_done.min()) < min_spp:
        st = fused.wavefront_steps_fused_plain(fs, cam, cfg, seed, st,
                                               max(32, cfg.max_depth))
        chunks += 1
    assert chunks >= 1 and int(st.n_done.min()) >= min_spp
    want = mc.wavefront_image(st, cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_equal_spp_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    with pytest.raises(RuntimeError):
        mc.render_wavefront(scene, cam, cfg, 0, torch.zeros((8, 8, 3)), 0)
    with pytest.raises(RuntimeError):
        mc.render_fast(scene, cam, cfg, 0)
