"""Retiring finished lanes in the fused MC stepper's gated modes
(``ops.fused._steps_plain(retire=True)``, the schedule of
``csrc/fused_mc.cu``) against the lockstep schedule: every state plane, the
shadow-ray counts and the single_path G-buffer bit for bit (compared as
int32 words, so -0.0 against +0.0 and NaN payloads count), and the
retiring render against the JAX scan engine at the JAX package's 2e-3."""

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

SEED = 4070199207   # seed_from_key(render_key(0)) of the JAX package
RETIRE = functools.partial(fused._steps_plain, retire=True)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_bit_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a) if a.is_floating_point() else a,
                           _bits(b) if b.is_floating_point() else b)


def _setup(name, w, h, depth, stop_after):
    scene = ref.port_scene(name)
    cam = ref.port_camera()
    cfg = RenderConfig(width=w, height=h, spp=stop_after, max_depth=depth,
                       rr_survival=0.8)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device="cpu")
    sf = torch.cat([x.T for x in (st.o, st.d, st.tp, st.cur, st.acc)],
                   0).contiguous()
    si = torch.stack([st.s, st.b, st.n_done,
                      torch.zeros_like(st.s)]).contiguous()
    r = w * h
    p = fused._Params(0, w, h, r, float(cfg.t_min), float(cfg.eps_offset),
                      0.8, float(cfg.shadow_tolerance), depth, stop_after)
    return fused.pack_scene(scene), fused._camera_words(cam), sf, si, p


@pytest.mark.parametrize("name,w,h,depth,stop_after", [
    ("cornell", 41, 37, 6, 2), ("cornell_sphere", 40, 32, 5, 3)])
def test_stop_after_retire_equals_lockstep(name, w, h, depth, stop_after):
    """render_turbo_exact's two launches (32 steps, then 64 more that most
    lanes enter done, at their fixed point): bit equal after each."""
    fs, cam16, sf, si, p = _setup(name, w, h, depth, stop_after)
    lock, ret = (sf, si), (sf, si)
    for n_steps in (32, 64):
        q = p._replace(n_steps=n_steps)
        lock = fused._steps_plain(fs, cam16, SEED, *lock, q)
        ret = RETIRE(fs, cam16, SEED, *ret, q)
        _assert_bit_equal(ret, lock)
    assert bool((lock[1][2] == stop_after).all())


def test_lanes_entering_done_are_at_their_fixed_point():
    """After a launch in which every lane met its quota, each lane is at
    the fixed point the kernel skips on entry, and a further launch moves
    no plane but the (zeroed) shadow-ray counts."""
    fs, cam16, sf, si, p = _setup("cornell", 24, 20, 5, 2)
    sf, si = fused._steps_plain(fs, cam16, SEED, sf, si,
                                p._replace(n_steps=48))
    assert bool((si[2] == 2).all())
    ln = fused.lanes(sf.shape[1], p.width, p.n_pix, 0, "cpu")
    fixed = fused._at_fixed_point(cam16, SEED, p, ln, list(sf.unbind(0)),
                                  si[0], si[1], si[2])
    assert bool(fixed.all())
    sf2, si2 = RETIRE(fs, cam16, SEED, sf, si, p._replace(n_steps=8))
    want = si.clone()
    want[3] = 0
    _assert_bit_equal((sf2, si2), (sf, want))
    _assert_bit_equal((sf2, si2), fused._steps_plain(
        fs, cam16, SEED, sf, si, p._replace(n_steps=8)))


def test_lanes_entering_done_off_their_fixed_point():
    """Lanes whose quota is met but that are not at the fixed point: cur or
    acc of -0.0 or a NaN with a payload, tp of either sign, a mid-path b,
    another origin or direction.  One step brings each there, bit equal to the
    lockstep launch.  Also lanes one sample short, with cur = acc = -0.0
    and a negative tp: a step that meets the quota after an occluded light
    sample adds -0.0 + -0.0 to acc, and the lane must take one more step
    (which adds +0) before it retires."""
    fs, cam16, sf, si, p = _setup("cornell", 32, 24, 5, 2)
    sf, si = fused._steps_plain(fs, cam16, SEED, sf, si,
                                p._replace(n_steps=48))
    assert bool((si[2] == 2).all())
    g = np.random.default_rng(3)
    r = sf.shape[1]

    def some(p_):
        return torch.as_tensor(g.random(r) < p_)

    nan = torch.tensor([0x7FC01234], dtype=torch.int32).view(torch.float32)
    odd = torch.as_tensor(g.choice(
        np.array([-0.0, 0.0, 1.5, -2.0, np.nan], np.float32), size=(6, r)))
    odd[:, :8] = torch.cat([nan, torch.tensor([-0.0])]).repeat(4)
    pick = some(0.4)
    pick[:8] = True
    sf[9:15] = torch.where(pick, odd, sf[9:15])
    tp = torch.as_tensor(g.choice([-1.0, -0.5, 0.0, 0.25], size=(3, r))
                         .astype(np.float32))
    sf[6:9] = torch.where(some(0.2), tp, sf[6:9])
    si[1] = torch.where(some(0.1), 2, si[1])
    sf[0] = torch.where(some(0.1), sf[0] + 0.5, sf[0])
    sf[3] = torch.where(some(0.1), -sf[3], sf[3])
    assert bool((_bits(sf[9:15]) == _bits(torch.tensor(-0.0))).any())
    short = some(0.3)
    short[:8] = False
    si[2] = torch.where(short, p.stop_after - 1, si[2])
    si[1] = torch.where(short & some(0.5), p.max_depth - 1, si[1])
    sf[9:15] = torch.where(short, -0.0, sf[9:15])
    sf[6:9] = torch.where(short, -1.0, sf[6:9])
    one = fused._steps_plain(fs, cam16, SEED, sf.clone(), si.clone(),
                             p._replace(n_steps=1))
    neg_zero = (_bits(one[0][12:15]) == _bits(torch.tensor(-0.0))).any(0)
    assert int((short & (one[1][2] == p.stop_after) & neg_zero).sum()) > 0
    for n_steps in (1, 2, 7):
        q = p._replace(n_steps=n_steps)
        want = fused._steps_plain(fs, cam16, SEED, sf.clone(), si.clone(), q)
        _assert_bit_equal(RETIRE(fs, cam16, SEED, sf.clone(), si.clone(), q),
                          want)
        assert not torch.equal(_bits(want[0]), _bits(sf))


@pytest.mark.parametrize("name,w,h,depth", [("cornell", 41, 37, 8),
                                            ("cornell_sphere", 40, 32, 16)])
def test_single_path_retire_equals_lockstep(name, w, h, depth):
    """The Denoiser's G-buffer launch: planes, shadow-ray counts and every
    G-buffer plane bit equal."""
    scene, cam = ref.port_scene(name), ref.port_camera()
    cfg = RenderConfig(width=w, height=h, max_depth=depth, rr_survival=0.8)
    cam16, sf, si, gb, p = fused._gbuffer_setup(cam, cfg, 3, "cpu")
    fs = fused.pack_scene(scene)
    gb2 = gb.clone()
    want = fused._steps_plain(fs, cam16, SEED, sf, si, p, gb=gb)
    got = RETIRE(fs, cam16, SEED, sf, si, p, gb=gb2)
    _assert_bit_equal(got + (gb2,), want + (gb,))
    assert bool((want[1][2] == 1).all())


def test_plain_mode_ignores_retire():
    fs, cam16, sf, si, p = _setup("cornell", 16, 12, 4, 0)
    q = p._replace(n_steps=6)
    _assert_bit_equal(RETIRE(fs, cam16, SEED, sf, si, q),
                      fused._steps_plain(fs, cam16, SEED, sf, si, q))


def test_retiring_render_matches_jax_render():
    """render_turbo_exact's schedule through the retiring plain stepper
    against the JAX scan engine (as test_torch_mc's lockstep case)."""
    kw = dict(width=32, height=32, spp=3, max_depth=5, rr_survival=0.8)
    want = np.asarray(jmc.render(jcornell.cornell_scene(),
                                 jcornell.cornell_camera(), JConfig(**kw),
                                 jrng.render_key(8)))
    scene, cam, cfg = ref.port_scene("cornell"), ref.port_camera(), \
        RenderConfig(**kw)
    seed = ref.seed_word(8)
    fs = fused.pack_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    chunk = max(32, cfg.max_depth)
    while True:
        st = fused._run(RETIRE, fs, cam, cfg, seed, st, chunk, cfg.spp)
        if int(torch.min(st.n_done)) >= cfg.spp:
            break
        chunk *= 2
    got = (st.acc / float(cfg.spp)).reshape(32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)
