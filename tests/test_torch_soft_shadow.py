"""Soft shadows (``soft_shadow_beta > 0``) in the port's plain Monte Carlo
engines against the JAX package: the sigmoid-relaxed visibility
(``ops.intersect.soft_visibility`` and its triangle and sphere cores), the
mesh-gated ``models.mesh.make_soft_vis_fn``, and every plain engine that
steps through ``_bounce_step`` at beta = 0.5.  The fused steppers refuse
beta > 0, as the JAX package's do; the hard mode (beta = 0) still matches
the JAX package.

Tolerances: images and float lane state 2e-3 with integer lane state
exactly (the JAX package's own); the visibility functions 1e-6 absolute
(measured up to 1.2e-7: ``torch.sigmoid`` and ``jax.nn.sigmoid``, and the
two products, round apart by an ulp or two); the gated visibility against
the brute one, and against JAX's on its own test's scene, rtol = atol =
2e-4 (``tests/test_grad_mesh.py:88-108``; measured 2.4e-7 and 2.4e-5:
JAX's box cuts more of the sigmoid tail, see ``make_soft_vis_fn``);
against JAX's jitted one where both gate every lane, 1e-5 (measured
5.1e-7: jitted XLA CPU code contracts multiply-adds, and the sigmoid
scales a margin's rounding by 1 / beta)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import denoiser as jdenoiser
from cpu_based_ray_tracer_tpu.models import mesh as jmesh
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.ops import intersect as jintersect
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import denoiser, mesh
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused, fused_mesh, intersect
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

import torch_ref as ref

BETA = 0.5
VIS_ATOL = 1e-6
GATED_ATOL = 1e-5


def _mesh_scenes():
    ico = meshes.icosphere(1)
    return cornell.cornell_mesh_scene(ico), jcornell.cornell_mesh_scene(ico)


# --- the engines at beta = 0.5 -----------------------------------------------

def _render():
    """Cornell 24x24, 2 spp: every one of the 576 pixels within 2e-3 of
    JAX, where the hard-shadow image is off on most of them."""
    kw = dict(width=24, height=24, spp=2, max_depth=4, rr_survival=0.8,
              soft_shadow_beta=BETA)
    want = np.asarray(jmc.render(jcornell.cornell_scene(),
                                 jcornell.cornell_camera(), JConfig(**kw),
                                 jrng.render_key(0)))
    scene, cam, seed = ref.port_scene("cornell"), ref.port_camera(), \
        ref.seed_word(0)
    got = mc.render(scene, cam, RenderConfig(**kw), seed, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ref.ATOL)
    hard = mc.render(scene, cam, RenderConfig(**kw).replace(
        soft_shadow_beta=0.0), seed, device="cpu").numpy()
    assert (np.abs(hard - want).max(-1) > ref.ATOL).sum() > 576 // 2


def _wavefront_steps():
    kw = dict(width=16, height=12, spp=2, max_depth=4, soft_shadow_beta=BETA)
    scene, cam, cfg = (jcornell.cornell_scene(), jcornell.cornell_camera(),
                       JConfig(**kw))
    key = jrng.render_key(4)
    want = jmc.wavefront_steps(scene, cam, cfg, key,
                               jmc.wavefront_init(scene, cam, cfg, key), 5)
    pscene, pcam, pcfg = (ref.port_scene("cornell"), ref.port_camera(),
                          RenderConfig(**kw))
    st = mc.wavefront_init(pscene, pcam, pcfg, ref.seed_word(4),
                           device="cpu")
    got = mc.wavefront_steps(pscene, pcam, pcfg, ref.seed_word(4), st, 5)
    ref.assert_states_match(ref.state_numpy(want), ref.state_numpy(got))


def _render_wavefront():
    kw = dict(width=16, height=12, spp=2, max_depth=4, soft_shadow_beta=BETA)
    want, _, want_n = jmc.render_wavefront(
        jcornell.cornell_scene(), jcornell.cornell_camera(), JConfig(**kw),
        jrng.render_key(8), jnp.zeros((12, 16, 3)), 0, return_rays=True)
    got, _, n = mc.render_wavefront(
        ref.port_scene("cornell"), ref.port_camera(), RenderConfig(**kw),
        ref.seed_word(8), torch.zeros((12, 16, 3)), 0, return_rays=True,
        device="cpu")
    assert int(n) == int(want_n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ref.RTOL,
                               atol=ref.ATOL)


def _mesh_render_mc():
    """The main rays through the packet intersector (JAX: its Pallas kernel
    in interpret mode), the shadow term brute soft visibility."""
    scene, jscene = _mesh_scenes()
    kw = dict(width=8, height=8, spp=1, max_depth=2, soft_shadow_beta=BETA)
    want = np.asarray(jmesh.render_mc(
        jmesh.prepare(jscene, method="packet"), jcornell.cornell_camera(),
        JConfig(**kw), jrng.render_key(5)))
    got = mesh.render_mc(mesh.prepare(scene, method="packet"),
                         cornell.cornell_camera(), RenderConfig(**kw),
                         ref.seed_word(5), device="cpu")
    assert float(got.mean()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


def _mesh_wavefront_mc_steps():
    scene, jscene = _mesh_scenes()
    kw = dict(width=8, height=6, spp=2, max_depth=3, soft_shadow_beta=BETA)
    jc, key = jcornell.cornell_camera(), jrng.render_key(9)
    st0 = jmc.wavefront_init(jscene, jc, JConfig(**kw), key)
    want = jmesh.wavefront_mc_steps(jmesh.prepare(jscene, method="packet"),
                                    jc, JConfig(**kw), key, st0, 3)
    cam, cfg, seed = cornell.cornell_camera(), RenderConfig(**kw), \
        ref.seed_word(9)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    got = mesh.wavefront_mc_steps(mesh.prepare(scene, method="packet"), cam,
                                  cfg, seed, st, 3)
    ref.assert_states_match(ref.state_numpy(want), ref.state_numpy(got))


def _render_gbuffer():
    kw = dict(width=8, height=8, spp=1, max_depth=3, soft_shadow_beta=BETA)
    # Jitted: one compile in place of one for each eager operation.
    want = jax.jit(lambda: jdenoiser.render_gbuffer(
        jcornell.cornell_scene(), jcornell.cornell_camera(), JConfig(**kw),
        jrng.render_key(3), 2, immediate_clamping=False))()
    got = denoiser.render_gbuffer(ref.port_scene("cornell"),
                                  ref.port_camera(), RenderConfig(**kw),
                                  ref.seed_word(3), 2,
                                  immediate_clamping=False, device="cpu")
    np.testing.assert_array_equal(got.prim_id.numpy(),
                                  np.asarray(want.prim_id))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               rtol=ref.RTOL, atol=ref.ATOL)
    assert float(got.color.mean()) > 0.0


ENGINES = {"render": _render, "wavefront_steps": _wavefront_steps,
           "mesh_render_mc": _mesh_render_mc,
           "render_gbuffer": _render_gbuffer,
           "render_wavefront": _render_wavefront,
           "mesh_wavefront_mc_steps": _mesh_wavefront_mc_steps}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_soft_shadows_match_jax(engine):
    ENGINES[engine]()


def test_hard_shadows_match_jax():
    kw = dict(width=24, height=24, spp=2, max_depth=4, rr_survival=0.8)
    want = np.asarray(jmc.render(jcornell.cornell_scene(),
                                 jcornell.cornell_camera(), JConfig(**kw),
                                 jrng.render_key(0)))
    got = mc.render(ref.port_scene("cornell"), ref.port_camera(),
                    RenderConfig(**kw), ref.seed_word(0), device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)
    assert want.max() > 0.0


# --- the fused steppers refuse beta > 0 --------------------------------------

def _fused_steps(scene, cam, cfg):
    st = mc.wavefront_init(scene, cam, cfg, 1, device="cpu")
    fused.wavefront_steps_fused(fused.pack_scene(scene), cam, cfg, 1, st, 1,
                                device="cpu")


def _render_turbo_exact(scene, cam, cfg):
    mc.render_turbo_exact(scene, cam, cfg, 1, device="cpu")


def _fused_mesh_steps(scene, cam, cfg):
    mscene, _ = _mesh_scenes()
    st = mc.wavefront_init(mscene, cam, cfg, 1, device="cpu")
    fused_mesh.wavefront_steps_fused_mesh(fused_mesh.pack_mesh_scene(mscene),
                                          cam, cfg, 1, st, 1, device="cpu")


@pytest.mark.parametrize("engine", [_fused_steps, _render_turbo_exact,
                                    _fused_mesh_steps],
                         ids=["wavefront_steps_fused", "render_turbo_exact",
                              "wavefront_steps_fused_mesh"])
def test_fused_steppers_refuse_soft_shadows(engine):
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                       soft_shadow_beta=BETA)
    with pytest.raises(NotImplementedError, match="hard shadow test"):
        engine(cornell.cornell_scene(), cornell.cornell_camera(), cfg)


# --- the visibility functions ------------------------------------------------

def _segments(n: int, seed: int, scene):
    """Seeded shadow segments in the Cornell room: origins inside it,
    unit directions, lengths; every fourth segment ends inside the
    tolerance window just past its nearest hit (t + 0.005)."""
    g = np.random.default_rng(seed)
    p = g.uniform([0.2, 0.2, 0.2], [3.5, 3.5, 3.3], (n, 3)).astype(np.float32)
    w = g.standard_normal((n, 3))
    w = (w / np.linalg.norm(w, axis=-1, keepdims=True)).astype(np.float32)
    dist = g.uniform(0.5, 4.0, (n,)).astype(np.float32)
    t = intersect.nearest_t(scene, torch.as_tensor(p), torch.as_tensor(w),
                            t_min=1e-3).numpy()
    edge = (np.arange(n) % 4 == 0) & (t < 1e3)
    dist[edge] = t[edge] + np.float32(0.005)
    return p, w, dist


def _odd_triangles():
    """The Cornell triangles plus a zero-area one, a near-degenerate sliver
    and a tiny one, all inside the room."""
    tr = ref.jax_scene("cornell").triangles
    v0, e1, e2 = (np.asarray(x) for x in (tr.v0, tr.e1, tr.e2))
    ov0 = np.array([[1.0, 1.0, 1.0], [1.5, 2.0, 1.5], [2.0, 1.5, 2.0]],
                   np.float32)
    oe1 = np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [1e-3, 0.0, 0.0]],
                   np.float32)
    oe2 = np.array([[2.0, 0.0, 0.0], [1.0, 1.0, 1e-6], [0.0, 1e-3, 0.0]],
                   np.float32)
    v0, e1, e2 = (np.concatenate([a, b]) for a, b in
                  ((v0, ov0), (e1, oe1), (e2, oe2)))
    area = (0.5 * np.linalg.norm(np.cross(e1.astype(np.float64),
                                          e2.astype(np.float64)), axis=-1)
            ).astype(np.float32)
    return v0, e1, e2, area


@pytest.mark.parametrize("beta", [0.05, BETA])
def test_soft_visibility_tris_matches_jax(beta):
    arrs = _odd_triangles()
    p, w, dist = _segments(512, 1, ref.port_scene("cornell"))
    want = np.asarray(jintersect.soft_visibility_tris(
        *map(jnp.asarray, arrs), p, w, dist, 1e-3, beta, 0.01))
    got = intersect.soft_visibility_tris(
        *map(torch.as_tensor, arrs), torch.as_tensor(p), torch.as_tensor(w),
        torch.as_tensor(dist), 1e-3, beta, 0.01)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VIS_ATOL)
    assert want.max() == 1.0 and (want < 0.5).any()


def test_soft_visibility_spheres_matches_jax():
    """A zero-radius sphere covers nothing; a negative radius covers by its
    magnitude."""
    center = np.array([[1.6, 2.6, 1.7], [2.0, 1.0, 2.0], [1.0, 3.0, 1.0]],
                      np.float32)
    radius = np.array([0.7, 0.0, -0.4], np.float32)
    p, w, dist = _segments(512, 2, ref.port_scene("cornell"))
    want = np.asarray(jintersect.soft_visibility_spheres(
        center, radius, p, w, dist, 1e-3, 0.05, 0.01))
    got = intersect.soft_visibility_spheres(
        torch.as_tensor(center), torch.as_tensor(radius), torch.as_tensor(p),
        torch.as_tensor(w), torch.as_tensor(dist), 1e-3, 0.05, 0.01)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VIS_ATOL)
    only_zero = intersect.soft_visibility_spheres(
        torch.as_tensor(center[1:2]), torch.as_tensor(radius[1:2]),
        torch.as_tensor(p), torch.as_tensor(w), torch.as_tensor(dist), 1e-3,
        0.05, 0.01)
    assert torch.equal(only_zero, torch.ones_like(only_zero))
    assert (want < 0.5).any()


def test_soft_visibility_matches_jax():
    jscene = ref.jax_scene("cornell_sphere")
    scene = ref.port_scene("cornell_sphere")
    p, w, dist = _segments(1024, 3, scene)
    want = np.asarray(jintersect.soft_visibility(jscene, p, w, dist, 1e-3,
                                                 0.05, 0.01))
    got = intersect.soft_visibility(scene, torch.as_tensor(p),
                                    torch.as_tensor(w), torch.as_tensor(dist),
                                    1e-3, 0.05, 0.01)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VIS_ATOL)


# --- the mesh-gated visibility -----------------------------------------------

def _jax_gated(jscene, mask, cap, p, w, dist, beta):
    fn = jmesh.make_soft_vis_fn(jscene, gate_mask=mask, cap=cap)
    return np.asarray(jax.jit(lambda a, b, c: fn(jscene, a, b, c, 1e-3, beta,
                                                 0.01))(p, w, dist))


def _port_args(p, w, dist, beta=0.05):
    return (torch.as_tensor(p), torch.as_tensor(w), torch.as_tensor(dist),
            1e-3, beta, 0.01)


@pytest.mark.parametrize("gate", ["default", "arange22"])
def test_gated_soft_visibility_matches_jax_and_brute(gate):
    """On the JAX package's own test scene (an icosphere(1) mesh) and
    segments like its test's, the gated visibility is JAX's and the brute
    one to the tolerance of ``tests/test_grad_mesh.py:88-108``."""
    scene, jscene = _mesh_scenes()
    p, w, dist = _segments(256, 4, scene)
    mask = (None if gate == "default"
            else np.arange(scene.triangles.count) >= 22)
    want = _jax_gated(jscene, mask, None, p, w, dist, 0.05)
    args = _port_args(p, w, dist)
    got = mesh.make_soft_vis_fn(scene, gate_mask=mask)(scene, *args)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    brute = intersect.soft_visibility(scene, *args)
    np.testing.assert_allclose(got.numpy(), brute.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert (brute.numpy() < 0.5).any()


def test_gated_soft_visibility_matches_brute_near_the_mesh():
    """Many segments near a finer mesh (icosphere(2), 320 triangles): the
    port's box keeps every lane within 2e-4 of the brute estimator.  The
    JAX package's box (inflated by 10 beta max sqrt(2A)) cuts coverage
    above the bound on lanes that pass near the mesh."""
    ico = meshes.icosphere(2)
    scene, jscene = (cornell.cornell_mesh_scene(ico),
                     jcornell.cornell_mesh_scene(ico))
    p, w, dist = _segments(2048, 5, scene)
    args = _port_args(p, w, dist)
    brute = intersect.soft_visibility(scene, *args).numpy()
    got = mesh.make_soft_vis_fn(scene)(scene, *args).numpy()
    np.testing.assert_allclose(got, brute, rtol=2e-4, atol=2e-4)
    jax_gated = _jax_gated(jscene, None, None, p, w, dist, 0.05)
    assert (np.abs(jax_gated - brute) > 2e-4 + 2e-4 * brute).any()


def test_gated_soft_visibility_cap():
    """Past ``cap`` crossing lanes a lane keeps mesh visibility 1, as JAX's
    ``nonzero(size=cap)`` and dropped scatter give.  Gating the room's
    walls, every segment crosses the box in both packages, so the capped
    lanes are the same ones."""
    scene, jscene = _mesh_scenes()
    p, w, dist = _segments(256, 6, scene)
    mask = np.arange(scene.triangles.count) < 12
    cap = 100
    want = _jax_gated(jscene, mask, cap, p, w, dist, 0.05)
    args = _port_args(p, w, dist)
    got = mesh.make_soft_vis_fn(scene, gate_mask=mask, cap=cap)(scene, *args)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GATED_ATOL)
    tr = scene.triangles
    rest = ~torch.as_tensor(mask)
    unwalled = (intersect.soft_visibility_tris(
        tr.v0[rest], tr.e1[rest], tr.e2[rest], tr.area[rest], *args)
        * intersect.soft_visibility_spheres(scene.spheres.center,
                                            scene.spheres.radius, *args))
    assert torch.equal(got[cap:], unwalled[cap:])
    full = mesh.make_soft_vis_fn(scene, gate_mask=mask)(scene, *args)
    assert torch.equal(got[:cap], full[:cap])
    assert (got[cap:] > full[cap:] + 1e-3).any()
