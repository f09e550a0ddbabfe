"""Gradients through the port's differentiable Monte Carlo path: the checks
of ``tests/test_grad.py`` and ``tests/test_grad_mesh.py`` in the port, with
their tolerances, and the port's gradients against JAX's.

Finite differences run in the port (a render costs milliseconds).  Under a
fixed seed, hard visibility is a step function of geometry, so each
finite-difference probe moves the scene along a direction that flips no
silhouette (a dolly along the view axis, a zoom, the light slid in its
plane), as the JAX tests do; the soft-shadow estimator makes the occluder
term smooth, and there the probe moves an occluder.

The packet route detaches its rays on every device (the kernel's t carries
no gradient on the card, so its plain version must carry none on the
CPU): ``test_packet_route_detaches_the_traversal`` holds the port's
gradient w.r.t. the ray origins against JAX's packet route (its
``stop_gradient`` before the kernel, here on JAX's brute winner), and
``differentiable=True`` against JAX's recompute of the winner's t.

Tolerances against JAX (Cornell 12², 2 spp, depth 3): albedo, camera
position, vfov and the light's translation rtol 1e-4 / atol 1e-6 x scale
(largest relative difference 8.8e-6, the light's); triangle v0 rtol 1e-4
/ atol 1e-5 x scale (largest difference 1.2e-6 x scale, on an entry far
below the scale: the two packages sum the lanes' cotangent terms in other
orders); the packet route's ray-origin gradients atol 1e-5 x scale
(largest difference 8.7e-8 x scale; with the rays left attached it is
9.6, on 937 of 1,152 entries).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpu_based_ray_tracer_tpu import camera as jcam
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.ops import intersect as jintersect
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import mesh, offline
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes, rtiow

import torch_ref as ref
from torch_ref import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX_KW = dict(width=12, height=12, spp=2, max_depth=3)
JAX_KEY = 7


def _fd(loss, x0: float, eps: float) -> float:
    with torch.no_grad():
        return (float(loss(torch.tensor(x0 + eps)))
                - float(loss(torch.tensor(x0 - eps)))) / (2 * eps)


def _grad(loss, x0):
    x = torch.as_tensor(x0, dtype=torch.float32).clone().requires_grad_(True)
    return torch.autograd.grad(loss(x), x)[0].numpy()


def _render(scene, cam, cfg, seed, **kw):
    return mc.render(scene, cam, cfg, seed, device="cpu", **kw)


def _with_camera(cam, pos=None, vfov=None):
    return cam_mod.PerspectiveCamera(
        position=cam.position if pos is None else pos, forward=cam.forward,
        up=cam.up, vfov_degrees=cam.vfov_degrees if vfov is None else vfov)


def _translate_masked(scene, mask, t):
    tr = scene.triangles
    shift = torch.where(mask[:, None], 1.0, 0.0) * t
    return scene.replace(triangles=tr.replace(v0=tr.v0 + shift))


def _light_mask(scene):
    return scene.materials.emissive[scene.triangles.material.long()]


# --- camera, light and sphere geometry (tests/test_grad.py) ------------------

def test_camera_position_gradient_vs_fd():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=10, height=10, spp=4, max_depth=2)
    seed = ref.seed_word(11)

    def loss(pos):
        return torch.mean(_render(scene, _with_camera(cam, pos=pos), cfg,
                                  seed))

    g = _grad(loss, cam.position)
    assert np.isfinite(g).all() and np.abs(g).max() > 0

    def along_z(z):
        pos = cam.position.clone()
        pos[2] = z
        return loss(pos)

    fd = _fd(along_z, float(cam.position[2]), 2e-3)
    np.testing.assert_allclose(g[2], fd, rtol=5e-2, atol=1e-5)


def test_camera_vfov_gradient_vs_fd():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=10, height=10, spp=4, max_depth=2)
    seed = ref.seed_word(12)

    def loss(v):
        return torch.mean(_render(scene, _with_camera(cam, vfov=v), cfg,
                                  seed))

    g = float(_grad(loss, cam.vfov_degrees))
    fd = _fd(loss, float(cam.vfov_degrees), 1e-2)
    np.testing.assert_allclose(g, fd, rtol=8e-2, atol=1e-5)


def test_light_translation_gradient_vs_fd():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=10, height=10, spp=4, max_depth=2)
    seed = ref.seed_word(13)
    mask = _light_mask(scene)

    def loss(t):
        return torch.mean(_render(_translate_masked(scene, mask, t), cam,
                                  cfg, seed))

    g = _grad(loss, torch.zeros(3))
    assert np.isfinite(g).all()
    for i in (0, 2):  # in the light's plane: no silhouette flips
        def along(v, i=i):
            t = torch.zeros(3)
            t[i] = v
            return loss(t)
        fd = _fd(along, 0.0, 2e-3)
        np.testing.assert_allclose(g[i], fd, rtol=5e-2, atol=1e-5)


def _interior_rays():
    """8 rays from the origin into the middle of the red sphere, never
    within 0.3 of its silhouette (``tests/test_grad.py``)."""
    r = float(np.cos(np.pi / 4.0))
    targets = np.array([[r + 0.1 * i, 0.05 * j, -1.0]
                        for i in (-1, 0, 1, 2) for j in (-1, 1)], np.float32)
    d = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    return torch.zeros(d.shape), torch.as_tensor(d)


@pytest.mark.parametrize("leaf", ["center", "radius"])
def test_sphere_geometry_gradient_vs_fd(leaf):
    scene = rtiow.offline_two_sphere_scene()
    cfg = RenderConfig(width=8, height=1, spp=1, max_depth=2)
    o, d = _interior_rays()
    seed = ref.seed_word(14)
    pixel = torch.arange(o.shape[0], dtype=torch.int64)

    def loss(x):
        sp = scene.spheres
        if leaf == "center":
            centers = torch.cat([sp.center[:1], torch.stack(
                [x, sp.center[1, 1], sp.center[1, 2]])[None]])
            sp = sp.replace(center=centers)
        else:
            sp = sp.replace(radius=torch.stack([sp.radius[0], x]))
        return torch.mean(offline.trace(scene.replace(spheres=sp), o, d, cfg,
                                        seed=seed, pixel=pixel, sample=0))

    x0 = (scene.spheres.center[1, 0] if leaf == "center"
          else scene.spheres.radius[1])
    g = float(_grad(loss, x0))
    fd = _fd(loss, float(x0), 1e-3)
    assert np.isfinite(g) and abs(g) > 1e-6
    np.testing.assert_allclose(g, fd, rtol=5e-2, atol=1e-6)


def test_soft_shadow_occluder_gradient_vs_fd():
    """beta = 0.15: the occluder's gradient through the shadow term matches
    central differences; the hard estimator's gradient stays finite."""
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=2,
                       soft_shadow_beta=0.15)
    seed = ref.seed_word(16)
    mask = torch.arange(scene.triangles.count) >= scene.triangles.count - 10

    def loss(tx, c=cfg):
        t = tx * torch.tensor([1.0, 0.0, 0.0])
        return torch.mean(_render(_translate_masked(scene, mask, t), cam, c,
                                  seed))

    g = float(_grad(loss, 0.0))
    assert np.isfinite(g) and abs(g) > 1e-5
    fd = _fd(loss, 0.0, 1e-3)
    np.testing.assert_allclose(g, fd, rtol=5e-2, atol=1e-5)
    g_hard = float(_grad(lambda tx: loss(tx, cfg.replace(
        soft_shadow_beta=0.0)), 0.0))
    assert np.isfinite(g_hard)


# --- through the packet route (tests/test_grad_mesh.py) ----------------------

def _mesh():
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    bundle = mesh.prepare(scene, method="packet")
    return (scene, cornell.cornell_camera(),
            mesh.make_intersect_fn(bundle, differentiable=True),
            mesh.make_nearest_t_fn(bundle))


def _with_albedo_channel(scene, row, a):
    alb = scene.materials.albedo.clone()
    alb[row, 0] = a
    return scene.replace(materials=scene.materials.replace(albedo=alb))


def test_albedo_gradient_through_packet_matches_brute_and_fd():
    scene, cam, ifn, nfn = _mesh()
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=2)
    seed = ref.seed_word(21)
    row = int(scene.triangles.material[-1])  # the icosphere's material

    def loss_packet(a):
        return torch.mean(_render(_with_albedo_channel(scene, row, a), cam,
                                  cfg, seed, intersect_fn=ifn,
                                  nearest_t_fn=nfn))

    def loss_brute(a):
        return torch.mean(_render(_with_albedo_channel(scene, row, a), cam,
                                  cfg, seed))

    g_packet = float(_grad(loss_packet, 0.5))
    g_brute = float(_grad(loss_brute, 0.5))
    assert np.isfinite(g_packet) and abs(g_packet) > 0
    np.testing.assert_allclose(g_packet, g_brute, rtol=1e-3)
    fd = _fd(loss_packet, 0.5, 1e-2)
    np.testing.assert_allclose(g_packet, fd, rtol=5e-2, atol=1e-6)


def test_light_emission_gradient_through_packet_vs_fd():
    scene, cam, ifn, nfn = _mesh()
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=2)
    seed = ref.seed_word(22)
    row = int(np.flatnonzero(scene.materials.emissive.numpy())[0])

    def loss(scale):
        em = scene.materials.emission
        em = torch.where(torch.arange(em.shape[0])[:, None] == row,
                         em * scale, em)
        s2 = scene.replace(materials=scene.materials.replace(emission=em))
        return torch.mean(_render(s2, cam, cfg, seed, intersect_fn=ifn,
                                  nearest_t_fn=nfn))

    g = float(_grad(loss, 1.0))
    fd = _fd(loss, 1.0, 1e-2)
    assert np.isfinite(g) and g > 0
    np.testing.assert_allclose(g, fd, rtol=5e-2)


def _lift_mesh(scene, dy):
    tr = scene.triangles
    v0 = torch.cat([tr.v0[:22], tr.v0[22:] + dy * torch.tensor(
        [0.0, 1.0, 0.0])])
    return scene.replace(triangles=tr.replace(v0=v0))


def test_mesh_silhouette_gradient_fd_validated():
    """The mesh's soft shadow through the gated ``make_soft_vis_fn``, with
    every primary ray that could reach the mesh's box (grown by the probe's
    range) masked out: dy moves the loss only through the soft shadow."""
    scene, cam, ifn, nfn = _mesh()
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=1,
                       soft_shadow_beta=0.08)
    seed = ref.seed_word(11)
    gate = np.arange(scene.triangles.count) >= 22
    svf = mesh.make_soft_vis_fn(scene, gate_mask=gate)
    d0 = cam_mod.perspective_rays(cam, 16, 16).reshape(-1, 3)
    o0 = cam.position.expand(d0.shape)
    tr = scene.triangles
    verts = torch.stack([tr.v0, tr.v0 + tr.e1, tr.v0 + tr.e2], 1)[22:]
    lo = verts.reshape(-1, 3).amin(0) - 0.15
    hi = verts.reshape(-1, 3).amax(0) + 0.15
    crosses = fused_mesh._slab_crosses(o0, d0, lo, hi, 1e-3,
                                       torch.full((256,), 1e30))
    floor = (~crosses).reshape(16, 16, 1).to(torch.float32)
    assert floor.sum() > 50

    def loss(dy):
        img = _render(_lift_mesh(scene, dy), cam, cfg, seed,
                      intersect_fn=ifn, nearest_t_fn=nfn, soft_vis_fn=svf)
        return torch.mean(img * floor)

    g = float(_grad(loss, 0.0))
    fd = _fd(loss, 0.0, 5e-3)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=7e-2, atol=1e-5)


def test_mesh_geometry_gradient_through_packet_is_finite():
    """The mesh's vertices through detached traversal and the recomputed
    winner t (``differentiable=True``): finite and nonzero."""
    scene, cam, ifn, nfn = _mesh()
    cfg = RenderConfig(width=10, height=10, spp=1, max_depth=2)
    seed = ref.seed_word(23)
    g = float(_grad(lambda dy: torch.mean(_render(
        _lift_mesh(scene, dy), cam, cfg, seed, intersect_fn=ifn,
        nearest_t_fn=nfn)), 0.0))
    assert np.isfinite(g) and g != 0.0


def _mesh_rays(n=384, seed=5):
    """Seeded rays from the room toward the icosphere (most hit it)."""
    g = np.random.default_rng(seed)
    o = g.uniform([0.3, 0.3, 0.3], [3.3, 3.3, 3.3], (n, 3))
    target = np.array([1.86, 0.9, 1.685]) + g.uniform(-0.8, 0.8, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _hit_loss(hit, w, where=torch.where):
    """A loss over the continuous fields of a Hit (either package)."""
    return ((hit.point * w[:, :3]).sum() + (hit.geom_normal * w[:, 3:]).sum()
            + where(hit.hit, hit.t, 0.0).sum())


def test_packet_route_detaches_the_traversal():
    """``make_intersect_fn(packet)``'s gradient w.r.t. the ray origins on
    the CPU, where the packet route runs its plain version: with
    ``differentiable=False`` JAX's detached packet route (t from the
    traversal, stop_gradient), with ``differentiable=True`` JAX's recompute
    of the winner's t; the two differ, so the test sees a traversal that
    carries a gradient.  The fused route's gradient equals the detached
    packet route's; the shadow routes carry none."""
    ico = meshes.icosphere(1)
    scene = cornell.cornell_mesh_scene(ico)
    jscene = jcornell.cornell_mesh_scene(ico)
    bundle = mesh.prepare(scene, method="packet")
    o_np, d_np = _mesh_rays()
    w_np = np.random.default_rng(6).standard_normal(
        (o_np.shape[0], 6)).astype(np.float32)
    d, w = torch.as_tensor(d_np), torch.as_tensor(w_np)
    jd, jw = jnp.asarray(d_np), jnp.asarray(w_np)

    def jax_loss(o, recompute):
        tt, idx = jintersect.nearest_triangle(
            jscene, jax.lax.stop_gradient(o), jd, 1e-3, jnp.inf)
        if recompute:
            tr = jscene.triangles
            j = jnp.clip(idx, 0, tr.count - 1)
            t_rec, _, _ = jintersect.moller_trumbore_single(
                o, jd, tr.v0[j], tr.e1[j], tr.e2[j])
            tt = jnp.where(tt < jintersect.NO_HIT_T, t_rec,
                           jintersect.NO_HIT_T)
        hit = jintersect.assemble_hit(jscene, o, jd, tt, idx, 1e-3)
        return _hit_loss(hit, jw, jnp.where)

    want = {}
    for rec in (False, True):
        want[rec] = np.asarray(jax.jit(jax.grad(jax_loss), static_argnums=1)(
            jnp.asarray(o_np), rec))
        o = torch.as_tensor(o_np).clone().requires_grad_(True)
        fn = mesh.make_intersect_fn(bundle, differentiable=rec)
        hit = fn(scene, o, d, 1e-3)
        assert hit.hit.float().mean() > 0.5
        got = torch.autograd.grad(_hit_loss(hit, w), o)[0].numpy()
        scale = np.abs(want[rec]).max()
        np.testing.assert_allclose(got, want[rec], rtol=0, atol=1e-5 * scale)
    assert np.abs(want[True] - want[False]).max() > 0.1 * np.abs(
        want[False]).max()
    # The fused route detaches too (JAX's stop_gradient before coherent).
    o = torch.as_tensor(o_np).clone().requires_grad_(True)
    hit = mesh.make_intersect_fn(mesh.prepare(scene, method="fused"))(
        scene, o, d, 1e-3)
    got = torch.autograd.grad(_hit_loss(hit, w), o)[0].numpy()
    np.testing.assert_allclose(got, want[False], rtol=0,
                               atol=1e-5 * np.abs(want[False]).max())
    for b in (bundle, mesh.prepare(scene, method="fused")):
        o = torch.as_tensor(o_np).clone().requires_grad_(True)
        t = mesh.make_nearest_t_fn(b, sort_rays=True)(scene, o, d, 1e-3)
        assert not t.requires_grad


def test_mesh_vertex_gradient_needs_differentiable():
    """Gradients reach the mesh's vertices through the packet route only
    with ``differentiable=True`` (the kernel's t is detached)."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    bundle = mesh.prepare(scene, method="packet")
    o_np, d_np = _mesh_rays(n=128)
    o, d = torch.as_tensor(o_np), torch.as_tensor(d_np)
    for rec in (False, True):
        v0 = scene.triangles.v0.clone().requires_grad_(True)
        s2 = scene.replace(triangles=scene.triangles.replace(v0=v0))
        hit = mesh.make_intersect_fn(bundle, differentiable=rec)(
            s2, o, d, 1e-3)
        loss = torch.where(hit.hit, hit.t, 0.0).sum()
        if rec:
            g = torch.autograd.grad(loss, v0)[0]
            assert torch.isfinite(g).all() and g[22:].abs().max() > 0
        else:
            assert not loss.requires_grad


# --- the port's gradients against JAX's ---------------------------------------

@pytest.fixture(scope="module")
def jax_grads():
    """JAX's gradients of mean(render^2) on Cornell w.r.t. the albedo
    table, the triangles' v0, the light's translation, the camera position
    and its vfov: one jitted call."""
    scene, cam = jcornell.cornell_scene(), jcornell.cornell_camera()
    cfg, key = JConfig(**JAX_KW), jrng.render_key(JAX_KEY)
    is_em = scene.materials.emissive[scene.triangles.material]

    def loss(albedo, v0, t, pos, vfov):
        tr = scene.triangles
        s = scene.replace(
            materials=scene.materials.replace(albedo=albedo),
            triangles=tr.replace(v0=v0 + jnp.where(is_em[:, None], 1.0, 0.0)
                                 * t))
        c = jcam.PerspectiveCamera(position=pos, forward=cam.forward,
                                   up=cam.up, vfov_degrees=vfov)
        return jnp.mean(jmc.render(s, c, cfg, key) ** 2)

    args = (scene.materials.albedo, scene.triangles.v0,
            jnp.zeros(3, jnp.float32), cam.position, cam.vfov_degrees)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*args)
    return [np.asarray(g) for g in grads]


def test_gradients_match_jax(jax_grads):
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg, seed = RenderConfig(**JAX_KW), ref.seed_word(JAX_KEY)
    is_em = _light_mask(scene)
    leaves = [x.clone().requires_grad_(True) for x in (
        scene.materials.albedo, scene.triangles.v0, torch.zeros(3),
        cam.position, cam.vfov_degrees)]
    albedo, v0, t, pos, vfov = leaves
    s = scene.replace(
        materials=scene.materials.replace(albedo=albedo),
        triangles=scene.triangles.replace(
            v0=v0 + torch.where(is_em[:, None], 1.0, 0.0) * t))
    img = _render(s, _with_camera(cam, pos, vfov), cfg, seed)
    got = torch.autograd.grad(torch.mean(img ** 2), leaves)
    for name, a, b in zip(("albedo", "v0", "light", "position", "vfov"),
                          got, jax_grads):
        a = a.numpy()
        assert np.isfinite(a).all() and np.any(b != 0), name
        atol = (1e-5 if name == "v0" else 1e-6) * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol, err_msg=name)
