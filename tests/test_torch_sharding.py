"""Row-sharded rendering of the PyTorch port (``parallel``) in one process:
the sharded image, lane state and gradients against the port's own
unsharded engines (which the other ``test_torch_*`` files hold against
JAX), plus one cheap JAX comparison per path; the collective count; the
divisibility rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import graft_entry
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
from cpu_based_ray_tracer_tpu_torch.parallel import (
    Mesh, make_mesh, render_sharded, replicated, row_sharded, shard,
    wavefront_init_sharded, wavefront_steps_fused_mesh_sharded,
    wavefront_steps_sharded)
from cpu_based_ray_tracer_tpu_torch.parallel.worker import Collectives
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

from torch_ref import one_torch_thread  # noqa: F401
from torch_ref import assert_states_match, seed_word, state_numpy

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PLANES = shard.PLANES + ("nrays",)


def cpu_mesh(n):
    return make_mesh(n, devices="cpu")


def assert_planes_equal(got, want):
    """Every plane bit equal (float planes as int32 words)."""
    for f in PLANES:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f


def test_make_mesh_round_robin_and_default_device():
    m = make_mesh(3, devices=["cpu", "cpu"])
    assert m.n_slabs == 3 and m.slabs == (0, 1, 2) and m.group is None
    assert all(d.type == "cpu" for d in m.devices)
    assert replicated(m) == (torch.device("cpu"),)
    assert row_sharded(m, 12) == [(0, 4), (4, 4), (8, 4)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):       # no silent CPU mesh
            make_mesh(2)


def test_render_sharded_bit_equal_and_against_jax():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=3)
    seed = seed_word(0)
    ref = mc.render(scene, cam, cfg, seed, device="cpu")
    for n in (2, 8):
        img = render_sharded(scene, cam, cfg, seed, cpu_mesh(n))
        assert torch.equal(img.view(torch.int32), ref.view(torch.int32)), n
    want = np.asarray(jmc.render(
        jcornell.cornell_scene(), jcornell.cornell_camera(),
        JConfig(width=32, height=32, spp=4, max_depth=3), jrng.render_key(0)))
    np.testing.assert_allclose(ref.numpy(), want, rtol=2e-3, atol=2e-3)


def test_sharded_gradient_matches_unsharded_and_jax():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2)
    seed = seed_word(1)

    def grad(render):
        a = scene.materials.albedo.clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=a))
        torch.mean(render(s)).backward()
        return a.grad.numpy()

    g1 = grad(lambda s: mc.render(s, cam, cfg, seed, device="cpu"))
    g2 = grad(lambda s: render_sharded(s, cam, cfg, seed, cpu_mesh(4)))
    np.testing.assert_allclose(g2, g1, rtol=1e-5, atol=1e-7)

    jscene, jcam = jcornell.cornell_scene(), jcornell.cornell_camera()
    jcfg = JConfig(width=16, height=16, spp=2, max_depth=2)

    def jloss(albedo):
        s = jscene.replace(materials=jscene.materials.replace(albedo=albedo))
        return jnp.mean(jmc.render(s, jcam, jcfg, jrng.render_key(1)))

    gj = np.asarray(jax.jit(jax.grad(jloss))(jscene.materials.albedo))
    np.testing.assert_allclose(g1, gj, rtol=1e-4, atol=1e-6)


def test_sharded_wavefront_stepper_bit_equal():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=4)
    seed = seed_word(2)
    st0 = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    ref = mc.wavefront_steps(scene, cam, cfg, seed, st0, 10)
    for n in (2, 8):
        mesh = cpu_mesh(n)
        st = wavefront_init_sharded(scene, cam, cfg, seed, mesh)
        assert_planes_equal(st, st0)
        st = wavefront_steps_sharded(scene, cam, cfg, seed, st, 10, mesh)
        assert_planes_equal(st, ref)
        assert torch.equal(mc.wavefront_image(st, cfg),
                           mc.wavefront_image(ref, cfg))
    # and the unsharded port against JAX's stepper on the same lanes
    jcfg = JConfig(width=16, height=16, spp=4, max_depth=4)
    jst = jmc.wavefront_init(jcornell.cornell_scene(),
                             jcornell.cornell_camera(), jcfg,
                             jrng.render_key(2))
    jst = jmc.wavefront_steps(jcornell.cornell_scene(),
                              jcornell.cornell_camera(), jcfg,
                              jrng.render_key(2), jst, 10)
    assert_states_match(state_numpy(jst), state_numpy(ref))


def test_fused_mesh_plain_stepper_sharded_bit_equal():
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1, radius=1.0))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=4)
    seed = seed_word(0)
    mp = fused_mesh.pack_mesh_scene(
        scene, gate_mask=np.arange(scene.triangles.count) >= 22,
        cluster_size=64)
    st0 = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    ref, of_ref, np_ref = fused_mesh.wavefront_steps_fused_mesh(
        mp, cam, cfg, seed, st0, 3, device="cpu")
    mesh = cpu_mesh(2)
    st = wavefront_init_sharded(scene, cam, cfg, seed, mesh)
    st, of, npred = wavefront_steps_fused_mesh_sharded(
        mp, cam, cfg, seed, st, 3, mesh)
    assert_planes_equal(st, ref)
    assert int(of) == int(of_ref) == 0
    assert npred.tolist() == np_ref.tolist() and int(npred.sum()) > 0


def test_collectives_one_per_call(monkeypatch):
    """A stepper's call makes one all_reduce (the summed counters), whatever
    its step count; the render one all_gather and, in the backward pass,
    one all_reduce.  A stand-in group of one process (its sums the
    identity, the calls counted by the workers' ``Collectives``) runs the
    group code paths."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None, **kw: None)
    monkeypatch.setattr(dist, "all_gather",
                        lambda parts, x, group=None: parts[0].copy_(x))
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)

    group = object()
    mesh = dataclasses.replace(cpu_mesh(2), group=group)
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=3)
    seed = seed_word(3)
    with Collectives() as c:
        st = wavefront_init_sharded(scene, cam, cfg, seed, mesh)
    assert c.counts == {"all_reduce": 0, "all_gather": 0}
    for n_steps in (1, 6):
        with Collectives() as c:
            st = wavefront_steps_sharded(scene, cam, cfg, seed, st, n_steps,
                                         mesh)
        assert c.counts == {"all_reduce": 1, "all_gather": 0}, n_steps

    mscene = cornell.cornell_mesh_scene(meshes.icosphere(1, radius=1.0))
    mp = fused_mesh.pack_mesh_scene(
        mscene, gate_mask=np.arange(mscene.triangles.count) >= 22,
        cluster_size=64)
    stm = wavefront_init_sharded(mscene, cam, cfg, seed, mesh)
    with Collectives() as c:
        wavefront_steps_fused_mesh_sharded(mp, cam, cfg, seed, stm, 2, mesh)
    assert c.counts == {"all_reduce": 1, "all_gather": 0}

    a = scene.materials.albedo.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(albedo=a))
    with Collectives() as c:
        img = render_sharded(s, cam, cfg, seed, mesh)
        assert c.counts == {"all_reduce": 0, "all_gather": 1}
        img.mean().backward()
    assert c.counts == {"all_reduce": 1, "all_gather": 1}
    ref = mc.render(scene, cam, cfg, seed, device="cpu")
    assert torch.equal(img.detach(), ref)


def test_indivisible_height_raises():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=8, height=10, spp=1, max_depth=2)
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError):
        render_sharded(scene, cam, cfg, 0, mesh)
    with pytest.raises(ValueError):
        wavefront_init_sharded(scene, cam, cfg, 0, mesh)
    st = mc.wavefront_init(scene, cam, cfg, 0, device="cpu")
    with pytest.raises(ValueError):
        wavefront_steps_sharded(scene, cam, cfg, 0, st, 1, mesh)
    with pytest.raises(ValueError):
        row_sharded(mesh, 10)
    assert isinstance(mesh, Mesh) and shard._lanes_per_device(
        cfg.replace(height=8), mesh) == 16


def test_dryrun_multichip_in_process():
    graft_entry.dryrun_multichip(2, device="cpu")
    fn, args = graft_entry.entry(device="cpu")
    assert callable(fn) and len(args) == 3
