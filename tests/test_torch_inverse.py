"""Inverse rendering in the port (``models.inverse``): Adam through the
differentiable Monte Carlo estimator recovers Cornell's albedos and its
light's emission from a target image, by the criteria of
``tests/test_inverse.py`` (loss down at least 10x, albedo error below
0.08, emission relative error below 0.15), and over the packet mesh by
those of ``tests/test_grad_mesh.py:187-205``.

The first three losses of each recovery equal JAX's (optax's Adam) to
rtol 1e-4, under ``engine="replay"`` and ``"scan"``: the first loss is
the same function of the same parameters, the next two follow one and
two Adam steps (``torch.optim.Adam`` at optax's defaults: the same update
rounded in another order; largest relative difference 8.3e-6)."""

import numpy as np
import pytest

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import inverse as jinverse
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import inverse, mesh
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

import torch_ref as ref
from torch_ref import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(width=24, height=24, spp=2, max_depth=3, rr_survival=0.8)
N_JAX = 3


def _setup(kw=KW):
    scene, cam = ref.port_scene("cornell"), ref.port_camera()
    cfg, seed = RenderConfig(**kw), ref.seed_word(0)
    return scene, cam, cfg, seed, mc.render(scene, cam, cfg, seed,
                                            device="cpu")


def test_albedo_recovery_converges():
    scene, cam, cfg, seed, target = _setup()
    res = inverse.recover_albedo(scene, cam, cfg, seed, target, n_steps=60,
                                 lr=0.2, device="cpu")
    losses = res.losses.numpy()
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    free = ~scene.materials.emissive.numpy()
    err = np.abs(scene.materials.albedo.numpy() - res.params.numpy())[free]
    assert err.max() < 0.08, err.max()
    np.testing.assert_array_equal(
        res.params.numpy()[~free], scene.materials.albedo.numpy()[~free])


def test_emission_recovery_converges():
    scene, cam, cfg, seed, target = _setup()
    res = inverse.recover_emission(scene, cam, cfg, seed, target, n_steps=50,
                                   lr=0.3, device="cpu")
    losses = res.losses.numpy()
    assert losses[-1] < losses[0] / 10.0, (losses[0], losses[-1])
    true_em = scene.materials.emission.numpy()
    em = scene.materials.emissive.numpy()
    rel = (np.abs(true_em - res.params.numpy())
           / np.maximum(true_em, 1.0))[em]
    assert rel.max() < 0.15, rel.max()


@pytest.fixture(scope="module")
def jax_target():
    jscene, jcam = jcornell.cornell_scene(), jcornell.cornell_camera()
    jcfg, key = JConfig(**KW), jrng.render_key(0)
    return jscene, jcam, jcfg, key, jmc.render(jscene, jcam, jcfg, key)


@pytest.mark.parametrize("what", ["albedo", "emission"])
@pytest.mark.parametrize("engine", ["replay", "scan"])
def test_first_losses_match_jax(jax_target, what, engine):
    scene, cam, cfg, seed, target = _setup()
    jscene, jcam, jcfg, key, jtarget = jax_target
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget),
                               rtol=ref.RTOL, atol=ref.ATOL)
    if what == "albedo":
        want = jinverse.recover_albedo(jscene, jcam, jcfg, key, jtarget,
                                       n_steps=N_JAX, lr=0.2, engine=engine)
        got = inverse.recover_albedo(scene, cam, cfg, seed, target,
                                     n_steps=N_JAX, lr=0.2, engine=engine,
                                     device="cpu")
    else:
        want = jinverse.recover_emission(jscene, jcam, jcfg, key, jtarget,
                                         n_steps=N_JAX, lr=0.3, engine=engine)
        got = inverse.recover_emission(scene, cam, cfg, seed, target,
                                       n_steps=N_JAX, lr=0.3, engine=engine,
                                       device="cpu")
    assert got.losses.shape == (N_JAX,)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=1e-4)


def test_albedo_recovery_over_accelerated_mesh():
    """The mesh's albedo from a packet-rendered target, through the packet
    route with ``differentiable=True`` (its plain version here)."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2)
    seed = ref.seed_word(24)
    bundle = mesh.prepare(scene, method="packet")
    ifn = mesh.make_intersect_fn(bundle, differentiable=True)
    nfn = mesh.make_nearest_t_fn(bundle)
    target = mc.render(scene, cam, cfg, seed, device="cpu", intersect_fn=ifn,
                       nearest_t_fn=nfn)
    res = inverse.recover_albedo(scene, cam, cfg, seed, target, n_steps=25,
                                 lr=0.2, intersect_fn=ifn, nearest_t_fn=nfn,
                                 device="cpu")
    losses = res.losses.numpy()
    assert losses[-1] < 0.25 * losses[0]
    true = scene.materials.albedo.numpy()
    free = ~scene.materials.emissive.numpy()
    err0 = np.abs(0.5 - true).mean()
    err = np.abs(res.params.numpy() - true)[free].mean()
    assert err < err0
