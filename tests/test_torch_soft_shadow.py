"""Soft shadows (``soft_shadow_beta > 0``) in the port's plain Monte Carlo
engines: refused with ``NotImplementedError`` until ``soft_visibility`` is
ported, never rendered silently with the hard shadow test.  The hard mode
(beta = 0) still matches the JAX package."""

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import denoiser, mesh
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

import torch_ref as ref

SOFT = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                    soft_shadow_beta=0.5)


def _render(scene, cam, seed):
    return mc.render(scene, cam, SOFT, seed, device="cpu")


def _wavefront_steps(scene, cam, seed):
    st = mc.wavefront_init(scene, cam, SOFT, seed, device="cpu")
    return mc.wavefront_steps(scene, cam, SOFT, seed, st, 1)


def _render_mc(scene, cam, seed):
    bundle = mesh.prepare(cornell.cornell_mesh_scene(meshes.icosphere(1)),
                          method="packet")
    return mesh.render_mc(bundle, cam, SOFT, seed, device="cpu")


def _render_gbuffer(scene, cam, seed):
    return denoiser.render_gbuffer(scene, cam, SOFT, seed, 0, device="cpu")


@pytest.mark.parametrize("engine", [_render, _wavefront_steps, _render_mc,
                                    _render_gbuffer],
                         ids=["render", "wavefront_steps", "mesh_render_mc",
                              "render_gbuffer"])
def test_soft_shadows_refused(engine):
    with pytest.raises(NotImplementedError, match="soft_visibility"):
        engine(cornell.cornell_scene(), cornell.cornell_camera(), 1)


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
