"""The port's single-path stepper (the Denoiser's G-buffer pass, the plain
version of ``csrc/fused_mc.cu`` in ``single_path`` mode) against the JAX
package's Pallas kernel itself, run in interpret mode on the CPU — the most
expensive JAX call of the Denoiser tests, so in a file of its own.  The
gate of ``tests/test_fused.py``: color 2e-3, world position and normal
1e-4, primitive ids and the contributor flag exact."""

import numpy as np

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.ops import fused as jfused
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import fused

import torch_ref as ref


def test_single_sample_gbuffer_plain_matches_jax_kernel():
    kw = dict(width=48, height=48, spp=1, max_depth=6, rr_survival=0.8)
    want = jfused.single_sample_gbuffer(
        jfused.pack_scene(jcornell.cornell_scene()),
        jcornell.cornell_camera(), JConfig(**kw), jrng.render_key(5), 3,
        interpret=True)
    scene = ref.port_scene("cornell")
    launches = fused.LAUNCHES["fused_mc"]
    got = fused.single_sample_gbuffer(fused.pack_scene(scene),
                                      ref.port_camera(), RenderConfig(**kw),
                                      ref.seed_word(5), 3, device="cpu")
    assert fused.LAUNCHES["fused_mc"] == launches
    want = [np.asarray(x) for x in want]
    got = [x.numpy() for x in got]
    for i, tol in ((0, 2e-3), (1, 1e-4), (2, 1e-4)):
        np.testing.assert_allclose(got[i], want[i], rtol=tol, atol=tol)
    for i in (3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    assert got[3].dtype == np.int32 and got[4].dtype == bool
    assert 0 < got[4].mean() <= 1 and (got[3][~got[4]] == -1).all()
