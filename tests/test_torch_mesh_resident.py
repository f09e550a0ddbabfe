"""The ``cornell_mesh`` configuration on the fused mesh engine's resident
route, on the CPU: ``ops.fused_mesh.render_turbo_mesh_exact`` (the plain
versions of its kernels) on the configuration's scene, every pixel held
to the benchmark's plain PyTorch reference (``portbench/reference/mc.py``);
each chunk of the render resident, and the grouping's span two a bounce
step.  Imports no JAX."""

from __future__ import annotations

import json
import os

import pytest
import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
from cpu_based_ray_tracer_tpu_torch.scenes import cornell
from portbench.common import estimator_settings, share_off
from portbench.reference import geometry, mc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "portbench", "configs", "cornell_mesh.json")) as f:
    CONFIG = json.load(f)
W, H, SPP, DEPTH = 24, 16, 2, 5
WORDS = (0x9E3779B9, 2 ** 31 + 12345)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread (restored after): the tier-1 run puts
    six test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    verts, mats, soup = geometry.config_triangles(CONFIG)
    scene = cornell.cornell_mesh_scene(soup, height=CONFIG["mesh"]["height"])
    est = estimator_settings(CONFIG)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH, **est)
    ref = (geometry.ref_scene(verts, mats, "cpu"),
           geometry.ref_camera(geometry.CAMERA_POSITION,
                               geometry.CAMERA_FORWARD,
                               geometry.CAMERA_VFOV, "cpu"),
           mc.Settings(W, H, SPP, DEPTH, **est))
    return scene, cornell.cornell_camera(), cfg, ref


def _render(setup, word):
    scene, cam, cfg, _ = setup
    return fused_mesh.render_turbo_mesh_exact(
        scene, cam, cfg, word, cluster_size=CONFIG["cluster_size"],
        device="cpu")


@pytest.mark.parametrize("word", WORDS)
def test_resident_render_matches_the_plain_reference(setup, word):
    img = _render(setup, word)
    sc, cam, st = setup[3]
    tr = mc.trace(sc, cam, st, word, torch.arange(W * H))
    # The reference repeats the engine's documented arithmetic in the same
    # order, so a sound engine lands within the benchmark's own radiance
    # tolerance (2e-3 absolute and relative, common.TOL) on every pixel:
    # no pixel may be off.
    assert share_off(img.reshape(-1, 3), tr.radiance / SPP) == 0.0
    assert fused_mesh.TRACE and all(ch["resident"]
                                    for ch in fused_mesh.TRACE)
    assert fused_mesh.TRACE[-1]["overflow"] == 0


@pytest.mark.parametrize("resident", [True, False])
def test_one_group_span_per_grouping(setup, resident):
    """Two groupings a bounce step on the resident route, each in its own
    span; none on the shortlist route.  On an icosphere(1) in the box at
    8x8: the profiler's event list costs seconds at the configuration's
    size."""
    from torch.profiler import ProfilerActivity, profile

    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes

    _, cam, _, _ = setup
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1),
                                       height=CONFIG["mesh"]["height"])
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=DEPTH,
                       **estimator_settings(CONFIG))
    mp = fused_mesh.pack_mesh_scene(scene,
                                    cluster_size=CONFIG["cluster_size"])
    state = monte_carlo.wavefront_init(scene, cam, cfg, WORDS[0],
                                       device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fused_mesh.wavefront_steps_fused_mesh(mp, cam, cfg, WORDS[0], state,
                                              1, resident=resident,
                                              device="cpu")
    names = [e.name for e in prof.events()]
    assert names.count("fused_mesh.group") == (2 if resident else 0)
