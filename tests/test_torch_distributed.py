"""Two processes of the PyTorch port on ``torch.distributed`` (gloo, a
``file://`` rendezvous in ``tmp_path``): the ranks' rows tile the
one-process image bit for bit, every rank's albedo gradient matches the
one-process gradient, the plain and fused mesh steppers over the two ranks
equal one process's lanes, the steppers make one collective a call, and
``graft_entry.dryrun_multichip`` passes over the global mesh.

The workers run ``python -m cpu_based_ray_tracer_tpu_torch.parallel.worker``
(the port's module, which imports no JAX), as ``tests/test_distributed.py``
starts its workers from a script."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
from cpu_based_ray_tracer_tpu_torch.parallel import dist as pdist
from cpu_based_ray_tracer_tpu_torch.parallel.shard import PLANES
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

from torch_ref import seed_word

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = seed_word(0)
RENDER = dict(width=16, height=16, spp=2, max_depth=2, seed=SEED)
SPEC = {"device": "cpu", "render": RENDER, "grad": dict(RENDER, loss="mean"),
        "wavefront": dict(width=16, height=16, spp=4, max_depth=4, seed=SEED,
                          n_steps=10),
        "fused_mesh": dict(width=16, height=16, spp=4, max_depth=4,
                           seed=SEED, n_steps=3, subdivisions=1, gate_from=22,
                           cluster_size=64),
        "dryrun": True}
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "cpu_based_ray_tracer_tpu_torch.parallel.worker", "--init-method",
         f"file://{tmp}/rendezvous", "--world-size", str(WORLD), "--rank",
         str(r), "--backend", "gloo", "--out", str(tmp),
         "--spec", json.dumps(SPEC)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in out, out[-3000:]
    reports = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    data = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return reports, data


def cfg_of(case):
    return RenderConfig(**{k: v for k, v in case.items()
                           if k in RenderConfig.__dataclass_fields__})


def test_rows_tile_the_single_process_image(ranks):
    _, data = ranks
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    ref = mc.render(scene, cam, cfg_of(RENDER), SEED, device="cpu").numpy()
    rows = {int(k[3:]): v for d in data for k, v in d.items()
            if k.startswith("row")}
    assert sorted(rows) == [0, 8]
    for r0, slab in rows.items():
        np.testing.assert_array_equal(slab.view(np.int32),
                                      ref[r0:r0 + 8].view(np.int32))


def test_every_rank_gradient_matches_single_process(ranks):
    _, data = ranks
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    a = scene.materials.albedo.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(albedo=a))
    img = mc.render(s, cam, cfg_of(RENDER), SEED, device="cpu")
    torch.mean(img).backward()
    for d in data:
        np.testing.assert_allclose(d["grad"], a.grad.numpy(), rtol=1e-5,
                                   atol=1e-7)


def _lanes(data, prefix, plane):
    return np.concatenate([d[f"{prefix}_{plane}"] for d in data])


def test_plain_stepper_over_two_ranks_bit_equal(ranks):
    _, data = ranks
    case = SPEC["wavefront"]
    cfg = cfg_of(case)
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    ref = mc.wavefront_steps(scene, cam, cfg, SEED, mc.wavefront_init(
        scene, cam, cfg, SEED, device="cpu"), case["n_steps"])
    for f in PLANES:
        want = getattr(ref, f).numpy()
        np.testing.assert_array_equal(_lanes(data, "wf", f).view(want.dtype),
                                      want, err_msg=f)
    for d in data:
        assert int(d["wf_nrays"]) == int(ref.nrays)


def test_fused_mesh_stepper_over_two_ranks_bit_equal(ranks):
    _, data = ranks
    case = SPEC["fused_mesh"]
    cfg = cfg_of(case)
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1, radius=1.0))
    cam = cornell.cornell_camera()
    mp = fused_mesh.pack_mesh_scene(
        scene, gate_mask=np.arange(scene.triangles.count) >= 22,
        cluster_size=64)
    ref, of, npred = fused_mesh.wavefront_steps_fused_mesh(
        mp, cam, cfg, SEED, mc.wavefront_init(scene, cam, cfg, SEED,
                                              device="cpu"),
        case["n_steps"], device="cpu")
    for f in PLANES:
        want = getattr(ref, f).numpy()
        np.testing.assert_array_equal(_lanes(data, "fm", f).view(want.dtype),
                                      want, err_msg=f)
    for d in data:
        assert int(d["fm_nrays"]) == int(ref.nrays)
        assert int(d["fm_overflow"]) == int(of) == 0
        assert d["fm_npred"].tolist() == npred.tolist()


def test_collectives_and_dryrun(ranks):
    reports, _ = ranks
    for rep in reports:
        assert rep["backend"] == "gloo"
        assert rep["render"]["collectives"] == {"all_reduce": 0,
                                                "all_gather": 1}
        assert rep["grad"]["collectives"] == {"all_reduce": 1,
                                              "all_gather": 1}
        for case in ("wavefront", "fused_mesh"):
            assert rep[case]["collectives"] == {"all_reduce": 1,
                                                "all_gather": 0}, case
        assert "dryrun" in rep


@pytest.mark.parametrize("env, world_size, cards, want", [
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8"}, None, 8, "nccl"),
    ({"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, None, 1, "gloo"),
    ({}, 4, 4, "nccl"),
    ({}, 2, 1, "gloo"),
    ({}, 2, 0, "gloo"),
])
def test_default_backend_counts_this_nodes_processes(monkeypatch, env,
                                                     world_size, cards, want):
    """nccl when each process on this node has a card of its own: two nodes
    of 8 cards under torchrun (a world of 16) take nccl; two processes on
    one card, or no card, gloo."""
    for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert pdist.default_backend(world_size) == want
