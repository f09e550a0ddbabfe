"""The port's utilities against the JAX package's: checkpoint / resume (a
JAX-saved render state resumes in the port), pytrees, the run log and
timers, ``device_trace``, the fly camera, the seed word, the native BVH
builder and OBJ loader, ``refcompare``; and an import of every module of
the port with JAX blocked."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu import camera as jcam
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.ops import bvh as jbvh
from cpu_based_ray_tracer_tpu.utils import checkpoint as jckpt
from cpu_based_ray_tracer_tpu.utils import objio as jobjio
from cpu_based_ray_tracer_tpu.utils import refcompare as jrc
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import bvh
from cpu_based_ray_tracer_tpu_torch.scenes import cornell
from cpu_based_ray_tracer_tpu_torch.utils import (checkpoint, native, objio,
                                                  profiling, refcompare, rng)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checkpoint_resume_exact(tmp_path):
    """Interrupt and resume gives the image of an uninterrupted run."""
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2)
    seed = rng.seed_word(5)
    full = mc.render(scene, cam, cfg.replace(spp=4), seed, device="cpu")
    accum, done = mc.render_progressive(
        scene, cam, cfg, seed, torch.zeros((16, 16, 3)), 0)
    p = tmp_path / "state.npz"
    checkpoint.save_render_state(p, accum, done, seed, cfg)
    accum2, done2, seed2 = checkpoint.load_render_state(p, cfg, device="cpu")
    assert seed2 == seed
    accum2, done2 = mc.render_progressive(scene, cam, cfg, seed, accum2,
                                          done2)
    assert done2 == 4
    np.testing.assert_allclose((accum2 / 4.0).numpy(), full.numpy(),
                               atol=1e-6)


def test_checkpoint_config_mismatch(tmp_path):
    cfg = RenderConfig(width=8, height=8, spp=1)
    p = tmp_path / "s.npz"
    checkpoint.save_render_state(p, torch.zeros((8, 8, 3)), 1, 0, cfg)
    with pytest.raises(ValueError):
        checkpoint.load_render_state(p, cfg.replace(spp=2), device="cpu")


def test_jax_render_state_resumes_in_the_port(tmp_path):
    """The two RenderConfigs have the same fields, so the hash is the
    same, and a state the JAX package saved loads in the port (and the
    port's in JAX)."""
    kw = dict(width=8, height=4, spp=3, max_depth=5, rr_survival=0.5)
    assert checkpoint.config_hash(RenderConfig(**kw)) == jckpt.config_hash(
        JConfig(**kw))
    acc = np.random.default_rng(0).uniform(0, 2, (4, 8, 3)).astype(np.float32)
    key = jrng.render_key(9)
    jckpt.save_render_state(tmp_path / "j.npz", jnp.asarray(acc), 6,
                            jrng.seed_from_key(key), JConfig(**kw))
    a, done, seed = checkpoint.load_render_state(
        tmp_path / "j.npz", RenderConfig(**kw), device="cpu")
    np.testing.assert_array_equal(a.numpy(), acc)
    assert done == 6 and seed == rng.seed_word(9)
    checkpoint.save_render_state(tmp_path / "p.npz", a, done, seed,
                                 RenderConfig(**kw))
    a2, done2, seed2 = jckpt.load_render_state(tmp_path / "p.npz",
                                               JConfig(**kw))
    np.testing.assert_array_equal(np.asarray(a2), acc)
    assert done2 == 6 and int(seed2) == seed


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(5.0), "b": (torch.ones((2, 2)), np.uint32(3))}
    p = tmp_path / "t.npz"
    checkpoint.save_pytree(p, tree)
    back = checkpoint.load_pytree(p, tree)
    assert torch.equal(back["a"], torch.arange(5.0))
    assert torch.equal(back["b"][0], torch.ones((2, 2)))
    assert int(back["b"][1]) == 3
    scene = cornell.cornell_scene()
    checkpoint.save_pytree(tmp_path / "s.npz", scene)
    s2 = checkpoint.load_pytree(tmp_path / "s.npz", scene)
    assert torch.equal(s2.triangles.v0, scene.triangles.v0)
    assert torch.equal(s2.materials.albedo, scene.materials.albedo)
    with pytest.raises(ValueError):
        checkpoint.load_pytree(p, {"a": torch.zeros(5)})


def test_runlog(tmp_path):
    p = tmp_path / "run.jsonl"
    log = profiling.RunLog(str(p))
    log.emit("render", rays_per_s=1.5e8, cfg="cornell",
             n=torch.tensor(3), arr=np.arange(2))
    log.close()
    rec = json.loads(p.read_text().splitlines()[0])
    assert rec["event"] == "render" and rec["rays_per_s"] == 1.5e8
    assert rec["n"] == 3 and rec["arr"] == [0, 1]


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert json.load(f)["traceEvents"]


def test_seed_word_matches_jax():
    for k in (0, 1, 2, 3, 4, 5, 15, 123456, 2**31 - 1):
        assert rng.seed_word(k) == int(jrng.seed_from_key(jrng.render_key(k)))


def test_fly_camera_matches_jax():
    start = dict(position=np.array([2.78, 2.73, -8.0]),
                 forward=np.array([0.0, 0.0, 1.0]),
                 up=np.array([0.0, 1.0, 0.0]), vfov_degrees=40.0)
    a = cam_mod.FlyCameraController(**start)
    b = jcam.FlyCameraController(**start)
    script = [({"w"}, (0.0, 0.0)), ({"a", "space"}, (1.5, -0.5)),
              ({"s", "d", "shift"}, (-3.0, 2.0)), (set(), (0.25, 0.0)),
              ({"d"}, (0.0, 0.0))]
    for keys, mouse in script:
        a, b = a.moved(keys, mouse, dt=0.05), b.moved(keys, mouse, dt=0.05)
        np.testing.assert_allclose(a.position, b.position, rtol=1e-12)
        np.testing.assert_allclose(a.forward, b.forward, rtol=1e-12)
        ca, cb = a.camera(), b.camera()
        for f in ("position", "forward", "up", "vfov_degrees"):
            np.testing.assert_array_equal(getattr(ca, f).numpy(),
                                          np.asarray(getattr(cb, f)))


def _tris(n, seed=0):
    r = np.random.default_rng(seed)
    c = r.uniform(-5, 5, (n, 1, 3))
    return c + r.uniform(-0.5, 0.5, (n, 3, 3))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build "
                    "the native library")
def test_native_bvh_and_obj_match_jax(tmp_path):
    assert native.available()
    tris = _tris(137)
    want = jbvh.build_bvh(tris, leaf_size=4)
    got = native.build_bvh_native(tris, leaf_size=4)
    numpy_port = bvh.build_bvh(tris, leaf_size=4)
    for f in ("node_skip", "leaf_first", "leaf_count", "order", "node_min",
              "node_max"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
        np.testing.assert_array_equal(getattr(numpy_port, f),
                                      np.asarray(getattr(want, f)), f)
    p = tmp_path / "m.obj"
    objio.save_obj(p, _tris(15, 1))
    nat_tris, nat_uv = native.load_obj_native(str(p))
    j_tris, j_uv = jobjio.load_obj(p)
    assert nat_uv is None and j_uv is None
    np.testing.assert_allclose(nat_tris, j_tris, atol=1e-9)
    np.testing.assert_array_equal(objio.load_obj(p)[0], j_tris)
    built = os.listdir(os.path.join(REPO, "build", "native"))
    assert any(f.startswith("libcrt_native.") for f in built)


def test_refcompare_matches_jax():
    r = np.random.default_rng(3)
    img = r.uniform(0, 0.1, (96, 128, 3)).astype(np.float32)
    night = np.asarray([12, 20, 69], np.float32) / 255.0
    img[:] = night
    img[16:80, 24:104] = r.uniform(0.3, 0.9, (64, 80, 3))
    for name in ("box_filter", "grid_means"):
        np.testing.assert_array_equal(getattr(refcompare, name)(img, 8),
                                      getattr(jrc, name)(img, 8))
    assert refcompare.bright_content_bbox(img) == jrc.bright_content_bbox(img)
    assert (refcompare.color_region_bbox(img, night, tol=0.1)
            == jrc.color_region_bbox(img, night, tol=0.1))
    np.testing.assert_array_equal(refcompare.cornell_box_crop(img),
                                  jrc.cornell_box_crop(img))
    other = img[::-1].copy()
    assert refcompare.grid_diff(img, other) == jrc.grid_diff(img, other)
    for x, y in zip(refcompare.sky_and_object_stats(img, night),
                    jrc.sky_and_object_stats(img, night)):
        np.testing.assert_array_equal(x, y)


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter with ``jax`` and the JAX package blocked imports
    every module of the port."""
    code = r"""
import os, pkgutil, sys, importlib
for name in list(sys.modules):
    if name == "jax" or name.startswith(("jax.", "jaxlib")):
        del sys.modules[name]
sys.modules["jax"] = None
sys.modules["cpu_based_ray_tracer_tpu"] = None
import cpu_based_ray_tracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print(len(names), "modules")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.split()[0])
    assert n >= 45
