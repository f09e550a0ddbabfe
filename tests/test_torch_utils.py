"""The port's utilities against the JAX package's: checkpoint / resume (a
JAX-saved render state resumes in the port), pytrees, the run log and
timers, ``device_trace``, the fly camera, the seed word, the native BVH
builder and OBJ loader, ``refcompare``; the shared scalar constants
(``utils.consts``) against fresh tensors; and an import of every module of
the port with JAX blocked."""

import collections
import contextlib
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
from cpu_based_ray_tracer_tpu_torch.ops import bvh, vec
from cpu_based_ray_tracer_tpu_torch.scenes import cornell
from cpu_based_ray_tracer_tpu_torch.utils import (checkpoint, consts, graphs,
                                                  native, objio, profiling,
                                                  refcompare, rng)

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


# --- shared scalar constants (utils.consts) ----------------------------------

_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_divisor_divides_as_a_fresh_tensor(dtype):
    """``vec.div`` by a shared constant gives the bits of the division by
    a fresh ``torch.tensor(c)``, NaN payloads and signed zeros included."""
    x = torch.cat([torch.linspace(-3.0, 3.0, 255, dtype=dtype),
                   torch.tensor([0.0, -0.0, float("inf"), 1e-30, 7e37],
                                dtype=dtype)])
    for c in (3, 448, 0.1, 1.0 / 3.0, 2.0 * 3.141592653589793, 0.8, 0.0,
              -0.0, 2.0 ** -149, 1e30, float("inf"), float("nan")):
        for _ in range(2):   # built, then found again
            got = vec.div(x, c)
            want = x / torch.tensor(c, dtype=dtype)
            assert torch.equal(got.view(_BITS[dtype]),
                               want.view(_BITS[dtype])), c


def test_cached_counters_hash_as_fresh_tensors():
    """``rng.as_u32`` of an int is the Python int of the fresh tensor's
    u32 pattern (values at and past 2**31 and 2**32, negative ones), and
    ``uniforms4`` with int counters draws what it draws with fresh
    tensors (int products past 2**63 included); ``pcg4d`` of four ints
    gives the ints of its tensor hash."""
    pixel = torch.arange(97, dtype=torch.int64) * 40503 + 11

    def fresh(x):
        return torch.as_tensor(x, dtype=torch.int64) & 0xFFFFFFFF

    for x in (0, 1, 7, 2**31 - 1, 2**31, 2**31 + 3, 4070199207, 2**32 - 1,
              2**32, 2**32 + 5, -1, -(2**31)):
        got = rng.as_u32(x)
        assert type(got) is int and got == int(fresh(x)), x
        ints = rng.pcg4d(rng.as_u32(x), 5, rng.as_u32(-x), 4070199207)
        want = rng.pcg4d(fresh(x), fresh(5), fresh(-x), fresh(4070199207))
        assert [type(i) for i in ints] == [int] * 4
        assert list(ints) == [int(w) for w in want], x
        for sample, bounce in ((0, 0), (x, 3), (5, x), (x, x)):
            got = rng.uniforms4(x, pixel, sample, bounce, rng.LIGHT)
            ctr = (fresh(bounce) * rng.N_STREAMS + rng.LIGHT) & 0xFFFFFFFF
            want = rng.pcg4d(pixel & 0xFFFFFFFF, fresh(sample), ctr, fresh(x))
            for g, w in zip(got, want):
                assert torch.equal(g, rng._to_unit_float(w.expand(
                    pixel.shape))), (x, sample, bounce)


def test_shared_constants_are_guarded(monkeypatch):
    """One tensor a (value, dtype, device): -0.0 and 0.0 apart, a NaN found
    again; made in inference mode it is still a normal tensor autograd can
    save; written in place or made to require grad it is refused."""
    monkeypatch.setattr(consts, "_CACHE", collections.OrderedDict())
    c = consts.scalar(0.8125, torch.float64)
    assert consts.scalar(0.8125, torch.float64, "cpu") is c
    assert consts.scalar(0.8125, torch.float32) is not c
    z = consts.scalar(0.0, torch.float32)
    nz = consts.scalar(-0.0, torch.float32)
    assert z is not nz and torch.signbit(nz) and not torch.signbit(z)
    nan = consts.scalar(float("nan"), torch.float32)
    assert consts.scalar(float("nan"), torch.float32) is nan
    with torch.inference_mode():
        k = consts.scalar(3.0, torch.float32)
    assert not k.is_inference()
    x = torch.ones(3, requires_grad=True)
    (x / k).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 1.0) / k)
    c.add_(1.0)
    with pytest.raises(RuntimeError, match="written in place"):
        consts.scalar(0.8125, torch.float64)
    z.requires_grad_(True)
    with pytest.raises(RuntimeError, match="require grad"):
        consts.scalar(0.0, torch.float32)


def test_shared_constants_are_bounded_and_recorded(monkeypatch):
    """The cache keeps the ``KEEP`` most recently used constants, and
    ``recording()`` holds every constant handed out in its block, those
    the cache has since dropped included."""
    monkeypatch.setattr(consts, "_CACHE", collections.OrderedDict())
    monkeypatch.setattr(consts, "KEEP", 4)
    first = consts.scalar(1.0, torch.float32)
    with consts.recording() as seen:
        got = [consts.scalar(float(v), torch.float32) for v in range(2, 9)]
        assert consts.scalar(8.0, torch.float32) is got[-1]
        with consts.recording() as inner:
            consts.scalar(3.5, torch.float32)
    assert len(consts._CACHE) == 4 and first not in consts._CACHE.values()
    assert sorted(float(t) for t in seen.values()) == [
        2.0, 3.0, 3.5, 4.0, 5.0, 6.0, 7.0, 8.0]
    assert [float(t) for t in inner.values()] == [3.5]
    assert consts._RECORDING == []
    again = consts.scalar(2.0, torch.float32)     # dropped: built anew
    assert again is not got[0] and torch.equal(again, got[0])


def test_graph_cache_captures_a_key_at_its_second_call(monkeypatch):
    """``GraphCache``'s policy, with its CUDA parts stood in for: a key's
    first call runs eagerly, its second captures and replays, later ones
    replay; a key whose replay waits for its backward runs eagerly; keys
    that never repeat (a fresh seed a call) never capture, and the cache
    remembers at most ``SEEN`` of them and ``KEEP`` captures."""
    made = []

    class Capture:
        def __init__(self, fn, inputs, requires_grad):
            self.waiting = set()
            made.append(self)

    monkeypatch.setattr(graphs, "_Capture", Capture)
    monkeypatch.setattr(graphs._Replay, "apply",
                        staticmethod(lambda cap, *xs: ("replay", cap)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(profiling, "COUNTERS", dict(profiling.COUNTERS))
    counter = profiling.Counter("test_graph_cache",
                                ("captures", "replays", "eager"))
    cache = graphs.GraphCache(counter)
    x = torch.zeros(3)

    def fn(t):
        return "eager"

    assert cache("a", fn, [x]) == "eager"
    assert counter.snapshot() == {"captures": 0, "replays": 0, "eager": 1}
    assert cache("a", fn, [x]) == ("replay", made[0])
    assert cache("a", fn, [torch.ones(3)]) == ("replay", made[0])
    assert counter.snapshot() == {"captures": 1, "replays": 2, "eager": 1}
    assert cache("a", fn, [torch.zeros(4)]) == "eager"      # another shape
    made[0].waiting.add(object())
    assert cache("a", fn, [x]) == "eager"
    counter.reset()
    for seed in range(3 * graphs.SEEN):
        assert cache(("b", seed), fn, [x]) == "eager"
    assert counter.snapshot() == {"captures": 0, "replays": 0,
                                  "eager": 3 * graphs.SEEN}
    assert len(cache._seen) == graphs.SEEN and len(made) == 1
    for k in range(graphs.KEEP + 2):
        cache(("c", k), fn, [x])
        cache(("c", k), fn, [x])
    assert len(cache._captures) == graphs.KEEP
    assert len(made) == 1 + graphs.KEEP + 2
    cache.clear()
    assert not cache._seen and not cache._captures
