"""Record and replay (``monte_carlo.render_replay``, ``record_trace``,
``render_from_trace``, ``intersect.hit_from_record``) in the port, against
the port's standard engine and against the JAX package.

The replay rebuilds every hit from its recorded winner by per-lane twins
of the t-matrix producers, so its image is bit equal to ``render``'s and
its gradients equal the standard engine's (the min of the t-matrix routes
each lane's cotangent to the winner's entry, the function the replay
differentiates).

Tolerances: the hit reconstruction, the twins and the replay image
against ``render`` exactly (JAX's CPU gate, rtol 1e-4 / atol 4e-6 of
``tests/test_replay.py:43-46``, is checked as well); replay against
standard gradients as ``tests/test_replay.py:90-139`` (materials rtol 1e-5
/ atol 1e-8; geometry rtol 1e-4 / atol 1e-6 x scale).  Against JAX's
jitted replay: albedo rtol 1e-4 / atol 1e-6 x scale (largest difference
3.6e-6 x scale, within rtol); triangle vertices and sphere centers rtol
1e-4 / atol 1e-5 x scale (largest differences 7.8e-6 x scale on a v0
entry far below the scale, and 7.2e-5 x scale on a center component
within rtol: JAX scatters a gathered vertex's cotangents back through a
one-hot product, the port through an indexed add, and the two sum the
lanes' terms in other orders).  The record: ``prim``, ``is_triangle``
and ``hit`` equal JAX's on every lane; ``visible`` on all but knife-edge
lanes (at most one in a thousand; one of 2,048 here, a dead lane), at each of which JAX's own eager ``nearest_t`` on the
port's shadow ray gives the port's occluder t: the two rays differ in the
last bits (XLA's CPU code contracts multiply-adds), not the intersector.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.ops import intersect as jintersect
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import interop
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import mesh
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import intersect
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes
from cpu_based_ray_tracer_tpu_torch.utils import consts

import torch_ref as ref
from torch_ref import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(width=16, height=16, spp=2, max_depth=4)
KEY = 7
FIELDS = ("prim", "is_triangle", "hit", "visible")


@pytest.fixture(scope="module")
def jax_replay():
    """JAX's record_trace and render_from_trace on Cornell with the
    sphere, and the gradients of mean(image^2) w.r.t. the albedo table,
    the triangles' v0 and the sphere centers: one jitted call."""
    scene, cam = ref.jax_scene("cornell_sphere"), jcornell.cornell_camera()
    cfg, key = JConfig(**KW), jrng.render_key(KEY)

    def loss(albedo, v0, center):
        s = scene.replace(
            materials=scene.materials.replace(albedo=albedo),
            triangles=scene.triangles.replace(v0=v0),
            spheres=scene.spheres.replace(center=center))
        recs = jmc.record_trace(s, cam, cfg, key)
        img = jmc.render_from_trace(s, cam, cfg, key, recs)
        return jnp.mean(img ** 2), (img, recs)

    (_, (img, recs)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        scene.materials.albedo, scene.triangles.v0, scene.spheres.center)
    return dict(img=np.asarray(img),
                recs={f: np.asarray(getattr(recs, f)) for f in FIELDS},
                grads=[np.asarray(g) for g in grads])


def _port():
    return (ref.port_scene("cornell_sphere"), ref.port_camera(),
            RenderConfig(**KW), ref.seed_word(KEY))


def _leaves(scene):
    """(scene with grad-carrying albedo, v0 and sphere centers, leaves)."""
    alb, v0, cen = (x.clone().requires_grad_(True) for x in (
        scene.materials.albedo, scene.triangles.v0, scene.spheres.center))
    s = scene.replace(materials=scene.materials.replace(albedo=alb),
                      triangles=scene.triangles.replace(v0=v0),
                      spheres=scene.spheres.replace(center=cen))
    return s, [alb, v0, cen]


def _grads(render_fn, scene, cam, cfg, seed, **kw):
    s, leaves = _leaves(scene)
    img = render_fn(s, cam, cfg, seed, device="cpu", **kw)
    return img.detach(), torch.autograd.grad(torch.mean(img ** 2), leaves)


def _room_rays(n=512, seed=3):
    """Seeded rays from points in the room (a quarter of them inside the
    sphere, so its far root wins) in random directions, and the camera's
    primary rays."""
    scene, cam, cfg, s = _port()
    g = np.random.default_rng(seed)
    o = g.uniform([0.2, 0.2, 0.2], [3.4, 3.4, 3.4], (n, 3))
    o[: n // 4] = (np.asarray(ref.SPHERE_CENTER)
                   + g.uniform(-0.3, 0.3, (n // 4, 3)))
    d = g.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    po, pd, _ = mc._primary_rays(cam, cfg, s, 0)
    return (scene, torch.cat([torch.as_tensor(o, dtype=torch.float32), po]),
            torch.cat([torch.as_tensor(d, dtype=torch.float32), pd]))


def test_hit_from_record_equals_intersect_scene():
    scene, o, d = _room_rays()
    live = intersect.intersect_scene(scene, o, d, t_min=1e-3)
    assert live.hit.any() and (live.hit & ~live.is_triangle).sum() > 50
    rec = intersect.hit_from_record(scene, o, d, live.prim, live.is_triangle,
                                    live.hit, 1e-3)
    for f in ("t", "hit", "is_triangle", "prim", "material", "point",
              "geom_normal", "front", "uv"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(),
                                      getattr(live, f).numpy(), err_msg=f)


def test_single_twins_equal_matrix_entries():
    """Every (ray, primitive) pair, hits and misses: the per-lane twins
    give the t-matrix entries bit for bit."""
    scene, o, d = _room_rays(n=256)
    tr, sp = scene.triangles, scene.spheres
    r, n, m = o.shape[0], tr.count, sp.count
    tmat = intersect.triangle_t_matrix(o, d, tr.v0, tr.e1, tr.e2, 1e-3,
                                       intersect.INF)
    rep = lambda x, k: x.repeat_interleave(k, 0)  # noqa: E731
    tile = lambda x: x.repeat(r, *([1] * (x.dim() - 1)))  # noqa: E731
    got = intersect.triangle_t_single(rep(o, n), rep(d, n), tile(tr.v0),
                                      tile(tr.e1), tile(tr.e2), 1e-3)
    assert (tmat < intersect.NO_HIT_T).any()
    np.testing.assert_array_equal(got.reshape(r, n).numpy(), tmat.numpy())
    smat = intersect.intersect_spheres(o, d, sp.center, sp.radius, 1e-3,
                                       intersect.INF)
    got = intersect.sphere_t_single(rep(o, m), rep(d, m), tile(sp.center),
                                    tile(sp.radius), 1e-3)
    assert (smat < intersect.NO_HIT_T).any()
    np.testing.assert_array_equal(got.reshape(r, m).numpy(), smat.numpy())


def test_record_trace_matches_jax(jax_replay):
    scene, cam, cfg, seed = _port()
    rays = []

    def shadow_t(s, o, d, t_min):  # the port's shadow rays, kept
        rays.append((o, d))
        return intersect.nearest_t(s, o, d, t_min=t_min)

    got = interop.record_to_arrays(mc.record_trace(
        scene, cam, cfg, seed, "cpu", nearest_t_fn=shadow_t))
    want = jax_replay["recs"]
    for f in FIELDS:
        assert got[f].shape == (cfg.spp, cfg.max_depth, 256), f
        assert got[f].dtype == want[f].dtype, f
    for f in ("prim", "is_triangle", "hit"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    off = np.argwhere(got["visible"] != want["visible"])
    assert len(off) <= got["visible"].size // 1000, off
    jscene = ref.jax_scene("cornell_sphere")
    for s, b, lane in off:
        o, d = (x[lane:lane + 1] for x in rays[s * cfg.max_depth + b])
        mine = intersect.nearest_t(scene, o, d, t_min=cfg.t_min).numpy()
        theirs = np.asarray(jintersect.nearest_t(
            jscene, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
            t_min=cfg.t_min))
        np.testing.assert_array_equal(theirs, mine)


def test_jax_trace_replays_in_port(jax_replay):
    """JAX's record, carried across, replays in the port to the port's
    own image (its knife-edge bits lie on lanes that no longer add)."""
    scene, cam, cfg, seed = _port()
    recs = interop.record_from_arrays(jax_replay["recs"])
    assert recs.prim.dtype == torch.int32 and recs.hit.dtype == torch.bool
    got = mc.render_from_trace(scene, cam, cfg, seed, recs, "cpu")
    want = mc.render(scene, cam, cfg, seed, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(got.numpy(), jax_replay["img"], rtol=ref.RTOL,
                               atol=ref.ATOL)


def test_render_replay_equals_render():
    scene, cam, cfg, seed = _port()
    a = mc.render(scene, cam, cfg, seed, device="cpu").numpy()
    b = mc.render_replay(scene, cam, cfg, seed, device="cpu").numpy()
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=4e-6)
    assert int((a != b).any(-1).sum()) == 0


def test_replay_gradients_equal_standard():
    scene, cam, cfg, seed = _port()
    img_s, g_std = _grads(mc.render, scene, cam, cfg, seed)
    img_r, g_rep = _grads(mc.render_replay, scene, cam, cfg, seed)
    np.testing.assert_array_equal(img_r.numpy(), img_s.numpy())
    for name, a, b in zip(("albedo", "v0", "center"), g_rep, g_std):
        a, b = a.numpy(), b.numpy()
        assert np.isfinite(a).all() and np.any(b != 0.0), name
        if name == "albedo":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-6 * np.abs(b).max())
    # Emission: its own leaf (the emissive mask is read from it).
    em = scene.materials.emission.clone().requires_grad_(True)
    s2 = scene.replace(materials=scene.materials.replace(emission=em))
    g = [torch.autograd.grad(torch.mean(fn(s2, cam, cfg, seed,
                                           device="cpu") ** 2), em)[0]
         for fn in (mc.render, mc.render_replay)]
    assert np.any(g[0].numpy() != 0.0)
    np.testing.assert_allclose(g[1].numpy(), g[0].numpy(), rtol=1e-5,
                               atol=1e-8)


def test_replay_gradients_match_jax(jax_replay):
    scene, cam, cfg, seed = _port()
    img, got = _grads(mc.render_replay, scene, cam, cfg, seed)
    np.testing.assert_allclose(img.numpy(), jax_replay["img"], rtol=ref.RTOL,
                               atol=ref.ATOL)
    for name, a, b, atol in zip(("albedo", "v0", "center"), got,
                                jax_replay["grads"], (1e-6, 1e-5, 1e-5)):
        a = a.numpy()
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=atol * np.abs(b).max(), err_msg=name)


def test_replay_fd_validates_albedo():
    """Central differences on one albedo channel through the replay."""
    scene, cam, cfg, seed = _port()

    def loss(a):
        albedo = scene.materials.albedo.clone()
        albedo[2, 0] = a
        s = scene.replace(materials=scene.materials.replace(albedo=albedo))
        return torch.mean(mc.render_replay(s, cam, cfg, seed, device="cpu"))

    x0 = scene.materials.albedo[2, 0].clone().requires_grad_(True)
    g = torch.autograd.grad(loss(x0), x0)[0].item()
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(x0 + eps) - loss(x0 - eps)).item() / (2 * eps)
    assert g != 0.0
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-7)


def test_replay_mesh_record_pass():
    """The index pass through the packet intersector (its plain version
    here, detached), the replay O(R): image equal to the standard packet
    render, albedo gradients finite and nonzero."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    cam = cornell.cornell_camera()
    bundle = mesh.prepare(scene, method="packet")
    isect = mesh.make_intersect_fn(bundle, sort_rays=True)
    near = mesh.make_nearest_t_fn(bundle, sort_rays=True)
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=4)
    seed = ref.seed_word(KEY)
    a = mc.render(scene, cam, cfg, seed, device="cpu", intersect_fn=isect,
                  nearest_t_fn=near).numpy()
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    s2 = scene.replace(materials=scene.materials.replace(albedo=albedo))
    img = mc.render_replay(s2, cam, cfg, seed, device="cpu",
                           intersect_fn=isect, nearest_t_fn=near)
    np.testing.assert_allclose(img.detach().numpy(), a, rtol=1e-4, atol=4e-6)
    np.testing.assert_array_equal(img.detach().numpy(), a)
    g = torch.autograd.grad(torch.mean(img ** 2), albedo)[0].numpy()
    assert np.isfinite(g).all() and np.any(g != 0.0)


def test_replay_guards():
    scene, cam, cfg, seed = _port()
    soft = cfg.replace(soft_shadow_beta=0.05)
    for fn in (mc.render_replay, mc.record_trace):
        with pytest.raises(ValueError, match="hard shadows"):
            fn(scene, cam, soft, seed, device="cpu")
    recs = mc.record_trace(scene, cam, cfg, seed, "cpu")
    with pytest.raises(ValueError, match="hard shadows"):
        mc.render_from_trace(scene, cam, soft, seed, recs, "cpu")
    o, d, pixel = mc._primary_rays(cam, cfg, seed, 0)
    first = intersect.intersect_scene(scene, o, d, t_min=cfg.t_min)
    for kw in (dict(return_record=True), dict(record=recs[0])):
        with pytest.raises(ValueError, match="first_hit"):
            mc.trace(scene, o, d, cfg, seed=seed, pixel=pixel, sample=0,
                     first_hit=first, **kw)


def test_replay_on_the_cpu_runs_eagerly():
    """The CPU route is ``_replay`` itself: counted ``eager``, nothing
    captured, the image and gradients of the body called directly."""
    scene, cam, cfg, seed = _port()
    recs = mc.record_trace(scene, cam, cfg, seed, "cpu")
    out, counts = [], []
    for fn in (lambda s: mc.render_from_trace(s, cam, cfg, seed, recs, "cpu"),
               lambda s: mc._replay(cfg, seed, s, cam, recs)):
        s, leaves = _leaves(scene)
        mc.REPLAY_GRAPH.reset()
        img = fn(s)
        out.append((img.detach(), torch.autograd.grad(torch.mean(img ** 2),
                                                      leaves)))
        counts.append(mc.REPLAY_GRAPH.snapshot())
    assert counts == [{"captures": 0, "replays": 0, "eager": 1},
                      {"captures": 0, "replays": 0, "eager": 0}]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_new_seeds_add_no_shared_constants():
    """A new seed word a call (the final-render traffic draws one an image)
    adds no shared constant: the hash's integer counters are Python ints,
    and only the configuration's float divisors are cached
    (``utils.consts``)."""
    scene, cam, cfg, seed = _port()
    engines = (lambda s: mc.render_replay(scene, cam, cfg, s, "cpu"),
               lambda s: mc.render(scene, cam, cfg, s, device="cpu"),
               lambda s: mc.render_turbo_exact(scene, cam, cfg, s,
                                               device="cpu"))
    for render in engines:
        render(seed)
    n = len(consts._CACHE)
    for k in range(1, 5):
        s = (seed + k * 0x9E3779B9) & 0xFFFFFFFF
        for render in engines:
            render(s)
    assert len(consts._CACHE) == n


class _Ops(TorchDispatchMode):
    """Every ATen operation dispatched, with its keyword arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((str(func), args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_replay_step_reads_and_copies_nothing_of_the_host():
    """What a CUDA graph cannot capture, seen on the CPU: a replay step
    (forward, recomputation, backward) after the first makes no tensor
    from host data (``lift_fresh``: ``torch.tensor(c)``), reads no value
    back (``_local_scalar_dense``: ``.item()``, ``int(t)``), sizes no
    output by its data (``nonzero``, ``masked_select``) and moves no
    tensor between devices."""
    scene, cam, cfg, seed = _port()
    recs = mc.record_trace(scene, cam, cfg, seed, "cpu")

    def step():
        s, leaves = _leaves(scene)
        img = mc.render_from_trace(s, cam, cfg, seed, recs, "cpu")
        torch.autograd.grad(torch.mean(img ** 2), leaves)

    step()                       # builds the shared constants
    ops = _Ops()
    with ops:
        step()
    names = [c[0] for c in ops.calls]
    assert len(names) > 1000 and "aten.index_select.default" in names
    refused = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero",
               "aten.masked_select", "aten.is_nonzero", "aten.item")
    assert not [n for n in names if n.startswith(refused)]
    for name, args, kw in ops.calls:
        if name.startswith("aten._to_copy") and "device" in kw:
            assert kw["device"] == args[0].device, name


def test_light_sample_matches_jax():
    """``sample_area_light`` picks the light triangle by a binary search of
    the area CDF where JAX counts the entries at or below the budget: the
    same triangle on every lane (the mesh scene: 1,302 triangles, zero
    areas repeat CDF entries; draws of 0, just below 1 and seeded), the
    same point to 1e-6."""
    from cpu_based_ray_tracer_tpu.ops import sampling as jsampling
    from cpu_based_ray_tracer_tpu.scenes import meshes as jmeshes

    from cpu_based_ray_tracer_tpu_torch.ops import sampling

    ico = jmeshes.icosphere(1)
    jscene = jcornell.cornell_mesh_scene(ico)
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    g = np.random.default_rng(9)
    u = g.uniform(0.0, 1.0, (3, 4096)).astype(np.float32)
    u[0, :3] = [0.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 0.5]
    got = sampling.sample_area_light(scene, *map(torch.as_tensor, u))
    want = jsampling.sample_area_light(jscene, *map(jnp.asarray, u))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for f in ("position", "normal", "emission", "pdf"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
