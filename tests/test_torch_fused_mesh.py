"""The port's fused mesh-MC engine (``ops.fused_mesh``) against the JAX
package: the host-side packs byte for byte, the plain compaction against
the JAX ``ops.compact`` helpers (Pallas interpreter), and the plain stepper
against the JAX Pallas engine in interpret mode and against the JAX XLA
wavefront through the packet intersector.

Tolerances (``tests/test_fused_mesh.py``): integer lane state, ``nrays``,
the overflow and the predicate populations exactly; float lane state and
images rtol = atol = 2e-3; the slab composition bit for bit.  The scene is
the Cornell box with an 80-triangle icosphere in 64-triangle clusters."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from cpu_based_ray_tracer_tpu import scene as jscene_mod
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import mesh as jmesh
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.ops import compact as jcompact
from cpu_based_ray_tracer_tpu.ops import fused_mesh as jfm
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import interop
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import clusters, compact, fused
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
from cpu_based_ray_tracer_tpu_torch.scene import make_spheres
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

import torch_ref as ref
from test_torch_cuda import flat_far_clusters

N_SMALLS = 22      # walls, light and tall box of cornell_mesh_scene
SPHERE = ((1.0, 3.0, 2.0), 0.5, 0)    # a white sphere left of the mesh


@functools.lru_cache(maxsize=None)
def _scenes(sub: int = 1, sphere: bool = False):
    ico = meshes.icosphere(sub, radius=1.0)
    scene = cornell.cornell_mesh_scene(ico)
    jscene = jcornell.cornell_mesh_scene(ico)
    if sphere:
        scene = scene.replace(spheres=make_spheres(*SPHERE))
        jscene = jscene.replace(spheres=jscene_mod.make_spheres(*SPHERE))
    return scene, jscene


def _gate(scene):
    return np.arange(scene.triangles.count) >= N_SMALLS


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in parallel workers, where the
    plain stepper's thread pool on 65,536-lane tensors only oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_pack(scene=None):
    scene = scene if scene is not None else _scenes()[0]
    return fm.pack_mesh_scene(scene, gate_mask=_gate(scene), cluster_size=64)


def _jax_pack_arrays(jmp) -> dict:
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in jmp._asdict().items()}


# --- the packs, byte for byte ------------------------------------------------

@pytest.mark.parametrize("case", ["default_gate", "explicit_gate",
                                  "icosphere3", "icosphere5"])
def test_pack_mesh_scene_byte_equal(case):
    """Every array of the pack byte-equal to JAX's, the ints and tuples
    equal; the light and sky rows equal the port's ``pack_scene``.
    icosphere5: 160 clusters, so the 64 spatial boxes are the predicate's."""
    sub, kw = {"default_gate": (1, dict(cluster_size=64)),
               "explicit_gate": (1, dict(cluster_size=64, gate=True)),
               "icosphere3": (3, {}), "icosphere5": (5, {})}[case]
    scene, jscene = _scenes(sub)
    gate = _gate(scene) if kw.pop("gate", False) else None
    got = fm.pack_mesh_scene(scene, gate_mask=gate, **kw)
    want = _jax_pack_arrays(jfm.pack_mesh_scene(jscene, gate_mask=gate, **kw))
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), want[f.name]
        if isinstance(a, torch.Tensor):
            a = a.numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.gate_mask.sum() == scene.triangles.count - N_SMALLS
    if case == "icosphere3":
        assert got.n_clusters == 10 and got.cs == 128
    if case == "icosphere5":
        assert got.n_clusters == 160 and len(got.boxes) == 64
        assert got.pred_aabb is got.smc_box_aabb
    fs = fused.pack_scene(scene)
    assert torch.equal(got.light, fs.light) and torch.equal(got.sky, fs.sky)
    # the JAX pack carried across gives the same pack
    back = interop.mesh_pack_from_arrays(want)
    for f in ("stri", "smc_tri", "smc_aabb", "light"):
        assert torch.equal(getattr(back, f), getattr(got, f)), f


def test_build_smem_clusters_byte_equal():
    """A mesh with a padded last cluster (2,580 triangles, cs 128)."""
    tris = np.concatenate([meshes.icosphere(3), meshes.torus(1.6, 0.6, 24,
                                                             10)])
    rng = np.random.default_rng(1)
    nrm = rng.normal(size=(len(tris), 3)).astype(np.float32)
    mids = rng.integers(0, 4, len(tris)).astype(np.float32)
    got = clusters.build_smem_clusters(tris, nrm, mids, 128)
    want = jfm.build_smem_clusters(tris, nrm, mids, 128)
    for f in ("tri", "aabb", "box_aabb"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.boxes == want.boxes and got.cs == want.cs
    assert (got.tri[-1, :, 13] == -1.0).any()           # padded tail


@functools.lru_cache(maxsize=None)
def _scene_164k():
    """The benchmark's 163,862-triangle scene: two icospheres(6)."""
    soup = np.concatenate([meshes.icosphere(6), meshes.transform(
        meshes.icosphere(6), 0.6, (1.2, 0.9, 0.3))])
    return cornell.cornell_mesh_scene(soup, height=1.8)


@pytest.mark.parametrize("gate", [False, True])
def test_pack_counter_reads_the_device_a_fixed_number_of_times(gate):
    """One pack, one level pass a level of its BVH, and as many reads of
    the device at 1,302 triangles as at 163,862."""
    reads = []
    for scene in (_scenes(3)[0], _scene_164k()):
        fm.PACK.reset()
        mp = fm.pack_mesh_scene(scene, gate_mask=_gate(scene) if gate
                                else None)
        n, leaf = int(mp.gate_mask.sum()), max(8, mp.cs // 8)
        levels = next(lv for lv in range(64) if -(-n // 2 ** lv) <= leaf)
        got = fm.PACK.snapshot()
        assert got["packs"] == 1 and got["levels"] == levels
        reads.append(got["host_reads"])
    assert reads == ([2, 2] if gate else [3, 3])


# --- compaction against the JAX helpers (Pallas interpreter) -----------------

SUB = 8


def _jax_pack_unpack(x, pred):
    """JAX funnel_pack + funnel_unpack of (P, SUB, 128) planes, in a
    Pallas kernel under the interpreter -> (packed, count, unpacked,
    landed, prefix)."""
    n_planes = x.shape[0]

    def kern(x_ref, p_ref, pk_ref, un_ref, m_ref, pos_ref, c_ref):
        planes = [x_ref[j] for j in range(n_planes)]
        packed, count = jcompact.funnel_pack(planes, p_ref[:, :])
        tgt = packed[-1].astype(jnp.int32)   # the last plane: lane ids
        si = jax.lax.broadcasted_iota(jnp.int32, tgt.shape, 0)
        li = jax.lax.broadcasted_iota(jnp.int32, tgt.shape, 1)
        un, landed = jcompact.funnel_unpack(
            packed, tgt, (si * 128 + li < count).astype(jnp.int32))
        for j in range(n_planes):
            pk_ref[j] = packed[j]
            un_ref[j] = un[j]
        m_ref[:, :] = landed
        pos_ref[:, :] = jcompact.tile_prefix_pos(p_ref[:, :])
        c_ref[:, :] = jnp.full((SUB, 128), count, jnp.int32)

    shp = jax.ShapeDtypeStruct
    out = pl.pallas_call(kern, out_shape=[
        shp((n_planes, SUB, 128), jnp.float32),
        shp((n_planes, SUB, 128), jnp.float32),
        shp((SUB, 128), jnp.int32), shp((SUB, 128), jnp.int32),
        shp((SUB, 128), jnp.int32)], interpret=True)(jnp.asarray(x),
                                                    jnp.asarray(pred))
    pk, un, m, pos, c = (np.asarray(o) for o in out)
    return pk, int(c[0, 0]), un, m, pos


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
def test_compaction_matches_jax(density):
    """Prefix, packed lanes and count exact; the unpack inverts the pack
    (landed mask = predicate, values back in place) in both packages."""
    rng = np.random.default_rng(int(density * 100))
    x = rng.standard_normal((3, SUB, 128)).astype(np.float32)
    x[-1] = np.arange(SUB * 128, dtype=np.float32).reshape(SUB, 128)
    pred = (rng.random((SUB, 128)) < density).astype(np.int32)
    j_pk, j_cnt, j_un, j_landed, j_pos = _jax_pack_unpack(x, pred)

    tx, tp = torch.as_tensor(x), torch.as_tensor(pred)
    np.testing.assert_array_equal(compact.tile_prefix_pos(tp).numpy(), j_pos)
    packed, count = compact.funnel_pack(list(tx), tp)
    assert count == j_cnt == int(pred.sum())
    for j in range(3):
        np.testing.assert_array_equal(packed[j].reshape(-1)[:count].numpy(),
                                      j_pk[j].reshape(-1)[:count])
    valid = (torch.arange(SUB * 128) < count).reshape(SUB, 128)
    un, landed = compact.funnel_unpack(packed, packed[-1].to(torch.int32),
                                       valid)
    np.testing.assert_array_equal(landed.numpy() != 0, pred != 0)
    np.testing.assert_array_equal(j_landed != 0, pred != 0)
    for j in range(3):
        np.testing.assert_array_equal(un[j].numpy()[pred != 0],
                                      x[j][pred != 0])
        np.testing.assert_array_equal(j_un[j][pred != 0], x[j][pred != 0])


# --- the slice against the JAX engines ---------------------------------------

def _port_steps(cfg_kw, seed_k, n_steps, mp=None, sphere=False, **kw):
    scene, _ = _scenes(sphere=sphere)
    cfg, seed = RenderConfig(**cfg_kw), ref.seed_word(seed_k)
    cam = cornell.cornell_camera()
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    return fm.wavefront_steps_fused_mesh(mp or _port_pack(scene), cam, cfg,
                                         seed, st, n_steps, device="cpu",
                                         **kw)


def test_plain_stepper_matches_jax_pallas_interpret():
    """Against JAX ``wavefront_steps_fused_mesh`` (its five Pallas kernels
    in interpret mode) fed the same pack: integer state, nrays, overflow (0)
    and the predicate populations exact, floats 2e-3."""
    kw = dict(width=32, height=32, spp=4, max_depth=4, rr_survival=0.8)
    _, jscene = _scenes()
    jmp = jfm.pack_mesh_scene(jscene, gate_mask=_gate(jscene),
                              cluster_size=64)
    key = jrng.render_key(7)
    st0 = jmc.wavefront_init(jscene, jcornell.cornell_camera(),
                             JConfig(**kw), key)
    want, j_of, j_npred = jfm.wavefront_steps_fused_mesh(
        jmp, jcornell.cornell_camera(), JConfig(**kw), key, st0, 4,
        interpret=True)
    mp = interop.mesh_pack_from_arrays(_jax_pack_arrays(jmp))
    got, of, npred = _port_steps(kw, 7, 4, mp=mp)
    assert int(j_of) == 0 and int(of) == 0
    np.testing.assert_array_equal(npred.numpy(), np.asarray(j_npred))
    assert int(npred[0]) > 0 and int(npred[1]) > 0
    ref.assert_states_match(ref.state_numpy(want), ref.state_numpy(got))


def _xla_reference(cfg_kw, seed_k, n_steps, sphere=False):
    _, jscene = _scenes(sphere=sphere)
    cam, key = jcornell.cornell_camera(), jrng.render_key(seed_k)
    st0 = jmc.wavefront_init(jscene, cam, JConfig(**cfg_kw), key)
    b = jmesh.prepare(jscene, method="packet", cluster_size=64)
    return jmc.wavefront_steps(jscene, cam, JConfig(**cfg_kw), key, st0,
                               n_steps, intersect_fn=jmesh.make_intersect_fn(b),
                               nearest_t_fn=jmesh.make_nearest_t_fn(b))


@pytest.mark.parametrize("w,h,n_steps,rr,sphere", [
    (48, 48, 6, 0.8, False), (41, 37, 4, 0.5, False),
    (32, 32, 5, 0.8, True)])
def test_plain_stepper_matches_jax_xla_packet(w, h, n_steps, rr, sphere):
    """Against the JAX XLA wavefront through the packet intersector
    (``tests/test_fused_mesh.py:31-36``), also on a lane count that is no
    multiple of 4,096 and with a sphere among the smalls: integer state
    and nrays exact, floats 2e-3."""
    kw = dict(width=w, height=h, spp=4, max_depth=4, rr_survival=rr)
    want = _xla_reference(kw, 7, n_steps, sphere)
    got, of, _ = _port_steps(kw, 7, n_steps, sphere=sphere)
    assert int(of) == 0
    ref.assert_states_match(ref.state_numpy(want), ref.state_numpy(got))


def test_overflow_reported():
    """A 4,096-lane cap at 256x256 overflows on the primary step (far more
    primary rays cross the mesh AABBs), and the population is still
    counted in full."""
    kw = dict(width=256, height=256, spp=2, max_depth=3)
    _, of, npred = _port_steps(kw, 3, 1, cap_main=4096, cap_shadow=4096)
    n_main, n_shadow = npred.tolist()
    assert n_main > 4096
    assert int(of) == n_main - 4096 + max(n_shadow - 4096, 0)


def test_render_turbo_mesh_tight_caps_equal_full_caps():
    """``render_turbo_mesh`` starts from the smallest cap (4,096 lanes at
    80x80), doubles on overflow and reruns the chunk: the image is
    bit-equal to the same steps with full caps, which never overflow.
    Every non-emissive triangle is gated, walls included, so the predicate
    fires for nearly every lane (the JAX package's adversarial gate,
    ``tests/test_fused_mesh.py:158-212``)."""
    scene, _ = _scenes()
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=80, height=80, spp=1, max_depth=2,
                       rr_survival=0.8)
    gate = ~np.asarray(scene.materials.emissive)[
        scene.triangles.material.numpy()]
    tight = fm.render_turbo_mesh(scene, cam, cfg, 4, gate_mask=gate,
                                 cluster_size=64, device="cpu")
    trace = list(fm.TRACE)
    assert trace[0]["cap_main"] == 4096 and trace[0]["overflow"] > 0
    assert trace[-1]["overflow"] == 0 and trace[-1]["cap_main"] > 4096
    steps = sum(t["steps"] for t in trace if t["overflow"] == 0)
    rp = 2 * 4096                                  # 6,400 lanes, whole tiles
    st = mc.wavefront_init(scene, cam, cfg, 4, device="cpu")
    st, of, _ = fm.wavefront_steps_fused_mesh(
        fm.pack_mesh_scene(scene, gate_mask=gate, cluster_size=64), cam, cfg,
        4, st, steps, cap_main=rp, cap_shadow=rp, device="cpu")
    assert int(of) == 0
    full = mc.wavefront_image(st, cfg)
    assert torch.equal(tight, full) and float(full.mean()) > 0.0


def test_render_turbo_mesh_exact_matches_jax_render():
    """The equal-spp renderer against JAX ``mc.render`` (fixed depth) through
    the packet intersector (``tests/test_fused_mesh.py:216-234``): the
    same paths, rtol = atol = 2e-3."""
    scene, jscene = _scenes()
    kw = dict(width=24, height=24, spp=3, max_depth=4, rr_survival=0.8)
    got = fm.render_turbo_mesh_exact(scene, cornell.cornell_camera(),
                                     RenderConfig(**kw), ref.seed_word(12),
                                     gate_mask=_gate(scene), cluster_size=64,
                                     device="cpu")
    b = jmesh.prepare(jscene, method="packet", cluster_size=64)
    want = np.asarray(jmc.render(
        jscene, jcornell.cornell_camera(), JConfig(**kw), jrng.render_key(12),
        intersect_fn=jmesh.make_intersect_fn(b),
        nearest_t_fn=jmesh.make_nearest_t_fn(b)))
    assert got.shape == (24, 24, 3) and float(got.mean()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


def test_slab_composition_bit_exact():
    """A row slab stepped with ``pixel_offset`` equals the same lanes of
    the full image, bit for bit (``tests/test_fused_mesh.py:252-287``)."""
    scene, _ = _scenes()
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=3,
                       rr_survival=0.8)
    seed, mp = ref.seed_word(6), _port_pack()
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    full, of, _ = fm.wavefront_steps_fused_mesh(mp, cam, cfg, seed, st, 3,
                                                device="cpu")
    assert int(of) == 0
    half = st.s.shape[0] // 2
    parts = []
    for k, sl in enumerate((slice(0, half), slice(half, None))):
        sub = dataclasses.replace(
            st, s=st.s[sl], b=st.b[sl], o=st.o[sl], d=st.d[sl],
            tp=st.tp[sl], cur=st.cur[sl], acc=st.acc[sl],
            n_done=st.n_done[sl])
        out, of2, _ = fm.wavefront_steps_fused_mesh(
            mp, cam, cfg, seed, sub, 3, pixel_offset=k * half, device="cpu")
        assert int(of2) == 0
        parts.append(out)
    for f in ("acc", "n_done", "s", "b", "o", "d", "tp", "cur"):
        assert torch.equal(getattr(full, f),
                           torch.cat([getattr(p, f) for p in parts])), f


# --- entry points and wrappers -----------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    """Without CUDA, the entry points called without ``device`` raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, _ = _scenes()
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    st = mc.wavefront_init(scene, cam, cfg, 0, device="cpu")
    for call in (
            lambda: fm.render_turbo_mesh_exact(scene, cam, cfg, 0),
            lambda: fm.render_turbo_mesh(scene, cam, cfg, 0),
            lambda: fm.wavefront_steps_fused_mesh(_port_pack(), cam, cfg, 0,
                                                  st, 1)):
        with pytest.raises(RuntimeError):
            call()


@pytest.mark.parametrize("op", ["k1", "nearest", "k1b", "occl", "k2"])
def test_kernel_wrappers_refuse_cpu_tensors(op):
    """Each kernel wrapper raises ValueError on CPU tensors, before its
    launch counter moves."""
    mp = _port_pack()
    p = fm.params(RenderConfig(width=16, height=16), 256)
    tb = fm._tables(mp, fused._camera_words(cornell.cornell_camera()))
    b = fm.step_buffers(256, p, 1, "cpu")
    sf = torch.zeros((15, 256))
    si = torch.zeros((4, 256), dtype=torch.int32)
    c1, c2 = b.cnt[0, 0:1], b.cnt[0, 1:2]
    call = {
        "k1": lambda: fm._k1_kernel(tb, p, sf, b.hf, b.mr, b.mr_id, b.offs1,
                                    c1),
        "nearest": lambda: fm._nearest_kernel(tb, p, b.mr, b.mr_id, c1,
                                              b.hf[5:10]),
        "k1b": lambda: fm._k1b_kernel(tb, p, 0, sf, si, b.hf, b.kb, b.sr,
                                      b.sr_id, b.offs2, c2),
        "occl": lambda: fm._occl_kernel(tb, p, b.sr, b.sr_id, c2,
                                        b.kb[8:9]),
        "k2": lambda: fm._k2_kernel(tb, p, 0, b.kb, sf, si)}[op]
    launches = fm.LAUNCHES[op]
    with pytest.raises(ValueError):
        call()
    assert fm.LAUNCHES[op] == launches


@pytest.mark.parametrize("what", ["soft_shadows"])
def test_unported_modes_raise(what):
    """Soft shadows are refused, not emulated."""
    scene, _ = _scenes()
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                       soft_shadow_beta=0.05)
    st = mc.wavefront_init(scene, cam, cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError):
        fm.wavefront_steps_fused_mesh(_port_pack(), cam, cfg, 0, st, 1,
                                      device="cpu")


# --- the shortlist-streaming mode (resident=False) ----------------------------

def _shortlist_run(cfg, n_steps, **kw):
    scene, _ = _scenes()
    cam, seed = cornell.cornell_camera(), ref.seed_word(9)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    return fm.wavefront_steps_fused_mesh(_port_pack(scene), cam, cfg, seed,
                                         st, n_steps, device="cpu", **kw)


def test_shortlist_stepper_equals_resident():
    """``resident=False`` steps bit for bit like the all-cluster sweep: the
    JAX gate of ``tests/test_fused_mesh.py:95-117`` (48x48, 64-triangle
    clusters, gated from triangle 22, 4 steps), on every field, the
    overflow and the populations."""
    cfg = RenderConfig(width=48, height=48, spp=4, max_depth=3,
                       rr_survival=0.8)
    a, of_a, np_a = _shortlist_run(cfg, 4, resident=True)
    b, of_b, np_b = _shortlist_run(cfg, 4, resident=False)
    assert int(of_a) == 0 and int(of_b) == 0
    assert torch.equal(np_a, np_b) and int(np_a[1]) > 0
    for f in ("s", "b", "n_done", "nrays", "o", "d", "tp", "cur", "acc"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("occl", [False, True])
def test_shortlist_sweep_matches_jax_pallas_interpret(occl):
    """The plain shortlist sweep (mask pass, lists, list sweep) against the
    JAX ``_mesh_pass(resident=False)`` (its mask and shortlist-sweep Pallas
    kernels in interpret mode) on the same packed buffer: 3,072 segments
    toward the mesh in one 4,096-ray tile, the idle rays pointing away.
    Occlusion flags exact; nearest: hits equal, t rtol 1e-5 and the
    winner's normal and material on all but 0.5% of the rays (XLA's CPU
    code contracts multiply-adds, the port does not, so near-ties can
    flip)."""
    _, jscene = _scenes()
    jmp = jfm.pack_mesh_scene(jscene, gate_mask=_gate(jscene),
                              cluster_size=64)
    mp = interop.mesh_pack_from_arrays(_jax_pack_arrays(jmp))
    g = np.random.default_rng(3)
    cap, n = fm.LANES_PER_TILE, 3072
    lo, hi = mp.smc_aabb[:, :3].amin(0), mp.smc_aabb[:, 3:6].amax(0)
    tgt = g.uniform(lo.numpy(), hi.numpy(), (n, 3))
    o = tgt + g.normal(size=(n, 3)) * 2.0
    seg = np.linalg.norm(tgt - o, axis=-1)
    rays = np.zeros((7, cap), np.float32)
    rays[0:3], rays[3:6] = 100.0, 1.0
    rays[0:3, :n], rays[3:6, :n] = o.T, ((tgt - o) / seg[:, None]).T
    rays[6, :n] = seg * g.uniform(0.3, 1.5, n)
    n_planes = 7 if occl else 6
    p = fm.params(RenderConfig(width=64, height=64), cap)
    jrays = np.concatenate([rays[:n_planes], np.arange(cap)[None]], 0)
    want = np.asarray(jfm._mesh_pass(
        jmp.smc_tri, jnp.asarray(jrays.reshape(n_planes + 1, -1, 128),
                                 jnp.float32),
        jnp.asarray([[n // 128, 0]], jnp.int32), jmp.smc_aabb,
        n_clusters=mp.n_clusters, cs=64, t_min=p.t_min, occl=occl,
        resident=False, interpret=True)).reshape(-1, cap)[:, :n]
    tb = fm._tables(mp, fused._camera_words(cornell.cornell_camera()))
    out = torch.zeros((1 if occl else 5, cap))
    fm._sl_sweep(tb, p, torch.as_tensor(rays[:n_planes]).contiguous(),
                 torch.arange(cap, dtype=torch.int32),
                 torch.tensor([n], dtype=torch.int32), out, occl=occl,
                 kernel=False)
    got = out[:, :n].numpy()
    if occl:
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < n
        return
    hit = want[0] < fused.NO_HIT
    assert 0 < hit.sum() < n
    np.testing.assert_array_equal(got[0] < fused.NO_HIT, hit)
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=1e-5)
    assert (got[1:] != want[1:]).any(0).mean() < 0.005


def _split_inputs():
    """Nine 16-triangle clusters, cluster 5 a copy of cluster 1, and two
    tiles of 256 rays aimed at them: tile 0 lists the clusters in order,
    tile 1 seven of them from the back, so a ray whose nearest triangle is
    in cluster 1 meets the same t again in cluster 5, in another slice."""
    g = np.random.default_rng(11)
    c, cs, n_l = 9, 16, 256
    tri = np.zeros((c, cs, clusters.MESH_NF), np.float32)
    tri[..., 0:3] = g.uniform(-1.0, 1.0, (c, cs, 3))
    tri[..., 3:9] = g.uniform(-0.6, 0.6, (c, cs, 6))
    tri[..., 9:12] = g.normal(size=(c, cs, 3))
    tri[..., 12] = g.integers(0, 4, (c, cs))
    tri[5] = tri[1]
    o = g.uniform(-3.0, 3.0, (2, n_l, 3))
    d = g.uniform(-0.5, 0.5, (2, n_l, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o.transpose(2, 0, 1), d.transpose(2, 0, 1),
                           g.uniform(0.5, 5.0, (1, 2, n_l))]).astype(
                               np.float32)
    ids = np.stack([np.arange(c), np.array([8, 5, 7, 1, 6, 2, 4, 0, 3])])
    return (torch.as_tensor(tri), torch.as_tensor(rays),
            torch.as_tensor(ids, dtype=torch.int32), torch.tensor([c, 7]))


@pytest.mark.parametrize("k", [1, 2, 3, 7])
@pytest.mark.parametrize("occl", [False, True])
def test_split_sweep_equals_serial(k, occl):
    """The list cut into k slices, each swept alone and combined by the
    kernel's rule, equals the serial list sweep bit for bit (t and winning
    row; occlusion flags), exact-t ties between the copied clusters
    included; k = 1 also makes the same tests."""
    tri, rays, ids, cnts = _split_inputs()
    rays = rays if occl else rays[:6]
    want = clusters.list_sweep_plain(tri, rays, ids, cnts, 1e-3, occl=occl,
                               n_live=400)
    got = clusters.split_sweep_plain(tri, rays, ids, cnts, 1e-3, k, occl=occl,
                               n_live=400)
    assert torch.equal(got[0], want[0])
    if occl:
        assert 0 < int(want[0].sum()) < 400
        assert int(got[2].sum()) >= int(want[2].sum())
    else:
        assert torch.equal(got[1], want[1])
        row = want[1][want[1] >= 0] // 16
        # ties: winners in the copied clusters, the earlier listed one wins
        assert bool((row == 1).any()) and bool((row == 5).any())
    if k == 1:
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("tilt", [0.0, 1e-3])
@pytest.mark.parametrize("occl", [False, True])
def test_box_cull_keeps_every_hit(tilt, occl):
    """The sweep kernel's cluster cull (``crosses_box_plain``, the same
    test) on clusters whose boxes are flat or nearly flat, far from the
    origin, under grazing rays near their edges: every ray that hits a
    triangle of a cluster (the plain sweep of that cluster alone) crosses
    its padded box, so the culled sweep's results are the unculled ones."""
    tri, aabb, rays = (torch.as_tensor(x) for x in flat_far_clusters(tilt))
    rays = rays if occl else rays[:6]
    crossed = clusters.crosses_box_plain(aabb, rays, 1e-3, occl=occl)
    for c in range(3):
        res, _, _ = clusters.list_sweep_plain(
            tri, rays[:, None], torch.tensor([[c]]), torch.tensor([1]), 1e-3,
            occl=occl)
        hit = res[0] if occl else res[0] < fm.NO_HIT
        assert int(hit.sum()) > 100
        assert bool(crossed[c][hit].all())
    # the pad is thin: most rays cross only the box they aim at
    assert int(crossed.sum()) < 1.2 * rays.shape[1]


@pytest.mark.parametrize("n_clusters,cs", [(2, 64), (40, 128), (92, 128),
                                           (93, 128), (1280, 128)])
def test_resident_auto_rule_matches_jax(n_clusters, cs):
    """``resident=None`` takes the JAX package's rule: resident exactly
    when the table fits its SMEM budget (92 clusters of 128 is 736 KB)."""
    want = n_clusters * cs * jfm.MESH_NF * 4 <= jfm.SMEM_RESIDENT_BUDGET
    assert fm.SMEM_RESIDENT_BUDGET == jfm.SMEM_RESIDENT_BUDGET
    assert fm.fits_resident(n_clusters, cs) == want


def test_resident_auto_rule_takes_the_shortlists(monkeypatch):
    """Past the budget (here set to 0) the default sweeps the shortlists:
    the mask pass runs, twice a step, and the state is the resident one."""
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=3)
    want, _, np_w = _shortlist_run(cfg, 2, resident=True)
    from cpu_based_ray_tracer_tpu_torch.ops import coherent

    calls, mask_plain = [], coherent.mask_plain
    monkeypatch.setattr(fm, "SMEM_RESIDENT_BUDGET", 0)
    monkeypatch.setattr(coherent, "mask_plain",
                        lambda *a, **kw: calls.append(a[1].shape[0])
                        or mask_plain(*a, **kw))
    got, of, np_g = _shortlist_run(cfg, 2)
    assert calls == [6, 7, 6, 7] and int(of) == 0
    assert torch.equal(np_g, np_w)
    for f in ("s", "b", "n_done", "acc"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("occl", [False, True])
def test_shortlist_sweep_wrapper_refuses_cpu_tensors(occl):
    mp = _port_pack()
    p = fm.params(RenderConfig(width=16, height=16), 256)
    tb = fm._tables(mp, fused._camera_words(cornell.cornell_camera()))
    b = fm.step_buffers(256, p, 1, "cpu")
    key = "occl_sl" if occl else "nearest_sl"
    rays, ids, out = ((b.sr, b.sr_id, b.kb[8:9]) if occl
                      else (b.mr, b.mr_id, b.hf[5:10]))
    lists = (torch.zeros((mp.n_clusters,), dtype=torch.int32),
             torch.zeros((1,), dtype=torch.int32))
    launches = fm.LAUNCHES[key]
    with pytest.raises(ValueError):
        fm._sweep_kernel(tb, p, rays, ids, b.cnt[0, 0:1], out, occl=occl,
                         lists=lists)
    assert fm.LAUNCHES[key] == launches
