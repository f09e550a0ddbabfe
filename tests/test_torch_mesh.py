"""The port's BVH mesh stage against the JAX package: the host-side builds
(meshes, BVH, clusters, scenes) byte for byte, the packet kernel's plain
version against the JAX ``packet.nearest`` (its Pallas kernel in interpret
mode), and the stage as a whole: ``mesh.render`` (Whitted) and
``mesh.render_mc`` / ``wavefront_mc_steps`` (Monte Carlo) through the
packet intersector.

Tolerances: hit masks and triangle indices equal, t rtol 1e-6
(``tests/test_packet.py:131-133``); the Whitted image rtol 1e-5, atol 1e-6;
the MC image 2e-3 and the MC integer lane state exactly
(``tests/test_mc_mesh.py``)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cpu_based_ray_tracer_tpu import camera as jcam
from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import mesh as jmesh
from cpu_based_ray_tracer_tpu.models import monte_carlo as jmc
from cpu_based_ray_tracer_tpu.ops import bvh as jbvh
from cpu_based_ray_tracer_tpu.ops import intersect as jintersect
from cpu_based_ray_tracer_tpu.ops import packet as jpacket
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.scenes import meshes as jmeshes
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import camera, interop
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import mesh
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import bvh, packet
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes
from cpu_based_ray_tracer_tpu_torch.utils import objio

import torch_ref as ref


def _assert_scene_bytes_equal(port_scene, jax_scene):
    a, b = interop.scene_to_arrays(port_scene), ref.scene_arrays(jax_scene)
    for k, v in b.items():
        for f, x in (v.items() if isinstance(v, dict) else [(k, v)]):
            y = a[k][f] if isinstance(v, dict) else a[k]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (k, f)


# --- host-side builds, byte for byte ------------------------------------------

def test_procedural_meshes_byte_equal():
    for sub in (1, 2, 3):
        assert meshes.icosphere(sub).tobytes() == \
            jmeshes.icosphere(sub).tobytes()
    for args in ((1.6, 0.6), (1.5, 0.4, 48, 32), (1.0, 0.35, 16, 8)):
        assert meshes.torus(*args).tobytes() == jmeshes.torus(*args).tobytes()
    t = meshes.transform(meshes.icosphere(1), 2.0, (-1, 6.1, 0))
    assert t.tobytes() == jmeshes.transform(jmeshes.icosphere(1), 2.0,
                                            (-1, 6.1, 0)).tobytes()


@pytest.mark.parametrize("leaf", [1, 4, 64])
def test_build_bvh_byte_equal(leaf):
    tris = np.concatenate([meshes.icosphere(2),
                           meshes.torus(1.6, 0.6, 16, 8)])
    want, got = jbvh.build_bvh(tris, leaf), bvh.build_bvh(tris, leaf)
    for f in ("node_min", "node_max", "node_skip", "leaf_first",
              "leaf_count", "order"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.n_nodes == want.n_nodes and got.max_leaf == want.max_leaf


def _leaf_order_mesh(case: str, leaf: int) -> np.ndarray:
    soup = np.concatenate([meshes.icosphere(3), meshes.torus(1.6, 0.6, 24,
                                                             10)])
    sizes = {"one": 1, "leaf": leaf, "leaf_plus_1": leaf + 1, "n1000": 1000,
             "icosphere3_torus": len(soup)}
    if case in sizes:
        return soup[:sizes[case]]
    rng = np.random.default_rng(7)
    if case == "duplicates_flat":
        # 12 distinct triangles, each many times over; every z equal
        base = rng.uniform(-1.0, 1.0, (12, 3, 3))
        base[..., 2] = 0.5
        return base[rng.integers(0, 12, 600)]
    # "signed_zeros": centroids at -0.0 and 0.0 on x and y, split around
    # a few triangles far out on each axis
    tris = np.repeat(rng.integers(0, 3, (300, 1, 3)).astype(np.float64), 3, 1)
    tris[..., 0:2] = np.where(rng.random((300, 1, 2)) < 0.5, -0.0, 0.0)
    tris[:4, :, 0] = [[-5.0], [5.0], [-5.0], [5.0]]
    tris[4:8, :, 1] = [[-3.0], [3.0], [-3.0], [3.0]]
    return tris


@pytest.mark.parametrize("case", ["one", "leaf", "leaf_plus_1", "n1000",
                                  "icosphere3_torus", "duplicates_flat",
                                  "signed_zeros"])
@pytest.mark.parametrize("leaf", [4, 8, 16])
def test_leaf_order_equals_build_bvh_order(case, leaf):
    """The level-by-level build gives the recursion's leaf order: the same
    split axes (the first of the greatest extents) and the same stable
    ties, -0.0 against 0.0 included."""
    tris = _leaf_order_mesh(case, leaf)
    if case == "signed_zeros":
        z = tris.min(1)[tris.min(1) == 0.0]
        assert np.signbit(z).any() and (~np.signbit(z)).any()
    got = bvh.leaf_order(tris, leaf)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  bvh.build_bvh(tris, leaf).order)
    levels = []
    bvh.leaf_order(torch.as_tensor(tris), leaf,
                   on_level=lambda: levels.append(1))
    assert len(levels) == len(bvh.split_levels(len(tris), leaf))


@pytest.mark.parametrize("cs", [32, 128])
def test_build_clusters_byte_equal(cs):
    tris = np.concatenate([meshes.icosphere(3),
                           meshes.torus(1.6, 0.6, 24, 12)])
    want, got = jpacket.build_clusters(tris, cs), packet.build_clusters(tris,
                                                                       cs)
    for f in ("tri", "aabb", "tri_id"):
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.cs == want.cs and got.n_clusters == want.n_clusters


def test_mesh_scenes_byte_equal():
    _assert_scene_bytes_equal(meshes.bvh_stage_scene(),
                              jmeshes.bvh_stage_scene())
    assert meshes.bvh_stage_scene().triangles.count == 3584
    for f, x in ref.camera_arrays(jmeshes.bvh_stage_camera()).items():
        np.testing.assert_array_equal(
            interop.camera_to_arrays(meshes.bvh_stage_camera())[f], x)
    ico = meshes.icosphere(2)
    _assert_scene_bytes_equal(cornell.cornell_mesh_scene(ico),
                              jcornell.cornell_mesh_scene(ico))
    # Without $CRT_REFERENCE_DIR both default to the icosphere stand-in.
    if meshes.reference_asset_dir() is None:
        _assert_scene_bytes_equal(cornell.cornell_mesh_scene(),
                                  jcornell.cornell_mesh_scene())


def test_parse_obj_fan_and_negative_indices(tmp_path):
    text = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
            "f 1/1 2/2 3/3 4\nf -4 -3 -2\n")
    p = tmp_path / "quad.obj"
    p.write_text(text)
    tris, uv = objio.load_obj(p, scale=2.0, translate=(1, 0, 0))
    assert tris.shape == (3, 3, 3) and uv.shape == (3, 3, 2)
    np.testing.assert_array_equal(tris[1, 2], [1.0, 2.0, 0.0])
    np.testing.assert_array_equal(uv[0, 2], [1.0, 1.0])


# --- the packet kernel's plain version -----------------------------------------

def _check_vs_jax(tris, o, d, t_min=1e-3, cs=32, rtol=1e-6):
    want_t, want_i = jpacket.nearest(jpacket.build_clusters(tris, cs),
                                     jnp.asarray(o), jnp.asarray(d), t_min,
                                     block=packet.BLOCK)
    want_t, want_i = np.asarray(want_t), np.asarray(want_i)
    got_t, got_i = packet.nearest_plain(packet.build_clusters(tris, cs),
                                        torch.as_tensor(o),
                                        torch.as_tensor(d), t_min)
    got_t, got_i = got_t.numpy(), got_i.numpy()
    np.testing.assert_array_equal(got_t < packet.NO_HIT,
                                  want_t < jpacket.NO_HIT)
    np.testing.assert_array_equal(got_i, want_i)
    hit = want_t < jpacket.NO_HIT
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=rtol)
    return hit


def _random_rays(seed, n, lo=-2.0, hi=2.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_nearest_plain_random_rays_icosphere():
    o, d = _random_rays(0, 512)
    hit = _check_vs_jax(meshes.icosphere(2), o, d)
    assert 0 < hit.sum() < hit.size


def test_nearest_plain_ray_padding():
    """A ray count that is not a multiple of the block."""
    o, d = _random_rays(3, 100)
    _check_vs_jax(meshes.icosphere(1), o, d)


def test_nearest_plain_t_min_respected():
    """A ray starting on a triangle does not hit it below t_min."""
    tris = meshes.icosphere(1)
    surf = tris[0].mean(0).astype(np.float32)
    o = np.stack([surf, surf])
    d = np.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    _check_vs_jax(tris, o, d)
    t, _ = packet.nearest(packet.build_clusters(tris, 32), torch.as_tensor(o),
                          torch.as_tensor(d), t_min=1e-3)
    assert (t[t < packet.NO_HIT] > 1e-3).all()


def test_nearest_plain_camera_rays_two_meshes():
    bunny = meshes.transform(meshes.icosphere(2), 2.0, (-1, 6.1, 0))
    teapot = meshes.transform(meshes.torus(1.6, 0.6, 16, 8), 1.0, (-1, 3, 0))
    tris = np.concatenate([bunny, teapot])
    cam = meshes.bvh_stage_camera()
    d = camera.perspective_rays(cam, 32, 16).reshape(-1, 3).numpy()
    o = np.broadcast_to(cam.position.numpy(), d.shape).copy()
    hit = _check_vs_jax(tris, o, d, cs=64)
    assert hit.any()


def test_nearest_plain_streams_large_mesh():
    """8,192 triangles in more clusters than the JAX kernel's 64-cluster
    block, with a padded tail there: against the JAX brute-force oracle,
    as ``tests/test_packet.py`` holds the JAX kernel."""
    tris = np.concatenate([meshes.icosphere(4, radius=1.0),
                           meshes.torus(1.5, 0.4, 48, 32)])
    clusters = packet.build_clusters(tris, cluster_size=64)
    assert clusters.n_clusters > jpacket.CLUSTER_BLOCK
    o, d = _random_rays(3, 512, -3.0, 3.0)
    t, idx, n_pass = packet.nearest_plain(clusters, torch.as_tensor(o),
                                          torch.as_tensor(d), 1e-3,
                                          return_passes=True)
    tm = jintersect.triangle_t_matrix(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris[:, 0], jnp.float32),
        jnp.asarray(tris[:, 1] - tris[:, 0], jnp.float32),
        jnp.asarray(tris[:, 2] - tris[:, 0], jnp.float32), 1e-3, jnp.inf)
    t_br = np.asarray(jnp.min(tm, -1))
    i_br = np.asarray(jnp.argmin(tm, -1))
    t = t.numpy()
    hit = t_br < packet.NO_HIT
    np.testing.assert_array_equal(t < packet.NO_HIT, hit)
    np.testing.assert_allclose(t[hit], t_br[hit], rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy()[hit], i_br[hit])
    assert (idx.numpy()[~hit] == -1).all()
    assert 0 < n_pass <= clusters.n_clusters * -(-512 // packet.BLOCK)


@pytest.mark.parametrize("r", [1, 255, 257, 4096])
def test_nearest_plain_per_ray_cull_matches_jax(r):
    """The plain version tests a ray against the clusters whose padded box
    it crosses, whatever its block: against the JAX kernel, whose block
    vote culls by the best hit so far, at ray counts around one 256-ray
    block and at 4,096 rays, with more clusters (40) than the kernel cuts
    its list into (at most 16 slices).  Hit masks and indices equal; t
    within rtol 1e-5: XLA's CPU code, which runs the interpreted kernel,
    contracts a * b + c into one rounding where the port (as the CUDA
    kernel, built with -fmad=false) rounds the product, so t differs by a
    few ulp on some rays (2e-6 here; ``test_torch_coherent.py`` says the
    same of the shortlist kernel)."""
    tris = meshes.icosphere(3)
    assert len(tris) // 32 > 16
    o, d = _random_rays(11 + r, r, -1.6, 1.6)
    hit = _check_vs_jax(tris, o, d, rtol=1e-5)
    if r > 1:
        assert 0 < hit.sum() < hit.size


# --- the stage ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mesh_render():
    js = jmeshes.bvh_stage_scene()
    b = jmesh.prepare(js)
    assert b.method == "packet"
    return np.asarray(jmesh.render(b, jmeshes.bvh_stage_camera(),
                                   JConfig(width=48, height=32)))


def test_mesh_render_packet_matches_jax():
    bundle = mesh.prepare(meshes.bvh_stage_scene())
    assert bundle.method == "packet" and bundle.clusters.n_clusters == 32
    got = mesh.render(bundle, meshes.bvh_stage_camera(),
                      RenderConfig(width=48, height=32), device="cpu")
    assert got.shape == (32, 48, 3)
    np.testing.assert_allclose(got.numpy(), _jax_mesh_render(), rtol=1e-5,
                               atol=1e-6)


def test_mesh_render_brute_equals_packet():
    cfg = RenderConfig(width=24, height=16)
    scene, cam = meshes.bvh_stage_scene(), meshes.bvh_stage_camera()
    a = mesh.render(mesh.prepare(scene), cam, cfg, device="cpu")
    b = mesh.render(mesh.prepare(scene, method="brute"), cam, cfg,
                    device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_mesh_render_packet_takes_the_whole_image(monkeypatch):
    """mesh.render gives the packet intersector the whole image as one ray
    set (136x128 = 17,408 rays, past the Whitted twin's default chunk of
    16,384): one camera pass and one shadow pass per light, each of every
    pixel; the image equals the render in chunks of 16,384 rays."""
    from cpu_based_ray_tracer_tpu_torch.models import whitted

    scene, cam = meshes.bvh_stage_scene(1), meshes.bvh_stage_camera()
    bundle = mesh.prepare(scene, method="packet")
    cfg = RenderConfig(width=136, height=128)
    sizes, real = [], packet.nearest

    def recording(clusters, origin, direction, t_min=0.0):
        sizes.append(origin.shape[0])
        return real(clusters, origin, direction, t_min)
    monkeypatch.setattr(packet, "nearest", recording)
    got = mesh.render(bundle, cam, cfg, device="cpu")
    assert sizes == [136 * 128] * (1 + scene.lights.count)
    sizes.clear()
    want = whitted.render(scene, cam, cfg.replace(ray_chunk=16384),
                          intersect_fn=mesh.make_intersect_fn(bundle),
                          nearest_t_fn=mesh.make_nearest_t_fn(bundle),
                          device="cpu")
    assert sizes == [16384] * (2 * (1 + scene.lights.count))
    assert got.shape == (128, 136, 3) and float(got.mean()) > 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_prepare_methods():
    small = meshes._mesh_scene(meshes.icosphere(1))
    assert mesh.prepare(small).method == "brute"          # 80 < 512
    assert mesh.prepare(meshes.bvh_stage_scene()).method == "packet"
    fused = mesh.prepare(small, method="fused")
    assert fused.method == "fused" and fused.coherent.n_clusters == 1
    sparse = mesh.prepare(small, method="sparse")
    assert sparse.method == "sparse" and sparse.pv0.shape == (80, 3)
    with pytest.raises(ValueError):
        mesh.prepare(small, method="octree")


def _mc_inputs():
    ico = meshes.icosphere(2)
    return (cornell.cornell_mesh_scene(ico), jcornell.cornell_mesh_scene(ico),
            cornell.cornell_camera(), jcornell.cornell_camera())


def test_mesh_render_mc_packet_matches_jax():
    scene, jscene, cam, jc = _mc_inputs()
    kw = dict(width=16, height=16, spp=2, max_depth=4)
    want = np.asarray(jmesh.render_mc(
        jmesh.prepare(jscene, method="packet"), jc,
        JConfig(**kw), jrng.render_key(5)))
    got = mesh.render_mc(mesh.prepare(scene, method="packet"), cam,
                         RenderConfig(**kw), ref.seed_word(5), device="cpu")
    assert got.shape == (16, 16, 3) and float(got.mean()) > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=ref.RTOL,
                               atol=ref.ATOL)


def test_mesh_wavefront_mc_steps_match_jax():
    scene, jscene, cam, jc = _mc_inputs()
    kw = dict(width=16, height=12, spp=2, max_depth=4)
    key = jrng.render_key(9)
    jb = jmesh.prepare(jscene, method="packet")
    st0 = jmc.wavefront_init(jscene, jc, JConfig(**kw), key)
    want = ref.state_numpy(jmesh.wavefront_mc_steps(jb, jc, JConfig(**kw),
                                                    key, st0, 5))
    cfg, seed = RenderConfig(**kw), ref.seed_word(9)
    st = mc.wavefront_init(scene, cam, cfg, seed, device="cpu")
    got = mesh.wavefront_mc_steps(mesh.prepare(scene, method="packet"), cam,
                                  cfg, seed, st, 5)
    ref.assert_states_match(want, ref.state_numpy(got))


def test_mesh_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = mesh.prepare(meshes.bvh_stage_scene())
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    with pytest.raises(RuntimeError):
        mesh.render(bundle, meshes.bvh_stage_camera(), cfg)
    with pytest.raises(RuntimeError):
        mesh.render_mc(bundle, cornell.cornell_camera(), cfg, 0)


def test_packet_kernel_wrapper_refuses_cpu_tensors():
    cl = packet.build_clusters(meshes.icosphere(1), 32)
    with pytest.raises(ValueError):
        packet._nearest_kernel(cl, torch.zeros((4, 3)), torch.zeros((4, 3)),
                               1e-3)
