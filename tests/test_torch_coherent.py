"""The port's shortlist intersector (``ops.coherent``), the mesh stage's
``fused`` and ``sparse`` methods, and the BVH traversal against the JAX
package.  The JAX Pallas kernels run in interpret mode, as
``tests/test_coherent.py`` runs them, on ``bvh_stage_scene(subdivisions=2)``
in 64-triangle clusters (41 clusters).

Tolerances:
- the packs byte for byte; the shortlists (ids and counts) exactly, on
  pixel-tiled, strip-tiled, ragged and lim-bounded ray sets;
- ``coherent.nearest`` against JAX's: hit masks equal, t rtol 1e-5 and
  indices equal on all but 0.5% of the rays.  Not bit for bit: XLA's CPU
  code, which runs the interpreted kernel, contracts each a * b + c into a
  fused multiply-add, while the port (like its CUDA kernel, built with
  -fmad=false) rounds the product, so t differs by a few ulp (2.5e-6 at
  most here) and a near-tie winner can flip;
- against brute force, the JAX package's own gate
  (``tests/test_coherent.py:42-47``): rtol 2e-6, winners on all but 0.2%;
- ``mesh.render(method="fused")`` against JAX's under the Whitted-twin
  gate (rtol 1e-5, atol 1e-6 on all but 0.5% knife-edge pixels), and
  against the port's ``brute`` at rtol 1e-4, atol 1e-5
  (``tests/test_coherent.py:59``);
- ``bvh.traverse`` against JAX's: hit masks equal, t rtol 1e-6 and indices
  equal (XLA's multiply-adds again); ``method="sparse"`` against
  ``brute`` at rtol 1e-5, atol 1e-6."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cpu_based_ray_tracer_tpu.config import RenderConfig as JConfig
from cpu_based_ray_tracer_tpu.models import mesh as jmesh
from cpu_based_ray_tracer_tpu.ops import bvh as jbvh
from cpu_based_ray_tracer_tpu.ops import coherent as jcoherent
from cpu_based_ray_tracer_tpu.scenes import meshes as jmeshes

from cpu_based_ray_tracer_tpu_torch import camera, interop
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import mesh
from cpu_based_ray_tracer_tpu_torch.ops import (bvh, clusters, coherent,
                                                fused_mesh, intersect)
from cpu_based_ray_tracer_tpu_torch.scenes import meshes

CS = 64
T_MIN = 1e-3
W, H = 48, 36              # the image of tests/test_coherent.py's render
KNIFE_EDGE_SHARE = 0.005


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _packs():
    scene = meshes.bvh_stage_scene(subdivisions=2)
    jpack = jcoherent.pack_coherent(jmeshes.bvh_stage_scene(subdivisions=2),
                                    cluster_size=CS)
    return scene, coherent.pack_coherent(scene, cluster_size=CS), jpack


def _fused_bundle():
    """The ``fused`` bundle of the test scene in 64-triangle clusters, as
    ``mesh.prepare`` builds it (which clusters 128)."""
    scene, pack, _ = _packs()
    return mesh.MeshBundle(scene=scene, clusters=None, method="fused",
                           coherent=pack)


def _camera_rays(w, h):
    cam = meshes.bvh_stage_camera()
    d = camera.perspective_rays(cam, w, h).reshape(-1, 3)
    return cam.position.expand(d.shape).contiguous(), d.contiguous()


def _lim_rays(n=1000):
    """Random segments through the meshes, with their lim plane."""
    g = np.random.default_rng(5)
    o = g.uniform((-3.0, 1.0, -2.0), (1.0, 8.0, 2.0), (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lim = g.uniform(0.0, 4.0, n)
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    return t(o), t(d), t(lim)


@functools.lru_cache(maxsize=None)
def _jax_nearest(w, h):
    _, pack, jpack = _packs()
    o, d = _camera_rays(w, h)
    tt, idx = jcoherent.nearest(
        jpack.tri, jpack.aabb, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        n_cl=pack.n_clusters, cs=CS, t_min=T_MIN, hw=(h, w), interpret=True)
    return np.asarray(tt), np.asarray(idx)


def test_pack_coherent_byte_equal():
    scene, got, want = _packs()
    assert got.tri.numpy().tobytes() == np.asarray(want.tri).tobytes()
    assert got.aabb.numpy().tobytes() == np.asarray(want.aabb).tobytes()
    assert (got.cs, got.n_tri) == (want.cs, want.n_tri) == (CS, 2624)
    assert got.n_clusters == 41
    back = interop.coherent_pack_from_arrays(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in want._asdict().items()})
    assert torch.equal(back.tri, got.tri) and torch.equal(back.aabb, got.aabb)


@pytest.mark.parametrize("case", ["pixel_tiles", "strips", "ragged", "lim"])
def test_shortlists_match_jax(case):
    """Planes, ids and counts equal JAX ``coherent._shortlists``."""
    _, pack, jpack = _packs()
    if case == "lim":
        o, d, lim = _lim_rays()
        rays, _ = coherent._to_planes(o, d, None)
        lim_plane = torch.zeros((1,) + rays.shape[1:])
        lim_plane.view(-1)[:lim.shape[0]] = lim
        rays = torch.cat([rays, lim_plane], 0)
        jrays = jnp.asarray(rays.numpy())
    else:
        w, h = (41, 37) if case == "ragged" else (W, H)
        hw = (h, w) if case == "pixel_tiles" else None
        o, d = _camera_rays(w, h)
        rays, shape = coherent._to_planes(o, d, hw)
        jrays, jshape = jcoherent._to_planes(jnp.asarray(o.numpy()),
                                             jnp.asarray(d.numpy()), hw)
        assert shape == jshape
        np.testing.assert_array_equal(rays.numpy(), np.asarray(jrays))
    ids, cnts = coherent._shortlists(pack.aabb, rays, T_MIN)
    jids, jcnts = jcoherent._shortlists(jpack.aabb, jrays,
                                        n_cl=pack.n_clusters, t_min=T_MIN,
                                        interpret=True)
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert 0 < int(cnts.min()) and int(cnts.max()) <= pack.n_clusters


def test_mask_plain_words_are_tile_ors():
    """The tile words are the OR of the lanes' mask words over each
    32 x 128 tile, bit for bit (the OR the kernel fuses in)."""
    _, pack, _ = _packs()
    o, d = _camera_rays(W, H)
    rays, _ = coherent._to_planes(o, d, (H, W))
    masks, words = coherent.mask_plain(pack.aabb, rays, T_MIN)
    assert masks.shape == (2, 64, 128) and words.shape == (2, 2)
    tiles = coherent._tile_major(masks).to(torch.int64) & 0xFFFFFFFF
    ors = torch.zeros((2, 2), dtype=torch.int64)
    for b in range(32):
        ors |= (((tiles >> b) & 1).amax(2) << b).T
    assert torch.equal(coherent._wrap_u32(ors), words)


def test_nearest_matches_jax():
    _, pack, _ = _packs()
    o, d = _camera_rays(W, H)
    tt, idx = coherent.nearest(pack, o, d, T_MIN, hw=(H, W))
    want_t, want_i = _jax_nearest(W, H)
    tt, idx = tt.numpy(), idx.numpy()
    hit = want_t < intersect.NO_HIT_T
    np.testing.assert_array_equal(tt < intersect.NO_HIT_T, hit)
    np.testing.assert_allclose(tt[hit], want_t[hit], rtol=1e-5)
    assert (tt[~hit] == intersect.NO_HIT_T).all() and (idx[~hit] == -1).all()
    assert (idx != want_i).mean() < KNIFE_EDGE_SHARE
    assert 0 < hit.sum() < hit.size


def test_nearest_matches_brute():
    """The JAX package's gate (``tests/test_coherent.py:25-47``) on the
    port, strip-tiled at 40x30."""
    scene, pack, _ = _packs()
    o, d = _camera_rays(40, 30)
    tt, idx = coherent.nearest(pack, o, d, T_MIN)
    tr = scene.triangles
    tm = intersect.triangle_t_matrix(o, d, tr.v0, tr.e1, tr.e2, T_MIN,
                                     float("inf"))
    t_ref, i_ref = torch.min(tm, -1)
    hit = t_ref < 1e30
    np.testing.assert_allclose(tt[hit].numpy(), t_ref[hit].numpy(),
                               rtol=2e-6)
    assert (tt[~hit] >= intersect.NO_HIT_T).all()
    assert (hit & (idx != i_ref)).float().mean() < 0.002


@functools.lru_cache(maxsize=None)
def _fused_render():
    cfg = RenderConfig(width=W, height=H, whitted_depth=3)
    return mesh.render(_fused_bundle(), meshes.bvh_stage_camera(), cfg,
                       device="cpu").numpy()


def test_mesh_render_fused_matches_jax():
    want = np.asarray(jmesh.render(
        jmesh.prepare(jmeshes.bvh_stage_scene(subdivisions=2),
                      method="fused", cluster_size=CS),
        jmeshes.bvh_stage_camera(), JConfig(width=W, height=H,
                                            whitted_depth=3)))
    got = _fused_render()
    assert got.shape == (H, W, 3)
    bad = (np.abs(got - want) > 1e-6 + 1e-5 * np.abs(want)).any(-1)
    assert bad.mean() < KNIFE_EDGE_SHARE


def test_mesh_render_fused_matches_brute():
    scene, _, _ = _packs()
    cfg = RenderConfig(width=W, height=H, whitted_depth=3)
    brute = mesh.render(mesh.prepare(scene, method="brute"),
                        meshes.bvh_stage_camera(), cfg, device="cpu")
    np.testing.assert_allclose(_fused_render(), brute.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert float(brute.mean()) > 0.0


def test_fused_capacity_guard():
    """``tests/test_coherent.py:62-69``: the budget, and ``prepare``
    refusing a table past it."""
    _, pack, _ = _packs()
    assert fused_mesh.fits_resident(pack.n_clusters, pack.cs)
    assert not fused_mesh.fits_resident(4000, 128)
    assert fused_mesh.fits_resident(92, 128)                 # 736 KB exactly
    bundle = mesh.prepare(meshes.bvh_stage_scene(subdivisions=2),
                          method="fused")
    assert bundle.coherent.cs == 128 and bundle.coherent.n_clusters == 21
    with pytest.raises(ValueError):
        mesh.prepare(meshes.bvh_stage_scene(subdivisions=5), method="fused")


def _traverse_inputs():
    g = np.random.default_rng(2)
    tris = np.concatenate([meshes.icosphere(2), meshes.torus(1.6, 0.6, 16,
                                                             8)])
    o = g.uniform(-3.0, 3.0, (256, 3)).astype(np.float32)
    d = g.normal(size=(256, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return tris, o, d


def test_traverse_matches_jax():
    tris, o, d = _traverse_inputs()
    v0 = tris[:, 0].astype(np.float32)
    e1 = (tris[:, 1] - tris[:, 0]).astype(np.float32)
    e2 = (tris[:, 2] - tris[:, 0]).astype(np.float32)
    jflat = jbvh.build_bvh(tris, leaf_size=4)
    order = np.asarray(jflat.order)
    want_t, want_i = jbvh.traverse(
        jflat, jnp.asarray(v0[order]), jnp.asarray(e1[order]),
        jnp.asarray(e2[order]), jnp.asarray(o), jnp.asarray(d), T_MIN)
    flat = bvh.build_bvh(tris, leaf_size=4)
    t = lambda a: torch.as_tensor(a[order])  # noqa: E731
    got_t, got_i = bvh.traverse(flat, t(v0), t(e1), t(e2), torch.as_tensor(o),
                                torch.as_tensor(d), T_MIN)
    want_t, want_i = np.asarray(want_t), np.asarray(want_i)
    hit = want_t < intersect.NO_HIT_T
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(got_t.numpy() < intersect.NO_HIT_T, hit)
    np.testing.assert_allclose(got_t.numpy()[hit], want_t[hit], rtol=1e-6)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    # and the port's brute-force oracle agrees
    bt, bi = bvh.nearest_triangle_bruteforce(
        torch.as_tensor(v0), torch.as_tensor(e1), torch.as_tensor(e2),
        torch.as_tensor(o), torch.as_tensor(d), T_MIN)
    np.testing.assert_array_equal(bt.numpy(), got_t.numpy())
    np.testing.assert_array_equal(bi.numpy()[hit], got_i.numpy()[hit])


def test_mesh_render_sparse_matches_brute():
    scene = meshes.bvh_stage_scene(subdivisions=1)
    cam, cfg = meshes.bvh_stage_camera(), RenderConfig(width=24, height=16)
    bundle = mesh.prepare(scene, method="sparse")
    assert bundle.method == "sparse" and bundle.bvh.n_nodes > 1
    got = mesh.render(bundle, cam, cfg, device="cpu")
    want = mesh.render(mesh.prepare(scene, method="brute"), cam, cfg,
                       device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("which", ["mask", "sweep"])
def test_kernel_wrappers_refuse_cpu_tensors(which):
    """The wrappers raise ValueError on CPU tensors, before their launch
    counter moves."""
    _, pack, _ = _packs()
    o, d = _camera_rays(W, H)
    rays, _ = coherent._to_planes(o, d, (H, W))
    launches = coherent.LAUNCHES[which]
    with pytest.raises(ValueError):
        if which == "mask":
            coherent._mask_kernel(pack.aabb, rays, T_MIN)
        else:
            ids, cnts = coherent._shortlists(pack.aabb, rays, T_MIN)
            coherent._sweep_kernel(pack.tri, pack.aabb, rays, ids, cnts,
                                   T_MIN)
    assert coherent.LAUNCHES[which] == launches


def test_fused_render_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mesh.render(_fused_bundle(), meshes.bvh_stage_camera(),
                    RenderConfig(width=8, height=8))


def _edge_case_pack():
    """A hand-made pack of four 32-triangle clusters (two row groups each
    for the kernel's sub-box cull) and three 4,096-ray strip tiles of
    rays, made with numpy from a seed.
    - cluster 0: a 4 x 4 grid of half-unit squares in the plane z = 5 (its
      box flat in z; its row groups meet at x = 0); cluster 1: the same
      triangles under other indices, so
      every ray that hits cluster 0 meets two triangles at the same t (the
      first cluster of the list must win); cluster 2: a grid tilted about
      the y axis near x = 3; cluster 3: far off, crossed by no ray;
    - tile 0: rays from the origin toward the grids and toward their edges
      and corners, within 1e-6 of them, inside and out;
    - tile 1: rays that graze cluster 0's and cluster 2's boxes: along
      their faces at heights within 1e-6, nearly parallel to them;
    - tile 2: rays pointing away from every box: an empty list.
    -> tri (4, 32, MESH_NF) f32, aabb (4, 8) f32, origins and directions
    (12288, 3) f32."""
    g = np.random.default_rng(11)
    cs, nf = 32, clusters.MESH_NF
    tri = np.zeros((4, cs, nf), np.float32)

    def grid(corner, du, dv):
        rows = []
        for i in range(4):
            for j in range(4):
                p = corner + i * du + j * dv
                rows += [(p, du, du + dv), (p, du + dv, dv)]
        return rows

    z0 = np.array([-1.0, -1.0, 5.0])
    flat = grid(z0, np.array([0.5, 0, 0]), np.array([0, 0.5, 0]))
    tilt = grid(np.array([3.0, -1.0, 1.0]), np.array([0.125, 0, 0.5]),
                np.array([0, 0.5, 0]))
    far = grid(np.array([50.0, 50.0, -60.0]), np.array([0.5, 0, 0]),
               np.array([0, 0, 0.5]))
    for c, rows in enumerate((flat, flat, tilt, far)):
        for k, (v0, e1, e2) in enumerate(rows):
            tri[c, k, 0:3], tri[c, k, 3:6], tri[c, k, 6:9] = v0, e1, e2
            n = np.cross(e1, e2)
            tri[c, k, 9:12] = n / np.linalg.norm(n)
            tri[c, k, 13] = 100 * c + k
    aabb = np.zeros((4, 8), np.float32)
    for c in range(4):
        v = tri[c, :, 0:3].astype(np.float64)
        vs = np.concatenate([v, v + tri[c, :, 3:6], v + tri[c, :, 6:9]])
        aabb[c, 0:3] = np.nextafter(vs.min(0).astype(np.float32), -np.inf)
        aabb[c, 3:6] = np.nextafter(vs.max(0).astype(np.float32), np.inf)
    n = 4096
    off = g.uniform(-1e-6, 1e-6, (n, 3))
    # tile 0: toward the flat grid's points, edges and corners, and the
    # tilted grid's
    edge = g.choice([-1.0, 0.0, 1.0], (n, 2))
    free = g.uniform(-1.0, 1.0, (n, 2))
    pick = g.integers(0, 3, (n, 2))
    xy = np.where(pick == 0, edge, free)
    target = np.where(g.integers(0, 2, (n, 1)) == 0,
                      np.c_[xy, np.full(n, 5.0)],
                      np.c_[3.0 + 0.25 * (xy[:, 0] + 1.0), xy[:, 1],
                            1.0 + (xy[:, 0] + 1.0)]) + off
    o0, d0 = np.zeros((n, 3)), target
    # tile 1: along the faces z = 5 and x = 3, at heights within 1e-6, with
    # a slope of at most 1e-5
    o1 = g.uniform(-3.0, 3.0, (n, 3))
    d1 = g.normal(size=(n, 3))
    face = g.integers(0, 2, n)
    o1[:, 2] = np.where(face == 0, 5.0 + off[:, 2], o1[:, 2])
    d1[:, 2] = np.where(face == 0, g.uniform(-1e-5, 1e-5, n), d1[:, 2])
    o1[:, 0] = np.where(face == 1, 3.0 + off[:, 0], o1[:, 0])
    d1[:, 0] = np.where(face == 1, g.uniform(-1e-5, 1e-5, n), d1[:, 0])
    # tile 2: from (0, 0, -10), away from every box
    o2 = np.tile([0.0, 0.0, -10.0], (n, 1))
    d2 = np.c_[g.uniform(-0.1, 0.1, (n, 2)), -np.ones(n)]
    o = np.concatenate([o0, o1, o2]).astype(np.float32)
    d = np.concatenate([d0, d1, d2]).astype(np.float32)
    return tri, aabb, o, d


@functools.lru_cache(maxsize=None)
def _edge_case_jax():
    tri, aabb, o, d = _edge_case_pack()
    tt, idx = jcoherent.nearest(
        jnp.asarray(tri.reshape(4, -1, 128)), jnp.asarray(aabb),
        jnp.asarray(o), jnp.asarray(d), n_cl=4, cs=32, t_min=T_MIN,
        interpret=True)
    return np.asarray(tt), np.asarray(idx)


def test_sweep_edge_cases_match_jax():
    """The sweep's semantics through its plain version on the hand-made
    pack against JAX ``coherent.nearest`` (its Pallas kernels in interpret
    mode): hit masks and indices equal on all but knife-edge rays (XLA's
    multiply-adds: the rays aimed within 1e-6 of an edge are knife edges
    by design), t rtol 1e-5 where both hit; at the exact-t ties between
    clusters 0 and 1 both pick cluster 0's triangle; the third tile's list
    is empty and its rays miss."""
    tri, aabb, o, d = _edge_case_pack()
    pack = coherent.CoherentPack(tri=torch.as_tensor(tri),
                                 aabb=torch.as_tensor(aabb), cs=32, n_tri=128)
    tt, idx = coherent.nearest(pack, torch.as_tensor(o), torch.as_tensor(d),
                               T_MIN)
    tt, idx = tt.numpy(), idx.numpy()
    want_t, want_i = _edge_case_jax()
    hit = want_t < intersect.NO_HIT_T
    both = hit & (tt < intersect.NO_HIT_T)
    assert ((tt < intersect.NO_HIT_T) != hit).mean() < KNIFE_EDGE_SHARE
    np.testing.assert_allclose(tt[both], want_t[both], rtol=1e-5)
    assert (idx != want_i).mean() < KNIFE_EDGE_SHARE
    flat = both & (want_i < 100)
    assert flat.sum() > 1000 and (idx[flat] < 100).all()
    assert hit[4096:8192].sum() > 100 and not hit[8192:].any()
    rays, _ = coherent._to_planes(torch.as_tensor(o), torch.as_tensor(d),
                                  None)
    _, cnts = coherent._shortlists(pack.aabb, rays, T_MIN)
    assert cnts.tolist() == [3, 3, 0]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sweep_plain_slices_and_cull_are_bit_equal(k):
    """``sweep_plain`` with each tile's list cut into k slices, and with
    the kernel's padded-box cull, bit equal to the serial unculled sweep on
    the hand-made pack's rays (grazing rays, exact-t ties, an empty list)
    and on the test scene's camera rays (41 clusters)."""
    tri, aabb, o, d = _edge_case_pack()
    _, pack, _ = _packs()
    cam_o, cam_d = _camera_rays(W, H)
    cases = [(torch.as_tensor(tri), torch.as_tensor(aabb),
              *coherent._to_planes(torch.as_tensor(o), torch.as_tensor(d),
                                   None)),
             (pack.tri, pack.aabb,
              *coherent._to_planes(cam_o, cam_d, (H, W)))]
    for tri_, aabb_, rays, _ in cases:
        ids, cnts = coherent._shortlists(aabb_, rays, T_MIN)
        want = coherent.sweep_plain(tri_, rays, ids, cnts, T_MIN)
        assert bool((want[1] >= 0).any())
        for cull in (None, aabb_):
            got = coherent.sweep_plain(tri_, rays, ids, cnts, T_MIN, k=k,
                                       aabb=cull)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("cluster_size", [8, 256])
def test_sweep_plain_cull_takes_every_cluster_size(cluster_size):
    """The kernel's cull in ``sweep_plain`` on packs of 8 and of 256
    triangles a cluster (the least and the most the sweep kernel takes),
    at 1 and 3 slices: bit equal to the serial unculled sweep of the same
    pack, and its t bit equal to that of the test's 64-triangle pack."""
    scene, pack64, _ = _packs()
    pack = coherent.pack_coherent(scene, cluster_size=cluster_size)
    assert pack.cs == cluster_size
    cam_o, cam_d = _camera_rays(W, H)
    rays, _ = coherent._to_planes(cam_o, cam_d, (H, W))
    want64 = coherent.sweep_plain(pack64.tri, rays,
                                  *coherent._shortlists(pack64.aabb, rays,
                                                        T_MIN), T_MIN)
    ids, cnts = coherent._shortlists(pack.aabb, rays, T_MIN)
    want = coherent.sweep_plain(pack.tri, rays, ids, cnts, T_MIN)
    assert bool((want[1] >= 0).any())
    assert torch.equal(want[0].view(torch.int32), want64[0].view(torch.int32))
    for k in (1, 3):
        got = coherent.sweep_plain(pack.tri, rays, ids, cnts, T_MIN, k=k,
                                   aabb=pack.aabb)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


@pytest.mark.parametrize("cluster_size", [0, 12, 264, 512])
def test_pack_refuses_cluster_sizes_the_kernel_cannot_take(cluster_size):
    """pack_coherent refuses, on the CPU too, a cluster size that is not a
    multiple of 8 up to 256, with the rule in its message."""
    scene, _, _ = _packs()
    with pytest.raises(ValueError, match="multiple of 8 up to 256"):
        coherent.pack_coherent(scene, cluster_size=cluster_size)


def _cull_boxes(n=45, seed=7):
    """n small boxes on a sphere of radius 2 in sorted-centre order (a
    compact patch per 32-cluster word, as a BVH preorder gives), (n, 8)
    f32."""
    g = np.random.default_rng(seed)
    c = g.normal(size=(n, 3))
    c = 2.0 * c / np.linalg.norm(c, axis=1, keepdims=True)
    c = c[np.lexsort((c[:, 2], c[:, 1], np.round(c[:, 0], 0)))]
    half = g.uniform(0.05, 0.3, (n, 3))
    box = np.zeros((n, 8), np.float32)
    box[:, 0:3], box[:, 3:6] = c - half, c + half
    return torch.as_tensor(box)


def _grazing_rays(aabb, levels):
    """Rays along every face and edge of each word and group box where a
    member box attains it: an origin on that member's face (the face's
    centre) or edge (its midpoint) and a direction in the face's plane
    (along the edge), so the ray's segment touches the box at t = 0 only
    where its side lies; plus random rays through the boxes' sphere."""
    a = aabb.numpy().astype(np.float64)
    o, d = [], []
    for w in range(levels.shape[0]):
        for row in range(levels.shape[1]):
            lo, hi = levels[w, row, 0:3].numpy(), levels[w, row, 3:6].numpy()
            mem = np.arange(w * 32, min((w + 1) * 32, a.shape[0]))
            if row:
                mem = mem[(row - 1) * coherent.MASK_GROUP:
                          row * coherent.MASK_GROUP]
            for ax in range(3):
                for side, val in ((0, lo[ax]), (3, hi[ax])):
                    m = mem[a[mem, side + ax] == val]
                    if not len(m):
                        continue
                    b = a[m[0]]
                    ctr = (b[0:3] + b[3:6]) / 2
                    ctr[ax] = val
                    u, v = [k for k in range(3) if k != ax]
                    dd = np.zeros(3)
                    dd[u], dd[v] = 0.6, 0.8
                    o.append(ctr.copy())
                    d.append(dd)
                    # the edge at this face's max along u, along v
                    e = ctr.copy()
                    e[u] = b[3 + u]
                    dd = np.zeros(3)
                    dd[v] = 1.0
                    o.append(e)
                    d.append(dd)
    g = np.random.default_rng(11)
    ro = g.normal(size=(3000, 3))
    ro = 5.0 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
    rd = g.uniform(-2.0, 2.0, (3000, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = np.concatenate([np.array(o), ro]).astype(np.float32)
    d = np.concatenate([np.array(d), rd]).astype(np.float32)
    return torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("case", ["grazing", "lim", "ragged", "camera"])
def test_mask_plain_cull_is_bit_equal(case):
    """``mask_plain`` with the kernel's word and group box cull
    (``level_boxes``) bit equal to the flat mask: masks and tile words, on
    45 boxes (not a multiple of 32) under rays grazing each word and group
    box's faces and edges ("grazing"; with a lim plane ending each segment
    at random: "lim"; the first 2,500 counting: "ragged"), and on the test
    scene's camera rays (41 clusters).  A copy of the boxes with the word
    boxes, or the group boxes, shrunk by one ulp fails the grazing case."""
    if case == "camera":
        _, pack, _ = _packs()
        aabb = pack.aabb
        rays, _ = coherent._to_planes(*_camera_rays(W, H), (H, W))
    else:
        aabb = _cull_boxes()
        o, d = _grazing_rays(aabb, coherent.level_boxes(aabb))
        rays, _ = coherent._to_planes(o, d, None)
        if case == "lim":
            lim = torch.as_tensor(np.random.default_rng(3).uniform(
                0.0, 6.0, rays.shape[1:]).astype(np.float32))
            rays = torch.cat([rays, lim[None]], 0)
    cnt = torch.tensor([2500], dtype=torch.int32) if case == "ragged" else None
    levels = coherent.level_boxes(aabb)
    want = coherent.mask_plain(aabb, rays, T_MIN, cnt)
    got = coherent.mask_plain(aabb, rays, T_MIN, cnt, boxes=levels)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[1] != 0).any())
    if case == "grazing":
        for rows in (slice(0, 1), slice(1, None)):
            shrunk = levels.clone()
            shrunk[:, rows, 3:6] = torch.nextafter(
                shrunk[:, rows, 3:6], torch.tensor(-np.inf))
            bad = coherent.mask_plain(aabb, rays, T_MIN, cnt, boxes=shrunk)
            assert not torch.equal(bad[0], want[0])


def test_level_boxes_hold_their_members():
    """Each word box holds its 32 clusters' boxes and each group box its
    MASK_GROUP, with a side equal to a member's; a member whose sides are not
    ordered makes its group and word the whole space; a group past the
    last cluster is empty."""
    aabb = _cull_boxes()
    lv = coherent.level_boxes(aabb)
    assert lv.shape == (2, coherent.LEVEL_ROWS, 8)
    for w in range(2):
        for row in range(coherent.LEVEL_ROWS):
            mem = aabb[w * 32:(w + 1) * 32]
            g = coherent.MASK_GROUP
            if row:
                mem = mem[(row - 1) * g:row * g]
            if not len(mem):
                assert bool((lv[w, row, 0:3] > lv[w, row, 3:6]).all())
                continue
            assert torch.equal(lv[w, row, 0:3], mem[:, 0:3].amin(0))
            assert torch.equal(lv[w, row, 3:6], mem[:, 3:6].amax(0))
    bad = aabb.clone()
    bad[40, 0], bad[40, 3] = 1.0, -1.0
    lv = coherent.level_boxes(bad)
    inf = float("inf")
    for row in (0, 1 + (40 - 32) // coherent.MASK_GROUP):
        assert lv[1, row, 0:3].tolist() == [-inf] * 3
        assert lv[1, row, 3:6].tolist() == [inf] * 3
    assert torch.equal(lv[0], coherent.level_boxes(aabb)[0])
