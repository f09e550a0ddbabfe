"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``requires_cuda``: each test skips (from a fixture) where there is
no CUDA device.  The file imports nothing of JAX, so it also runs on a
machine with a card and no JAX, without the repository's conftest:
``python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py``."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu_torch import camera
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import mesh
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.models import denoiser
from cpu_based_ray_tracer_tpu_torch.ops import (bvh, clusters, coherent,
                                                denoise, fused, fused_mesh,
                                                fused_rtiow, fused_whitted,
                                                intersect, packet)
from cpu_based_ray_tracer_tpu_torch.scene import (REFLECTIVE_REFRACTIVE,
                                                  MaterialBuilder,
                                                  PointLights, make_scene,
                                                  make_spheres,
                                                  make_triangles)
from cpu_based_ray_tracer_tpu_torch.scenes import (cornell, meshes, rtiow,
                                                   whitted_scene)
from cpu_based_ray_tracer_tpu_torch.utils import consts, kernels

pytestmark = pytest.mark.requires_cuda

SEED = 4070199207  # seed_from_key(render_key(0)) of the JAX package


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(name, device):
    s = cornell.cornell_scene(device)
    if name == "cornell_sphere":
        s = s.replace(spheres=make_spheres((1.6, 2.6, 1.7), 0.7, 0, device))
    return s


@pytest.mark.parametrize("name,stop_after", [("cornell", 0), ("cornell", 2),
                                             ("cornell_sphere", 0)])
def test_kernel_matches_plain(cuda, name, stop_after):
    scene, cam = _scene(name, cuda), cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=96, height=64, spp=4, max_depth=6)
    fs = fused.pack_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device=cuda)
    want = fused.wavefront_steps_fused_plain(fs, cam, cfg, SEED, st, 12,
                                             stop_after=stop_after)
    launches = fused.LAUNCHES["fused_mc"]
    got = fused.wavefront_steps_fused(fs, cam, cfg, SEED, st, 12,
                                      stop_after=stop_after)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_mc"] == launches + 1
    for f in ("s", "b", "n_done", "nrays"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("o", "d", "tp", "cur", "acc"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=2e-3, atol=2e-3)


def test_render_turbo_exact_on_card(cuda):
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=5)
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    fused.LAUNCHES.reset()
    img = mc.render_turbo_exact(scene, cam, cfg, SEED)
    assert img.is_cuda and fused.LAUNCHES["fused_mc"] > 0
    plain = mc.render_turbo_exact(scene, cam, cfg, SEED, device="cpu")
    np.testing.assert_allclose(img.cpu().numpy(), plain.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("queue", [4, 2])
def test_whitted_kernel_matches_plain(cuda, queue):
    """Same algorithm, -fmad=false: the Fresnel, Snell and shading chains
    agree to a few ulp; the gate of tests/test_fused_whitted.py."""
    scene, cam = whitted_scene.whitted_scene(), whitted_scene.whitted_camera()
    cfg = RenderConfig(width=96, height=80)
    want, want_t = fused_whitted.render_fused_plain(scene, cam, cfg,
                                                    queue=queue, device=cuda)
    launches = fused_whitted.LAUNCHES["fused_whitted"]
    got, t = fused_whitted.render_fused(scene, cam, cfg, queue=queue)
    torch.cuda.synchronize()
    assert fused_whitted.LAUNCHES["fused_whitted"] == launches + 1
    diff = (got - want).abs().cpu().numpy()
    assert float(np.percentile(diff, 99)) < 1e-4
    assert (diff.max(-1) > 1e-3).mean() < 0.005
    np.testing.assert_allclose(float(t), float(want_t), rtol=1e-5)
    if queue == 4:
        assert float(t) == 0.0


def full_queue_scene(device="cpu"):
    """The Whitted scene with both spheres glass (ior 2.4 and 1.5) and the
    floor a glass quad (ior 2.4) facing down, so that camera rays meet its
    back: at 96x80 some pixels keep every slot of a Q = 4 or Q = 2 queue
    live, and grazing rays lose their refracted child to total internal
    reflection (a sphere never reflects totally what entered it)."""
    mb = MaterialBuilder()
    dense = mb.add(REFLECTIVE_REFRACTIVE, ior=2.4)
    glass = mb.add(REFLECTIVE_REFRACTIVE, ior=1.5)
    spheres = make_spheres(center=[[-1.0, 0.0, -12.0], [0.5, -0.5, -8.0]],
                           radius=[2.0, 1.5], material=[dense, glass],
                           device=device)
    v = np.array([[-5, -3, -6], [5, -3, -6], [5, -3, -16], [-5, -3, -16]],
                 np.float64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
    idx = np.array([[0, 3, 1], [1, 3, 2]])
    tris = make_triangles(v[idx], np.array([dense, dense]), uv=uv[idx],
                          device=device)
    sky = whitted_scene.SKY
    lights = PointLights(
        position=torch.tensor([[-20.0, 70.0, 20.0], [30.0, 50.0, -12.0]],
                              device=device),
        radiance=torch.full((2, 3), 0.5, device=device))
    return make_scene(triangles=tris, spheres=spheres,
                      materials=mb.build(device), lights=lights,
                      sky_bottom=sky, sky_top=sky, device=device)


@pytest.mark.parametrize("queue", [4, 2])
def test_whitted_kernel_matches_plain_on_full_queues(cuda, queue):
    """The kernel against its plain version (run on the card) within
    chip_smoke's PLAIN_ATOL of 1e-6 on every pixel, the truncated weight
    too, on a frame where some pixel has every slot live and total
    internal reflection kills a child (the plain version's tally says
    so)."""
    scene, cam = full_queue_scene(cuda), whitted_scene.whitted_camera(cuda)
    cfg = RenderConfig(width=96, height=80)
    counts = {}
    want, want_t = fused_whitted.render_fused_plain(
        scene, cam, cfg, queue=queue, device=cuda, counts=counts)
    assert max(lv["full_lanes"] for lv in counts["levels"]) > 0
    assert sum(lv["tir"] for lv in counts["levels"]) > 0
    got, t = fused_whitted.render_fused(scene, cam, cfg, queue=queue)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6
    assert abs(float(t) - float(want_t)) <= 1e-6 * max(1.0, float(want_t))
    assert float(want_t) > 0.0


def _rays(seed, n, lo, hi, device):
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


@pytest.mark.parametrize("case", ["icosphere", "camera", "streamed"])
def test_packet_kernel_matches_plain(cuda, case):
    if case == "icosphere":
        tris, cs = meshes.icosphere(2), 32
        o, d = _rays(0, 1000, -2.0, 2.0, cuda)
    elif case == "camera":
        tris, cs = None, 128
        cam = meshes.bvh_stage_camera(cuda)
        d = camera.perspective_rays(cam, 64, 48).reshape(-1, 3).contiguous()
        o = cam.position.expand(d.shape).contiguous()
    else:
        tris = np.concatenate([meshes.icosphere(4),
                               meshes.torus(1.5, 0.4, 48, 32)])
        cs = 64
        o, d = _rays(3, 4000, -3.0, 3.0, cuda)
    if tris is None:
        sc = meshes.bvh_stage_scene()
        v0, e1, e2 = (x.numpy().astype(np.float64) for x in
                      (sc.triangles.v0, sc.triangles.e1, sc.triangles.e2))
        tris = np.stack([v0, v0 + e1, v0 + e2], 1)
    cl = packet.build_clusters(tris, cs, device=cuda)
    want_t, want_i = packet.nearest_plain(cl, o, d, 1e-3)
    launches = packet.LAUNCHES["packet"]
    got_t, got_i = packet.nearest(cl, o, d, 1e-3)
    torch.cuda.synchronize()
    assert packet.LAUNCHES["packet"] == launches + 1
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_t < packet.NO_HIT, want_t < packet.NO_HIT)
    hit = want_t < packet.NO_HIT
    assert hit.any()
    torch.testing.assert_close(got_t[hit], want_t[hit], rtol=1e-6, atol=0)


def _packet_clusters(n_clusters, device):
    """Cluster sets of 1 (icosphere(1), 80 triangles in one cluster of
    128), 28 (the first 524 triangles of icosphere(4), clusters of 32:
    fewer than two slices a cluster at 16 slices) and 256 (icosphere(4)
    and a torus, 8,192 triangles in clusters of 32) clusters."""
    if n_clusters == 1:
        tris, cs = meshes.icosphere(1), 128
    elif n_clusters == 28:
        tris, cs = meshes.icosphere(4)[:524], 32
    else:
        tris = np.concatenate([meshes.icosphere(4),
                               meshes.torus(1.5, 0.4, 48, 32)])
        cs = 32
    cl = packet.build_clusters(tris, cs, device=device)
    assert cl.n_clusters == n_clusters
    return cl


@pytest.mark.parametrize("n_clusters", [1, 28, 256])
@pytest.mark.parametrize("r", [1, 255, 16384, 65536])
def test_packet_kernel_slices_match_plain(cuda, r, n_clusters):
    """The kernel at ray counts from one ray to 65,536 (16 cluster slices
    at 16,384 rays, fewer at 65,536, one for one cluster) against
    nearest_plain: indices and hit masks equal, t bit equal, in two
    launches, the second on the tickets the first left zero."""
    cl = _packet_clusters(n_clusters, cuda)
    o, d = _rays(r, r, -3.0, 3.0, cuda)
    if r == 1:      # from (3, 3, 3) toward cluster 0's first triangle
        v0, e1, e2 = cl.tri[0, 0, 0:3], cl.tri[0, 0, 3:6], cl.tri[0, 0, 6:9]
        o = torch.full_like(o, 3.0)
        d = v0 + (e1 + e2) / 3.0 - o
        d = d / d.norm()
    k = clusters.slices(packet.LIB, "packet_slots", r, cl.n_clusters, cl.cs)
    assert 1 <= k <= min(16, n_clusters)
    if r == 16384 and n_clusters > 1:
        assert k == min(16, n_clusters)
    want_t, want_i = packet.nearest_plain(cl, o, d, 1e-3)
    launches = packet.LAUNCHES["packet"]
    for n in (1, 2):
        got_t, got_i = packet.nearest(cl, o, d, 1e-3)
        torch.cuda.synchronize()
        assert packet.LAUNCHES["packet"] == launches + n
        assert torch.equal(got_i, want_i)
        assert torch.equal(got_t.view(torch.int32), want_t.view(torch.int32))
        if k > 1:
            stream = torch.cuda.current_stream(o.device)
            tickets = kernels.TICKETS[(stream.device.index,
                                       stream.cuda_stream)]
            assert not bool(tickets.any())
    assert bool((want_i >= 0).any())


def _mesh_step_inputs(device, steps_before=3, sub=2):
    """A fused-mesh pack, its tables and one step's input state on
    ``device``: the 64x64 Cornell mesh scene (an icosphere of ``sub``
    subdivisions in 64-triangle clusters) after a few plain steps."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(sub), device=device)
    cam = cornell.cornell_camera(device)
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6)
    mp = fused_mesh.pack_mesh_scene(scene, cluster_size=64)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device=device)
    st, _, _ = fused_mesh.wavefront_steps_fused_mesh_plain(
        mp, cam, cfg, SEED, st, steps_before, cap_main=4096 * 2,
        cap_shadow=4096 * 2)
    p = fused_mesh.params(cfg, 4096)
    tb = fused_mesh._tables(mp, fused._camera_words(cam))
    return (tb, p) + fused.state_planes(st)


@pytest.mark.parametrize("op", ["k1", "nearest", "k1b", "occl", "k2"])
def test_fused_mesh_kernel_matches_plain(cuda, op):
    """Each of the five entry points of csrc/fused_mesh.cu against its plain
    version on the same inputs: outputs bit-equal (-fmad=false, the same
    operations in the same order), packed lanes as sets (blocks land in
    any order), packed populations equal."""
    tb, p, sf, si = _mesh_step_inputs(cuda)
    r = sf.shape[1]
    fm = fused_mesh
    bp = fm.StepBuffers(*[torch.zeros_like(x) for x in
                          fm.step_buffers(r, p, 1, cuda)])
    # the plain version's step up to this op supplies the op's inputs
    order = ["k1", "nearest", "k1b", "occl"]
    for name in order[:order.index(op) if op in order else 4]:
        fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED, sf, si, bp)
    bk = fm.StepBuffers(*[x.clone() for x in bp])
    sf_k, si_k = sf.clone(), si.clone()
    launches = fm.LAUNCHES[op]
    fm.run_op(fm.KERNEL_OPS, op, tb, p, SEED, sf_k, si_k, bk)
    fm.run_op(fm.PLAIN_OPS, op, tb, p, SEED, sf, si, bp)
    torch.cuda.synchronize()
    assert fm.LAUNCHES[op] == launches + 1
    assert torch.equal(bk.cnt, bp.cnt)
    if op in ("k1", "k1b"):
        n = int(bp.cnt[0, 0 if op == "k1" else 1])
        assert n > 0
        ids_k = (bk.mr_id if op == "k1" else bk.sr_id)[:n]
        ids_p = (bp.mr_id if op == "k1" else bp.sr_id)[:n]
        order_k = torch.argsort(ids_k)
        assert torch.equal(ids_k[order_k], ids_p)
        rays_k = (bk.mr if op == "k1" else bk.sr)[:, :n]
        rays_p = (bp.mr if op == "k1" else bp.sr)[:, :n]
        assert torch.equal(rays_k[:, order_k], rays_p)
        offs_k, offs_p = (bk.offs1, bp.offs1) if op == "k1" else (
            bk.offs2, bp.offs2)
        assert torch.equal(offs_k[:, 1], offs_p[:, 1])
        # each block's slice is contiguous and in lane order
        for (bk0, c), (bp0, _) in zip(offs_k.tolist(), offs_p.tolist()):
            assert torch.equal(ids_k[bk0:bk0 + c], ids_p[bp0:bp0 + c])
    assert torch.equal(bk.hf, bp.hf) and torch.equal(bk.kb, bp.kb)
    assert torch.equal(sf_k, sf) and torch.equal(si_k, si)


def _k1_inputs(case, device):
    """K1's (tables, params, sf) for a case of test_k1_kernel_matches_plain:
    the 64x64 mesh step's state with its rays replaced ("none", "all"), a
    ragged slab ("ragged") or a sphere among the smalls ("sphere")."""
    if case in ("ragged", "sphere"):
        scene = cornell.cornell_mesh_scene(meshes.icosphere(2), device=device)
        if case == "sphere":
            scene = scene.replace(spheres=make_spheres((1.0, 3.0, 2.0), 0.5,
                                                       0, device))
        cam = cornell.cornell_camera(device)
        w, h = (41, 37) if case == "ragged" else (64, 64)
        cfg = RenderConfig(width=w, height=h, spp=4, max_depth=6)
        mp = fused_mesh.pack_mesh_scene(scene, cluster_size=64)
        st = mc.wavefront_init(scene, cam, cfg, SEED, device=device)
        st, _, _ = fused_mesh.wavefront_steps_fused_mesh_plain(
            mp, cam, cfg, SEED, st, 3, cap_main=8192, cap_shadow=8192)
        sf, _ = fused.state_planes(st)
        tb = fused_mesh._tables(mp, fused._camera_words(cam))
        if case == "sphere":
            assert mp.n_sph == 1
            return tb, fused_mesh.params(cfg, sf.shape[1]), sf
        # 1,100 lanes from pixel 600 of 1,517: the last 183 lie past the
        # image (never predicated), and the last block is partial
        sf = torch.cat([sf[:, 600:], sf[:, :183]], 1).contiguous()
        return tb, fused_mesh.params(cfg, sf.shape[1], pixel_offset=600), sf
    tb, p, sf, _ = _mesh_step_inputs(device)
    hull = tb.mp.pred_aabb[:, :6]
    lo, hi = hull[:, :3].amin(0), hull[:, 3:].amax(0)
    c, ext = (lo + hi) / 2, (hi - lo).max()
    g = torch.Generator(device).manual_seed(3)
    n = sf.shape[1]
    u = torch.randn((n, 3), device=device, generator=g)
    u = u / torch.linalg.norm(u, dim=1, keepdim=True)
    # "none": from outside the ball round the hull, away from it; "all":
    # from 0.6 of its extent off its center, toward the center
    o = c + (1.0 if case == "none" else 0.6) * ext * u
    d = u if case == "none" else -u
    sf = sf.clone()
    sf[0:3], sf[3:6] = o.T, d.T
    return tb, p, sf


@pytest.mark.parametrize("case", ["none", "all", "ragged", "sphere"])
def test_k1_kernel_matches_plain(cuda, case):
    """K1 against _k1_plain: no lane predicated (every ray leaves the
    predicate boxes' hull), every lane predicated (every ray aims through
    the mesh), a ragged slab at pixel_offset 600 (lanes past the image),
    and a sphere among the smalls: the ten hf planes bit equal, the packed
    lanes and rays as sets, each block's count, and the population."""
    tb, p, sf = _k1_inputs(case, cuda)
    r = sf.shape[1]
    fm = fused_mesh
    bp = fm.StepBuffers(*[torch.zeros_like(x) for x in
                          fm.step_buffers(r, p, 1, cuda)])
    bk = fm.StepBuffers(*[x.clone() for x in bp])
    si = torch.zeros((4, r), dtype=torch.int32, device=cuda)
    launches = fm.LAUNCHES["k1"]
    fm.run_op(fm.KERNEL_OPS, "k1", tb, p, SEED, sf, si, bk)
    fm.run_op(fm.PLAIN_OPS, "k1", tb, p, SEED, sf, si, bp)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["k1"] == launches + 1
    n = int(bp.cnt[0, 0])
    valid = min(r, p.n_pix - p.pixel_offset)
    assert {"none": n == 0, "all": n == valid}.get(case, 0 < n < valid), n
    assert torch.equal(bk.cnt, bp.cnt)
    assert torch.equal(bk.hf.view(torch.int32), bp.hf.view(torch.int32))
    order = torch.argsort(bk.mr_id[:n])
    assert torch.equal(bk.mr_id[:n][order], bp.mr_id[:n])
    assert torch.equal(bk.mr[:, :n][:, order], bp.mr[:, :n])
    assert torch.equal(bk.offs1[:, 1], bp.offs1[:, 1])


@pytest.mark.parametrize("stop_after", [0, 2])
def test_fused_mesh_stepper_matches_plain_ragged_slab(cuda, stop_after):
    """A slab of 917 lanes (no whole number of blocks) at pixel_offset 600
    of a 41x37 image, with a sphere among the smalls: the five kernels'
    stepper against the plain one, integer state and populations exact,
    floats 2e-3."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(2), device=cuda)
    scene = scene.replace(spheres=make_spheres((1.0, 3.0, 2.0), 0.5, 0,
                                               cuda))
    cam = cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=41, height=37, spp=4, max_depth=5)
    mp = fused_mesh.pack_mesh_scene(scene, cluster_size=64)
    assert mp.n_sph == 1
    full = mc.wavefront_init(scene, cam, cfg, SEED, device=cuda)
    st = mc.WavefrontState(**{
        f: (getattr(full, f) if f == "nrays" else getattr(full, f)[600:])
        for f in ("s", "b", "o", "d", "tp", "cur", "acc", "n_done",
                  "nrays")})
    kw = dict(pixel_offset=600, stop_after=stop_after)
    want, of_p, np_p = fused_mesh.wavefront_steps_fused_mesh_plain(
        mp, cam, cfg, SEED, st, 8, **kw)
    got, of_k, np_k = fused_mesh.wavefront_steps_fused_mesh(
        mp, cam, cfg, SEED, st, 8, **kw)
    torch.cuda.synchronize()
    assert int(of_k) == int(of_p) == 0 and torch.equal(np_k, np_p)
    for f in ("s", "b", "n_done", "nrays"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("o", "d", "tp", "cur", "acc"):
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=2e-3, atol=2e-3)


def test_pack_mesh_scene_on_card_equals_the_cpu_pack(cuda):
    """The pack of the benchmark's 163,862-triangle scene built on the card
    equals the CPU's build byte for byte, the ints and tuples equal."""
    soup = np.concatenate([meshes.icosphere(6), meshes.transform(
        meshes.icosphere(6), 0.6, (1.2, 0.9, 0.3))])
    scene = cornell.cornell_mesh_scene(soup, height=1.8)
    want = fused_mesh.pack_mesh_scene(scene)
    fused_mesh.PACK.reset()
    got = fused_mesh.pack_mesh_scene(scene.to(cuda))
    assert fused_mesh.PACK["host_reads"] == 3 and want.n_clusters == 1280
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda", f.name
            a, b = a.cpu().numpy(), b.numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", ["signed_zeros", "duplicates"])
def test_leaf_order_on_card_keeps_ties(cuda, case):
    """The card's sorts keep equal keys, -0.0 against 0.0 among them, in
    their order, as ``build_bvh``'s stable argsort does."""
    rng = np.random.default_rng(11)
    if case == "signed_zeros":
        # rows past 4,096 keys take the card's other sort
        tris = np.zeros((20000, 3, 3))
        tris[..., 2] = np.repeat(rng.integers(0, 3, (20000, 1)), 3, 1)
        tris[..., 0:2] = np.where(rng.random((20000, 1, 2)) < 0.5, -0.0, 0.0)
        tris[:4, :, 0] = [[-5.0], [5.0], [-5.0], [5.0]]
    else:
        tris = rng.uniform(-1.0, 1.0, (40, 3, 3))[rng.integers(0, 40, 5000)]
    for leaf in (4, 16):
        got = bvh.leaf_order(torch.as_tensor(tris, device=cuda), leaf)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      bvh.build_bvh(tris, leaf).order)


def test_render_turbo_mesh_exact_on_card(cuda):
    scene = cornell.cornell_mesh_scene(meshes.icosphere(2))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=5)
    fused_mesh.LAUNCHES.reset()
    packet.LAUNCHES.reset()
    img = fused_mesh.render_turbo_mesh_exact(scene, cam, cfg, SEED,
                                             cluster_size=64)
    steps = sum(t["steps"] for t in fused_mesh.TRACE)
    assert img.is_cuda and packet.LAUNCHES["packet"] == 0
    counts = fused_mesh.LAUNCHES
    assert all(counts[k] == steps for k in fused_mesh.OP_NAMES)
    assert counts["group"] == steps        # the resident sweep's rays
    assert counts["nearest_sl"] == counts["occl_sl"] == 0   # resident
    plain = fused_mesh.render_turbo_mesh_exact(scene, cam, cfg, SEED,
                                               cluster_size=64, device="cpu")
    np.testing.assert_allclose(img.cpu().numpy(), plain.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_cornell_mesh_resident_render_on_card(cuda, monkeypatch):
    """The ``cornell_mesh`` benchmark scene (an icosphere(4) at the bunny's
    scale, 5,142 triangles, 40 clusters of 128) on the grouped resident
    sweeps: a grouping, a nearest and an occlusion sweep a step, no
    shortlist sweep; the image bit equal to the shortlist route's."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(4, radius=1.0),
                                       height=1.8, device=cuda)
    cam = cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=128, height=128, spp=2, max_depth=16)
    fused_mesh.LAUNCHES.reset()
    img = fused_mesh.render_turbo_mesh_exact(scene, cam, cfg, SEED)
    steps = sum(t["steps"] for t in fused_mesh.TRACE)
    assert steps > 0 and all(t["resident"] for t in fused_mesh.TRACE)
    counts = fused_mesh.LAUNCHES
    for key in ("group", "nearest", "group_occl", "occl"):
        assert counts[key] == steps, key
    assert counts["nearest_sl"] == counts["occl_sl"] == 0
    monkeypatch.setattr(fused_mesh, "fits_resident", lambda n, cs: False)
    shortlist = fused_mesh.render_turbo_mesh_exact(scene, cam, cfg, SEED)
    assert not any(t["resident"] for t in fused_mesh.TRACE)
    assert counts["occl_sl"] > 0
    assert torch.equal(img, shortlist)


def test_mesh_render_on_card(cuda):
    scene, cam = meshes.bvh_stage_scene(), meshes.bvh_stage_camera()
    cfg = RenderConfig(width=64, height=48)
    bundle = mesh.prepare(scene)
    packet.LAUNCHES.reset()
    img = mesh.render(bundle, cam, cfg)
    assert img.is_cuda and packet.LAUNCHES["packet"] > 0
    plain = mesh.render(bundle, cam, cfg, device="cpu").numpy()
    # rtol 1e-5, atol 1e-6 on all but knife-edge pixels (< 0.5%).
    bad = (np.abs(img.cpu().numpy() - plain) > 1e-6 + 1e-5 * np.abs(plain))
    assert bad.any(-1).mean() < 0.005


# --- the shortlist intersector and the shortlist-streaming sweep ------------

def sphere_boxes(n: int, seed: int = 3):
    """n small cluster boxes on a sphere of radius 2 about the origin, in
    the order of their centres' 3-bit-per-axis cell codes (a spatial order,
    as the BVH preorder of a pack gives), (n, 8) f32."""
    g = np.random.default_rng(seed)
    c = g.normal(size=(n, 3))
    c = 2.0 * c / np.linalg.norm(c, axis=1, keepdims=True)
    cell = np.clip(((c + 2.0) / 4.0 * 8).astype(int), 0, 7)
    code = np.zeros(n, int)
    for b in range(3):
        for a in range(3):
            code |= ((cell[:, a] >> b) & 1) << (3 * b + a)
    c = c[np.argsort(code, kind="stable")]
    half = g.uniform(0.02, 0.15, (n, 3))
    box = np.zeros((n, 8), np.float32)
    box[:, 0:3], box[:, 3:6] = c - half, c + half
    return box


def _coherent_rays(case, device):
    """(pack, ray planes, cnt) of bvh_stage_scene: its 64x64 camera rays
    in pixel tiles ("camera"; in 80-triangle clusters, 45 of them:
    "clusters_45"), random segments with a lim plane, or a strip-tiled
    packed buffer of which the first 3,000 rays ("packed") or none
    ("packed_none") count; "clusters_1280": 1,280 boxes on a sphere
    (``sphere_boxes``) under 8,192 random rays toward it, 5,000 counting."""
    scene = meshes.bvh_stage_scene(device=device)
    pack = coherent.pack_coherent(
        scene, cluster_size=80 if case == "clusters_45" else 128)
    cam = meshes.bvh_stage_camera(device)
    d = camera.perspective_rays(cam, 64, 64).reshape(-1, 3).contiguous()
    o = cam.position.expand(d.shape).contiguous()
    cnt = None
    if case in ("camera", "clusters_45"):
        rays, _ = coherent._to_planes(o, d, (64, 64))
    elif case == "lim":
        o, d = _rays(4, 4096, -3.0, 6.0, device)
        rays, _ = coherent._to_planes(o, d, None)
        lim = torch.rand((1,) + rays.shape[1:], device=device,
                         generator=torch.Generator(device).manual_seed(0))
        rays = torch.cat([rays, 6.0 * lim], 0).contiguous()
    elif case == "clusters_1280":
        aabb = torch.as_tensor(sphere_boxes(1280), device=device)
        pack = dataclasses.replace(pack, aabb=aabb)
        g = np.random.default_rng(6)
        o = g.normal(size=(8192, 3))
        o = 5.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
        d = g.uniform(-1.6, 1.6, (8192, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays, _ = coherent._to_planes(
            *(torch.as_tensor(x.astype(np.float32), device=device)
              for x in (o, d)), None)
        cnt = torch.tensor([5000], dtype=torch.int32, device=device)
    else:
        rays, _ = coherent._to_planes(o, d, None)
        cnt = torch.tensor([3000 if case == "packed" else 0],
                           dtype=torch.int32, device=device)
    return pack, rays, cnt


@pytest.mark.parametrize("case", ["camera", "lim", "packed", "packed_none",
                                  "clusters_45", "clusters_1280"])
def test_coherent_mask_matches_plain(cuda, case):
    """The mask kernel against mask_plain: mask planes and tile words bit
    equal; without the planes (as the lists run it) the same tile words;
    the lists it writes in the same launch (with and without the planes)
    equal to ``_lists`` of the plain words; the tickets left zero."""
    pack, rays, cnt = _coherent_rays(case, cuda)
    stream = torch.cuda.current_stream(cuda)
    launches = coherent.LAUNCHES["mask"]
    mk, wk = coherent._mask_kernel(pack.aabb, rays, 1e-3, cnt)
    none, wk0 = coherent._mask_kernel(pack.aabb, rays, 1e-3, cnt,
                                      planes=False)
    mp, wp = coherent.mask_plain(pack.aabb, rays, 1e-3, cnt)
    torch.cuda.synchronize()
    assert coherent.LAUNCHES["mask"] == launches + 2
    assert torch.equal(mk, mp) and torch.equal(wk, wp)
    assert none is None and torch.equal(wk0, wk)
    assert bool((wk != 0).any()) == (case != "packed_none")
    want = coherent._lists(wp, pack.n_clusters)
    for planes in (False, True):
        got = coherent._mask_kernel(pack.aabb, rays, 1e-3, cnt, planes=planes,
                                    boxes=pack.boxes, lists=True)
        torch.cuda.synchronize()
        assert torch.equal(got[1], wp)
        assert torch.equal(got[2], want[0]) and torch.equal(got[3], want[1])
        if planes:
            assert torch.equal(got[0], mp)
        tickets = kernels.TICKETS[(stream.device.index, stream.cuda_stream)]
        assert not bool(tickets.any())
    ids, cnts = coherent._shortlists(pack.aabb, rays, 1e-3, cnt)
    assert torch.equal(ids, want[0]) and torch.equal(cnts, want[1])


@pytest.mark.parametrize("case", ["camera", "packed", "compacted"])
def test_coherent_sweep_matches_plain(cuda, case):
    """The sweep kernel against sweep_plain (unsliced, no cull) on the same
    lists, at the default slice count and at each of 1, 2, 3, 7 and 16
    slices: t and indices bit equal, and the tickets left zero.
    "compacted": the shadow rays of the camera rays' hits toward a point
    light, compacted into strip tiles (as a caller packs them)."""
    pack, rays, cnt = _coherent_rays(
        "camera" if case == "compacted" else case, cuda)
    if case == "compacted":
        o, d = (rays[0:3, :, :64].reshape(3, -1).T.contiguous(),
                rays[3:6, :, :64].reshape(3, -1).T.contiguous())
        t, _ = coherent.nearest(pack, o, d, 1e-3)
        hit = t < 1e30
        p = o[hit] + t[hit, None] * d[hit]
        light = torch.tensor([0.5, 6.0, 2.0], device=cuda)
        sd = light - p
        sd = sd / torch.linalg.norm(sd, dim=1, keepdim=True)
        rays, _ = coherent._to_planes(p.contiguous(), sd.contiguous(), None)
    ids, cnts = coherent._shortlists(pack.aabb, rays, 1e-3, cnt)
    want = coherent.sweep_plain(pack.tri, rays, ids, cnts, 1e-3)
    assert bool((want[1] >= 0).any()) and int(cnts.min()) >= 0
    stream = torch.cuda.current_stream(cuda)
    for k in (None, 1, 2, 3, 7, 16):
        launches = coherent.LAUNCHES["sweep"]
        got = coherent._sweep_kernel(pack.tri, pack.aabb, rays, ids, cnts,
                                     1e-3, k=k)
        torch.cuda.synchronize()
        assert coherent.LAUNCHES["sweep"] == launches + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
        tickets = kernels.TICKETS.get((stream.device.index,
                                       stream.cuda_stream))
        assert tickets is None or not bool(tickets.any())


@pytest.mark.parametrize("cluster_size", [8, 256])
def test_coherent_sweep_takes_every_cluster_size(cuda, cluster_size):
    """The sweep kernel on packs of 8 and of 256 triangles a cluster (the
    least and the most it takes: one thread a row) against sweep_plain at
    1 and 3 slices: t and indices bit equal."""
    scene = meshes.bvh_stage_scene(device=cuda)
    pack = coherent.pack_coherent(scene, cluster_size=cluster_size)
    assert pack.cs == cluster_size
    cam = meshes.bvh_stage_camera(cuda)
    d = camera.perspective_rays(cam, 64, 64).reshape(-1, 3).contiguous()
    o = cam.position.expand(d.shape).contiguous()
    rays, _ = coherent._to_planes(o, d, (64, 64))
    ids, cnts = coherent._shortlists(pack.aabb, rays, 1e-3)
    want = coherent.sweep_plain(pack.tri, rays, ids, cnts, 1e-3)
    assert bool((want[1] >= 0).any())
    for k in (1, 3):
        got = coherent._sweep_kernel(pack.tri, pack.aabb, rays, ids, cnts,
                                     1e-3, k=k)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


@pytest.mark.parametrize("op", ["nearest", "occl"])
def test_fused_mesh_shortlist_sweep_matches_plain(cuda, op):
    """The shortlist sweeps (mask kernel, lists, then the sweep of
    csrc/fused_mesh.cu with lists) against their plain versions: outputs
    and populations bit equal."""
    tb, p, sf, si = _mesh_step_inputs(cuda)
    fm = fused_mesh
    bp = fm.StepBuffers(*[torch.zeros_like(x) for x in
                          fm.step_buffers(sf.shape[1], p, 1, cuda)])
    for name in ["k1", "nearest", "k1b"][:1 if op == "nearest" else 3]:
        fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED, sf, si, bp)
    bk = fm.StepBuffers(*[x.clone() for x in bp])
    key, masks = op + "_sl", coherent.LAUNCHES["mask"]
    launches = fm.LAUNCHES[key]
    fm.run_op(fm.KERNEL_SL_OPS, op, tb, p, SEED, sf, si, bk)
    fm.run_op(fm.PLAIN_SL_OPS, op, tb, p, SEED, sf, si, bp)
    torch.cuda.synchronize()
    assert fm.LAUNCHES[key] == launches + 1
    assert coherent.LAUNCHES["mask"] == masks + 1
    assert int(bp.cnt[0, 0 if op == "nearest" else 1]) > 0
    assert torch.equal(bk.hf, bp.hf) and torch.equal(bk.kb, bp.kb)


@pytest.mark.parametrize("op", ["nearest", "occl"])
@pytest.mark.parametrize("lists", [False, True])
def test_fused_mesh_split_sweep_matches_plain(cuda, op, lists):
    """The sweep with each ray block's list cut into 7 slices (more block
    slots than the packed rays fill, so every ray block takes 7), combined
    by the last slice to finish, against the unsplit plain sweep: outputs
    bit equal (20 clusters), and the stream's tickets left zero."""
    tb, p, sf, si = _mesh_step_inputs(cuda, sub=3)
    fm = fused_mesh
    bp = fm.StepBuffers(*[torch.zeros_like(x) for x in
                          fm.step_buffers(sf.shape[1], p, 1, cuda)])
    for name in ["k1", "nearest", "k1b"][:1 if op == "nearest" else 3]:
        fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED, sf, si, bp)
    occl = op == "occl"
    rays, ids, cnt = ((bp.sr, bp.sr_id, bp.cnt[0, 1:2]) if occl
                      else (bp.mr, bp.mr_id, bp.cnt[0, 0:1]))
    want = (bp.kb[8:9] if occl else bp.hf[5:10]).clone()
    got = torch.full_like(want, -7.0)
    lst = fm._lists(tb, p, rays, cnt, kernel=False) if lists else None
    fm._sweep_plain(tb, p, rays, ids, cnt, want, occl=occl, lists=lst)
    per_sm, n_sm = fm.LIB.occupancy("fused_mesh_sweep_slots", int(occl),
                                    tb.mp.cs)
    assert clusters.split_count(int(cnt), clusters.SWEEP_WAVES * per_sm
                                * n_sm, 7) == 7
    fm._sweep_kernel(tb, p, rays, ids, cnt, got, occl=occl, lists=lst,
                     k_max=7)
    torch.cuda.synchronize()
    assert tb.mp.n_clusters >= 7 and int(cnt) > 0
    lanes = ids[:int(cnt)].long()
    assert torch.equal(got[:, lanes], want[:, lanes])
    stream = torch.cuda.current_stream(cuda)
    tickets = kernels.TICKETS[(stream.device.index, stream.cuda_stream)]
    assert not bool(tickets.any())


def flat_far_clusters(tilt: float, n_rays: int = 4096, seed: int = 5):
    """Three 16-triangle clusters about 300 from the origin, each a 4 x 2
    grid of half-unit squares across axis x, y and z in turn, rising by
    ``tilt`` a half unit (0: the cluster's box is flat in that axis), and
    rays that graze them (a normal component of 1e-7 to 1e-2) towards
    points within 2e-3 of an edge of the grid, inside and out, from 0.5 to
    20 away.  -> tri (3, 16, 16), aabb (3, 8), rays (7, n) [o d lim], numpy
    f32 (the sweep kernel's box cull on the worst case for its margin)."""
    g = np.random.default_rng(seed)
    tri = np.zeros((3, 16, clusters.MESH_NF), np.float32)
    aabb = np.zeros((3, 8), np.float32)
    corner, span_u, span_v, normal = [], [], [], []
    for c in range(3):
        a, u, v = c, (c + 1) % 3, (c + 2) % 3

        def at(i, j):
            q = np.zeros(3)
            q[a] = 300.0 + c + tilt * (i + j)
            q[u], q[v] = 250.0 + 0.5 * i, -260.0 + 0.5 * j
            return q.astype(np.float32).astype(np.float64)
        k = 0
        for i in range(4):
            for j in range(2):
                for q0, q1, q2 in ((at(i, j), at(i + 1, j), at(i + 1, j + 1)),
                                   (at(i, j), at(i + 1, j + 1), at(i, j + 1))):
                    n = np.cross(q1 - q0, q2 - q0)
                    tri[c, k, 0:3], tri[c, k, 3:6] = q0, q1 - q0
                    tri[c, k, 6:9] = q2 - q0
                    tri[c, k, 9:12] = n / np.linalg.norm(n)
                    tri[c, k, 12] = c
                    k += 1
        v0 = tri[c, :, 0:3].astype(np.float64)
        vs = np.concatenate([v0, v0 + tri[c, :, 3:6], v0 + tri[c, :, 6:9]])
        aabb[c, 0:3], aabb[c, 3:6] = vs.min(0), vs.max(0)
        corner.append(at(0, 0))
        span_u.append(at(4, 0) - at(0, 0))
        span_v.append(at(0, 2) - at(0, 0))
        n = np.cross(span_u[-1], span_v[-1])
        normal.append(n / np.linalg.norm(n))
    corner, span_u, span_v, normal = (np.array(x) for x in
                                      (corner, span_u, span_v, normal))
    c = g.integers(0, 3, n_rays)
    iu, iv = g.uniform(0.0, 1.0, (2, n_rays))
    side, off = g.integers(0, 4, n_rays), g.uniform(-2e-3, 2e-3, n_rays)
    iu = np.where(side == 0, off, np.where(side == 1, 1.0 - off, iu))
    iv = np.where(side == 2, off, np.where(side == 3, 1.0 - off, iv))
    target = corner[c] + iu[:, None] * span_u[c] + iv[:, None] * span_v[c]
    w = g.normal(size=(n_rays, 3))
    w -= (w * normal[c]).sum(1, keepdims=True) * normal[c]
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    slope = 10.0 ** g.uniform(-7.0, -2.0, n_rays) * g.choice([-1.0, 1.0],
                                                            n_rays)
    d = w + slope[:, None] * normal[c]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t0 = g.uniform(0.5, 20.0, n_rays)
    o = target - t0[:, None] * d
    lim = t0 * g.uniform(0.9, 1.5, n_rays)
    rays = np.concatenate([o.T, d.T, lim[None]]).astype(np.float32)
    return tri, aabb, rays


@pytest.mark.parametrize("tilt", [0.0, 1e-3])
@pytest.mark.parametrize("op", ["nearest", "occl"])
def test_fused_mesh_sweep_cull_on_flat_far_clusters(cuda, tilt, op):
    """The sweep kernel, which skips the clusters whose padded boxes a
    ray's warp does not cross, against the plain sweep, which tests every
    cluster, on flat and nearly flat clusters far from the origin under
    grazing rays near their edges: outputs bit equal."""
    tb, p, _, _ = _mesh_step_inputs(cuda)
    tri, aabb, rays = (torch.as_tensor(x, device=cuda)
                       for x in flat_far_clusters(tilt))
    tb = dataclasses.replace(tb, mp=dataclasses.replace(
        tb.mp, smc_tri=tri, smc_aabb=aabb, cs=16))
    occl = op == "occl"
    rays = (rays if occl else rays[:6]).contiguous()
    n = rays.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    cnt = torch.tensor([n], dtype=torch.int32, device=cuda)
    want = torch.zeros((1 if occl else 5, n), device=cuda)
    got = torch.full_like(want, -7.0)
    fm = fused_mesh
    fm._sweep_plain(tb, p, rays, ids, cnt, want, occl=occl)
    fm._sweep_kernel(tb, p, rays, ids, cnt, got, occl=occl)
    torch.cuda.synchronize()
    hits = int((want[0] > 0.5).sum() if occl else (want[0] < fm.NO_HIT).sum())
    assert hits > 500
    assert torch.equal(got, want)


def test_fused_mesh_stepper_shortlist_matches_resident(cuda):
    """resident=False against resident=True through the kernels: every
    field bit equal, overflow 0, the same populations."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(2), device=cuda)
    cam = cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6)
    mp = fused_mesh.pack_mesh_scene(scene, cluster_size=64)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device=cuda)
    a, of_a, np_a = fused_mesh.wavefront_steps_fused_mesh(
        mp, cam, cfg, SEED, st, 8, resident=True)
    launches = fused_mesh.LAUNCHES["occl_sl"]
    b, of_b, np_b = fused_mesh.wavefront_steps_fused_mesh(
        mp, cam, cfg, SEED, st, 8, resident=False)
    torch.cuda.synchronize()
    assert fused_mesh.LAUNCHES["occl_sl"] == launches + 8
    assert int(of_a) == int(of_b) == 0 and torch.equal(np_a, np_b)
    for f in ("s", "b", "n_done", "nrays", "o", "d", "tp", "cur", "acc"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_mesh_render_fused_on_card(cuda):
    scene, cam = meshes.bvh_stage_scene(), meshes.bvh_stage_camera()
    cfg = RenderConfig(width=64, height=48)
    bundle = mesh.prepare(scene, method="fused")
    packet.LAUNCHES.reset()
    masks, sweeps = coherent.LAUNCHES["mask"], coherent.LAUNCHES["sweep"]
    img = mesh.render(bundle, cam, cfg)
    assert img.is_cuda and packet.LAUNCHES["packet"] == 0
    assert coherent.LAUNCHES["mask"] > masks
    assert coherent.LAUNCHES["sweep"] > sweeps
    plain = mesh.render(bundle, cam, cfg, device="cpu").numpy()
    # rtol 1e-5, atol 1e-6 on all but knife-edge pixels (< 0.5%).
    bad = (np.abs(img.cpu().numpy() - plain) > 1e-6 + 1e-5 * np.abs(plain))
    assert bad.any(-1).mean() < 0.005


# name -> (scene, camera, diffuse model): both camera modes, the three
# diffuse models.
RTIOW_CASES = {
    "thinlens": ("offline_two_sphere_scene",
                 lambda: rtiow.offline_camera(96 / 64), 1),
    "thinlens_aperture_in_sphere": (
        "rtiow_classic_scene",
        lambda: rtiow.offline_camera(96 / 64, aperture=0.4), 0),
    "dof_in_hemisphere": ("rtiow_classic_scene",
                          lambda: rtiow.offline_dof_camera(96 / 64), 2),
    "perspective_nppt": ("nppt_scene", rtiow.nppt_camera, 1),
    "perspective_in_hemisphere": ("nppt_scene", rtiow.nppt_camera, 2),
}


@pytest.mark.parametrize("case", list(RTIOW_CASES))
def test_rtiow_kernel_matches_plain(cuda, case):
    scene, cam, model = RTIOW_CASES[case]
    cfg = RenderConfig(width=96, height=64, spp=4, max_depth=8,
                       diffuse_model=model)
    pk, cam24, sf, si, p = fused_rtiow._setup(
        getattr(rtiow, scene)(), cam(), cfg, SEED, cuda)
    p = p._replace(n_steps=24)
    want_f, want_i = fused_rtiow._steps_plain(pk, cam24, SEED, sf, si, p)
    launches = fused_rtiow.LAUNCHES["fused_rtiow"]
    got_f, got_i = fused_rtiow.rtiow_steps(pk, cam24, SEED, sf.clone(),
                                           si.clone(), p)
    torch.cuda.synchronize()
    assert fused_rtiow.LAUNCHES["fused_rtiow"] == launches + 1
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_f, want_f, rtol=2e-3, atol=2e-3)
    assert int(got_i[2].max()) > 0


def test_rtiow_render_fused_on_card(cuda):
    scene, cam = rtiow.nppt_scene(), rtiow.nppt_camera()
    cfg = RenderConfig(width=64, height=48, spp=3, max_depth=8)
    fused_rtiow.LAUNCHES.reset()
    img = fused_rtiow.render_fused(scene, cam, cfg, SEED)
    assert img.is_cuda and fused_rtiow.LAUNCHES["fused_rtiow"] > 0
    plain = fused_rtiow.render_fused(scene, cam, cfg, SEED, device="cpu")
    np.testing.assert_allclose(img.cpu().numpy(), plain.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("chunks", [None, 1, 3])
@pytest.mark.parametrize("case", list(RTIOW_CASES))
def test_rtiow_render_matches_lockstep_kernel(cuda, case, chunks):
    """The one-launch render (work items refilled from a counter, each step
    branching on what its ray meets; each pixel's samples in 1, 3 or the
    card's default number of chunks) against the step-mode kernel under
    the lockstep chunk schedule: every state plane bit equal, one
    launch."""
    scene, cam, model = RTIOW_CASES[case]
    cfg = RenderConfig(width=96, height=64, spp=4, max_depth=8,
                       diffuse_model=model)
    pk, cam24, sf, si, p = fused_rtiow._setup(
        getattr(rtiow, scene)(), cam(), cfg, SEED, cuda)
    want_f, want_i = fused_rtiow.render_lockstep(pk, cam24, SEED, sf.clone(),
                                                 si.clone(), p)
    launches = fused_rtiow.LAUNCHES["fused_rtiow"]
    got_f, got_i = fused_rtiow._render_kernel(pk, cam24, SEED, sf, si, p,
                                              chunks=chunks)
    torch.cuda.synchronize()
    assert fused_rtiow.LAUNCHES["fused_rtiow"] == launches + 1
    assert bool((want_i[2] == cfg.spp).all())
    assert torch.equal(got_i, want_i) and torch.equal(got_f, want_f)


def test_single_path_kernel_matches_plain(cuda):
    """The Denoiser's G-buffer pass: ids and the contributor flag exact,
    color 2e-3, position and normal 1e-4 (tests/test_fused.py's gate)."""
    scene, cam = _scene("cornell_sphere", cuda), cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=96, height=64, max_depth=8, rr_survival=0.8)
    fs = fused.pack_scene(scene)
    want = fused._gbuffer(fused._steps_plain, fs, cam, cfg, SEED, 3, cuda)
    launches = fused.LAUNCHES["fused_mc"]
    got = fused.single_sample_gbuffer(fs, cam, cfg, SEED, 3)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_mc"] == launches + 1
    for i, tol in ((0, 2e-3), (1, 1e-4), (2, 1e-4)):
        torch.testing.assert_close(got[i], want[i], rtol=tol, atol=tol)
    for i in (3, 4):
        assert torch.equal(got[i], want[i])
    frame, _ = denoiser.render_frame(scene, cam, cfg, SEED, 0, None,
                                     denoiser.DenoiserParams(),
                                     engine="fused")
    assert frame.is_cuda and frame.shape == (64, 96, 3)


# --- the Denoiser's a-trous levels (csrc/denoise.cu) -------------------------

def _denoise_gbuffer(dev, h=97, w=131, seed=7) -> denoise.GBuffer:
    """A G-buffer no 32 x 8 block shape divides: a gently bumped plane
    with normals near +z (a tenth of them flipped away, edges the filter
    keeps), colors in [0, 1.2], ~15% non-contributors inside the frame
    and a 3-pixel ring of misses (position and normal zero) along the
    border."""
    gen = torch.Generator().manual_seed(seed)
    rows, cols = torch.meshgrid(torch.arange(h), torch.arange(w),
                                indexing="ij")
    pos = torch.stack([cols * 0.01, rows * 0.01,
                       0.003 * torch.randn((h, w), generator=gen)], -1)
    nrm = torch.tensor([0.0, 0.0, 1.0]) + 0.15 * torch.randn(
        (h, w, 3), generator=gen)
    nrm = torch.where(torch.rand((h, w, 1), generator=gen) < 0.1, -nrm, nrm)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    con = torch.rand((h, w), generator=gen) > 0.15
    ring = torch.ones((h, w), dtype=torch.bool)
    ring[3:h - 3, 3:w - 3] = False
    con &= ~ring
    pos = torch.where(ring[..., None], 0.0, pos)
    nrm = torch.where(ring[..., None], 0.0, nrm)
    color = 1.2 * torch.rand((h, w, 3), generator=gen)
    eye = torch.eye(4)
    return denoise.GBuffer(
        color=color.float().to(dev), world_pos=pos.float().to(dev),
        normal=nrm.float().to(dev), contributor=con.to(dev),
        prim_id=torch.where(con, 1, -1).int().to(dev), view=eye.to(dev),
        proj=eye.to(dev))


@pytest.mark.parametrize("half_size", [3, 7, 16, 32])
@pytest.mark.parametrize("clamp", [True, False])
def test_atrous_kernel_matches_plain(cuda, half_size, clamp):
    """Each level's launch bit equal to the plain twin run on the card from
    the same input, and the whole filter bit equal to the plain route; one
    launch a level."""
    g = _denoise_gbuffer(cuda)
    wts = denoise._weights()
    n = denoise._levels(half_size)
    assert n == {3: 2, 7: 3, 16: 4, 32: 5}[half_size]
    color = g.color
    for level in range(n):
        want = denoise._atrous_level_plain(g, color, level, wts)
        got = denoise._atrous_level_kernel(g, color, level, wts)
        assert torch.equal(got, want), level
        if level == n - 1:   # the last launch also clamps and passes misses
            got = denoise._atrous_level_kernel(g, color, level, wts, clamp)
            last = denoise._atrous_level_plain(g, color, level, wts, clamp)
            assert torch.equal(got, last)
            assert torch.equal(last, torch.where(
                g.contributor[..., None],
                torch.clamp(want, 0.0, 1.0) if clamp else want, g.color))
        color = want
    launches = denoise.LAUNCHES["atrous"]
    got = denoise.joint_bilateral_atrous(g, half_size, clamp=clamp)
    torch.cuda.synchronize()
    assert denoise.LAUNCHES["atrous"] == launches + n
    assert torch.equal(got, denoise._atrous(g, half_size, clamp, wts,
                                            on_card=False))
    assert not torch.equal(got, g.color)
    assert 0.05 < float(g.contributor.float().mean()) < 0.9


def test_atrous_kernel_on_a_rendered_gbuffer(cuda):
    """The Denoiser's filter over a G-buffer of the Cornell box from each
    engine (fused and scan), bit equal to the plain route; denoise_frame
    launches one level at a time."""
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dn

    scene, cam = cornell.cornell_scene(cuda), cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=131, height=97, max_depth=8, rr_survival=0.8)
    for render in (dn.render_gbuffer_fused, dn.render_gbuffer):
        g = render(scene, cam, cfg, SEED, 2, device=cuda)
        for k in (7, 16):
            want = denoise._atrous(g, k, True, denoise._weights(),
                                   on_card=False)
            assert torch.equal(denoise.joint_bilateral_atrous(g, k), want)
        launches = denoise.LAUNCHES["atrous"]
        color, _ = dn.denoise_frame(g, None, dn.DenoiserParams())
        assert denoise.LAUNCHES["atrous"] == launches + 3
        assert torch.equal(color, denoise._atrous(
            g, 7, True, denoise._weights(), on_card=False))


def test_atrous_kernel_refuses_bad_tensors(cuda):
    g = _denoise_gbuffer(cuda, h=16, w=24)
    wts, out = denoise._weights(), torch.empty_like(g.color)
    bad = (g.replace(world_pos=g.world_pos.transpose(0, 1).contiguous()
                     .transpose(0, 1)),
           g.replace(normal=g.normal.double()),
           g.replace(color=g.color.double()),
           g.replace(contributor=g.contributor.to(torch.uint8)),
           g.replace(color=g.color.cpu()))
    for b in bad:
        with pytest.raises(ValueError, match="contiguous CUDA"):
            denoise._atrous_level_kernel(b, b.color, 0, wts, out=out)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        denoise.joint_bilateral_atrous(bad[0], 7)
    with pytest.raises(ValueError, match="one frame"):
        denoise._atrous_level_kernel(g, g.color, 0, wts, out=out[:8])
    with pytest.raises(RuntimeError, match="cudaError"):
        denoise._atrous_level_kernel(g, out, 0, wts, out=out)


def test_new_wrappers_refuse_bad_tensors(cuda):
    scene, cam = rtiow.nppt_scene(), rtiow.nppt_camera()
    cfg = RenderConfig(width=16, height=8, spp=1, max_depth=2)
    pk, cam24, sf, si, p = fused_rtiow._setup(scene, cam, cfg, SEED,
                                              torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fused_rtiow._steps_kernel(pk, cam24, SEED, sf, si, p)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fused_rtiow._steps_kernel(pk.to(cuda), cam24.to(cuda), SEED,
                                  sf.to(cuda).double(), si.to(cuda), p)
    fs = fused.pack_scene(cornell.cornell_scene(cuda))
    p = fused._Params(2, 16, 8, 128, 1e-3, 1e-5, 0.8, 1e-2, 2, 0,
                      single_path=True)
    sf = torch.zeros((15, 128), device=cuda)
    si = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    cam16 = fused._camera_words(cornell.cornell_camera(cuda))
    with pytest.raises(ValueError, match="G-buffer"):
        fused._steps_kernel(fs, cam16, SEED, sf, si, p)
    with pytest.raises(ValueError, match="G-buffer"):
        fused._steps_kernel(fs, cam16, SEED, sf, si, p,
                            gb=torch.zeros((8, 128), device=cuda,
                                           dtype=torch.float64))


# --- retiring lanes (csrc/fused_mc.cu) and grouping rays (fused_mesh.cu) ----

def _bits_equal(got, want):
    return all(torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
               for a, b in zip(got, want))


def _gated_state(device, w=96, h=64, depth=6, stop_after=2):
    scene = _scene("cornell_sphere", device)
    cam = cornell.cornell_camera(device)
    cfg = RenderConfig(width=w, height=h, spp=stop_after, max_depth=depth,
                       rr_survival=0.8)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device=device)
    sf, si = fused.state_planes(st)
    p = fused._Params(1, w, h, w * h, float(cfg.t_min), float(cfg.eps_offset),
                      0.8, float(cfg.shadow_tolerance), depth, stop_after)
    return fused.pack_scene(scene), fused._camera_words(cam), sf, si, p


@pytest.mark.parametrize("stop_after", [0, 2])
@pytest.mark.parametrize("n_steps", [1, 32, 96])
def test_retiring_kernel_matches_lockstep_plain(cuda, stop_after, n_steps):
    """The persistent kernel (lanes retire once their quota is met) against
    the plain version run in lockstep: every plane bit equal, from the
    initial state and then from the state it leaves (lanes enter done)."""
    fs, cam16, sf, si, p = _gated_state(cuda, stop_after=stop_after)
    q = p._replace(n_steps=n_steps)
    want, got = (sf, si), (sf, si)
    for _ in range(2):
        want = fused._steps_plain(fs, cam16, SEED, *[x.clone() for x in want],
                                  q)
        launches = fused.LAUNCHES["fused_mc"]
        got = fused._steps_kernel(fs, cam16, SEED, *[x.clone() for x in got],
                                  q)
        torch.cuda.synchronize()
        assert fused.LAUNCHES["fused_mc"] == launches + 1
        assert _bits_equal(got, want)


@pytest.mark.parametrize("n_steps", [1, 32, 96])
def test_retiring_single_path_kernel_matches_lockstep_plain(cuda, n_steps):
    scene, cam = _scene("cornell_sphere", cuda), cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=96, height=64, max_depth=16, rr_survival=0.8)
    cam16, sf, si, gb, p = fused._gbuffer_setup(cam, cfg, 3, cuda)
    fs = fused.pack_scene(scene)
    p = p._replace(n_steps=n_steps)
    gb_k = gb.clone()
    want = fused._steps_plain(fs, cam16, SEED, sf.clone(), si.clone(), p,
                              gb=gb)
    got = fused._steps_kernel(fs, cam16, SEED, sf.clone(), si.clone(), p,
                              gb=gb_k)
    torch.cuda.synchronize()
    assert _bits_equal(got + (gb_k,), want + (gb,))


def test_retiring_kernel_off_the_fixed_point(cuda):
    """Lanes that enter done but off the fixed point (-0.0 and NaN in cur
    and acc, tp of either sign, mid-path b), and lanes one sample short
    with cur = acc = -0.0 and a negative tp (the step that meets the quota
    can leave acc at -0.0): bit equal to the lockstep plain version after
    1, 2 and 7 steps."""
    fs, cam16, sf, si, p = _gated_state(cuda, w=64, h=48)
    sf, si = fused._steps_plain(fs, cam16, SEED, sf, si,
                                p._replace(n_steps=48))
    g = np.random.default_rng(3)
    r = sf.shape[1]

    def some(q):
        return torch.as_tensor(g.random(r) < q, device=cuda)

    odd = torch.as_tensor(g.choice(np.array([-0.0, 0.0, 1.5, np.nan],
                                            np.float32), size=(6, r)),
                          device=cuda)
    sf[9:15] = torch.where(some(0.4), odd, sf[9:15])
    sf[6:9] = torch.where(some(0.2), -sf[6:9], sf[6:9])
    si[1] = torch.where(some(0.1), 2, si[1])
    sf[3] = torch.where(some(0.1), -sf[3], sf[3])
    short = some(0.3)
    si[2] = torch.where(short, p.stop_after - 1, si[2])
    si[1] = torch.where(short & some(0.5), p.max_depth - 1, si[1])
    sf[9:15] = torch.where(short, -0.0, sf[9:15])
    sf[6:9] = torch.where(short, -1.0, sf[6:9])
    one = fused._steps_plain(fs, cam16, SEED, sf.clone(), si.clone(),
                             p._replace(n_steps=1))
    neg_zero = (one[0][12:15].view(torch.int32)
                == torch.tensor(-0.0).view(torch.int32).item()).any(0)
    assert int((short & (one[1][2] == p.stop_after) & neg_zero).sum()) > 0
    for n_steps in (1, 2, 7):
        q = p._replace(n_steps=n_steps)
        want = fused._steps_plain(fs, cam16, SEED, sf.clone(), si.clone(), q)
        got = fused._steps_kernel(fs, cam16, SEED, sf.clone(), si.clone(), q)
        torch.cuda.synchronize()
        assert _bits_equal(got, want)


def _grouping_equal(g_k, g_p, rays, ray_id, n):
    """The kernel's grouping holds the plain one's rays and ids in the same
    key runs (the order inside a key is the atomics')."""
    (rk, ik, kk), (rp, ip, kp) = g_k, g_p
    if not torch.equal(kk[:n].long(), kp):
        return False
    key_of = torch.zeros(int(ray_id[:n].max()) + 1, dtype=torch.int64,
                         device=rays.device)
    key_of[ray_id[:n].long()] = kp
    run_k, run_p = key_of[ik[:n].long()], key_of[ip[:n].long()]
    pos = torch.zeros_like(key_of)
    pos[ray_id[:n].long()] = torch.arange(n, device=rays.device)
    return (torch.equal(run_k, run_p)
            and torch.equal(torch.sort(run_k * (1 << 32) + ik[:n]).values,
                            torch.sort(run_p * (1 << 32) + ip[:n]).values)
            and torch.equal(rk[:, :n], rays[:, pos[ik[:n].long()]]))


@pytest.mark.parametrize("sub,occl", [
    pytest.param(sub, occl, id=f"{sub}" + ("-occl" if occl else ""))
    for sub in (2, 3) for occl in (False, True)])
def test_group_kernel_matches_plain(cuda, sub, occl):
    """The grouping of K1's main rays, or of K1b's shadow rays (keyed over
    the segment up to lim), against group_plain: equal keys, the same
    lanes in each key run."""
    tb, p, sf, si = _mesh_step_inputs(cuda, sub=sub)
    fm = fused_mesh
    b = fm.step_buffers(sf.shape[1], p, 1, cuda)
    b.cnt.zero_()
    for name in ("k1", "nearest", "k1b") if occl else ("k1",):
        fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED, sf, si, b)
    k = 1 if occl else 0
    rays, ids = (b.sr, b.sr_id) if occl else (b.mr, b.mr_id)
    n = int(b.cnt[0, k])
    key = "group_occl" if occl else "group"
    launches = fm.LAUNCHES[key]
    got = fm._group_kernel(tb, p, rays, ids, b.cnt[0, k:k + 1], occl=occl)
    want = fm.group_plain(tb, p, rays, ids, b.cnt[0, k:k + 1], occl=occl)
    torch.cuda.synchronize()
    assert fm.LAUNCHES[key] == launches + 1
    assert n > 0 and _grouping_equal(got, want, rays, ids, n)


@pytest.mark.parametrize("over_cap", [False, True])
def test_grouped_resident_sweep_matches_plain(cuda, over_cap):
    """The stepper's nearest op on the card (grouping, then the sweep)
    against the plain sweep in pack order, bit for bit at every lane; also
    with a population past the cap."""
    tb, p, sf, si = _mesh_step_inputs(cuda, sub=3)
    fm = fused_mesh
    b = fm.step_buffers(sf.shape[1], p, 1, cuda)
    b.cnt.zero_()
    fm._k1_plain(tb, p, sf, b.hf, b.mr, b.mr_id, b.offs1, b.cnt[0, 0:1])
    cnt = b.cnt[0, 0:1].clone()
    if over_cap:
        # a full buffer, as K1 leaves it when more lanes cross than fit:
        # the packed rays again, each with its lane (same ray, same result)
        n, cap = int(cnt), b.mr.shape[1]
        again = torch.arange(cap - n, device=cuda) % n
        b.mr[:, n:] = b.mr[:, again]
        b.mr_id[n:] = b.mr_id[again]
        cnt += cap
    out_k = torch.full_like(b.hf[5:10], -7.0)
    out_p = out_k.clone()
    fm._nearest_kernel(tb, p, b.mr, b.mr_id, cnt, out_k)
    fm._sweep_plain(tb, p, b.mr, b.mr_id, cnt, out_p, occl=False)
    torch.cuda.synchronize()
    assert _bits_equal((out_k,), (out_p,))


def test_grouped_occlusion_sweep_matches_plain_every_step(cuda):
    """16 steps of the stepper, kernels and plain versions side by side:
    the grouped occlusion sweep's flags (kb row 8) bit equal after every
    step, and the state bit equal at the end."""
    tb, p, sf_k, si_k = _mesh_step_inputs(cuda, sub=3)
    fm = fused_mesh
    sf_p, si_p = sf_k.clone(), si_k.clone()
    n_steps = 16
    bk = fm.step_buffers(sf_k.shape[1], p, n_steps, cuda)
    bp = fm.step_buffers(sf_k.shape[1], p, n_steps, cuda)
    launches = fm.LAUNCHES["group_occl"]
    for k in range(n_steps):
        for name in fm.OP_NAMES:
            fm.run_op(fm.KERNEL_OPS, name, tb, p, SEED, sf_k, si_k, bk, k)
            fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED, sf_p, si_p, bp, k)
        torch.cuda.synchronize()
        assert int(bp.cnt[k, 1]) > 0
        assert _bits_equal((bk.kb[8],), (bp.kb[8],)), k
    assert fm.LAUNCHES["group_occl"] == launches + n_steps
    assert _bits_equal((sf_k, si_k), (sf_p, si_p))


# --- the plain equal-spp engine, slabs and soft shadows on the card ----------

def test_render_wavefront_on_card(cuda):
    """The equal-spp engine on the card against the CPU (2e-3), and at 1
    spp its ray count equal to the scan engine's on the card."""
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5)
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    acc, nxt, n = mc.render_wavefront(scene, cam, cfg, SEED,
                                      torch.zeros((32, 32, 3)), 0,
                                      return_rays=True)
    assert acc.is_cuda and nxt == 2
    want, _, n_cpu = mc.render_wavefront(scene, cam, cfg, SEED,
                                         torch.zeros((32, 32, 3)), 0,
                                         return_rays=True, device="cpu")
    np.testing.assert_allclose(acc.cpu().numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)
    one = cfg.replace(spp=1)
    _, _, n1 = mc.render_wavefront(scene, cam, one, SEED,
                                   torch.zeros((32, 32, 3)), 0,
                                   return_rays=True)
    assert int(n1) == int(mc.count_rays(cornell.cornell_scene(cuda), cam,
                                        one, SEED))


def test_slabs_compose_on_card(cuda):
    """Slab states (one cut on a row boundary, one off it) concatenate
    into the whole image's state bit for bit, after init and 6 steps."""
    cfg = RenderConfig(width=40, height=24, spp=2, max_depth=4)
    scene, cam = cornell.cornell_scene(cuda), cornell.cornell_camera(cuda)
    r = cfg.width * cfg.height
    whole = mc.wavefront_init(scene, cam, cfg, SEED, device=cuda)
    stepped = mc.wavefront_steps(scene, cam, cfg, SEED, whole, 6)
    for cut in (12 * cfg.width, 12 * cfg.width + 7):
        parts0, parts1 = [], []
        for a, b in ((0, cut), (cut, r)):
            st = mc.wavefront_init(scene, cam, cfg, SEED, pixel_offset=a,
                                   n_lanes=b - a, device=cuda)
            parts0.append(st)
            parts1.append(mc.wavefront_steps(scene, cam, cfg, SEED, st, 6,
                                             pixel_offset=a))
        for want, parts in ((whole, parts0), (stepped, parts1)):
            for f in ("s", "b", "n_done", "o", "d", "tp", "cur", "acc"):
                got = torch.cat([getattr(p, f) for p in parts])
                assert _bits_equal((got,), (getattr(want, f),)), (cut, f)
            assert int(sum(p.nrays for p in parts)) == int(want.nrays)


def test_soft_visibility_on_card(cuda):
    """soft_visibility and the mesh-gated make_soft_vis_fn on the card
    against the CPU (1e-6) on seeded segments in the room."""
    g = np.random.default_rng(7)
    p = g.uniform([0.2, 0.2, 0.2], [3.5, 3.5, 3.3], (4096, 3))
    w = g.standard_normal((4096, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    dist = g.uniform(0.5, 4.0, 4096)
    mscene = cornell.cornell_mesh_scene(meshes.icosphere(2))
    fn = mesh.make_soft_vis_fn(mscene)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in (p, w, dist)] + [1e-3, 0.05, 0.01]
        out[dev.type] = (
            intersect.soft_visibility(cornell.cornell_scene(dev), *args),
            intersect.soft_visibility(mscene.to(dev), *args),
            fn(mscene.to(dev), *args))
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


# --- gradients, record and replay --------------------------------------------

def _grad_leaves(scene):
    alb = scene.materials.albedo.clone().requires_grad_(True)
    v0 = scene.triangles.v0.clone().requires_grad_(True)
    return (scene.replace(materials=scene.materials.replace(albedo=alb),
                          triangles=scene.triangles.replace(v0=v0)),
            [alb, v0])


def _mc_grads(scene, cam, cfg, dev, render=mc.render, **kw):
    s, leaves = _grad_leaves(scene.to(dev))
    img = render(s, cam.to(dev), cfg, SEED, device=dev, **kw)
    return img.detach().cpu(), [g.cpu() for g in torch.autograd.grad(
        torch.mean(img ** 2), leaves)]


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and b.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()))


def test_render_replay_on_card(cuda):
    """The replay image equals render's on the card (bit equal: the same
    operations in both programs), and the replay's gradients the standard
    engine's."""
    scene, cam = _scene("cornell_sphere", cuda), cornell.cornell_camera(cuda)
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=4)
    a, g_std = _mc_grads(scene, cam, cfg, cuda)
    b, g_rep = _mc_grads(scene, cam, cfg, cuda, render=mc.render_replay)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=4e-6)
    assert int((a != b).any(-1).sum()) == 0
    _assert_grads_close(g_rep, g_std)


def test_gradients_on_card_match_cpu(cuda):
    """Cornell's albedo and v0 gradients on the card against the CPU's,
    for both engines."""
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=24, height=24, spp=2, max_depth=4)
    for render in (mc.render, mc.render_replay):
        img, got = _mc_grads(scene, cam, cfg, cuda, render=render)
        want_img, want = _mc_grads(scene, cam, cfg, torch.device("cpu"),
                                   render=render)
        np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=2e-3,
                                   atol=2e-3)
        _assert_grads_close(got, want)


def test_packet_gradients_on_card_match_plain(cuda):
    """Through csrc/packet.cu with ``differentiable=True``, the albedo and
    vertex gradients equal those of the plain packet version on the CPU:
    the kernel's t carries no gradient, so the rays must be detached on
    both routes."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=24, height=24, spp=1, max_depth=3)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        bundle = mesh.prepare(scene.to(dev), method="packet")
        packet.LAUNCHES.reset()
        out[dev.type] = _mc_grads(
            scene, cam, cfg, dev,
            intersect_fn=mesh.make_intersect_fn(bundle, sort_rays=True,
                                                differentiable=True),
            nearest_t_fn=mesh.make_nearest_t_fn(bundle, sort_rays=True))
        if dev.type == "cuda":
            assert packet.LAUNCHES["packet"] == 2 * cfg.max_depth
    np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(),
                               rtol=2e-3, atol=2e-3)
    _assert_grads_close(out["cuda"][1], out["cpu"][1])


def test_record_trace_through_packet_on_card(cuda, monkeypatch):
    """record_trace through csrc/packet.cu equals, field by field, its
    record through the plain packet version on the card, and its record on
    the CPU (the plain version there)."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(2))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=48, height=48, spp=2, max_depth=4)

    def record(dev):
        bundle = mesh.prepare(scene.to(dev), method="packet")
        return mc.record_trace(
            scene, cam, cfg, SEED, dev,
            intersect_fn=mesh.make_intersect_fn(bundle, sort_rays=True),
            nearest_t_fn=mesh.make_nearest_t_fn(bundle, sort_rays=True))

    packet.LAUNCHES.reset()
    kernel = record(cuda)
    assert packet.LAUNCHES["packet"] == 2 * cfg.spp * cfg.max_depth
    cpu = record(torch.device("cpu"))
    monkeypatch.setattr(packet, "nearest", packet.nearest_plain)
    plain = record(cuda)
    for f in ("prim", "is_triangle", "hit", "visible"):
        assert torch.equal(getattr(kernel, f), getattr(plain, f)), f
        assert torch.equal(getattr(kernel, f).cpu(), getattr(cpu, f)), f


# --- the replay's CUDA graphs (models/monte_carlo.render_from_trace) ---------

def _replay_routes(scene_of, param, cam, cfg, recs, target, dev):
    """(image, gradient of the MSE to ``target`` w.r.t. ``param``) of the
    graphed replay and of the eager body ``mc._replay``, at one point."""
    out = []
    for graphed in (True, False):
        p = param.detach().clone().requires_grad_(True)
        sc = scene_of(p)
        img = (mc.render_from_trace(sc, cam, cfg, SEED, recs, dev) if graphed
               else mc._replay(cfg, SEED, sc, cam, recs))
        (g,) = torch.autograd.grad(torch.mean((img - target) ** 2), p)
        out.append((img.detach(), g))
    return out


def _assert_same_replay(out):
    """The images bit equal; the gradients within 1e-6 relative (the
    gathers' backward adds with atomics, in no fixed order)."""
    (img, g), (want_img, want_g) = out
    assert torch.equal(img, want_img)
    assert torch.isfinite(g).all() and want_g.abs().max() > 0
    torch.testing.assert_close(g, want_g, rtol=1e-6,
                               atol=1e-6 * float(want_g.abs().max()))


def _replay_case(dev, width=40, height=32, spp=2, max_depth=4):
    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    target = torch.rand((height, width, 3), generator=gen, device=dev) * 0.6
    mc._REPLAY_GRAPHS.clear()
    mc.REPLAY_GRAPH.reset()
    return scene, cam, cfg, mc.record_trace(scene, cam, cfg, SEED, dev), target


def test_replay_graph_matches_the_eager_body(cuda):
    """Four Adam steps on the albedo logits, as the gradient cell takes
    them: at every step the graphed replay's image is bit equal to
    ``_replay``'s and its gradient within 1e-6; the first call eager, the
    second captures, then one replay a call; the images handed out are
    left as they were by the later replays, which write other values."""
    scene, cam, cfg, recs, target = _replay_case(cuda)
    mats = scene.materials

    def with_logits(lg):
        return scene.replace(materials=mats.replace(albedo=torch.where(
            ~mats.emissive[:, None], torch.sigmoid(lg), mats.albedo)))

    logits = torch.zeros_like(mats.albedo, requires_grad=True)
    opt = torch.optim.Adam([logits], lr=0.1)
    images = []
    for step in range(4):
        out = _replay_routes(with_logits, logits, cam, cfg, recs, target,
                             cuda)
        _assert_same_replay(out)
        assert mc.REPLAY_GRAPH.snapshot() == {
            "captures": min(step, 1), "replays": step, "eager": 1}
        images.append((out[0][0], out[0][0].clone()))
        opt.zero_grad()
        logits.grad = out[0][1]
        opt.step()
    for img, copy in images:
        assert torch.equal(img, copy)
    assert not torch.equal(images[1][0], images[3][0])


def test_replay_graph_keys_records_and_pending_backwards(cuda):
    """The emission's pattern (``recover_emission``'s) captures graphs of
    its own at its second call and matches ``_replay``; a record other
    than the captured one, of the same shapes (the camera moved), replays
    through them and matches; a call made while its key's last replay
    waits for its backward runs eagerly, and both backwards come out
    right; a second backward of a replay raises; calls without gradients
    capture a forward alone, bit equal."""
    scene, cam, cfg, recs, target = _replay_case(cuda)
    mats = scene.materials

    def with_raw(raw):
        return scene.replace(materials=mats.replace(emission=torch.where(
            mats.emissive[:, None], torch.exp(raw), mats.emission)))

    raw = torch.full_like(mats.emission, 2.0)
    _assert_same_replay(_replay_routes(with_raw, raw, cam, cfg, recs, target,
                                       cuda))
    cam2 = dataclasses.replace(cam, position=cam.position + torch.tensor(
        [0.05, -0.03, 0.02], device=cuda))
    recs2 = mc.record_trace(scene, cam2, cfg, SEED, cuda)
    assert not torch.equal(recs2.prim, recs.prim)
    _assert_same_replay(_replay_routes(with_raw, raw + 0.5, cam2, cfg, recs2,
                                       target, cuda))
    _assert_same_replay(_replay_routes(with_raw, raw + 0.25, cam, cfg, recs,
                                       target, cuda))
    assert mc.REPLAY_GRAPH.snapshot() == {"captures": 1, "replays": 2,
                                          "eager": 1}

    def loss(img):
        return torch.mean((img - target) ** 2)

    ps = [(raw + k).requires_grad_(True) for k in (0.25, 0.75)]
    imgs = [mc.render_from_trace(with_raw(p), cam, cfg, SEED, recs, cuda)
            for p in ps]
    assert mc.REPLAY_GRAPH["eager"] == 2
    got = [torch.autograd.grad(loss(imgs[k]), ps[k])[0] for k in (1, 0)]
    for k, g in zip((1, 0), got):
        want = _replay_routes(with_raw, ps[k], cam, cfg, recs, target,
                              cuda)[1]
        _assert_same_replay([(imgs[k].detach(), g), want])
    p = raw.clone().requires_grad_(True)
    lo = loss(mc.render_from_trace(with_raw(p), cam, cfg, SEED, recs, cuda))
    torch.autograd.grad(lo, p, retain_graph=True)
    with pytest.raises(RuntimeError, match="runs once"):
        torch.autograd.grad(lo, p)
    with torch.no_grad():
        for _ in range(3):
            img = mc.render_from_trace(scene, cam, cfg, SEED, recs, cuda)
            assert torch.equal(img, mc._replay(cfg, SEED, scene, cam, recs))
    assert mc.REPLAY_GRAPH["captures"] == 2


def test_replay_graph_on_a_mesh_record(cuda):
    """``test_replay_mesh_record_pass``'s set-up on the card: the record
    through csrc/packet.cu, the replay graphed at its second call, its
    image bit equal to the packet render's and to ``_replay``'s, its
    albedo gradient to ``_replay``'s."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1)).to(cuda)
    cam = cornell.cornell_camera(cuda)
    bundle = mesh.prepare(scene, method="packet")
    isect = mesh.make_intersect_fn(bundle, sort_rays=True)
    near = mesh.make_nearest_t_fn(bundle, sort_rays=True)
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=4)
    recs = mc.record_trace(scene, cam, cfg, SEED, cuda, intersect_fn=isect,
                           nearest_t_fn=near)
    mc._REPLAY_GRAPHS.clear()
    mc.REPLAY_GRAPH.reset()
    target = torch.zeros((cfg.height, cfg.width, 3), device=cuda)

    def with_albedo(a):
        return scene.replace(materials=scene.materials.replace(albedo=a))

    for _ in range(2):
        out = _replay_routes(with_albedo, scene.materials.albedo, cam, cfg,
                             recs, target, cuda)
        _assert_same_replay(out)
    assert mc.REPLAY_GRAPH.snapshot() == {"captures": 1, "replays": 1,
                                          "eager": 1}
    want = mc.render(scene, cam, cfg, SEED, device=cuda, intersect_fn=isect,
                     nearest_t_fn=near)
    assert torch.equal(out[0][0], want)


def test_replay_graph_holds_its_constants_and_spares_one_shot_calls(cuda):
    """A capture holds the shared constants it reads: with the cache
    emptied and the freed memory written over, its replays stay bit equal
    to ``_replay``.  A forward whose backward never ran may precede the
    capture.  ``render_replay`` with a new seed a call (one-shot calls)
    runs eagerly every time and captures nothing; the shared constants do
    not grow with the seeds."""
    scene, cam, cfg, recs, target = _replay_case(cuda)
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    sc = scene.replace(materials=scene.materials.replace(albedo=albedo))
    mc.render_from_trace(sc, cam, cfg, SEED, recs, cuda)   # no backward
    _assert_same_replay(_replay_routes(
        lambda a: scene.replace(materials=scene.materials.replace(albedo=a)),
        albedo, cam, cfg, recs, target, cuda))
    (cap,) = mc._REPLAY_GRAPHS._captures.values()
    assert {float(t) for t in cap.consts.values()} >= {
        float(torch.tensor(math.pi)), float(cfg.spp)}
    consts._CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full((1,), float("nan"), device=cuda)
            for _ in range(4096)]
    for k in range(2):
        _assert_same_replay(_replay_routes(
            lambda a: scene.replace(materials=scene.materials.replace(
                albedo=a)),
            albedo + 0.1 * k, cam, cfg, recs, target, cuda))
    del junk
    assert mc.REPLAY_GRAPH["captures"] == 1
    mc._REPLAY_GRAPHS.clear()
    mc.REPLAY_GRAPH.reset()
    sizes = []
    for k in range(4):
        img = mc.render_replay(sc, cam, cfg, SEED + 977 * k, cuda)
        torch.autograd.grad(torch.mean(img ** 2), albedo)
        sizes.append(len(consts._CACHE))
    assert mc.REPLAY_GRAPH.snapshot() == {"captures": 0, "replays": 0,
                                          "eager": 4}
    assert sizes == sizes[:1] * 4
