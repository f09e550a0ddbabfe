"""Grouping the resident sweeps' packed rays by the cluster boxes they
cross (``ops.fused_mesh.group_plain``, the order the kernels sweep in):
the main rays of the nearest sweep and the shadow rays of the occlusion
sweep.  The key is the sweep's own padded box test (over the unbounded
line, or over the shadow ray's segment up to lim), and the sweep over the
grouped rays writes what the sweep in pack order writes, bit for bit
(results go back by lane id).  The stepper's comparisons with the JAX
package (``test_torch_fused_mesh.py``) run through the grouped sweeps."""

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import clusters, fused
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

SEED = 4070199207   # seed_from_key(render_key(0)) of the JAX package


def _packed(sub: int, steps_before: int, occl: bool = False):
    """K1's packed main rays, or with ``occl`` K1b's packed shadow rays, of
    the 64x64 Cornell mesh scene (an icosphere of ``sub`` subdivisions in
    64-triangle clusters) after a few plain steps: (tables, params, step
    buffers, the packed rays, their lane ids, their count (1,))."""
    scene = cornell.cornell_mesh_scene(meshes.icosphere(sub))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=6)
    mp = fm.pack_mesh_scene(scene, cluster_size=64)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device="cpu")
    if steps_before:
        st, _, _ = fm.wavefront_steps_fused_mesh_plain(
            mp, cam, cfg, SEED, st, steps_before, cap_main=8192,
            cap_shadow=8192)
    p = fm.params(cfg, 4096)
    tb = fm._tables(mp, fused._camera_words(cam))
    sf, si = fused.state_planes(st)
    b = fm.step_buffers(4096, p, 1, "cpu")
    for name in ("k1", "nearest", "k1b") if occl else ("k1",):
        fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED, sf, si, b)
    k = 1 if occl else 0
    assert int(b.cnt[0, k]) > (100 if occl else 300)
    return (tb, p, b, b.sr if occl else b.mr, b.sr_id if occl else b.mr_id,
            b.cnt[0, k:k + 1])


def _cases(*subs_steps):
    """(sub, steps_before, occl) cases: main rays ("2-3"), shadow rays
    ("2-3-occl")."""
    return [pytest.param(sub, steps, occl,
                         id=f"{sub}-{steps}" + ("-occl" if occl else ""))
            for sub, steps in subs_steps for occl in (False, True)]


@pytest.mark.parametrize("sub,steps_before,occl",
                         _cases((2, 0), (2, 3), (3, 3)))
def test_group_keys_are_the_crossed_boxes(sub, steps_before, occl):
    """Bit c % GROUP_BITS of a ray's key is set exactly where the ray
    crosses cluster c's padded box (icosphere(3): 20 clusters, folded);
    a shadow ray's over its segment up to lim."""
    tb, p, b, packed, _, cnt = _packed(sub, steps_before, occl)
    n = int(cnt)
    rays = packed[:, :n]
    crossed = clusters.crosses_box_plain(tb.mp.smc_aabb, rays, p.t_min, occl=occl)
    keys = fm.group_keys_plain(tb.mp.smc_aabb, rays, p.t_min, occl=occl)
    if occl:
        # the segment crosses no box that the line misses
        line = clusters.crosses_box_plain(tb.mp.smc_aabb, rays, p.t_min,
                                    occl=False)
        assert bool((line | ~crossed).all())
    n_cl = tb.mp.n_clusters
    assert (n_cl > fm.GROUP_BITS) == (sub == 3)
    for bit in range(fm.GROUP_BITS):
        want = crossed[bit::fm.GROUP_BITS].any(0)
        assert torch.equal((keys >> bit) & 1 == 1, want)
    assert bool((keys >> fm.GROUP_BITS == 0).all())


@pytest.mark.parametrize("sub,steps_before,occl", _cases((2, 3), (3, 3)))
def test_group_plain_is_a_sort_by_key(sub, steps_before, occl):
    """The grouped rays are the packed rays (main, or shadow rays with
    their lim), each with its own lane id, in key order; a warp (32
    consecutive rays) crosses fewer boxes."""
    tb, p, b, packed, ids, cnt = _packed(sub, steps_before, occl)
    n = int(cnt)
    g_rays, g_id, keys = fm.group_plain(tb, p, packed, ids, cnt, occl=occl)
    assert g_rays.shape == packed.shape
    pos = torch.empty(int(ids[:n].max()) + 1, dtype=torch.int64)
    pos[ids[:n].long()] = torch.arange(n)
    src = pos[g_id[:n].long()]
    assert torch.equal(torch.sort(src).values, torch.arange(n))
    assert torch.equal(g_rays[:, :n], packed[:, src])
    assert bool((keys[src][1:] >= keys[src][:-1]).all())

    def boxes_per_warp(k):
        w = k[:n // 32 * 32].view(-1, 32)
        union = torch.zeros(w.shape[0], dtype=torch.int64)
        for lane in range(32):
            union |= w[:, lane]
        return sum(int(((union >> c) & 1).sum()) for c in range(fm.GROUP_BITS))

    assert boxes_per_warp(keys[src]) < boxes_per_warp(keys)


@pytest.mark.parametrize("over_cap", [False, True])
@pytest.mark.parametrize("sub", [2, 3])
def test_grouped_sweep_equals_pack_order_sweep(sub, over_cap):
    """The resident nearest sweep over the grouped rays (the stepper's)
    against the sweep in pack order: t, normal and material id at every
    lane bit equal, and the same triangle tests, in pack order; also with
    a population past the cap (the rays that fit are swept)."""
    tb, p, b, _, _, cnt = _packed(sub, 3)
    cnt = cnt.clone()
    if over_cap:
        # a full buffer, as K1 leaves it when more lanes cross than fit:
        # the packed rays again, each with its lane (same ray, same result)
        n, cap = int(cnt), b.mr.shape[1]
        again = torch.arange(cap - n) % n
        b.mr[:, n:] = b.mr[:, again]
        b.mr_id[n:] = b.mr_id[again]
        cnt += cap
    out_g = torch.full_like(b.hf[5:10], -7.0)
    out_p = out_g.clone()
    tests_g = fm._nearest_plain(tb, p, b.mr, b.mr_id, cnt, out_g)
    tests_p = fm._sweep_plain(tb, p, b.mr, b.mr_id, cnt, out_p, occl=False)
    assert torch.equal(out_g.view(torch.int32), out_p.view(torch.int32))
    assert torch.equal(tests_g, tests_p)
    hit = out_p[0] < fm.NO_HIT
    assert int(hit.sum()) > 100


@pytest.mark.parametrize("over_cap", [False, True])
@pytest.mark.parametrize("sub", [2, 3])
def test_grouped_occlusion_sweep_equals_pack_order_sweep(sub, over_cap):
    """The resident occlusion sweep over the grouped shadow rays (the
    stepper's) against the sweep in pack order: the flag at every lane
    bit equal, and the same triangle tests, in pack order; also with a
    population past the cap."""
    tb, p, b, packed, ids, cnt = _packed(sub, 3, occl=True)
    cnt = cnt.clone()
    if over_cap:
        n, cap = int(cnt), packed.shape[1]
        again = torch.arange(cap - n) % n
        packed[:, n:] = packed[:, again]
        ids[n:] = ids[again]
        cnt += cap
    out_g = torch.full_like(b.kb[8:9], -7.0)
    out_p = out_g.clone()
    tests_g = fm._occl_plain(tb, p, packed, ids, cnt, out_g)
    tests_p = fm._sweep_plain(tb, p, packed, ids, cnt, out_p, occl=True)
    assert torch.equal(out_g.view(torch.int32), out_p.view(torch.int32))
    assert torch.equal(tests_g, tests_p)
    n_occluded = int((out_p[0] == 1.0).sum())
    assert 10 < n_occluded < min(int(cnt), packed.shape[1])


def test_stepper_kernel_ops_group_only_the_resident_sweep():
    """The resident ops group the rays of both sweeps, the nearest sweep's
    and the occlusion sweep's; the shortlist ops keep the pack order."""
    assert fm.PLAIN_OPS.nearest is fm._nearest_plain
    assert fm.KERNEL_OPS.nearest is fm._nearest_kernel
    assert fm.PLAIN_OPS.occl is fm._occl_plain
    assert fm.KERNEL_OPS.occl is fm._occl_kernel
    for op in (fm.PLAIN_OPS.nearest, fm.PLAIN_OPS.occl):
        assert op.func is fm._grouped_sweep_plain
    for op in (fm.KERNEL_OPS.nearest, fm.KERNEL_OPS.occl):
        assert op.func is fm._grouped_sweep_kernel
    assert not fm.PLAIN_OPS.nearest.keywords["occl"]
    assert fm.KERNEL_OPS.occl.keywords["occl"]
    for ops in (fm.PLAIN_SL_OPS, fm.KERNEL_SL_OPS):
        assert ops.nearest.func is fm._sl_sweep
        assert ops.occl.func is fm._sl_sweep


def test_group_wrapper_refuses_cpu_tensors():
    """Both groupings (main rays, shadow rays) raise on CPU tensors before
    their launch counters move."""
    for occl in (False, True):
        tb, p, b, packed, ids, cnt = _packed(2, 0, occl)
        key = "group_occl" if occl else "group"
        launches = fm.LAUNCHES[key]
        with pytest.raises(ValueError, match="contiguous CUDA"):
            fm._group_kernel(tb, p, packed, ids, cnt, occl=occl)
        assert fm.LAUNCHES[key] == launches


def test_group_keys_fold_past_the_key_bits():
    """Clusters past GROUP_BITS share bits: cluster c sets bit c % 12."""
    g = np.random.default_rng(1)
    n_cl = 2 * fm.GROUP_BITS + 3
    lo = g.uniform(-4.0, 3.0, (n_cl, 3)).astype(np.float32)
    aabb = np.zeros((n_cl, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = lo, lo + 1.0
    o = np.zeros((3, 500), np.float32)
    d = g.normal(size=(3, 500)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    rays = torch.as_tensor(np.concatenate([o, d]))
    aabb = torch.as_tensor(aabb)
    crossed = clusters.crosses_box_plain(aabb, rays, 1e-3, occl=False)
    keys = fm.group_keys_plain(aabb, rays, 1e-3)
    want = torch.zeros(500, dtype=torch.int64)
    for c in range(n_cl):
        want |= crossed[c].long() << (c % fm.GROUP_BITS)
    assert torch.equal(keys, want)
    assert int(crossed[fm.GROUP_BITS:].sum()) > 0
