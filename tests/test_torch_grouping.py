"""Grouping the resident nearest sweep's packed rays by the cluster boxes
they cross (``ops.fused_mesh.group_plain``, the order the kernels sweep
in): the key is the sweep's own padded box test, and the sweep over the
grouped rays writes what the sweep in pack order writes, bit for bit
(results go back by lane id).  The stepper's comparisons with the JAX
package (``test_torch_fused_mesh.py``) run through the grouped sweep."""

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

SEED = 4070199207   # seed_from_key(render_key(0)) of the JAX package


def _packed(sub: int, steps_before: int):
    """K1's packed main rays of the 64x64 Cornell mesh scene (an icosphere
    of ``sub`` subdivisions in 64-triangle clusters) after a few plain
    steps: (tables, params, step buffers)."""
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
    sf, _ = fm.state_planes(st)
    b = fm.step_buffers(4096, p, 1, "cpu")
    fm._k1_plain(tb, p, sf, b.hf, b.mr, b.mr_id, b.offs1, b.cnt[0, 0:1])
    assert int(b.cnt[0, 0]) > 300
    return tb, p, b


@pytest.mark.parametrize("sub,steps_before", [(2, 0), (2, 3), (3, 3)])
def test_group_keys_are_the_crossed_boxes(sub, steps_before):
    """Bit c % GROUP_BITS of a ray's key is set exactly where the ray
    crosses cluster c's padded box (icosphere(3): 20 clusters, folded)."""
    tb, p, b = _packed(sub, steps_before)
    n = int(b.cnt[0, 0])
    rays = b.mr[:, :n]
    crossed = fm.crosses_box_plain(tb.mp.smc_aabb, rays, p.t_min, occl=False)
    keys = fm.group_keys_plain(tb.mp.smc_aabb, rays, p.t_min)
    n_cl = tb.mp.n_clusters
    assert (n_cl > fm.GROUP_BITS) == (sub == 3)
    for bit in range(fm.GROUP_BITS):
        want = crossed[bit::fm.GROUP_BITS].any(0)
        assert torch.equal((keys >> bit) & 1 == 1, want)
    assert bool((keys >> fm.GROUP_BITS == 0).all())


@pytest.mark.parametrize("sub,steps_before", [(2, 3), (3, 3)])
def test_group_plain_is_a_sort_by_key(sub, steps_before):
    """The grouped rays are the packed rays, each with its own lane id, in
    key order; a warp (32 consecutive rays) crosses fewer boxes."""
    tb, p, b = _packed(sub, steps_before)
    n = int(b.cnt[0, 0])
    g_rays, g_id, keys = fm.group_plain(tb, p, b.mr, b.mr_id, b.cnt[0, 0:1])
    pos = torch.empty(int(b.mr_id[:n].max()) + 1, dtype=torch.int64)
    pos[b.mr_id[:n].long()] = torch.arange(n)
    src = pos[g_id[:n].long()]
    assert torch.equal(torch.sort(src).values, torch.arange(n))
    assert torch.equal(g_rays[:, :n], b.mr[:, src])
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
    tb, p, b = _packed(sub, 3)
    cnt = b.cnt[0, 0:1].clone()
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


def test_stepper_kernel_ops_group_only_the_resident_sweep():
    """The resident ops group the nearest sweep's rays; the shortlist ops
    keep the pack order, and the occlusion sweep is not grouped."""
    assert fm.PLAIN_OPS.nearest is fm._nearest_plain
    assert fm.KERNEL_OPS.nearest is fm._nearest_kernel
    assert fm.PLAIN_SL_OPS.nearest.func is fm._sl_sweep
    assert fm.KERNEL_OPS.occl is fm._occl_kernel


def test_group_wrapper_refuses_cpu_tensors():
    tb, p, b = _packed(2, 0)
    launches = fm.LAUNCHES["group"]
    with pytest.raises(ValueError, match="contiguous CUDA"):
        fm._group_kernel(tb, p, b.mr, b.mr_id, b.cnt[0, 0:1])
    assert fm.LAUNCHES["group"] == launches


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
    crossed = fm.crosses_box_plain(aabb, rays, 1e-3, occl=False)
    keys = fm.group_keys_plain(aabb, rays, 1e-3)
    want = torch.zeros(500, dtype=torch.int64)
    for c in range(n_cl):
        want |= crossed[c].long() << (c % fm.GROUP_BITS)
    assert torch.equal(keys, want)
    assert int(crossed[fm.GROUP_BITS:].sum()) > 0
