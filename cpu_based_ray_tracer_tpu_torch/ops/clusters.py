"""The cluster table and the cluster sweeps' shared rules (the Python twin
of ``csrc/cluster_tri.cuh``), below every module that uses them.

- ``build_smem_clusters``: the cluster-major triangle table (``MESH_NF``
  floats a row) and its cluster boxes, the format that ``ops.fused_mesh``,
  ``ops.coherent`` and ``ops.packet`` sweep.
- ``split_count`` / ``slices``: how many slices a split sweep cuts each
  ray block's cluster list into on the current card.
- ``crosses_box_plain``: the sweeps' padded cluster-box cull.
- ``list_sweep_plain`` / ``split_sweep_plain``: the sweep over per-tile
  cluster lists in PyTorch, serial and sliced as the kernels slice it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.ops import bvh as bvh_ops
from cpu_based_ray_tracer_tpu_torch.ops.fused import NO_HIT, _DET_EPS
from cpu_based_ray_tracer_tpu_torch.utils import profiling

MESH_NF = 16            # floats per cluster triangle row: v0 e1 e2 n mid idx pad*2
SWEEP_BLOCK = 256       # packed rays per sweep block (csrc/fused_mesh.cu)
SPLIT_MAX = 16          # most list slices per sweep ray block (the same)
SWEEP_WAVES = 8         # the slices fill this many times the resident blocks
_TILE_CHUNK = 16        # tiles per vectorized step of list_sweep_plain

# pack_mesh_scene's device builds ("packs"), the level passes of their
# BVH leaf orders (``bvh.leaf_order``, also counted for the other callers of
# ``build_smem_clusters``) and their reads of the device ("host_reads"); a
# pack reads the device a fixed number of times, whatever the mesh's size.
PACK = profiling.Counter("fused_mesh_pack", ("packs", "levels", "host_reads"))


def split_count(n: int, target: int, k_max: int) -> int:
    """Slices per ray block that the sweep kernel takes for ``n`` packed
    rays and ``target`` block slots (csrc/fused_mesh.cu split_count)."""
    nb = -(-int(n) // SWEEP_BLOCK)
    if nb <= 0:
        return 1
    return max(1, min(-(-int(target) // nb), k_max))


def slices(lib, entry: str, n: int, n_clusters: int, *args) -> int:
    """The list slices a split sweep of ``n`` rays over ``n_clusters``
    clusters takes on the current card: enough (256-ray block, slice) work
    items to fill ``SWEEP_WAVES`` times the kernel's resident blocks
    (``lib.occupancy(entry, *args)``, a ``utils.kernels.Library``), at most
    ``SPLIT_MAX`` and the cluster count."""
    per_sm, n_sm = lib.occupancy(entry, *args)
    return split_count(n, per_sm * n_sm * SWEEP_WAVES,
                       max(1, min(SPLIT_MAX, n_clusters)))


# --- the table ---------------------------------------------------------------

class SmemClusters(NamedTuple):
    """Cluster-major triangle table (the JAX package's name: there it is
    SMEM-resident; here it stays in device memory)."""

    tri: torch.Tensor       # (C, CS, MESH_NF) f32 rows: v0 e1 e2 n mid idx
    aabb: torch.Tensor      # (C, 8) f32 min xyz / max xyz / pad
    cs: int
    box_aabb: torch.Tensor  # (B, 8) f32 union AABB per chunk of clusters
    boxes: tuple            # ((c_start, c_end), ...) cluster ranges


def build_smem_clusters(verts, normals, mids, cluster_size: int = 128
                        ) -> SmemClusters:
    """Spatially ordered FULL clusters: the triangles in median-split BVH
    preorder (leaves of at most ``max(8, cs // 8)``), the preorder stream
    cut into exactly-``cluster_size`` clusters; only the last cluster pads,
    with all-zero triangles (det == 0, never hit; index -1).  AABBs are
    rounded outward to float32.  Up to 64 spatial boxes of contiguous
    clusters serve as the predicate AABBs of meshes with more than 64
    clusters.  Built on the device of ``verts`` (numpy: the CPU) with no
    read of it; byte-equal to the JAX package's build."""
    tris = torch.as_tensor(verts).to(torch.float64).reshape(-1, 3, 3)
    dev, f32 = tris.device, torch.float32
    n, cs = tris.shape[0], cluster_size
    c = -(-n // cs)
    n_box = int(min(64, c))
    edges = np.linspace(0, c, n_box + 1).astype(int)
    boxes = tuple((int(edges[b]), int(edges[b + 1])) for b in range(n_box))
    # A box's clusters as one row, padded by repeating its last one (the
    # widths of the boxes differ by at most one).
    width = int(np.diff(edges).max()) if n_box else 0
    box_rows = torch.as_tensor(np.minimum(
        edges[:-1, None] + np.arange(width), edges[1:, None] - 1)).to(dev)
    order = bvh_ops.leaf_order(tris, leaf_size=max(8, cs // 8),
                               on_level=lambda: PACK.add("levels"))

    # One row a triangle in input order, and a last one for the padding.
    table = torch.zeros((n + 1, MESH_NF), dtype=f32, device=dev)
    table[:n, 0:3] = tris[:, 0]
    table[:n, 3:6] = tris[:, 1] - tris[:, 0]
    table[:n, 6:9] = tris[:, 2] - tris[:, 0]
    table[:n, 9:12] = torch.as_tensor(normals).to(dev)
    table[:n, 12] = torch.as_tensor(mids).to(dev)
    table[:n, 13] = torch.arange(n, device=dev)   # original index (f32)
    table[n, 13] = -1.0
    idx = torch.full((c * cs,), n, dtype=torch.int64, device=dev)
    idx[:n] = order
    rows = table[idx].view(c, cs, MESH_NF)

    inf = torch.full((1, 3), float("inf"), dtype=torch.float64, device=dev)
    lo = torch.cat([tris.amin(1), inf])[idx].view(c, cs, 3).amin(1)
    hi = torch.cat([tris.amax(1), -inf])[idx].view(c, cs, 3).amax(1)
    aabb = torch.zeros((c, 8), dtype=f32, device=dev)
    aabb[:, 0:3] = torch.nextafter(lo.to(f32), -inf.to(f32))
    aabb[:, 3:6] = torch.nextafter(hi.to(f32), inf.to(f32))
    box_aabb = torch.zeros((n_box, 8), dtype=f32, device=dev)
    box_aabb[:, 0:3] = aabb[box_rows, 0:3].amin(1)
    box_aabb[:, 3:6] = aabb[box_rows, 3:6].amax(1)
    return SmemClusters(tri=rows, aabb=aabb, cs=cs, box_aabb=box_aabb,
                        boxes=boxes)


# --- the sweeps in PyTorch ---------------------------------------------------

def list_sweep_plain(tri, rays, ids, cnts, t_min: float, *, occl: bool,
                     n_live: int | None = None, cull=None):
    """The cluster sweep over per-tile lists in PyTorch: the loops of the
    sweep kernels (csrc/cluster_tri.cuh).  rays (P, T, L): the rays of T
    tiles, P = 6 [o d] (nearest) or 7 [o d lim] (occlusion); tile t sweeps
    the clusters ids[t, :cnts[t]] of tri (C, CS, MESH_NF), in that order.
    Only the first ``n_live`` rays in tile order are swept (default all).

    Nearest: the first row at the least t in a cluster wins, a later
    cluster only when strictly nearer.  Occlusion: any row within
    (t_min, lim] by the division-free accept.  Returns (best_t (T, L),
    best_slot (T, L) i64 row of tri.reshape(-1, MESH_NF) or -1, tests) for
    nearest and (occluded (T, L) bool, None, tests) for occlusion; tests
    (T, L) i64 counts the triangle tests the kernels make (an occluded ray
    stops at its first occluder).  ``cull`` (nearest only): cull(cid (A,),
    rays (6, A, lc)) -> (A, CS, lc) bool, the rows of clusters cid that
    each ray tests (the others it skips; csrc/coherent.cu's cull, which
    is conservative, so the results stay the unculled sweep's)."""
    where = torch.where
    dev = rays.device
    cs = tri.shape[1]
    _, n_t, n_l = rays.shape
    n_live = n_t * n_l if n_live is None else min(int(n_live), n_t * n_l)
    rows = torch.arange(cs, device=dev)[None, :, None]
    tests = torch.zeros((n_t, n_l), dtype=torch.int64, device=dev)
    best = torch.zeros((n_t, n_l), dtype=torch.bool, device=dev)
    slot = None
    if not occl:
        best = torch.full((n_t, n_l), NO_HIT, dtype=torch.float32, device=dev)
        slot = torch.full((n_t, n_l), -1, dtype=torch.int64, device=dev)
    ids = ids.to(torch.int64)
    cn_all = cnts.to(torch.int64).cpu()          # loop bounds, on the host
    # whole tiles in chunks, then the live part of the last tile
    n_full = n_live // n_l
    segs = [(t0, min(n_full, t0 + _TILE_CHUNK), n_l)
            for t0 in range(0, n_full, _TILE_CHUNK)]
    if n_live % n_l:
        segs.append((n_full, n_full + 1, n_live % n_l))
    for t0, t1, lc in segs:
        cn = cn_all[t0:t1]
        for j in range(int(cn.max())):
            act = cn > j
            tt = (slice(t0, t1) if bool(act.all())
                  else (torch.nonzero(act)[:, 0] + t0).to(dev))
            cid = ids[tt, j]
            tc = tri[cid]                                   # (A, CS, NF)
            ox, oy, oz, dx, dy, dz = (x[:, None, :lc] for x in rays[0:6, tt])
            v0x, v0y, v0z = tc[:, :, 0:1], tc[:, :, 1:2], tc[:, :, 2:3]
            e1x, e1y, e1z = tc[:, :, 3:4], tc[:, :, 4:5], tc[:, :, 5:6]
            e2x, e2y, e2z = tc[:, :, 6:7], tc[:, :, 7:8], tc[:, :, 8:9]
            s1x = dy * e2z - dz * e2y
            s1y = dz * e2x - dx * e2z
            s1z = dx * e2y - dy * e2x
            det = s1x * e1x + s1y * e1y + s1z * e1z            # (A, CS, lc)
            okd = torch.abs(det) > _DET_EPS
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            s2x = sy * e1z - sz * e1y
            s2y = sz * e1x - sx * e1z
            s2z = sx * e1y - sy * e1x
            if occl:
                lim = rays[6, tt][:, None, :lc]
                sd = where(det >= 0.0, 1.0, -1.0)
                adet = det * sd
                tn = s2x * e2x + s2y * e2y + s2z * e2z
                b1n = s1x * sx + s1y * sy + s1z * sz
                b2n = s2x * dx + s2y * dy + s2z * dz
                tsd = tn * sd
                hit = (okd & (tsd > t_min * adet) & (tsd <= lim * adet)
                       & (b1n * sd >= 0.0) & (b2n * sd >= 0.0)
                       & ((det - b1n - b2n) * sd >= 0.0))
                hit_c = hit.any(1)                              # (A, lc)
                prev = best[tt, :lc]
                first = torch.amin(where(hit, rows, cs), 1)
                # tests up to and including the first accepted row
                tests[tt, :lc] += where(prev, 0, where(hit_c, first + 1, cs))
                best[tt, :lc] = prev | hit_c
                continue
            inv = 1.0 / where(okd, det, 1.0)
            t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
            b1 = (s1x * sx + s1y * sy + s1z * sz) * inv
            b2 = (s2x * dx + s2y * dy + s2z * dz) * inv
            ok = (okd & (t > t_min) & (b1 >= 0.0) & (b2 >= 0.0)
                  & (1.0 - b1 - b2 >= 0.0))
            if cull is not None:
                tested = cull(cid, rays[0:6, tt][:, :, :lc])    # (A, CS, lc)
                ok &= tested
            tm = where(ok, t, NO_HIT)                           # (A, CS, lc)
            t_c = torch.amin(tm, 1)
            # the strict t < best_t chain keeps the first row at the least t
            i_c = torch.amin(where(tm == t_c[:, None], rows, cs), 1)
            bt = best[tt, :lc]
            better = t_c < bt
            best[tt, :lc] = where(better, t_c, bt)
            slot[tt, :lc] = where(better, cid[:, None] * cs + i_c,
                                  slot[tt, :lc])
            tests[tt, :lc] += cs if cull is None else tested.sum(1)
    return best, slot, tests


def split_sweep_plain(tri, rays, ids, cnts, t_min: float, k: int, *,
                      occl: bool, n_live: int | None = None, cull=None):
    """``list_sweep_plain`` as the split sweep kernel computes it: each
    tile's list cut into ``k`` contiguous slices (slice i: positions
    [n * i // k, n * (i + 1) // k) of a list of n), each slice swept alone,
    then combined in slice order (nearest: a later slice wins only when
    strictly nearer; occlusion: OR).  Same returns as
    ``list_sweep_plain``; the tests are those of slices that each stop a
    ray only at their own first occluder (the kernel's slices also stop
    once another slice has found one, so they make at most these)."""
    dev = rays.device
    n_t, n_c = ids.shape
    cn = cnts.to(torch.int64).to(dev)
    pos = torch.arange(n_c, device=dev)
    best = slot = tests = None
    for i in range(k):
        j0, j1 = cn * i // k, cn * (i + 1) // k
        take = torch.clamp(j0[:, None] + pos, max=n_c - 1)
        ids_i = torch.gather(ids.to(torch.int64), 1, take)
        r, s, t = list_sweep_plain(tri, rays, ids_i, j1 - j0, t_min,
                                   occl=occl, n_live=n_live, cull=cull)
        if best is None:
            best, slot, tests = r, s, t
            continue
        tests = tests + t
        if occl:
            best = best | r
            continue
        better = r < best
        best = torch.where(better, r, best)
        slot = torch.where(better, s, slot)
    return best, slot, tests


def crosses_box_plain(aabb, rays, t_min: float, *, occl: bool):
    """The sweep kernel's cluster cull in PyTorch (csrc/fused_mesh.cu
    ``crosses_box``): does each ray of rays (6 or 7, n) cross each box of
    aabb (C, 8), every side pushed out by 1e-4 of the box's extent plus
    the largest coordinate magnitude of the box and the ray's origin, and
    1e-6?  The slab test of the mask pass, from min(t_min, 0) (occlusion:
    up to lim with its slack).  -> (C, n) bool."""
    ox, oy, oz, dx, dy, dz = rays[0:6]

    def sinv(v):
        tiny = torch.where(v < 0.0, -1e-20, 1e-20)
        return 1.0 / torch.where(torch.abs(v) < 1e-20, tiny, v)

    o_mag = torch.maximum(torch.maximum(torch.abs(ox), torch.abs(oy)),
                          torch.abs(oz))
    box = aabb[:, :6, None]
    mag = torch.maximum(o_mag, torch.amax(torch.abs(box), 1))   # (C, n)
    ts = []
    for o, iv, j in ((ox, sinv(dx), 0), (oy, sinv(dy), 1), (oz, sinv(dz), 2)):
        lo, hi = box[:, j], box[:, 3 + j]
        m = 1e-4 * ((hi - lo) + mag) + 1e-6
        ts.append(((lo - m - o) * iv, (hi + m - o) * iv))
    t_in = torch.maximum(torch.maximum(torch.minimum(*ts[0]),
                                       torch.minimum(*ts[1])),
                         torch.minimum(*ts[2]))
    t_out = torch.minimum(torch.minimum(torch.maximum(*ts[0]),
                                        torch.maximum(*ts[1])),
                          torch.maximum(*ts[2]))
    crossed = (t_out >= min(float(t_min), 0.0)) & (t_in <= t_out)
    if occl:
        crossed &= t_in <= rays[6] * 1.000001 + 1e-5
    return crossed
