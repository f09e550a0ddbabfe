"""Cluster-culled mesh intersector (port of
``cpu_based_ray_tracer_tpu.ops.packet``).

Host side, the triangles are partitioned into spatial clusters (the leaves
of the median-split BVH, ``ops.bvh``, with leaf size CS), each padded to
exactly CS never-hit triangles and stored contiguously beside its AABB.
A ray runs Moller-Trumbore over the CS triangles of every cluster whose
padded AABB it crosses (``ops.clusters.crosses_box_plain``: every side
pushed out by a margin that grows with the coordinates' magnitude, so a
ray that hits a triangle crosses its cluster's box).  Within a cluster the
lowest row at the minimum t wins; across clusters a cluster replaces the
best hit only when strictly nearer.  The winner's slot (cluster * CS +
row) maps to the original triangle index through ``tri_id``; -1 on a miss.

The JAX kernel culls by a vote of 256-ray blocks on the unpadded boxes,
nearer than each ray's best hit so far; its result is the same nearest
hit, since no cull drops a triangle a ray hits.  Here the set of clusters
a ray tests depends on the ray alone, so the kernel may cut the cluster
list into slices swept by blocks of their own and cull per warp and still
give the plain version's bits.

- ``csrc/packet.cu`` is the kernel (CUDA C++ for sm_90a: work items of a
  256-ray block and a slice of the clusters, enough to fill the card
  whatever the ray count; crossed clusters staged by ``cp.async`` into a
  double buffer; a warp none of whose rays crosses a cluster skips it);
  ``nearest`` launches it for CUDA tensors.
- ``nearest_plain`` is the same cluster loop in PyTorch, vectorized over
  the rays that cross each cluster's box and chunked so that a pass over
  802,816 rays fits in memory.  ``nearest`` runs it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.ops import bvh as bvh_ops
from cpu_based_ray_tracer_tpu_torch.ops import clusters as clusters_ops
from cpu_based_ray_tracer_tpu_torch.utils import kernels
from cpu_based_ray_tracer_tpu_torch.utils import profiling

_DET_EPS = 1e-12
NO_HIT = float(np.finfo(np.float32).max)

# Rays per block: one CUDA block of this many threads (BLOCK in
# csrc/packet.cu), and the unit of the JAX kernel's cull vote, by which
# ``nearest_plain(return_passes=True)`` counts the work of that cull.
BLOCK = 256
# Rays per vectorized step of the plain version.
_PLAIN_CHUNK = 65536

# Launches of csrc/packet.cu since the last reset.
LAUNCHES = profiling.Counter("packet")

_P = ctypes.c_void_p
LIB = kernels.Library("packet", {
    # (aabb, tri, tri_id, C, CS, o, d, R, t_min, K, part, tickets, t, idx,
    #  stream)
    "packet_nearest": ([_P] * 3 + [ctypes.c_int] * 2 + [_P] * 2
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int]
                       + [_P] * 5),
    # (cs, out)
    "packet_slots": [ctypes.c_int, _P],
}, LAUNCHES)


@dataclasses.dataclass(frozen=True)
class Clusters:
    """Cluster set over a triangle soup, built by ``build_clusters``."""

    tri: torch.Tensor     # (C, CS, 12) f32: v0 e1 e2 pad, zero rows pad
    aabb: torch.Tensor    # (C, 8) f32: min xyz, max xyz, 2 pad
    tri_id: torch.Tensor  # (C*CS,) i32: original triangle index, -1 on pads
    cs: int               # triangles per cluster

    @property
    def n_clusters(self) -> int:
        return self.aabb.shape[0]

    def to(self, device) -> "Clusters":
        return dataclasses.replace(self, tri=self.tri.to(device),
                                   aabb=self.aabb.to(device),
                                   tri_id=self.tri_id.to(device))


def build_clusters(tri_vertices: np.ndarray, cluster_size: int = 128,
                   device="cpu") -> Clusters:
    """Partition (T, 3, 3) triangles into the leaves of the median-split
    BVH with ``leaf_size=cluster_size``, each padded to ``cluster_size``
    degenerate triangles; AABBs rounded outward to float32.  Byte-equal to
    the JAX package's build."""
    tris = np.asarray(tri_vertices, np.float64).reshape(-1, 3, 3)
    flat = bvh_ops.build_bvh(tris, leaf_size=cluster_size)
    leaves = np.flatnonzero(flat.leaf_count > 0)
    cs, c = cluster_size, len(leaves)
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    packed = np.zeros((c, cs, 12), np.float32)
    tri_id = np.full((c * cs,), -1, np.int32)
    aabb = np.zeros((c, 8), np.float32)
    for ci, leaf in enumerate(leaves):
        first, count = flat.leaf_first[leaf], flat.leaf_count[leaf]
        idx = flat.order[first:first + count]
        k = len(idx)
        packed[ci, :k, 0:3] = v0[idx]
        packed[ci, :k, 3:6] = e1[idx]
        packed[ci, :k, 6:9] = e2[idx]
        tri_id[ci * cs:ci * cs + k] = idx
        pts = tris[idx].reshape(-1, 3)
        aabb[ci, 0:3] = np.nextafter(pts.min(0).astype(np.float32), -np.inf)
        aabb[ci, 3:6] = np.nextafter(pts.max(0).astype(np.float32), np.inf)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Clusters(tri=t(packed), aabb=t(aabb), tri_id=t(tri_id), cs=cs)


# --- plain version: the kernel's arithmetic in PyTorch ----------------------

def _safe_inv(v):
    tiny = torch.where(v < 0.0, -1e-20, 1e-20)
    return 1.0 / torch.where(torch.abs(v) < 1e-20, tiny, v)


def _slot_to_index(clusters: Clusters, slot):
    n = clusters.tri_id.shape[0]
    return torch.where(slot >= 0, clusters.tri_id[slot.clamp(0, n - 1).long()],
                       -1).to(torch.int32)


def nearest_plain(clusters: Clusters, origin, direction, t_min: float = 0.0,
                  *, return_passes: bool = False):
    """The plain PyTorch version of ``nearest`` on the device the rays lie
    on -> (t (R,), index (R,) i32).  ``return_passes``: also return the
    work of the JAX kernel's cull, the number of (256-ray block, cluster)
    pairs where a ray of the block crosses the unpadded box nearer than
    its best hit so far, for speed bounds only."""
    where = torch.where
    o = origin.to(torch.float32)
    d = direction.to(torch.float32)
    dev = o.device
    r = o.shape[0]
    rays = torch.cat([o.T, d.T])                                  # (6, R)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    best_t = torch.full((r,), NO_HIT, dtype=torch.float32, device=dev)
    best_slot = torch.full((r,), -1, dtype=torch.int64, device=dev)
    aabb = clusters.aabb.to(dev)
    tri = clusters.tri.to(dev)
    cs = clusters.cs
    rows = torch.arange(cs, device=dev)[:, None]
    n_pass = 0
    for c in range(clusters.n_clusters):
        if return_passes:
            n_pass += _votes(aabb[c], o, d, best_t)
        crossed = clusters_ops.crosses_box_plain(aabb[c:c + 1], rays, t_min,
                                                 occl=False)[0]
        ray_ids = torch.nonzero(crossed)[:, 0]
        tb = tri[c]
        v0x, v0y, v0z = tb[:, 0:1], tb[:, 1:2], tb[:, 2:3]       # (CS, 1)
        e1x, e1y, e1z = tb[:, 3:4], tb[:, 4:5], tb[:, 5:6]
        e2x, e2y, e2z = tb[:, 6:7], tb[:, 7:8], tb[:, 8:9]
        for k in range(0, ray_ids.shape[0], _PLAIN_CHUNK):
            j = ray_ids[k:k + _PLAIN_CHUNK]
            rox, roy, roz = ox[j][None], oy[j][None], oz[j][None]  # (1, n)
            rdx, rdy, rdz = dx[j][None], dy[j][None], dz[j][None]
            s1x = rdy * e2z - rdz * e2y
            s1y = rdz * e2x - rdx * e2z
            s1z = rdx * e2y - rdy * e2x
            det = s1x * e1x + s1y * e1y + s1z * e1z
            okd = torch.abs(det) > _DET_EPS
            inv_det = where(okd, 1.0 / det, 0.0)
            sx, sy, sz = rox - v0x, roy - v0y, roz - v0z
            s2x = sy * e1z - sz * e1y
            s2y = sz * e1x - sx * e1z
            s2z = sx * e1y - sy * e1x
            t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv_det
            b1 = (s1x * sx + s1y * sy + s1z * sz) * inv_det
            b2 = (s2x * rdx + s2y * rdy + s2z * rdz) * inv_det
            ok = (okd & (t > t_min) & (b1 >= 0.0) & (b2 >= 0.0)
                  & (1.0 - b1 - b2 >= 0.0))
            tm = where(ok, t, NO_HIT)                             # (CS, n)
            t_c = torch.amin(tm, 0)
            # the lowest row at the minimum t
            i_c = torch.amin(where(tm == t_c[None], rows, cs), 0)
            better = t_c < best_t[j]
            best_t[j] = where(better, t_c, best_t[j])
            best_slot[j] = where(better, c * cs + i_c, best_slot[j])
    out = (best_t, _slot_to_index(clusters, best_slot))
    return out + (n_pass,) if return_passes else out


def _votes(box, o, d, best_t) -> int:
    """The (256-ray block, cluster) pairs of the JAX kernel's cull for one
    cluster box: a block passes where one of its rays crosses the
    unpadded box no farther than its best hit so far."""
    ix, iy, iz = (_safe_inv(v) for v in d.unbind(1))
    ox, oy, oz = o.unbind(1)
    bx0, by0, bz0, bx1, by1, bz1 = box[:6].unbind(0)
    tx0, tx1 = (bx0 - ox) * ix, (bx1 - ox) * ix
    ty0, ty1 = (by0 - oy) * iy, (by1 - oy) * iy
    tz0, tz1 = (bz0 - oz) * iz, (bz1 - oz) * iz
    t_in = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                       torch.minimum(ty0, ty1)),
                         torch.minimum(tz0, tz1))
    t_out = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                        torch.maximum(ty0, ty1)),
                          torch.maximum(tz0, tz1))
    live = (t_out >= 0.0) & (t_in <= t_out) & (t_in <= best_t)
    nb = -(-max(o.shape[0], 1) // BLOCK)
    votes = torch.zeros((nb * BLOCK,), dtype=torch.bool, device=o.device)
    votes[:o.shape[0]] = live
    return int(votes.view(nb, BLOCK).any(1).sum())


# --- the kernel -------------------------------------------------------------

def _nearest_kernel(clusters: Clusters, origin, direction, t_min: float):
    """Launch csrc/packet.cu on CUDA tensors -> (t (R,), index (R,) i32)."""
    o, d = origin.contiguous(), direction.contiguous()
    f32 = torch.float32
    kernels.check("packet", dict(origin=(o, f32), direction=(d, f32)))
    if o.dim() != 2 or o.shape[1] != 3 or o.shape != d.shape:
        raise ValueError(f"packet takes (R, 3) rays, not origin "
                         f"{tuple(o.shape)} and direction {tuple(d.shape)}")
    dev = o.device
    aabb, tri, tri_id = (x.to(dev).contiguous() for x in
                         (clusters.aabb, clusters.tri, clusters.tri_id))
    kernels.check("packet", dict(tri=(tri, f32), aabb=(aabb, f32),
                                 tri_id=(tri_id, torch.int32)))
    c, cs = clusters.n_clusters, clusters.cs
    if (tri.shape != (c, cs, 12) or aabb.shape != (c, 8)
            or tri_id.shape != (c * cs,)):
        raise ValueError("clusters must be tri (C, CS, 12), aabb (C, 8) and "
                         "tri_id (C*CS,)")
    r = o.shape[0]
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return t, idx
    k = clusters_ops.slices(LIB, "packet_slots", r, c, cs)
    part = tickets = None
    if k > 1:
        part = torch.empty((2 * k * r,), dtype=torch.int32, device=dev)
        tickets = kernels.tickets(-(-r // BLOCK), dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    LIB.launch("packet_nearest", aabb.data_ptr(), tri.data_ptr(),
               tri_id.data_ptr(), c, cs, o.data_ptr(), d.data_ptr(), r,
               float(t_min), k, ptr(part), ptr(tickets), t.data_ptr(),
               idx.data_ptr(), kernels.stream(o))
    return t, idx


def nearest(clusters: Clusters, origin, direction, t_min: float = 0.0):
    """Nearest triangle hit for (R, 3) rays -> (t (R,), triangle index (R,)
    i32 into the original triangle order, -1 on a miss).  For CUDA rays
    this launches csrc/packet.cu; for CPU rays it runs the plain
    version."""
    if origin.is_cuda:
        return _nearest_kernel(clusters, origin.to(torch.float32),
                               direction.to(torch.float32), t_min)
    return nearest_plain(clusters, origin, direction, t_min)
