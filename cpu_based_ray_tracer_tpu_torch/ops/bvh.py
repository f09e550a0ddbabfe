"""Bounding-volume hierarchy (port of ``cpu_based_ray_tracer_tpu.ops.bvh``):
host-side builder, leaf order on any device, and per-lane traversal.

Median split on the longest axis of the centroid AABB over per-triangle
AABBs, flattened to preorder + skip links: visiting node i on an AABB hit
continues at i + 1, on a miss at ``node_skip[i]``.  Triangles are reordered
so each leaf is a contiguous ``order[first:first + count]`` slice.  The
build is pure numpy, byte-equal to the JAX package's; the packet and fused
intersectors' clusters are its leaves.  ``leaf_order`` gives the same
``order`` alone, built level by level with tensor ops on the triangles'
device (the fused mesh engine's clusters, ``ops.fused_mesh``).

``traverse`` walks the flattened tree per lane (the ``sparse`` mesh method,
a correctness oracle): the JAX package's ``while_loop`` over ``vmap``-ed
lanes becomes a PyTorch loop that advances every active lane by one node a
step until all have left the tree.  Plain PyTorch on every device, as the
JAX package has no kernel for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.ops import vec
from cpu_based_ray_tracer_tpu_torch.ops.intersect import (NO_HIT_T,
                                                          triangle_t_matrix)


class FlatBVH(NamedTuple):
    """Flattened preorder BVH over triangles (numpy arrays)."""

    node_min: np.ndarray    # (M, 3) f32
    node_max: np.ndarray    # (M, 3) f32
    node_skip: np.ndarray   # (M,) i32 — next node when this subtree is done
    leaf_first: np.ndarray  # (M,) i32 — first triangle (reordered); -1 internal
    leaf_count: np.ndarray  # (M,) i32 — 0 for internal nodes
    order: np.ndarray       # (N,) i32 — leaf-contiguous triangle permutation
    max_leaf: int           # widest leaf

    @property
    def n_nodes(self) -> int:
        return self.node_min.shape[0]


def build_bvh(tri_vertices: np.ndarray, leaf_size: int = 4) -> FlatBVH:
    """Median-split build (split index = count / 2 on the longest axis of
    the centroid AABB) over per-triangle AABBs, flattened to preorder +
    skip links."""
    tris = np.asarray(tri_vertices, np.float64).reshape(-1, 3, 3)
    n = len(tris)
    tmin = tris.min(1)
    tmax = tris.max(1)
    centroid = 0.5 * (tmin + tmax)

    node_min, node_max, node_skip = [], [], []
    leaf_first, leaf_count = [], []
    order: list[int] = []

    def emit(idx: np.ndarray) -> None:
        me = len(node_min)
        node_min.append(tmin[idx].min(0))
        node_max.append(tmax[idx].max(0))
        node_skip.append(-1)   # patched after the children are emitted
        if len(idx) <= leaf_size:
            leaf_first.append(len(order))
            leaf_count.append(len(idx))
            order.extend(int(i) for i in idx)
        else:
            leaf_first.append(-1)
            leaf_count.append(0)
            c = centroid[idx]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            split = np.argsort(c[:, axis], kind="stable")
            half = len(idx) // 2
            emit(idx[split[:half]])
            emit(idx[split[half:]])
        node_skip[me] = len(node_min)

    emit(np.arange(n))
    return FlatBVH(
        node_min=np.asarray(node_min).astype(np.float32),
        node_max=np.asarray(node_max).astype(np.float32),
        node_skip=np.asarray(node_skip, np.int32),
        leaf_first=np.asarray(leaf_first, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        order=np.asarray(order, np.int32),
        max_leaf=leaf_size,
    )


def split_levels(n: int, leaf_size: int) -> list:
    """The segments that ``build_bvh`` splits, level by level: a list of
    (starts, lengths) int64 arrays.  The split is always at ``len // 2``,
    so the tree's shape depends on ``n`` and ``leaf_size`` alone."""
    starts, lens = np.zeros(1, np.int64), np.array([n], np.int64)
    levels = []
    while True:
        split = lens > leaf_size
        starts, lens = starts[split], lens[split]
        if not len(lens):
            return levels
        levels.append((starts, lens))
        half = lens // 2
        starts = np.stack([starts, starts + half], 1).reshape(-1)
        lens = np.stack([half, lens - half], 1).reshape(-1)


def leaf_order(tri_vertices, leaf_size: int = 4, on_level=None
               ) -> torch.Tensor:
    """``build_bvh(tri_vertices, leaf_size).order`` (int64) built level by
    level on the triangles' device (numpy input: the CPU), with no read of
    the device.  Each level takes its splitting segments as rows padded
    to the longest: the float64 centroid bounds per row, the first axis
    of greatest extent (``np.argmax``), and one stable sort of each row's
    keys on that axis (``np.argsort(kind="stable")``: equal keys, -0.0
    and 0.0 among them, keep their order).  The leaves, left to right,
    are ``build_bvh``'s preorder.  ``on_level`` is called once a level."""
    tris = torch.as_tensor(tri_vertices).to(torch.float64).reshape(-1, 3, 3)
    n, dev = tris.shape[0], tris.device
    centroid = 0.5 * (tris.amin(1) + tris.amax(1))
    # Slot n, in perm and in the centroids, takes the rows' padding.
    centroid = torch.cat([centroid, centroid.new_zeros((1, 3))])
    perm = torch.arange(n + 1, device=dev)
    levels = split_levels(n, leaf_size)
    if levels:
        table = torch.as_tensor(np.concatenate(
            [np.concatenate(lv) for lv in levels])).to(dev)
    inf = float("inf")
    at = 0
    for starts, lens in levels:
        k, w = len(lens), int(lens.max())
        start, length = table[at:at + k, None], table[at + k:at + 2 * k, None]
        at += 2 * k
        j = torch.arange(w, device=dev)
        valid = j < length
        pos = torch.where(valid, start + j, n)
        elem = perm[pos]
        c = centroid[elem]                                      # (k, w, 3)
        lo = torch.where(valid[..., None], c, inf).amin(1)
        hi = torch.where(valid[..., None], c, -inf).amax(1)
        ext = hi - lo
        axis = (ext[:, 1] > ext[:, 0]).long()
        axis = torch.where(ext[:, 2] > ext.gather(1, axis[:, None])[:, 0],
                           2, axis)
        key = c.gather(2, axis[:, None, None].expand(k, w, 1))[..., 0]
        _, srt = torch.sort(torch.where(valid, key, inf), dim=1, stable=True)
        perm[pos] = elem.gather(1, srt)
        if on_level is not None:
            on_level()
    return perm[:n]


def slab_test(o, inv_d, bmin, bmax, t_best):
    """AABB slab test with reciprocal directions, rows of (R, 3): hit iff
    t_out >= 0, t_in <= t_out and t_in <= t_best (the nearer-than-best
    cull)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_in = torch.amax(torch.minimum(t0, t1), -1)
    t_out = torch.amin(torch.maximum(t0, t1), -1)
    return (t_out >= 0.0) & (t_in <= t_out) & (t_in <= t_best)


def _mt_scalar(o, d, v0, e1, e2):
    """Moller-Trumbore for one (ray, triangle) pair a row, all (R, 3):
    (t, b1, b2), t = NO_HIT_T for a degenerate triangle."""
    s1 = vec.cross(d, e2)
    det = vec.dot(s1, e1)[:, 0]
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    s = o - v0
    s2 = vec.cross(s, e1)
    t = vec.dot(s2, e2)[:, 0] * inv_det
    b1 = vec.dot(s1, s)[:, 0] * inv_det
    b2 = vec.dot(s2, d)[:, 0] * inv_det
    return torch.where(ok, t, NO_HIT_T), b1, b2


def traverse(bvh: FlatBVH, v0, e1, e2, origin, direction, t_min: float):
    """Nearest-hit traversal for (R, 3) rays on their device.  v0/e1/e2:
    the triangles already permuted by ``bvh.order``.  Returns (t (R,),
    triangle index (R,) i32 into the original order, -1 on a miss)."""
    dev = origin.device
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    node_min, node_max = as_t(bvh.node_min), as_t(bvh.node_max)
    skip = as_t(bvh.node_skip).long()
    first, count = as_t(bvh.leaf_first).long(), as_t(bvh.leaf_count).long()
    order = as_t(bvh.order)
    r = origin.shape[0]
    tiny = torch.where(direction < 0, -1e-20, 1e-20)
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-20, tiny, direction)
    best_t = torch.full((r,), NO_HIT_T, dtype=torch.float32, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros((r,), dtype=torch.int64, device=dev)
    lanes = torch.arange(r, device=dev)
    while lanes.numel():
        i = node[lanes]
        o, d = origin[lanes], direction[lanes]
        bt, bi = best_t[lanes], best_i[lanes]
        hit_box = slab_test(o, inv_d[lanes], node_min[i], node_max[i], bt)
        leaf = hit_box & (count[i] > 0)
        if bool(leaf.any()):
            for k in range(bvh.max_leaf):
                valid = leaf & (k < count[i])
                tj = torch.where(valid, first[i] + k, 0)
                t, b1, b2 = _mt_scalar(o, d, v0[tj], e1[tj], e2[tj])
                ok = (valid & (t > t_min) & (b1 >= 0.0)
                      & (b2 >= 0.0) & (1.0 - b1 - b2 >= 0.0) & (t < bt))
                bt = torch.where(ok, t, bt)
                bi = torch.where(ok, order[tj], bi)
            best_t[lanes], best_i[lanes] = bt, bi
        nxt = torch.where(hit_box & (count[i] == 0), i + 1, skip[i])
        node[lanes] = nxt
        lanes = lanes[nxt < bvh.n_nodes]
    return best_t, best_i


def nearest_triangle_bruteforce(v0, e1, e2, origin, direction, t_min: float):
    """The traversal tests' oracle: the exact all-triangles scan -> (t,
    index i32, -1 on a miss)."""
    tmat = triangle_t_matrix(origin, direction, v0, e1, e2, t_min,
                             float("inf"))
    t, idx = torch.min(tmat, -1)
    return t, torch.where(t < NO_HIT_T, idx, -1).to(torch.int32)
