"""Bounding-volume hierarchy builder (port of
``cpu_based_ray_tracer_tpu.ops.bvh``, the host-side part).

Median split on the longest axis of the centroid AABB over per-triangle
AABBs, flattened to preorder + skip links: visiting node i on an AABB hit
continues at i + 1, on a miss at ``node_skip[i]``.  Triangles are reordered
so each leaf is a contiguous ``order[first:first + count]`` slice.  Pure
numpy, byte-equal to the JAX package's build; the packet intersector's
clusters are its leaves.  The per-lane traversal (``traverse``, the
``sparse`` oracle) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
