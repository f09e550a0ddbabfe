"""Shortlist-driven mesh intersection for coherent ray sets (port of
``cpu_based_ray_tracer_tpu.ops.coherent``).

Whitted primaries and point-light shadow rays are coherent: a compact
block of pixels crosses only a handful of the mesh's clusters.  So the work
list is computed exactly, per tile, ahead of the sweep:

  mask pass   per-lane cluster-AABB crossing bitmasks (u32 words, bit c % 32
              of word c / 32), each word ORed into its tile's word; on the
              card a ray tests the clusters of the 4-cluster groups and
              32-cluster words whose boxes it crosses (``level_boxes``);
  lists       per tile the crossed clusters in ascending order, then the
              others (ids), and their number (cnts); on the card the mask
              kernel writes them;
  sweep       each tile runs Moller-Trumbore over only its listed clusters
              -> nearest (t, triangle index); on the card a ray tests only
              the rows of the 8-row groups whose padded boxes it crosses,
              in the listed clusters whose padded boxes it crosses, and
              each tile's list is cut into slices (the split sweeps' work
              items), which leave every bit of the result as it is.

Tiles are 32 x 128 pixel rectangles when the caller passes the image shape
(``hw``) and the rays are the whole image; otherwise row-major strips of
4,096 rays.  Per-ray results do not depend on the tiling; the lists do,
and both versions use the JAX package's tiles.

- ``csrc/coherent.cu`` holds the mask and the sweep kernels (CUDA C++ for
  sm_90a, loaded with ``ctypes``); ``_shortlists`` and ``sweep`` launch
  them for CUDA tensors.
- ``mask_plain`` and ``sweep_plain`` are the same arithmetic in PyTorch,
  with the same inputs and outputs; the entry points run them only for CPU
  tensors.  ``_lists``, the tile words made into lists in PyTorch (XLA in
  the JAX package), is the plain version of the lists the mask kernel
  writes.

Mask words are stored as int32 tensors holding the u32 bit patterns.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from cpu_based_ray_tracer_tpu_torch.ops import clusters, intersect
from cpu_based_ray_tracer_tpu_torch.ops.clusters import (
    MESH_NF, SPLIT_MAX, build_smem_clusters, crosses_box_plain,
    split_sweep_plain)
from cpu_based_ray_tracer_tpu_torch.utils import kernels
from cpu_based_ray_tracer_tpu_torch.utils import profiling

SUB = 32                 # tile rows
TILE_W = 128             # tile columns
TILE = SUB * TILE_W      # lanes per tile
_WORD = 32               # clusters per mask word
MASK_GROUP = 4           # clusters a group box of the mask pass covers
LEVEL_ROWS = 1 + _WORD // MASK_GROUP   # a word's box, then its groups'
GROUP_ROWS = 8           # rows of a cluster a sub-box covers (csrc/coherent.cu)
MAX_CLUSTER_SIZE = 256   # rows the sweep kernel's block stages (SWEEP_BLOCK)

# Launches of csrc/coherent.cu since the last reset.
LAUNCHES = profiling.Counter("coherent", ("mask", "sweep"))

_P = ctypes.c_void_p
LIB = kernels.Library("coherent", {
    # (aabb, levels, n_cl, rays, n_planes, hp, wp, t_min, cnt, masks,
    #  words, part, tickets, ids, cnts, stream)
    "coherent_mask": [_P, _P, ctypes.c_int, _P] + [ctypes.c_int] * 3
    + [ctypes.c_float] + [_P] * 8,
    # (cs, out)
    "coherent_sweep_slots": [ctypes.c_int, _P],
    # (tri, aabb, n_cl, cs, rays, hp, wp, ids, cnts, t_min, K, part,
    #  tickets, out, stream)
    "coherent_sweep": [_P, _P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                       ctypes.c_int, _P, _P, ctypes.c_float, ctypes.c_int,
                       _P, _P, _P, _P],
}, LAUNCHES)


@dataclasses.dataclass(frozen=True)
class CoherentPack:
    """Cluster table + AABBs for the shortlist intersector."""

    tri: torch.Tensor    # (C, CS, MESH_NF) f32 rows (triangle index in slot 13)
    aabb: torch.Tensor   # (C, 8) f32
    cs: int
    n_tri: int

    @property
    def n_clusters(self) -> int:
        return self.aabb.shape[0]

    @functools.cached_property
    def boxes(self) -> torch.Tensor:
        """The mask pass's word and group boxes (``level_boxes``), made
        once a pack."""
        return level_boxes(self.aabb)

    def to(self, device) -> "CoherentPack":
        return dataclasses.replace(self, tri=self.tri.to(device),
                                   aabb=self.aabb.to(device))


def pack_coherent(scene, cluster_size: int = 128) -> CoherentPack:
    """Cluster the scene's full triangle set (BVH preorder, full clusters)
    for the shortlist kernels, on the scene's device.  Byte-equal to the
    JAX package's pack.  ``cluster_size`` is a multiple of ``GROUP_ROWS``
    up to ``MAX_CLUSTER_SIZE`` (the sweep kernel gives a staged cluster's
    rows one thread each), on every device, so that a pack made on the
    CPU also runs on the card."""
    if cluster_size % GROUP_ROWS or not 0 < cluster_size <= MAX_CLUSTER_SIZE:
        raise ValueError(f"cluster_size must be a multiple of {GROUP_ROWS} "
                         f"up to {MAX_CLUSTER_SIZE}, not {cluster_size}")
    tr = scene.triangles
    v0, e1, e2 = (x.detach().to(torch.float64) for x in (tr.v0, tr.e1, tr.e2))
    smc = build_smem_clusters(torch.stack([v0, v0 + e1, v0 + e2], 1),
                              tr.normal.detach().to(torch.float32),
                              tr.material.to(torch.float32),
                              cluster_size=cluster_size)
    return CoherentPack(tri=smc.tri, aabb=smc.aabb, cs=smc.cs,
                        n_tri=int(tr.count))


# --- ray planes and tiles -----------------------------------------------------

def _to_planes(origin, direction, hw: Optional[tuple]):
    """(R, 3) x2 -> (6, Hp, Wp) padded planes + the (h, w, r) to recover.
    With ``hw`` and a full-image ray set the tiles are 32 x 128 pixel
    rectangles; otherwise row-major 4,096-lane strips.  Padded lanes get
    origin 0 and direction (1, 1, 1)."""
    r = origin.shape[0]
    if hw is not None and hw[0] * hw[1] == r:
        h, w = hw
    else:
        w = TILE_W
        h = -(-r // w)
    hp = -(-h // SUB) * SUB
    wp = -(-w // TILE_W) * TILE_W
    rays = torch.cat([origin.T, direction.T], 0).to(torch.float32)
    if (hp, wp) == (h, w) and h * w == r:
        return rays.reshape(6, h, w).contiguous(), (h, w, r)
    out = torch.zeros((6, hp * wp), dtype=torch.float32, device=origin.device)
    out[3:6] = 1.0
    out = out.view(6, hp, wp)
    flat = torch.zeros((6, h * w), dtype=torch.float32, device=origin.device)
    flat[3:6] = 1.0
    flat[:, :r] = rays
    out[:, :h, :w] = flat.view(6, h, w)
    return out, (h, w, r)


def _from_planes(out, shape):
    h, w, r = shape
    return out[:, :h, :w].reshape(out.shape[0], h * w)[:, :r]


def _tile_major(x):
    """(P, Hp, Wp) planes -> (P, T, 4096): the lanes of each tile."""
    p, hp, wp = x.shape
    return (x.reshape(p, hp // SUB, SUB, wp // TILE_W, TILE_W)
            .permute(0, 1, 3, 2, 4).reshape(p, -1, TILE))


def _plane_major(x, hp: int, wp: int):
    """The inverse of ``_tile_major``."""
    p = x.shape[0]
    return (x.reshape(p, hp // SUB, wp // TILE_W, SUB, TILE_W)
            .permute(0, 1, 3, 2, 4).reshape(p, hp, wp))


def _check_planes(rays):
    p, hp, wp = rays.shape
    if p not in (6, 7) or hp % SUB or wp % TILE_W:
        raise ValueError(f"rays must be (6 or 7, Hp, Wp) planes with Hp a "
                         f"multiple of {SUB} and Wp of {TILE_W}, not "
                         f"{tuple(rays.shape)}")


def _wrap_u32(x):
    """int64 values in [0, 2^32) -> int32 holding the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# --- mask pass ----------------------------------------------------------------

def level_boxes(aabb):
    """The boxes the mask kernel culls by: for each word of 32 clusters of
    aabb (C, 8), the least and greatest coordinates of its clusters' boxes
    (row 0), then those of each group of MASK_GROUP of them (rows 1 to
    LEVEL_ROWS - 1) -> (ceil(C / 32), LEVEL_ROWS, 8) f32 min xyz, max xyz,
    pad.  A box holds its members' boxes exactly (min and max round
    nothing), so a ray whose segment crosses a member crosses it.  A member
    whose sides are not ordered (or NaN) gives its group and word the
    whole space; a group past the last cluster is empty (never tested)."""
    c = aabb.shape[0]
    b32 = -(-c // _WORD)
    ng = b32 * (_WORD // MASK_GROUP)
    inf = float("inf")
    lo = torch.full((b32 * _WORD, 3), inf, device=aabb.device)
    hi = torch.full_like(lo, -inf)
    lo[:c], hi[:c] = aabb[:, 0:3], aabb[:, 3:6]
    whole = torch.zeros((b32 * _WORD,), dtype=torch.bool, device=aabb.device)
    whole[:c] = ~(aabb[:, 0:3] <= aabb[:, 3:6]).all(1)
    lo[whole], hi[whole] = -inf, inf
    box = torch.zeros((b32, LEVEL_ROWS, 8), dtype=torch.float32,
                      device=aabb.device)
    box[:, 0, 0:3] = lo.view(b32, _WORD, 3).amin(1)
    box[:, 0, 3:6] = hi.view(b32, _WORD, 3).amax(1)
    box[:, 1:, 0:3] = lo.view(ng, MASK_GROUP, 3).amin(1).view(b32, -1, 3)
    box[:, 1:, 3:6] = hi.view(ng, MASK_GROUP, 3).amax(1).view(b32, -1, 3)
    return box


def mask_plain(aabb, rays, t_min: float, cnt=None, planes: bool = True,
               boxes=None):
    """The mask pass in PyTorch.  aabb (C, 8); rays (6 or 7, Hp, Wp) [o d]
    or [o d lim]; ``cnt`` (1,) i32 or None: only the first cnt lanes in
    row-major order are rays (the others get 0 words).  Returns masks
    (ceil(C / 32), Hp, Wp), or None when not ``planes`` (the lists need
    only the tile words), and the ORed tile words (T, ceil(C / 32)), both
    int32 holding u32 bits.  With ``boxes`` (``level_boxes``), a lane
    tests a cluster only where it crosses the boxes of the cluster's word
    and group, as the kernel does; that changes no bit."""
    _check_planes(rays)
    p, hp, wp = rays.shape
    dev = rays.device
    n_cl = aabb.shape[0]
    b32 = -(-n_cl // _WORD)
    ox, oy, oz = rays[0], rays[1], rays[2]

    def sinv(v):
        tiny = torch.where(v < 0.0, -1e-20, 1e-20)
        return 1.0 / torch.where(torch.abs(v) < 1e-20, tiny, v)

    ivx, ivy, ivz = sinv(rays[3]), sinv(rays[4]), sinv(rays[5])
    t_lo = min(float(t_min), 0.0)
    hi_bound = rays[6] * 1.000001 + 1e-5 if p == 7 else None

    def crossed_by(box):                                     # (k, >= 6)
        bx0, by0, bz0, bx1, by1, bz1 = (box[:, j, None, None].to(dev)
                                        for j in range(6))   # (k, 1, 1)
        tx0, tx1 = (bx0 - ox) * ivx, (bx1 - ox) * ivx
        ty0, ty1 = (by0 - oy) * ivy, (by1 - oy) * ivy
        tz0, tz1 = (bz0 - oz) * ivz, (bz1 - oz) * ivz
        t_in = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                           torch.minimum(ty0, ty1)),
                             torch.minimum(tz0, tz1))
        t_out = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                            torch.maximum(ty0, ty1)),
                              torch.maximum(tz0, tz1))
        crossed = (t_out >= t_lo) & (t_in <= t_out)          # (k, Hp, Wp)
        if hi_bound is not None:
            crossed &= t_in <= hi_bound
        return crossed

    active = None
    if cnt is not None:
        lanes = torch.arange(hp * wp, device=dev).view(hp, wp)
        active = lanes < int(cnt.reshape(-1)[0])
    masks = (torch.zeros((b32, hp, wp), dtype=torch.int32, device=dev)
             if planes else None)
    words = torch.zeros((hp // SUB * (wp // TILE_W), b32), dtype=torch.int64,
                        device=dev)
    for w in range(b32):
        box = aabb[w * _WORD:(w + 1) * _WORD, :6]
        k = box.shape[0]
        crossed = crossed_by(box)
        if boxes is not None:
            ng = -(-k // MASK_GROUP)
            tested = crossed_by(boxes[w, 1:1 + ng]) & crossed_by(boxes[w, 0:1])
            crossed &= tested.repeat_interleave(MASK_GROUP, 0)[:k]
        if active is not None:
            crossed &= active
        bit = (1 << torch.arange(k, dtype=torch.int64,
                                 device=dev))[:, None, None]
        if planes:
            masks[w] = _wrap_u32((crossed.to(torch.int64) * bit).sum(0))
        tile_bits = _tile_major(crossed).any(2)               # (k, T)
        words[:, w] = (tile_bits.to(torch.int64) * bit[:, :, 0]).sum(0)
    return masks, _wrap_u32(words)


def _mask_kernel(aabb, rays, t_min: float, cnt=None, planes: bool = True,
                 boxes=None, lists: bool = False):
    """Launch the mask kernel of csrc/coherent.cu on CUDA tensors; as
    ``mask_plain``.  ``boxes``: the pack's ``level_boxes`` (made here when
    not given).  With ``lists`` the same launch also writes the shortlists:
    returns (masks, tile words, ids, cnts), the last two as ``_lists``
    makes them."""
    _check_planes(rays)
    if boxes is None:
        boxes = level_boxes(aabb)
    f32 = torch.float32
    tensors = dict(aabb=(aabb, f32), boxes=(boxes, f32), rays=(rays, f32))
    if cnt is not None:
        tensors["cnt"] = (cnt, torch.int32)
    kernels.check("coherent_mask", tensors)
    p, hp, wp = rays.shape
    n_cl = aabb.shape[0]
    b32 = -(-n_cl // _WORD)
    if (aabb.dim() != 2 or aabb.shape[1] != 8
            or boxes.shape != (b32, LEVEL_ROWS, 8)
            or aabb.data_ptr() % 16 or boxes.data_ptr() % 16
            or (cnt is not None and cnt.numel() != 1)):
        raise ValueError("the mask kernel takes aabb (C, 8) and its level "
                         "boxes, 16-byte aligned, and cnt (1,)")
    dev = rays.device
    n_tiles = hp // SUB * (wp // TILE_W)
    i32 = dict(dtype=torch.int32, device=dev)
    masks = torch.empty((b32, hp, wp), **i32) if planes else None
    words = torch.empty((n_tiles, b32), **i32)
    part = torch.empty((hp * wp // 32 * b32,), **i32)
    ids = torch.empty((n_tiles * n_cl,), **i32) if lists else None
    cnts = torch.empty((n_tiles,), **i32) if lists else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    LIB.launch(
        "coherent_mask", aabb.data_ptr(), boxes.data_ptr(), n_cl,
        rays.data_ptr(), p, hp, wp, float(t_min), ptr(cnt), ptr(masks),
        words.data_ptr(), part.data_ptr(),
        kernels.tickets(n_tiles, dev).data_ptr(), ptr(ids), ptr(cnts),
        kernels.stream(rays), key="mask")
    return (masks, words, ids, cnts) if lists else (masks, words)


def _lists(words, n_cl: int):
    """Tile words (T, ceil(C / 32)) -> (ids (T * C,) i32: per tile the set
    bits in ascending cluster order, then the unset ones; cnts (T,) i32).
    The plain version of the lists the mask kernel writes."""
    c = torch.arange(n_cl, device=words.device)
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    bset = ((w64[:, c // _WORD] >> (c % _WORD)) & 1).T        # (C, T)
    cnts = bset.sum(0).to(torch.int32)
    ids = torch.argsort((1 - bset).to(torch.int32), dim=0, stable=True)
    return ids.T.to(torch.int32).reshape(-1).contiguous(), cnts


def _shortlists(aabb, rays, t_min: float, cnt=None, boxes=None):
    """(T * C,) shortlist ids + (T,) counts for a (6 or 7, Hp, Wp) ray-plane
    set (7: with a lim plane): one mask kernel launch for CUDA rays (with
    the pack's ``boxes``), the plain mask pass and ``_lists`` for CPU
    rays."""
    if rays.is_cuda:
        return _mask_kernel(aabb, rays, t_min, cnt, planes=False,
                            boxes=boxes, lists=True)[2:]
    return _lists(mask_plain(aabb, rays, t_min, cnt, planes=False)[1],
                  aabb.shape[0])


# --- shortlist sweep ----------------------------------------------------------

def group_boxes_plain(tri):
    """The sub-boxes the sweep kernel culls by inside a cluster: for each
    run of GROUP_ROWS consecutive rows of tri (C, CS, MESH_NF), the least
    and greatest coordinates of its rows' corners v0, v0 + e1, v0 + e2
    (float32 sums, as the kernel forms them from the staged rows) -> (C,
    ceil(CS / GROUP_ROWS), 8) f32 min xyz, max xyz, pad.  Each holds its
    rows' triangles as Moller-Trumbore sees them, to within a rounding of
    the sums, which the padded box test absorbs."""
    c, cs = tri.shape[0], tri.shape[1]
    ng = -(-cs // GROUP_ROWS)
    v0 = tri[..., 0:3]
    corners = torch.stack([v0, v0 + tri[..., 3:6], v0 + tri[..., 6:9]], 2)
    lo = torch.full((c, ng * GROUP_ROWS, 3), float("inf"), device=tri.device)
    hi = torch.full_like(lo, float("-inf"))
    lo[:, :cs], hi[:, :cs] = corners.amin(2), corners.amax(2)
    box = torch.zeros((c, ng, 8), dtype=torch.float32, device=tri.device)
    box[..., 0:3] = lo.view(c, ng, GROUP_ROWS, 3).amin(2)
    box[..., 3:6] = hi.view(c, ng, GROUP_ROWS, 3).amax(2)
    return box


def _kernel_cull(tri, aabb, t_min: float):
    """The sweep kernel's cull for ``list_sweep_plain``: a ray tests a row
    when it crosses the padded box of the row's cluster and that of the
    row's group (``crosses_box_plain``, the kernel's ``crosses_box``)."""
    gb = group_boxes_plain(tri)
    ng, cs = gb.shape[1], tri.shape[1]

    def cull(cid, rays):                                      # (6, A, lc)
        a, lc = rays.shape[1], rays.shape[2]
        c_cross = crosses_box_plain(aabb[cid], rays, t_min, occl=False)
        g_rays = rays[:, :, None].expand(6, a, ng, lc).reshape(6, a * ng, lc)
        g_cross = crosses_box_plain(gb[cid].reshape(a * ng, 8), g_rays,
                                    t_min, occl=False).view(a, ng, lc)
        return (c_cross[:, None] & g_cross).repeat_interleave(
            GROUP_ROWS, 1)[:, :cs]                            # (A, CS, lc)
    return cull


def sweep_plain(tri, rays, ids, cnts, t_min: float, k: int = 1, aabb=None):
    """The shortlist sweep in PyTorch: rays (6, Hp, Wp); the table tri (C,
    CS, MESH_NF); per tile ids[tile * C + j] for j < cnts[tile].  Returns
    (2, Hp, Wp): the nearest t (NO_HIT on a miss) and the triangle index of
    slot 13 (-1.0), as floats.  ``k``: each tile's list cut into k slices
    and combined in slice order, as the kernel's work items; with the
    cluster boxes ``aabb`` (C, 8), each ray tests only the rows whose
    cluster's and group's padded boxes it crosses, as the kernel does.
    Neither changes a bit of the result."""
    _check_planes(rays)
    _, hp, wp = rays.shape
    n_cl = tri.shape[0]
    best_t, slot, _ = split_sweep_plain(
        tri, _tile_major(rays), ids.view(-1, n_cl), cnts, t_min, k,
        occl=False, cull=None if aabb is None else _kernel_cull(tri, aabb,
                                                                t_min))
    idx = tri.reshape(-1, MESH_NF)[slot.clamp(min=0), 13]
    idx = torch.where(slot >= 0, idx, -1.0)
    return _plane_major(torch.stack([best_t, idx]), hp, wp)


def _sweep_kernel(tri, aabb, rays, ids, cnts, t_min: float,
                  k: Optional[int] = None):
    """Launch the sweep kernel of csrc/coherent.cu on CUDA tensors; as
    ``sweep_plain``.  ``k``: the list slices (default
    ``clusters.slices``'s)."""
    _check_planes(rays)
    f32, i32 = torch.float32, torch.int32
    kernels.check("coherent_sweep", dict(
        tri=(tri, f32), aabb=(aabb, f32), rays=(rays, f32), ids=(ids, i32),
        cnts=(cnts, i32)))
    p, hp, wp = rays.shape
    n_cl, cs = tri.shape[0], tri.shape[1]
    n_tiles = hp // SUB * (wp // TILE_W)
    if (p != 6 or tri.shape[2:] != (MESH_NF,)
            or cs % GROUP_ROWS or cs > MAX_CLUSTER_SIZE
            or aabb.shape != (n_cl, 8)
            or ids.numel() != n_tiles * n_cl or cnts.numel() != n_tiles):
        raise ValueError("the sweep kernel takes rays (6, Hp, Wp), tri "
                         "(C, CS, 16) with CS a multiple of 8 up to 256, "
                         "aabb (C, 8), ids (T * C,) and cnts (T,)")
    n_lanes = hp * wp
    k = (clusters.slices(LIB, "coherent_sweep_slots", n_lanes, n_cl, cs)
         if k is None else int(k))
    if not 1 <= k <= min(SPLIT_MAX, n_cl):
        raise ValueError(f"k must be in [1, {min(SPLIT_MAX, n_cl)}], not {k}")
    dev = rays.device
    out = torch.empty((2, hp, wp), dtype=torch.float32, device=dev)
    part = tickets = None
    if k > 1:
        part = torch.empty((2 * k * n_lanes,), dtype=torch.int32, device=dev)
        tickets = kernels.tickets(n_lanes // 256, dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    LIB.launch(
        "coherent_sweep", tri.data_ptr(), aabb.data_ptr(), n_cl, cs,
        rays.data_ptr(), hp, wp, ids.data_ptr(), cnts.data_ptr(),
        float(t_min), k, ptr(part), ptr(tickets), out.data_ptr(),
        kernels.stream(rays), key="sweep")
    return out


def sweep(tri, aabb, rays, ids, cnts, t_min: float):
    """The shortlist sweep: the kernel for CUDA rays, the plain version for
    CPU rays."""
    if rays.is_cuda:
        return _sweep_kernel(tri, aabb, rays, ids, cnts, t_min)
    return sweep_plain(tri, rays, ids, cnts, t_min)


def nearest(pack: CoherentPack, origin, direction, t_min: float,
            hw: Optional[tuple] = None):
    """Nearest (t, triangle index i32) per ray for a coherent (R, 3) ray
    set; misses (NO_HIT_T, -1).  ``hw=(h, w)``: the rays are a row-major
    h x w image, tiled over 32 x 128 pixel rectangles."""
    rays, shape = _to_planes(origin, direction, hw)
    ids, cnts = _shortlists(pack.aabb, rays, t_min, boxes=pack.boxes)
    out = _from_planes(sweep(pack.tri, pack.aabb, rays, ids, cnts, t_min),
                       shape)
    tt = torch.where(out[0] < intersect.NO_HIT_T, out[0], intersect.NO_HIT_T)
    return tt, out[1].to(torch.int32)

