"""Fused wavefront Monte Carlo over clustered meshes (port of
``cpu_based_ray_tracer_tpu.ops.fused_mesh``).

The reference's MC stage sends every path and shadow ray through a BVH.
This engine keeps lanes in pixel order and compacts the work instead of
walking a tree per lane.  One bounce step is five launches:

  K1       smalls intersect (room walls, boxes, spheres: every primitive
           that is not gated into the mesh) -> per-lane best (t, n,
           material id); mesh predicate (does the segment cross a cluster
           AABB before the smalls winner?); stable pack of the crossing
           lanes' (o, d, lane id).
  nearest  sweep of the clusters over the packed rays -> nearest mesh
           (t, n, material id), written back to full planes by lane id;
           resident, the rays are first grouped by the cluster boxes
           they cross (``group_plain``), so that a warp's rays cross the
           same boxes.
  K1b      merge (the smalls win ties) + facing normal + shading point +
           NEE light sample + zero-weight pruning + shadow predicate +
           stable pack of the shadow rays (p, w_l, lim, lane id).
  occl     the same sweep, any-hit occlusion with the division-free accept
           -> per-lane mesh-occlusion flag.
  K2       sky/emissive accumulation, NEE with the smalls shadow test OR'd
           with the mesh flag, RR + hemisphere scatter, regeneration: the
           step of ``ops.fused`` without its intersection.

Lane for lane the semantics of ``models.monte_carlo.wavefront_steps``
through the packet intersector, and of the JAX package's Pallas engine.

Two sweep modes, as in the JAX package.  Resident (the table within
``SMEM_RESIDENT_BUDGET``): every 4,096-ray tile of the packed buffer sweeps
every cluster.  Shortlist streaming (``resident=False``, the default past
the budget): before each sweep the mask pass of ``ops.coherent`` gives
every tile the exact list of clusters its rays cross (main rays: the
unbounded line; shadow rays: up to lim), and each tile sweeps only those,
with the same triangle loops and so the same results.

- ``csrc/fused_mesh.cu`` holds the kernel bodies (K1, the templated sweep
  with or without lists, K1b, K2), CUDA C++ for sm_90a loaded with
  ``ctypes``; ``csrc/coherent.cu`` the mask pass.
  ``wavefront_steps_fused_mesh`` launches them for CUDA tensors.  The
  sweep cuts each ray block's cluster list into slices swept by blocks of
  their own (the packed rays alone are too few blocks to fill the card)
  and combines them in list order; a warp skips every cluster whose box
  (padded: ``clusters.crosses_box_plain``) none of its rays crosses.
- ``_k1_plain``, ``_sweep_plain``, ``_k1b_plain`` and ``_k2_plain`` (and
  ``coherent.mask_plain``) are the same arithmetic in PyTorch, with the
  same inputs and outputs as the kernels;
  ``wavefront_steps_fused_mesh_plain`` steps with them on any device.  The
  entry points run them only for CPU tensors.  The cluster table, the
  split rule and the plain list sweeps live in ``ops.clusters``.

Capacity: the packed buffers have a fixed size per call.  A step whose
predicate population exceeds one reports overflow (``render_turbo_mesh``
and ``render_turbo_mesh_exact`` double the caps and rerun the chunk, so a
result is never silently wrong).  The cluster table stays in device
memory in both modes, so any mesh size runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import coherent
from cpu_based_ray_tracer_tpu_torch.ops.clusters import (
    MESH_NF, PACK, SPLIT_MAX, SWEEP_BLOCK, build_smem_clusters,
    crosses_box_plain, list_sweep_plain)
from cpu_based_ray_tracer_tpu_torch.ops.fused import (
    NO_HIT, _DET_EPS, _camera_words, _light_sample, _norm3, _shade_advance,
    lanes, planes_state, state_planes)
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils import kernels
from cpu_based_ray_tracer_tpu_torch.utils import profiling

LANES_PER_TILE = 4096   # the caps are whole multiples of this many lanes
PACK_BLOCK = 256        # lanes per K1/K1b block: one offsets-table row each
# The JAX package's SMEM budget for the cluster table: past it the sweeps
# default to the shortlist-streaming mode.
SMEM_RESIDENT_BUDGET = 736 * 1024

# Launches of csrc/fused_mesh.cu since the last reset, by entry point;
# "nearest_sl" and "occl_sl" are the shortlist sweeps.
LAUNCHES = profiling.Counter(
    "fused_mesh", ("k1", "group", "nearest", "k1b", "group_occl", "occl",
                   "k2", "nearest_sl", "occl_sl"))
# Bits of the key by which the resident sweeps' rays are grouped: cluster c
# sets bit c % GROUP_BITS (csrc/fused_mesh.cu GROUP_BITS).
GROUP_BITS = 12

# One record per chunk of the last render_turbo_mesh(_exact) call: the
# steps, the caps, the overflow, the predicate populations and the sweep
# mode (``resident``: the grouped resident sweeps, else the shortlists).
TRACE: list = []


@dataclasses.dataclass(frozen=True)
class MeshPack:
    """Kernel-ready split of a mesh scene: unrolled smalls + clustered
    mesh, built by ``pack_mesh_scene``.  The ``light``/``sky`` rows equal
    ``ops.fused.pack_scene``'s, so the NEE CDF is the plain engine's."""

    stri: torch.Tensor      # (max(Ns,1), 16) f32 smalls: v0 e1 e2 n mid pad
    ssph: torch.Tensor      # (max(S,1), 8) f32 spheres: center radius mid pad
    mat: torch.Tensor       # (K, 8) f32 materials: albedo emission emissive pad
    light: torch.Tensor     # (Le, 16) f32 emissive tris: v0 e1 e2 n emission cdf
    sky: torch.Tensor       # (8,) f32: sky_bottom sky_top light_total pad
    smc_tri: torch.Tensor   # (C, CS, MESH_NF) f32 cluster table
    smc_aabb: torch.Tensor  # (C, 8) f32 cluster AABBs
    smc_box_aabb: torch.Tensor  # (B, 8) f32 spatial box AABBs
    boxes: tuple            # ((c_start, c_end), ...) cluster ranges
    cs: int                 # triangles per cluster
    gate_lo: tuple          # union AABB of the gated triangles
    gate_hi: tuple
    n_stri: int
    n_sph: int
    n_light: int
    n_mat: int
    gate_mask: np.ndarray   # (N,) bool over the scene's triangles

    @property
    def n_clusters(self) -> int:
        return self.smc_aabb.shape[0]

    @property
    def pred_aabb(self) -> torch.Tensor:
        """The predicate's AABBs: the clusters' while there are at most 64,
        else the coarser spatial boxes."""
        return self.smc_aabb if self.n_clusters <= 64 else self.smc_box_aabb

    @functools.cached_property
    def smc_level_boxes(self) -> torch.Tensor:
        """The mask pass's word and group boxes of the cluster AABBs
        (``ops.coherent.level_boxes``), made once a pack."""
        return coherent.level_boxes(self.smc_aabb)

    def to(self, device) -> "MeshPack":
        kw = {f.name: getattr(self, f.name).to(device)
              for f in dataclasses.fields(self)
              if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **kw)


def _read(x: torch.Tensor) -> np.ndarray:
    """One counted read of the device by the host."""
    PACK.add("host_reads")
    return x.detach().cpu().numpy()


def _select(mask: torch.Tensor) -> torch.Tensor:
    """The indices of ``mask``'s True entries, then of its False ones, each
    in index order (a stable sort: no read of the device)."""
    return torch.sort((~mask).to(torch.uint8), stable=True)[1]


def pack_mesh_scene(scene: Scene, gate_mask: Optional[np.ndarray] = None,
                    cluster_size: int = 128) -> MeshPack:
    """Split the scene into unrolled smalls and the clustered (gated) mesh.

    ``gate_mask``: (N,) bool, True = the triangle goes to the clusters.
    Default: the non-emissive triangles whose AABB diagonal is below 15% of
    the scene's (room walls and boxes span the room, mesh triangles are
    tiny).  Emissive triangles are never gated: NEE samples them from the
    light table.  A room tessellated into small triangles gates almost
    everything; the predicate then fires for about every lane and the caps
    overflow, which ``render_turbo_mesh(_exact)`` absorb by doubling
    them.

    Built on the scene's device, the BVH and the clusters included
    (``build_smem_clusters``), with three reads of the device at most:
    the scene's bounds (default gate only), the gate, emissive and live
    masks, and the light rows with the gated bounds."""
    PACK.add("packs")
    f32, f64 = torch.float32, torch.float64
    tr, sp, mats = scene.triangles, scene.spheres, scene.materials
    dev = scene.device
    v0, e1, e2 = (x.detach().to(f64) for x in (tr.v0, tr.e1, tr.e2))
    nrm = tr.normal.detach().to(f32)
    tmat = tr.material.long()
    m_emi = mats.emission.detach().to(f32)
    m_emissive = mats.emissive
    emissive = m_emissive[tmat]
    verts = torch.stack([v0, v0 + e1, v0 + e2], 1)          # (N, 3, 3)
    inf = float("inf")

    if gate_mask is None:
        pts = verts.reshape(-1, 3)
        lo_hi = _read(torch.stack([pts.amin(0), pts.amax(0)]))
        scene_diag = float(np.linalg.norm(lo_hi[1] - lo_hi[0]))
        d = verts.amax(1) - verts.amin(1)
        # np.linalg.norm's order of the three terms
        tri_diag = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                              + d[:, 2] * d[:, 2])
        gate = (tri_diag < 0.15 * scene_diag) & ~emissive
    else:
        gate = torch.as_tensor(np.asarray(gate_mask, bool)).to(dev)
    live = sp.radius != 0.0               # drop never-hit placeholders
    n = gate.shape[0]
    masks = _read(torch.cat([gate, emissive, live]))
    gate_mask, emi_h, live_h = masks[:n], masks[n:2 * n], masks[2 * n:]
    if emi_h[gate_mask].any():
        raise ValueError("gated (clustered) triangles must be non-emissive")
    ng, s, n_emi = (int(x.sum()) for x in (gate_mask, live_h, emi_h))
    ns = n - ng

    # Light table + sky: ops.fused.pack_scene's rows; its masked cumsum
    # over every triangle adds exact zeros between the emissive areas, so
    # the host's cumsum of those areas alone is its CDF to the bit.
    lidx = _select(emissive)[:max(n_emi, 1)]
    lrows = torch.cat([x[lidx].to(f32) for x in (v0, e1, e2, nrm)]
                      + [m_emi[tmat[lidx]]], 1)              # (Le, 15)
    g = gate[:, None, None]
    glo = torch.where(g, verts, inf).reshape(-1, 3).amin(0).to(f32)
    ghi = torch.where(g, verts, -inf).reshape(-1, 3).amax(0).to(f32)
    bounds = torch.cat([torch.nextafter(glo, torch.full_like(glo, -inf)),
                        torch.nextafter(ghi, torch.full_like(ghi, inf))])
    host = _read(torch.cat([lrows.reshape(-1), bounds]))
    lrows_h, bounds_h = host[:-6].reshape(-1, 15), host[-6:]
    le = lrows_h.shape[0]
    light = np.zeros((le, 16), np.float32)
    light[:, 0:15] = lrows_h
    light_total = np.float32(0.0)
    if n_emi:
        area = 0.5 * np.linalg.norm(
            np.cross(lrows_h[:, 3:6], lrows_h[:, 6:9]), axis=-1
        ).astype(np.float32)
        light[:, 15] = np.cumsum(area, dtype=np.float32)
        light_total = light[-1, 15]
    sky = torch.zeros((8,), dtype=f32, device=dev)
    sky[0:3] = scene.sky_bottom.detach()
    sky[3:6] = scene.sky_top.detach()
    sky[6] = float(light_total)

    if ng == 0:
        raise ValueError("no gated triangles: use ops.fused for small "
                         "scenes (every primitive unrolled)")
    order = _select(gate)
    gidx, sidx = order[:ng], order[ng:]
    stri = torch.zeros((max(ns, 1), 16), dtype=f32, device=dev)
    stri[:ns, 0:9] = torch.cat([v0, e1, e2], 1)[sidx]
    stri[:ns, 9:12] = nrm[sidx]
    stri[:ns, 12] = tmat[sidx]

    sph = _select(live)[:s]
    ssph = torch.zeros((max(s, 1), 8), dtype=f32, device=dev)
    ssph[:s, 0:3] = sp.center.detach()[sph]
    ssph[:s, 3] = sp.radius.detach()[sph]
    ssph[:s, 4] = sp.material[sph]

    k = mats.albedo.shape[0]
    mat = torch.zeros((k, 8), dtype=f32, device=dev)
    mat[:, 0:3] = mats.albedo.detach()
    mat[:, 3:6] = m_emi
    mat[:, 6] = m_emissive

    smc = build_smem_clusters(verts[gidx], nrm[gidx], tmat[gidx].to(f32),
                              cluster_size=cluster_size)
    return MeshPack(
        stri=stri, ssph=ssph, mat=mat,
        light=torch.as_tensor(light).to(dev), sky=sky,
        smc_tri=smc.tri, smc_aabb=smc.aabb, smc_box_aabb=smc.box_aabb,
        boxes=smc.boxes, cs=smc.cs,
        gate_lo=tuple(map(float, bounds_h[:3])),
        gate_hi=tuple(map(float, bounds_h[3:])),
        n_stri=ns, n_sph=s, n_light=le, n_mat=k,
        gate_mask=gate_mask)


def _slab_crosses(o, d, lo, hi, t_lo, t_hi):
    """Does the ray segment [t_lo, t_hi] cross the AABB (lo, hi)?  (R,)
    bool.  The slack on the far bound absorbs rounding: the predicate must
    be conservative (a missed lane would silently skip its mesh test)."""
    tiny = torch.where(d < 0.0, -1e-20, 1e-20)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=o.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=o.device)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_in = torch.amax(torch.minimum(t0, t1), -1)
    t_out = torch.amin(torch.maximum(t0, t1), -1)
    hi_bound = t_hi * 1.000001 + 1e-5
    return ((t_out >= min(t_lo, 0.0)) & (t_in <= t_out)
            & (t_in <= hi_bound))


# --- per-call state ----------------------------------------------------------

class _Params(NamedTuple):
    width: int
    height: int
    n_pix: int
    pixel_offset: int
    t_min: float
    eps_offset: float
    rr_survival: float
    shadow_tol: float
    max_depth: int
    stop_after: int
    cap_main: int
    cap_shadow: int


@dataclasses.dataclass(frozen=True)
class _Tables:
    """The pack and the camera words on the lanes' device, and for the
    kernels all of it in one float buffer: stri | ssph | mat | light | sky
    | pred_aabb | cam16, starting at ``offsets``."""

    mp: MeshPack
    cam16: torch.Tensor
    words: torch.Tensor
    offsets: tuple


def _tables(mp: MeshPack, cam16: torch.Tensor) -> _Tables:
    parts = [mp.stri, mp.ssph, mp.mat, mp.light, mp.sky, mp.pred_aabb, cam16]
    offsets, n = [], 0
    for x in parts:
        offsets.append(n)
        n += x.numel()
    words = torch.cat([x.reshape(-1) for x in parts]).to(torch.float32)
    return _Tables(mp=mp, cam16=cam16, words=words.contiguous(),
                   offsets=tuple(offsets))


def _lanes(r: int, p: _Params, device):
    return lanes(r, p.width, p.n_pix, p.pixel_offset, device)


def _pack_offsets(pred, offs):
    """The offsets table of a stable pack in lane order: per PACK_BLOCK
    lanes, (start, count)."""
    nb = offs.shape[0]
    m = torch.zeros((nb * PACK_BLOCK,), dtype=torch.int64, device=pred.device)
    m[:pred.shape[0]] = pred.to(torch.int64)
    counts = m.view(nb, PACK_BLOCK).sum(1)
    offs[:, 0] = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    offs[:, 1] = counts.to(torch.int32)


def _append(planes, pred, buf, buf_id, offs, cnt):
    """The plain pack: the lanes where ``pred`` in lane order to the front
    of ``buf`` (P, cap) / ``buf_id`` (cap,), as many as fit; ``cnt`` += the
    population."""
    idx = pred.nonzero()[:, 0]
    n = min(idx.numel(), buf.shape[1])
    for j, x in enumerate(planes):
        buf[j, :n] = x[idx[:n]]
    buf_id[:n] = idx[:n].to(torch.int32)
    _pack_offsets(pred, offs)
    cnt += idx.numel()


# --- plain versions: the kernels' arithmetic in PyTorch ----------------------

def _k1_plain(tb: _Tables, p: _Params, sf, hf, mr, mr_id, offs, cnt):
    """K1.  Reads the rays sf[0:6] (15, R).  Writes hf (10, R): [0:5] the
    smalls winner (t, n, material id), [5:10] the mesh winner's planes set
    to "no hit" (NO_HIT, 0, 0, 0, -1) for the nearest sweep to fill; packs
    the (o, d, lane) of the predicate lanes into mr (6, cap_main) / mr_id
    (cap_main,) and offs (ceil(R / PACK_BLOCK), 2); cnt (1,) += their
    number."""
    mp, where = tb.mp, torch.where
    ox, oy, oz, dx, dy, dz = sf[0:6].unbind(0)
    r = ox.shape[0]
    dev = ox.device
    valid = _lanes(r, p, dev).valid
    best_t = torch.full((r,), NO_HIT, dtype=torch.float32, device=dev)
    bnx = torch.zeros_like(best_t)
    bny = torch.zeros_like(best_t)
    bnz = torch.zeros_like(best_t)
    bmid = torch.full_like(best_t, -1.0)
    for n in range(mp.n_stri):
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
         nx, ny, nz, mid) = mp.stri[n, :13].unbind(0)
        s1x = dy * e2z - dz * e2y
        s1y = dz * e2x - dx * e2z
        s1z = dx * e2y - dy * e2x
        det = s1x * e1x + s1y * e1y + s1z * e1z
        okd = torch.abs(det) > _DET_EPS
        inv = 1.0 / where(okd, det, 1.0)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        s2x = sy * e1z - sz * e1y
        s2y = sz * e1x - sx * e1z
        s2z = sx * e1y - sy * e1x
        t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv
        b1 = (s1x * sx + s1y * sy + s1z * sz) * inv
        b2 = (s2x * dx + s2y * dy + s2z * dz) * inv
        ok = (okd & (t > p.t_min) & (b1 >= 0.0) & (b2 >= 0.0)
              & (1.0 - b1 - b2 >= 0.0) & (t < best_t))
        best_t = where(ok, t, best_t)
        bnx, bny, bnz = where(ok, nx, bnx), where(ok, ny, bny), where(ok, nz, bnz)
        bmid = where(ok, mid, bmid)
    for m in range(mp.n_sph):
        cx, cy, cz, rad, mid = mp.ssph[m, :5].unbind(0)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a_q = dx * dx + dy * dy + dz * dz
        hb = ocx * dx + ocy * dy + ocz * dz
        c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = hb * hb - a_q * c_q
        okq = disc > 0.0
        sq = torch.sqrt(where(okq, disc, 1.0))
        t_near = (-hb - sq) / a_q
        t_far = (-hb + sq) / a_q
        near_ok = okq & (t_near > p.t_min)
        far_ok = okq & (t_far > p.t_min)
        ts = where(near_ok, t_near, where(far_ok, t_far, NO_HIT))
        ok = ts < best_t
        inv_r = 1.0 / where(rad == 0.0, 1.0, rad)
        hpx, hpy, hpz = ox + ts * dx, oy + ts * dy, oz + ts * dz
        best_t = where(ok, ts, best_t)
        bnx = where(ok, (hpx - cx) * inv_r, bnx)
        bny = where(ok, (hpy - cy) * inv_r, bny)
        bnz = where(ok, (hpz - cz) * inv_r, bnz)
        bmid = where(ok, mid, bmid)

    o, d = sf[0:3].T, sf[3:6].T
    crossed = torch.zeros((r,), dtype=torch.bool, device=dev)
    for row in tb.mp.pred_aabb:
        crossed |= _slab_crosses(o, d, row[0:3], row[3:6], p.t_min, best_t)
    hf[0:5] = torch.stack([best_t, bnx, bny, bnz, bmid])
    hf[5] = NO_HIT
    hf[6:9] = 0.0
    hf[9] = -1.0
    _append((ox, oy, oz, dx, dy, dz), crossed & valid, mr, mr_id, offs, cnt)


def group_keys_plain(aabb, rays, t_min: float, *, occl: bool = False):
    """The grouping key of each ray of rays (6 or 7, n): bit c % GROUP_BITS
    set where the ray crosses cluster c's padded box (``crosses_box_plain``
    over the unbounded line; occl, the shadow rays: over the segment up to
    lim) -> (n,) i64."""
    crossed = crosses_box_plain(aabb, rays, t_min, occl=occl)
    key = torch.zeros((rays.shape[1],), dtype=torch.int64, device=rays.device)
    for c in range(crossed.shape[0]):
        key |= crossed[c].to(torch.int64) << (c % GROUP_BITS)
    return key


def group_plain(tb: _Tables, p: _Params, rays, ray_id, cnt, *,
                occl: bool = False):
    """The grouping of the first min(cnt, cap) packed main rays (6, cap),
    or shadow rays (7, cap) with ``occl``, and their lane ids (cap,) by
    ``group_keys_plain``: a stable sort by key.  Returns (grouped rays,
    grouped ids, the keys (n,) in pack order); past the n rays the buffers
    are copies of the input's."""
    n = min(int(cnt), rays.shape[1])
    keys = group_keys_plain(tb.mp.smc_aabb, rays[:, :n], p.t_min, occl=occl)
    order = torch.sort(keys, stable=True).indices
    g_rays, g_id = rays.clone(), ray_id.clone()
    g_rays[:, :n] = rays[:, order]
    g_id[:n] = ray_id[order]
    return g_rays, g_id, keys


def _sweep_plain(tb: _Tables, p: _Params, rays, ray_id, cnt, out, *,
                 occl: bool, lists=None):
    """The cluster sweep over the first min(cnt, cap) packed rays, in tiles
    of 4,096.  Nearest (rays (6, cap) [o d]): the first triangle at the
    least t wins; writes (t, n, material id) to out (5, R) at the rays'
    lanes.  Occlusion (rays (7, cap) [p w_l lim]): any triangle within
    (t_min, lim] by the division-free accept; writes 1.0 / 0.0 to out
    (1, R) at the rays' lanes.  ``lists``: (ids (T * C,), cnts (T,)), each
    tile's clusters (the shortlist mode); default every cluster in order.

    Returns the triangle tests of each of the n rays (n,) i64, for speed
    bounds only: the serial sweep tests every listed triangle (nearest) or
    stops a ray at its first accepted triangle in list order (occlusion);
    the kernel also skips the clusters whose boxes no ray of a warp
    crosses."""
    tri = tb.mp.smc_tri
    n_cl = tri.shape[0]
    n_planes, cap = rays.shape
    if cap % LANES_PER_TILE:
        raise ValueError(f"the packed buffer holds {cap} rays, not whole "
                         f"tiles of {LANES_PER_TILE}")
    n = min(int(cnt), cap)
    n_t = cap // LANES_PER_TILE
    if lists is None:
        ids = torch.arange(n_cl, device=rays.device).repeat(n_t)
        cnts = torch.full((n_t,), n_cl, dtype=torch.int64)
    else:
        ids, cnts = lists
    res, slot, tests = list_sweep_plain(
        tri, rays.view(n_planes, n_t, LANES_PER_TILE), ids.view(n_t, n_cl),
        cnts, p.t_min, occl=occl, n_live=n)
    lane = ray_id[:n].to(torch.int64)
    if occl:
        out[0, lane] = res.reshape(-1)[:n].to(torch.float32)
        return tests.reshape(-1)[:n]
    s = slot.reshape(-1)[:n]
    attrs = tri.reshape(-1, MESH_NF)[s.clamp(min=0), 9:13]
    attrs = torch.where((s >= 0)[:, None], attrs,
                        torch.tensor([0.0, 0.0, 0.0, -1.0], device=rays.device))
    out[:, lane] = torch.cat([res.reshape(-1)[:n][None], attrs.T])
    return tests.reshape(-1)[:n]


def _k1b_plain(tb: _Tables, p: _Params, seed, sf, si, hf, kb, sr, sr_id,
               offs, cnt):
    """K1b.  Reads the rays sf[0:6], (s, b) si[0:2] and hf (10, R).
    Writes kb (9, R): [0] t, [1:4] facing unit normal, [4] material id,
    [5:8] shading point, [8] the mesh-occlusion flag set to 0 for the
    occlusion sweep to fill; packs the (p, w_l, lim, lane) of the shadow
    rays that cross a predicate AABB into sr (7, cap_shadow) / sr_id and
    offs; cnt (1,) += their number."""
    mp, where = tb.mp, torch.where
    ox, oy, oz, dx, dy, dz = sf[0:6].unbind(0)
    r = ox.shape[0]
    ln = _lanes(r, p, ox.device)
    ts, snx, sny, snz, smid, tm, mnx, mny, mnz, mmid = hf.unbind(0)
    s, bb = si[0], si[1]

    is_mesh = tm < ts                     # the smalls win ties
    t = where(is_mesh, tm, ts)
    nx, ny, nz = (where(is_mesh, m, sm) for m, sm in
                  ((mnx, snx), (mny, sny), (mnz, snz)))
    mid = where(is_mesh, mmid, smid)
    nx, ny, nz = _norm3(nx, ny, nz)
    front = (nx * dx + ny * dy + nz * dz) < 0.0
    nx, ny, nz = where(front, nx, -nx), where(front, ny, -ny), where(front, nz, -nz)
    hit = t < NO_HIT
    t_pt = where(hit, t, 1.0)
    px = ox + t_pt * dx + nx * p.eps_offset
    py = oy + t_pt * dy + ny * p.eps_offset
    pz = oz + t_pt * dz + nz * p.eps_offset

    ef = torch.zeros_like(t)
    for k in range(mp.n_mat):
        ef = where(mid == float(k), mp.mat[k, 6], ef)
    alive_sh = ln.valid & hit & (ef < 0.5) & (mid >= 0.0)

    (wlx, wly, wlz), dist, _ = _light_sample(mp.light, mp.n_light, mp.sky[6],
                                             seed, ln.pix, s, bb, px, py, pz)
    lim = dist - p.shadow_tol
    # Zero-weight pruning: K2 scales NEE by (cos_s >= 0), so a sample at or
    # below the horizon contributes nothing whatever its visibility.
    cos_s = wlx * nx + wly * ny + wlz * nz
    alive_sh = alive_sh & (cos_s > 0.0) & (mp.sky[6] > 0.0)

    pt, wl = torch.stack([px, py, pz], 1), torch.stack([wlx, wly, wlz], 1)
    crossed = torch.zeros((r,), dtype=torch.bool, device=ox.device)
    for row in mp.pred_aabb:
        crossed |= _slab_crosses(pt, wl, row[0:3], row[3:6], p.t_min, lim)
    kb[0:8] = torch.stack([t, nx, ny, nz, mid, px, py, pz])
    kb[8] = 0.0
    _append((px, py, pz, wlx, wly, wlz, lim), alive_sh & crossed, sr, sr_id,
            offs, cnt)


def _k2_plain(tb: _Tables, p: _Params, seed, kb, sf, si):
    """K2, in place: reads kb (9, R) and the state; writes the next state
    sf (15, R) / si[0:3] and adds this step's shadow rays to si[3].  The
    step of ``ops.fused`` after its intersection: the smalls are the
    occluders, ORed with the mesh flag."""
    mp, where = tb.mp, torch.where
    t_hit, nxp, nyp, nzp, midp, hx, hy, hz, occ_f = kb.unbind(0)
    mat = [list(mp.mat[k, :7].unbind(0)) for k in range(mp.n_mat)]
    z = torch.zeros_like(t_hit)
    bal, bem, bef = [z, z, z], [z, z, z], z
    for k in range(mp.n_mat):
        take = midp == float(k)
        bal = [where(take, v, o) for v, o in zip(mat[k][0:3], bal)]
        bem = [where(take, v, o) for v, o in zip(mat[k][3:6], bem)]
        bef = where(take, mat[k][6], bef)
    planes, s, bb, nd, alive = _shade_advance(
        (mp.stri, mp.n_stri, mp.ssph, mp.n_sph), mp.light, mp.n_light,
        mp.sky, tb.cam16, seed, p, _lanes(sf.shape[1], p, sf.device),
        list(sf.unbind(0)), si[0], si[1], si[2], t_hit < NO_HIT,
        (bal, bem, bef), (nxp, nyp, nzp), (hx, hy, hz), occ_f > 0.5)
    sf.copy_(torch.stack(planes))
    si[0] = s
    si[1] = bb
    si[2] = nd
    si[3] += alive.to(torch.int32)


def _grouped_sweep_plain(tb, p, rays, ray_id, cnt, out, *, occl: bool):
    """A resident sweep over the rays grouped by ``group_plain`` (the
    kernels' order), as ``_sweep_plain``; the triangle tests are returned
    in pack order."""
    with profiling.span("fused_mesh.group"):
        g_rays, g_id, keys = group_plain(tb, p, rays, ray_id, cnt, occl=occl)
    tests = _sweep_plain(tb, p, g_rays, g_id, cnt, out, occl=occl)
    order = torch.sort(keys, stable=True).indices
    return torch.empty_like(tests).index_copy_(0, order, tests)


_nearest_plain = functools.partial(_grouped_sweep_plain, occl=False)
_occl_plain = functools.partial(_grouped_sweep_plain, occl=True)


# --- the kernels -------------------------------------------------------------

class _CParams(ctypes.Structure):
    """``Params`` of csrc/fused_mesh.cu, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "R", "n_pix", "pixel_offset", "width", "height", "n_stri", "n_sph",
        "n_light", "n_mat", "n_pred", "n_clusters", "cs", "cap_main",
        "cap_shadow", "max_depth", "stop_after", "off_ssph", "off_mat",
        "off_light", "off_sky", "off_pred", "off_cam", "n_words")] + [
        ("seed", ctypes.c_uint32)] + [(n, ctypes.c_float) for n in (
            "t_min", "eps_offset", "rr_survival", "inv_rr", "shadow_tol",
            "aspect")]


_P = ctypes.c_void_p
LIB = kernels.Library("fused_mesh", {
    # (params, tables, sf, hf, mr, mr_id, offs, cnt, stream)
    "fused_mesh_k1": [_P] * 9,
    # (params, occl, tri, aabb, rays, ray_id, cap, cnt, ids, cnts, k_max,
    #  part, tickets, out, stream)
    "fused_mesh_sweep": ([_P, ctypes.c_int] + [_P] * 4 + [ctypes.c_int]
                         + [_P] * 3 + [ctypes.c_int] + [_P] * 4),
    # (occl, cs, out)
    "fused_mesh_sweep_slots": [ctypes.c_int, ctypes.c_int, _P],
    # (params, occl, aabb, rays, ray_id, cap, cnt, keys, hist, g_rays,
    #  g_id, stream)
    "fused_mesh_group": ([_P, ctypes.c_int] + [_P] * 3 + [ctypes.c_int]
                         + [_P] * 6),
    # (params, tables, sf, si, hf, kb, sr, sr_id, offs, cnt, stream)
    "fused_mesh_k1b": [_P] * 11,
    # (params, tables, kb, sf, si, stream)
    "fused_mesh_k2": [_P] * 6,
}, LAUNCHES)


def _cparams(tb: _Tables, p: _Params, seed: int, r: int) -> _CParams:
    mp, o = tb.mp, tb.offsets
    return _CParams(
        R=r, n_pix=p.n_pix, pixel_offset=p.pixel_offset, width=p.width,
        height=p.height, n_stri=mp.n_stri, n_sph=mp.n_sph,
        n_light=mp.n_light, n_mat=mp.n_mat, n_pred=mp.pred_aabb.shape[0],
        n_clusters=mp.n_clusters, cs=mp.cs, cap_main=p.cap_main,
        cap_shadow=p.cap_shadow, max_depth=p.max_depth,
        stop_after=p.stop_after, off_ssph=o[1], off_mat=o[2], off_light=o[3],
        off_sky=o[4], off_pred=o[5], off_cam=o[6],
        n_words=tb.words.numel(), seed=int(seed) & 0xFFFFFFFF,
        t_min=p.t_min, eps_offset=p.eps_offset, rr_survival=p.rr_survival,
        inv_rr=1.0 / p.rr_survival, shadow_tol=p.shadow_tol,
        aspect=float(p.width) / float(p.height))


def _plane_rows(x, rows: int, r: int, what: str):
    if x.dim() != 2 or x.shape[0] != rows or x.shape[1] != r:
        raise ValueError(f"{what} must be ({rows}, {r}), not "
                         f"{tuple(x.shape)}")


_F, _I = torch.float32, torch.int32


def _k1_kernel(tb: _Tables, p: _Params, sf, hf, mr, mr_id, offs, cnt):
    """Launch K1 (csrc/fused_mesh.cu) on CUDA tensors; as ``_k1_plain``."""
    kernels.check("fused_mesh K1", dict(words=(tb.words, _F), sf=(sf, _F),
                                 hf=(hf, _F), mr=(mr, _F), mr_id=(mr_id, _I),
                                 offs=(offs, _I), cnt=(cnt, _I)))
    r = sf.shape[1]
    _plane_rows(sf, 15, r, "sf")
    _plane_rows(hf, 10, r, "hf")
    _plane_rows(mr, 6, p.cap_main, "mr")
    if offs.shape != (-(-r // PACK_BLOCK), 2) or mr_id.shape != (p.cap_main,):
        raise ValueError("bad offsets table or id buffer shape")
    cp = _cparams(tb, p, 0, r)
    LIB.launch("fused_mesh_k1", ctypes.byref(cp), tb.words.data_ptr(),
               sf.data_ptr(), hf.data_ptr(), mr.data_ptr(), mr_id.data_ptr(),
               offs.data_ptr(), cnt.data_ptr(), kernels.stream(sf), key="k1")


def _sweep_kernel(tb: _Tables, p: _Params, rays, ray_id, cnt, out, *,
                  occl: bool, lists=None, k_max: int = SPLIT_MAX):
    """Launch the sweep (csrc/fused_mesh.cu) on CUDA tensors; as
    ``_sweep_plain``.  Each ray block's list is cut into at most ``k_max``
    slices (1: unsplit), enough to fill ``SWEEP_WAVES`` times the card's
    resident sweep blocks."""
    key = ("occl" if occl else "nearest") + ("" if lists is None else "_sl")
    name = "fused_mesh_" + key
    tensors = dict(tri=(tb.mp.smc_tri, _F), aabb=(tb.mp.smc_aabb, _F),
                   rays=(rays, _F), ray_id=(ray_id, _I), cnt=(cnt, _I),
                   out=(out, _F))
    if lists is not None:
        tensors.update(ids=(lists[0], _I), cnts=(lists[1], _I))
    kernels.check(name, tensors)
    cap = rays.shape[1]
    _plane_rows(rays, 7 if occl else 6, cap, "rays")
    _plane_rows(out, 1 if occl else 5, out.shape[1], "out")
    if (ray_id.shape != (cap,) or tb.mp.smc_tri.shape
            != (tb.mp.n_clusters, tb.mp.cs, MESH_NF)
            or tb.mp.smc_aabb.shape != (tb.mp.n_clusters, 8)):
        raise ValueError("bad id buffer or cluster table shape")
    ids = cnts = None
    if lists is not None:
        n_t = cap // LANES_PER_TILE
        if (cap % LANES_PER_TILE or lists[0].numel() != n_t * tb.mp.n_clusters
                or lists[1].numel() != n_t):
            raise ValueError("the shortlist sweep takes whole 4,096-ray "
                             "tiles, ids (T * C,) and cnts (T,)")
        ids, cnts = lists[0].data_ptr(), lists[1].data_ptr()
    k_max = max(1, min(k_max, SPLIT_MAX, tb.mp.n_clusters))
    part = tickets = None
    if k_max > 1:
        # nearest: each slice's (t, row); occlusion: one flag per ray
        part = (torch.zeros((cap,), dtype=_I, device=rays.device) if occl
                else torch.empty((2 * k_max * cap,), dtype=_I,
                                 device=rays.device))
        tickets = kernels.tickets(-(-cap // SWEEP_BLOCK), rays.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    cp = _cparams(tb, p, 0, out.shape[1])
    LIB.launch("fused_mesh_sweep", ctypes.byref(cp), int(occl),
               tb.mp.smc_tri.data_ptr(), tb.mp.smc_aabb.data_ptr(),
               rays.data_ptr(), ray_id.data_ptr(),
               cap, cnt.data_ptr(), ids, cnts, k_max, ptr(part), ptr(tickets),
               out.data_ptr(), kernels.stream(rays), key=key)


def _group_kernel(tb: _Tables, p: _Params, rays, ray_id, cnt, *,
                  occl: bool = False):
    """Launch the grouping (csrc/fused_mesh.cu, three kernels) on CUDA
    tensors: as ``group_plain``, but the order inside a key is the
    atomics'.  Returns (grouped rays, grouped ids, the keys (cap,) i32 in
    pack order; only the first min(cnt, cap) of each are written)."""
    kernels.check("fused_mesh group", dict(aabb=(tb.mp.smc_aabb, _F),
                                    rays=(rays, _F), ray_id=(ray_id, _I),
                                    cnt=(cnt, _I)))
    cap = rays.shape[1]
    _plane_rows(rays, 7 if occl else 6, cap, "rays")
    if (ray_id.shape != (cap,)
            or tb.mp.smc_aabb.shape != (tb.mp.n_clusters, 8)):
        raise ValueError("bad id buffer or cluster box table shape")
    dev = rays.device
    keys = torch.empty((cap,), dtype=_I, device=dev)
    hist = torch.zeros((1 << GROUP_BITS,), dtype=_I, device=dev)
    g_rays = torch.empty_like(rays)
    g_id = torch.empty_like(ray_id)
    cp = _cparams(tb, p, 0, cap)
    LIB.launch("fused_mesh_group", ctypes.byref(cp), int(occl),
               tb.mp.smc_aabb.data_ptr(), rays.data_ptr(), ray_id.data_ptr(),
               cap, cnt.data_ptr(), keys.data_ptr(), hist.data_ptr(),
               g_rays.data_ptr(), g_id.data_ptr(), kernels.stream(rays),
               key="group_occl" if occl else "group")
    return g_rays, g_id, keys


def _grouped_sweep_kernel(tb, p, rays, ray_id, cnt, out, *, occl: bool):
    """Group the packed rays, then launch the resident sweep over them, on
    CUDA tensors; as ``_grouped_sweep_plain``."""
    with profiling.span("fused_mesh.group"):
        g_rays, g_id, _ = _group_kernel(tb, p, rays, ray_id, cnt, occl=occl)
    _sweep_kernel(tb, p, g_rays, g_id, cnt, out, occl=occl)


_nearest_kernel = functools.partial(_grouped_sweep_kernel, occl=False)
_occl_kernel = functools.partial(_grouped_sweep_kernel, occl=True)


def _lists(tb: _Tables, p: _Params, rays, cnt, kernel: bool):
    """The shortlists of the packed rays (P, cap): the mask pass of
    ``ops.coherent`` over the first cnt rays, in strips of 4,096, against
    the cluster AABBs (P = 7: up to lim); the kernel writes the lists in
    the same launch, the plain version makes them with ``_lists``."""
    planes = rays.view(rays.shape[0], -1, coherent.TILE_W)
    if kernel:
        return coherent._mask_kernel(
            tb.mp.smc_aabb, planes, p.t_min, cnt, planes=False,
            boxes=tb.mp.smc_level_boxes, lists=True)[2:]
    _, words = coherent.mask_plain(tb.mp.smc_aabb, planes, p.t_min, cnt,
                                   planes=False)
    return coherent._lists(words, tb.mp.n_clusters)


def _sl_sweep(tb, p, rays, ray_id, cnt, out, *, occl: bool, kernel: bool):
    """The shortlist-streaming sweep: the mask pass, the lists, then the
    sweep over each tile's list, by the kernels or by the plain versions;
    as ``_sweep_plain`` with lists."""
    sweep = _sweep_kernel if kernel else _sweep_plain
    return sweep(tb, p, rays, ray_id, cnt, out, occl=occl,
                 lists=_lists(tb, p, rays, cnt, kernel))


def _k1b_kernel(tb: _Tables, p: _Params, seed, sf, si, hf, kb, sr, sr_id,
                offs, cnt):
    """Launch K1b on CUDA tensors; as ``_k1b_plain``."""
    kernels.check("fused_mesh K1b", dict(words=(tb.words, _F), sf=(sf, _F),
                                  si=(si, _I), hf=(hf, _F), kb=(kb, _F),
                                  sr=(sr, _F), sr_id=(sr_id, _I),
                                  offs=(offs, _I), cnt=(cnt, _I)))
    r = sf.shape[1]
    _plane_rows(sf, 15, r, "sf")
    _plane_rows(si, 4, r, "si")
    _plane_rows(hf, 10, r, "hf")
    _plane_rows(kb, 9, r, "kb")
    _plane_rows(sr, 7, p.cap_shadow, "sr")
    if (offs.shape != (-(-r // PACK_BLOCK), 2)
            or sr_id.shape != (p.cap_shadow,)):
        raise ValueError("bad offsets table or id buffer shape")
    cp = _cparams(tb, p, seed, r)
    LIB.launch("fused_mesh_k1b", ctypes.byref(cp), tb.words.data_ptr(),
               sf.data_ptr(), si.data_ptr(), hf.data_ptr(), kb.data_ptr(),
               sr.data_ptr(), sr_id.data_ptr(), offs.data_ptr(),
               cnt.data_ptr(), kernels.stream(sf), key="k1b")


def _k2_kernel(tb: _Tables, p: _Params, seed, kb, sf, si):
    """Launch K2 on CUDA tensors; as ``_k2_plain``."""
    kernels.check("fused_mesh K2", dict(words=(tb.words, _F), kb=(kb, _F),
                                 sf=(sf, _F), si=(si, _I)))
    r = sf.shape[1]
    _plane_rows(sf, 15, r, "sf")
    _plane_rows(si, 4, r, "si")
    _plane_rows(kb, 9, r, "kb")
    cp = _cparams(tb, p, seed, r)
    LIB.launch("fused_mesh_k2", ctypes.byref(cp), tb.words.data_ptr(),
               kb.data_ptr(), sf.data_ptr(), si.data_ptr(), kernels.stream(sf),
               key="k2")


class _Ops(NamedTuple):
    k1: object
    nearest: object
    k1b: object
    occl: object
    k2: object


KERNEL_OPS = _Ops(_k1_kernel, _nearest_kernel, _k1b_kernel, _occl_kernel,
                  _k2_kernel)
PLAIN_OPS = _Ops(_k1_plain, _nearest_plain, _k1b_plain, _occl_plain,
                 _k2_plain)
# the shortlist-streaming mode (resident=False): the rays in pack order
KERNEL_SL_OPS = KERNEL_OPS._replace(
    nearest=functools.partial(_sl_sweep, occl=False, kernel=True),
    occl=functools.partial(_sl_sweep, occl=True, kernel=True))
PLAIN_SL_OPS = PLAIN_OPS._replace(
    nearest=functools.partial(_sl_sweep, occl=False, kernel=False),
    occl=functools.partial(_sl_sweep, occl=True, kernel=False))


def fits_resident(n_clusters: int, cs: int) -> bool:
    """The JAX package's SMEM budget rule: whether a table of ``n_clusters``
    clusters of ``cs`` triangles fits ``SMEM_RESIDENT_BUDGET``.  It picks
    the mode for ``resident=None`` and bounds ``models.mesh.prepare(method=
    "fused")``, though the table stays in device memory here."""
    return n_clusters * cs * MESH_NF * 4 <= SMEM_RESIDENT_BUDGET


# --- the stepper -------------------------------------------------------------

class StepBuffers(NamedTuple):
    """Per-call scratch of the stepper (reused by every step)."""

    hf: torch.Tensor     # (10, R) f32 smalls + mesh winner planes
    kb: torch.Tensor     # (9, R) f32 merged hit, shading point, mesh flag
    mr: torch.Tensor     # (6, cap_main) f32 packed main rays
    mr_id: torch.Tensor  # (cap_main,) i32 their lanes
    sr: torch.Tensor     # (7, cap_shadow) f32 packed shadow rays
    sr_id: torch.Tensor  # (cap_shadow,) i32 their lanes
    offs1: torch.Tensor  # (ceil(R / PACK_BLOCK), 2) i32 K1's offsets table
    offs2: torch.Tensor  # the same for K1b
    cnt: torch.Tensor    # (n_steps, 2) i32 packed populations per step


def step_buffers(r: int, p: _Params, n_steps: int, device) -> StepBuffers:
    e = lambda *s, dt=_F: torch.empty(s, dtype=dt, device=device)  # noqa: E731
    nb = -(-r // PACK_BLOCK)
    return StepBuffers(
        hf=e(10, r), kb=e(9, r), mr=e(6, p.cap_main),
        mr_id=e(p.cap_main, dt=_I), sr=e(7, p.cap_shadow),
        sr_id=e(p.cap_shadow, dt=_I), offs1=e(nb, 2, dt=_I),
        offs2=e(nb, 2, dt=_I),
        cnt=torch.zeros((n_steps, 2), dtype=_I, device=device))


OP_NAMES = _Ops._fields    # one step's entry points, in launch order


def run_op(ops: _Ops, name: str, tb: _Tables, p: _Params, seed: int, sf, si,
           buf: StepBuffers, k: int = 0):
    """Entry point ``name`` of bounce step ``k`` on the step buffers; the
    packers add to, and the sweeps read, the populations buf.cnt[k].
    Returns what the entry point returns."""
    c1, c2 = buf.cnt[k, 0:1], buf.cnt[k, 1:2]
    if name == "k1":
        return ops.k1(tb, p, sf, buf.hf, buf.mr, buf.mr_id, buf.offs1, c1)
    if name == "nearest":
        return ops.nearest(tb, p, buf.mr, buf.mr_id, c1, buf.hf[5:10])
    if name == "k1b":
        return ops.k1b(tb, p, seed, sf, si, buf.hf, buf.kb, buf.sr,
                       buf.sr_id, buf.offs2, c2)
    if name == "occl":
        return ops.occl(tb, p, buf.sr, buf.sr_id, c2, buf.kb[8:9])
    return ops.k2(tb, p, seed, buf.kb, sf, si)


def run_steps(ops: _Ops, tb: _Tables, p: _Params, seed: int, sf, si,
              n_steps: int, buf: StepBuffers):
    """``n_steps`` bounce steps of every lane, in place on sf (15, R) / si
    (4, R), five launches a step and no host sync."""
    for k in range(n_steps):
        for name in OP_NAMES:
            run_op(ops, name, tb, p, seed, sf, si, buf, k)


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def params(cfg: RenderConfig, r: int, cap_main=None, cap_shadow=None,
           pixel_offset: int = 0, stop_after: int = 0) -> _Params:
    """The stepper's constants for ``r`` lanes; the caps (default a quarter
    of the lanes) rounded up to whole multiples of 4,096 lanes."""
    quarter = max(LANES_PER_TILE, _ceil_to(r, LANES_PER_TILE) // 4)
    return _Params(
        width=cfg.width, height=cfg.height, n_pix=cfg.height * cfg.width,
        pixel_offset=int(pixel_offset), t_min=float(cfg.t_min),
        eps_offset=float(cfg.eps_offset), rr_survival=float(cfg.rr_survival),
        shadow_tol=float(cfg.shadow_tolerance), max_depth=int(cfg.max_depth),
        stop_after=int(stop_after),
        cap_main=_ceil_to(quarter if cap_main is None else cap_main,
                          LANES_PER_TILE),
        cap_shadow=_ceil_to(quarter if cap_shadow is None else cap_shadow,
                            LANES_PER_TILE))


def _run(kernel: bool, mp: MeshPack, camera, cfg: RenderConfig, seed: int,
         state, n_steps: int, cap_main, cap_shadow, pixel_offset: int,
         resident, stop_after: int):
    """``wavefront_steps_fused_mesh``'s work, returning its triple and the
    sweep mode taken (``resident=None`` resolved by ``fits_resident``)."""
    if cfg.soft_shadow_beta > 0.0:
        raise NotImplementedError("the fused mesh stepper implements the "
                                  "reference's hard shadow test only")
    if resident is None:
        resident = fits_resident(mp.n_clusters, mp.cs)
    ops = ((KERNEL_OPS if resident else KERNEL_SL_OPS) if kernel
           else (PLAIN_OPS if resident else PLAIN_SL_OPS))
    dev = state.s.device
    r = state.s.shape[0]
    p = params(cfg, r, cap_main, cap_shadow, pixel_offset, stop_after)
    with profiling.span("fused_mesh.tables"):
        tb = _tables(mp.to(dev), _camera_words(camera.to(dev)))
    sf, si = state_planes(state)
    buf = step_buffers(r, p, int(n_steps), dev)
    run_steps(ops, tb, p, int(seed) & 0xFFFFFFFF, sf, si, int(n_steps), buf)

    caps = torch.tensor([p.cap_main, p.cap_shadow], dtype=_I, device=dev)
    overflow = torch.clamp(buf.cnt - caps, min=0).sum()
    npred = buf.cnt.sum(0)
    return planes_state(state, sf, si, n_steps), overflow, npred, resident


def wavefront_steps_fused_mesh(mp: MeshPack, camera, cfg: RenderConfig,
                               seed: int, state, n_steps: int, *,
                               cap_main: int | None = None,
                               cap_shadow: int | None = None,
                               pixel_offset: int = 0,
                               resident: bool | None = None,
                               stop_after: int = 0, device=None):
    """Advance every lane of ``state`` (an ``ops.fused.WavefrontState``)
    by ``n_steps`` bounce steps over the mesh pack.
    Returns ``(state', overflow, npred)``: overflow 0 means every mesh
    crossing lane was tested (> 0: raise the caps and rerun, the state is
    invalid); npred (2,) the main and shadow predicate populations summed
    over the steps.  Both stay on the device.

    ``cap_main`` / ``cap_shadow``: packed-buffer sizes, rounded up to whole
    multiples of 4,096 lanes (default a quarter of the lanes).
    ``pixel_offset``: the absolute pixel of the state's first lane, so a
    row-major slab steps exactly like the same lanes of the full image.
    ``resident``: True sweeps every cluster for every packed ray, False
    only each tile's shortlist; None (default) takes the JAX package's
    rule, ``fits_resident``.  The results are the same.
    ``stop_after > 0``: equal-spp mode.  ``device`` (default: the card)
    must be where ``state`` lies; CUDA tensors launch csrc/fused_mesh.cu
    (and csrc/coherent.cu's mask pass in the shortlist mode), CPU tensors
    run the plain versions."""
    dev = kernels.resolve_device(device)
    if state.s.device.type != dev.type:
        raise ValueError(f"state lies on {state.s.device}, not on {dev}")
    return _run(state.s.is_cuda, mp, camera, cfg, seed, state, n_steps,
                cap_main, cap_shadow, pixel_offset, resident, stop_after)[:3]


def wavefront_steps_fused_mesh_plain(mp: MeshPack, camera, cfg: RenderConfig,
                                     seed: int, state, n_steps: int, *,
                                     cap_main: int | None = None,
                                     cap_shadow: int | None = None,
                                     pixel_offset: int = 0,
                                     resident: bool | None = None,
                                     stop_after: int = 0):
    """The plain PyTorch version of ``wavefront_steps_fused_mesh`` on any
    device (the kernels' arithmetic, vectorized over lanes)."""
    return _run(False, mp, camera, cfg, seed, state, n_steps, cap_main,
                cap_shadow, pixel_offset, resident, stop_after)[:3]


# --- renderers ---------------------------------------------------------------

def _drive(scene: Scene, camera, cfg: RenderConfig, seed: int, *,
           target: int, stop_after: int, gate_mask, cluster_size: int,
           device):
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc

    dev = kernels.resolve_device(device)
    with profiling.span("fused_mesh.render"):
        scene = scene.to(dev)
        with profiling.span("fused_mesh.pack"):
            mp = pack_mesh_scene(scene, gate_mask=gate_mask,
                                 cluster_size=cluster_size)
        with profiling.span("fused_mesh.init"):
            state = mc.wavefront_init(scene, camera, cfg, seed, device=dev)
        rp = _ceil_to(state.s.shape[0], LANES_PER_TILE)
        cap_main = cap_shadow = max(LANES_PER_TILE, rp // 8)
        chunk = max(32, cfg.max_depth)
        TRACE.clear()
        for _ in range(target * cfg.max_depth):
            with profiling.span("fused_mesh.chunk"):
                nxt, overflow, npred, resident = _run(
                    state.s.is_cuda, mp, camera, cfg, seed, state, chunk,
                    cap_main, cap_shadow, 0, None, stop_after)
            # the one read of the device per chunk
            with profiling.span("fused_mesh.poll"):
                over, least, n_main, n_shadow = torch.stack(
                    [overflow.to(torch.int64),
                     nxt.n_done.min().to(torch.int64),
                     npred[0].to(torch.int64),
                     npred[1].to(torch.int64)]).tolist()
            TRACE.append(dict(steps=chunk, cap_main=cap_main,
                              cap_shadow=cap_shadow, overflow=over,
                              npred=[n_main, n_shadow], resident=resident))
            if over > 0:
                # rerun the chunk with doubled caps (state untouched on
                # purpose)
                cap_main = min(2 * cap_main, rp)
                cap_shadow = min(2 * cap_shadow, rp)
                continue
            state = nxt
            if least >= target:
                break
            if stop_after:
                chunk = min(2 * chunk, 4096)
        return state


def render_turbo_mesh_exact(scene: Scene, camera, cfg: RenderConfig,
                            seed: int, *,
                            gate_mask: Optional[np.ndarray] = None,
                            cluster_size: int = 128,
                            device=None) -> torch.Tensor:
    """Mean linear radiance, (H, W, 3), over a mesh scene by the fused mesh
    engine in equal-spp mode: every pixel completes exactly ``cfg.spp``
    samples and idles (the reference's fixed-spp estimator).  The packed
    buffers start at an eighth of the lanes; a chunk that overflows reruns
    with both caps doubled.  Runs on ``device`` (default: the card);
    ``TRACE`` records the chunks."""
    state = _drive(scene, camera, cfg, seed, target=cfg.spp,
                   stop_after=int(cfg.spp), gate_mask=gate_mask,
                   cluster_size=cluster_size, device=device)
    spp = torch.tensor(float(cfg.spp), dtype=torch.float32,
                       device=state.acc.device)
    return (state.acc / spp).reshape(cfg.height, cfg.width, 3)


def render_turbo_mesh(scene: Scene, camera, cfg: RenderConfig, seed: int, *,
                      min_spp: int | None = None,
                      gate_mask: Optional[np.ndarray] = None,
                      cluster_size: int = 128,
                      device=None) -> torch.Tensor:
    """Mean linear radiance over a mesh scene by the fused mesh engine,
    equal-time progressive (``monte_carlo.render_turbo``'s semantics): steps
    until every pixel has ``min_spp`` (default ``cfg.spp``) samples, with
    the caps doubled on overflow as in ``render_turbo_mesh_exact``."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc

    target = cfg.spp if min_spp is None else min_spp
    state = _drive(scene, camera, cfg, seed, target=target, stop_after=0,
                   gate_mask=gate_mask, cluster_size=cluster_size,
                   device=device)
    return mc.wavefront_image(state, cfg)
