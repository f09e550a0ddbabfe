"""Row-sharded rendering (port of ``cpu_based_ray_tracer_tpu.parallel.shard``).

Each slab of a ``parallel.mesh.Mesh`` renders or steps a contiguous run of
image rows at ``pixel_offset = row0 * W``.  The counter-based RNG keys every
lane by its absolute pixel index, so the slabs concatenate into the
unsharded image and lane state bit for bit: a lane's result depends on its
pixel only.  JAX runs the slabs under ``shard_map``; here a process runs its
slabs one after another, each on its own device, and processes meet only
through ``torch.distributed`` collectives:

- ``render_sharded`` gathers the rows once (``all_gather``); the scene's
  gradient is summed over the processes in the backward pass
  (``all_reduce``), as ``shard_map``'s transpose psums the cotangent of a
  replicated parameter.  Both backward rules are written here
  (``_GatherRows``, ``_ReplicatedGrad``): ``torch.distributed.nn``'s
  gather would sum every rank's cotangent of the gathered image, which
  each rank computed whole, and scale the gradient by the world size;
- the wavefront steppers make one collective a call, a sum of the ray
  count (and for the fused mesh stepper, in the same call, the overflow
  and the predicate populations), and none inside the step loop.

A process holds the lane state of its own slabs, concatenated in slab order
on its mesh's first device; in a world of one that is the whole image.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
from cpu_based_ray_tracer_tpu_torch.ops import fused, fused_mesh
from cpu_based_ray_tracer_tpu_torch.parallel.mesh import (
    Mesh, replicated, row_sharded)
from cpu_based_ray_tracer_tpu_torch.scene import Scene

# The per-lane planes of a WavefrontState (all of it but the ray count),
# which the slabs split and join.
PLANES = tuple(f.name for f in dataclasses.fields(monte_carlo.WavefrontState)
               if f.name != "nrays")


def render_tiles(scene: Scene, camera, cfg: RenderConfig, seed: int,
                 row0: int, n_rows: int) -> torch.Tensor:
    """Rows [row0, row0 + n_rows) of the cfg.height image, on the device the
    scene lies on: the slab body of the sharded renderer.  (n_rows, W, 3)
    radiance summed over cfg.spp samples (divide by spp for the mean)."""
    w = cfg.width
    acc = torch.zeros((n_rows, w, 3), dtype=torch.float32,
                      device=scene.device)
    for s in range(cfg.spp):
        o, d, pixel = monte_carlo._primary_rays(
            camera, cfg, seed, s, pixel_offset=row0 * w, height=n_rows)
        rad = monte_carlo.trace(scene, o, d, cfg, seed=seed, pixel=pixel,
                                sample=s)
        acc = acc + rad.reshape(n_rows, w, 3)
    return acc


# --- the two collectives with hand-written backward rules ------------------

def _map_tensors(obj, fn):
    """``obj`` (a tensor or a dataclass of them, nested) with ``fn`` applied
    to every tensor."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, fn) for x in obj)
    return dataclasses.replace(obj, **{
        f.name: _map_tensors(getattr(obj, f.name), fn)
        for f in dataclasses.fields(obj)})


def _tensors(obj) -> list:
    out = []
    _map_tensors(obj, lambda t: out.append(t) or t)
    return out


class _ReplicatedGrad(torch.autograd.Function):
    """Identity forward; backward sums the cotangents over the group in one
    ``all_reduce``: the gradient of a parameter that every process holds
    and every process's slabs read."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        out, k = [], 0
        for g in gs:
            out.append(flat[k:k + g.numel()].view_as(g))
            k += g.numel()
        return (None, *out)


def replicate_grad(trees, group):
    """``trees`` (a tuple of scenes, cameras, tensors) with every tensor
    that requires a gradient passed through ``_ReplicatedGrad``."""
    if group is None:
        return trees
    live = [t for t in _tensors(trees) if t.requires_grad]
    if not live:
        return trees
    new = dict(zip(map(id, live), _ReplicatedGrad.apply(group, *live)))
    return _map_tensors(trees, lambda t: new.get(id(t), t))


class _GatherRows(torch.autograd.Function):
    """``all_gather`` of each process's rows into the whole image; backward
    takes this process's rows of the cotangent (every process computed the
    whole image's cotangent, so nothing is summed)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.rank, ctx.rows
        return g[r * n:(r + 1) * n], None


def render_sharded(scene: Scene, camera, cfg: RenderConfig, seed: int,
                   mesh: Mesh) -> torch.Tensor:
    """Mean linear radiance (H, W, 3), rows sharded over ``mesh``, on the
    mesh's first device: each slab renders its rows on its device (the
    scene and camera copied there); across processes the rows are gathered,
    so every process holds the whole image (``dist.local_rows`` picks its
    own).  Bit equal to ``monte_carlo.render``.  cfg.height must be
    divisible by the slab count (ValueError)."""
    slabs = row_sharded(mesh, cfg.height)
    scene, camera = replicate_grad((scene, camera), mesh.group)
    copies = {dev: (scene.to(dev), camera.to(dev))
              for dev in replicated(mesh)}
    parts = []
    for (row0, rows), dev in zip(slabs, mesh.devices):
        sc, cam = copies[dev]
        parts.append(render_tiles(sc, cam, cfg, seed, row0, rows)
                     .to(mesh.device))
    local = torch.cat(parts) / torch.tensor(float(cfg.spp),
                                            device=mesh.device)
    if mesh.group is None:
        return local
    return _GatherRows.apply(local, mesh.group)


# --- the sharded wavefront steppers ----------------------------------------

def _lanes_per_device(cfg: RenderConfig, mesh: Mesh) -> int:
    n = mesh.n_slabs
    if cfg.height % n:
        raise ValueError(f"height {cfg.height} not divisible by mesh size {n}")
    return cfg.height * cfg.width // n


def _slab(state, j: int, per: int, dev) -> monte_carlo.WavefrontState:
    """Local slab ``j`` of a process's state, on ``dev``, its ray count 0."""
    sl = slice(j * per, (j + 1) * per)
    return monte_carlo.WavefrontState(
        nrays=torch.zeros((), dtype=torch.int32, device=dev),
        **{f: getattr(state, f)[sl].to(dev) for f in PLANES})


def _join(parts, dev, nrays) -> monte_carlo.WavefrontState:
    return monte_carlo.WavefrontState(nrays=nrays, **{
        f: torch.cat([getattr(p, f).to(dev) for p in parts])
        for f in PLANES})


def _check_lanes(state, per: int, mesh: Mesh):
    want = per * len(mesh.slabs)
    if state.s.shape[0] != want:
        raise ValueError(f"the state holds {state.s.shape[0]} lanes, this "
                         f"process's {len(mesh.slabs)} slabs {want}")


def _sum_over_group(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The one collective of a stepper's call (int64 sums)."""
    if mesh.group is not None:
        dist.all_reduce(x, group=mesh.group)
    return x


def wavefront_init_sharded(scene: Scene, camera, cfg: RenderConfig,
                           seed: int, mesh: Mesh
                           ) -> monte_carlo.WavefrontState:
    """Fresh lane state of this process's slabs (``wavefront_init`` of each
    at its pixel offset), concatenated on the mesh's first device."""
    per = _lanes_per_device(cfg, mesh)
    parts = [monte_carlo.wavefront_init(scene, camera, cfg, seed,
                                        pixel_offset=i * per, n_lanes=per,
                                        device=dev)
             for i, dev in zip(mesh.slabs, mesh.devices)]
    return _join(parts, mesh.device,
                 torch.zeros((), dtype=torch.int32, device=mesh.device))


def wavefront_steps_sharded(scene: Scene, camera, cfg: RenderConfig,
                            seed: int, state: monte_carlo.WavefrontState,
                            n_steps: int, mesh: Mesh, intersect_fn=None,
                            nearest_t_fn=None
                            ) -> monte_carlo.WavefrontState:
    """Advance this process's slabs ``n_steps`` bounce steps each
    (``monte_carlo.wavefront_steps``).  ``nrays`` becomes the global count:
    the slabs' deltas summed, over the processes by one ``all_reduce`` a
    call."""
    per = _lanes_per_device(cfg, mesh)
    _check_lanes(state, per, mesh)
    outs = [monte_carlo.wavefront_steps(
        scene, camera, cfg, seed, _slab(state, j, per, dev), n_steps,
        intersect_fn=intersect_fn, nearest_t_fn=nearest_t_fn,
        pixel_offset=i * per)
        for j, (i, dev) in enumerate(zip(mesh.slabs, mesh.devices))]
    delta = torch.stack([o.nrays.to(mesh.device, torch.int64)
                         for o in outs]).sum().reshape(1)
    delta = _sum_over_group(delta, mesh)
    nrays = fused.wrap_i32(state.nrays.to(torch.int64) + delta[0])
    return _join(outs, mesh.device, nrays)


def wavefront_steps_fused_mesh_sharded(mp, camera, cfg: RenderConfig,
                                       seed: int,
                                       state: monte_carlo.WavefrontState,
                                       n_steps: int, mesh: Mesh, *,
                                       cap_main: int | None = None,
                                       cap_shadow: int | None = None,
                                       resident: bool | None = None):
    """The fused mesh stepper (``ops.fused_mesh``) over this process's
    slabs: each slab advances alone (its kernels on its device, its caps by
    default from its own lanes), bit equal to the same lanes of an
    unsharded run.  Returns ``(state, overflow, npred)``, as the unsharded
    stepper: the ray count, the cap overflow and the predicate populations
    summed over every slab of every process in one ``all_reduce``, so a cap
    overflow anywhere is seen everywhere."""
    per = _lanes_per_device(cfg, mesh)
    _check_lanes(state, per, mesh)
    outs, sums = [], []
    for j, (i, dev) in enumerate(zip(mesh.slabs, mesh.devices)):
        out, overflow, npred = fused_mesh.wavefront_steps_fused_mesh(
            mp, camera, cfg, seed, _slab(state, j, per, dev), n_steps,
            cap_main=cap_main, cap_shadow=cap_shadow, pixel_offset=i * per,
            resident=resident, device=dev)
        outs.append(out)
        sums.append(torch.stack([out.nrays.to(torch.int64),
                                 overflow.to(torch.int64),
                                 *npred.to(torch.int64)]).to(mesh.device))
    total = _sum_over_group(torch.stack(sums).sum(0), mesh)
    nrays = fused.wrap_i32(state.nrays.to(torch.int64) + total[0])
    return _join(outs, mesh.device, nrays), total[1], total[2:4]
