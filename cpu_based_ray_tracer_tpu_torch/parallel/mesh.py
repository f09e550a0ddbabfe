"""The 1-D mesh of image row slabs (port of
``cpu_based_ray_tracer_tpu.parallel.mesh``).

JAX shards the row axis over a ``jax.sharding.Mesh`` of devices.  Here a
``Mesh`` names the same thing directly: the global slab count, the slabs
this process renders, one device for each of them, and the
``torch.distributed`` process group that joins the processes (``None`` in
a world of one).  Slab ``i`` holds rows ``[i * H / n, (i + 1) * H / n)``;
the slabs of a process are contiguous and in order.
"""

from __future__ import annotations

import dataclasses

import torch

from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_slabs: int                        # global slab count
    slabs: tuple                        # this process's slab indices
    devices: tuple                      # torch.device of each local slab
    group: object = None                # process group; None: one process

    @property
    def device(self) -> torch.device:
        """Where this process's slabs are gathered (its first slab's)."""
        return self.devices[0]


def _devices(devices) -> list:
    if devices is None:
        dev = resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] or [dev]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    return [resolve_device(d) for d in devices]


def make_mesh(n_devices: int | None = None, *, devices=None) -> Mesh:
    """A mesh of ``n_devices`` slabs (default: one a device) in this
    process, over ``devices`` round robin (default: every CUDA device; with
    no card this raises, pass ``devices="cpu"``).  On one card, ``n`` slabs
    share it, as the JAX tests' virtual CPU devices share one CPU."""
    devs = _devices(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one slab, not {n}")
    return Mesh(n_slabs=n, slabs=tuple(range(n)),
                devices=tuple(devs[i % len(devs)] for i in range(n)))


def replicated(mesh: Mesh) -> tuple:
    """Where a replicated value (the scene, the camera) lives: one copy on
    each distinct device of this process's slabs."""
    return tuple(dict.fromkeys(mesh.devices))


def row_sharded(mesh: Mesh, height: int) -> list:
    """This process's slabs of an image of ``height`` rows, as
    ``(row0, n_rows)``.  Raises ValueError when the slab count does not
    divide the height, as the JAX package does."""
    n = mesh.n_slabs
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    rows = height // n
    return [(i * rows, rows) for i in mesh.slabs]
