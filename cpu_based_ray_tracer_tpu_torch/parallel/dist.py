"""Multi-process wiring on ``torch.distributed`` (port of
``cpu_based_ray_tracer_tpu.parallel.dist``).

The same contract as the JAX package's: every process builds the identical
scene on the host (the constructors are deterministic) and ``replicate``
puts it on its devices, so no scene is ever broadcast; the image rows are
sharded over the global mesh, one slab a process, and the counter-based RNG
makes the N-process render bit equal to the one-process one; the scene's
gradient is summed over the processes in the backward pass
(``parallel.shard``).

Nothing on a machine tells a process of its peers: pass ``init_method``
(``tcp://host:port`` or ``file:///path``), ``world_size`` and ``rank``, or
none of them under ``torchrun``, which sets the environment ``env://``
reads.  ``nccl`` needs a card a process; two processes on one card, or no
card, use ``gloo``, which takes CUDA tensors too.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from cpu_based_ray_tracer_tpu_torch.parallel.mesh import Mesh
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def default_backend(world_size: int | None = None) -> str:
    """``nccl`` when every process on this node can have a card of its own,
    else ``gloo``.  The processes on this node are torchrun's
    ``LOCAL_WORLD_SIZE``; without it, the whole world (``world_size``, else
    ``WORLD_SIZE``), so a world started by hand over several nodes passes
    ``backend`` itself."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    n = int(local) if local else (
        world_size or int(os.environ.get("WORLD_SIZE", "1")))
    if torch.cuda.is_available() and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None) -> None:
    """Join this process to the default process group (a no-op when it is
    already joined).  With no argument, torchrun's ``env://``."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend or default_backend(world_size),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank))


def global_mesh(device=None) -> Mesh:
    """A mesh of one slab a process, over every rank of the default group
    (a world of one when none was joined).  ``device``: this process's
    (default: the card ``LOCAL_RANK`` names, else its rank's, modulo the
    card count; with no card this raises, pass ``device="cpu"``)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(n_slabs=world, slabs=(rank,), devices=(dev,),
                group=dist.group.WORLD if world > 1 else None)


def replicate(tree, mesh: Mesh):
    """A scene or camera (any ``.to``-able value) copied to this process's
    devices: on its first, where its slabs gather (each slab copies it on to
    its own device once a call)."""
    return tree.to(mesh.device)


def local_rows(global_image: torch.Tensor, mesh: Mesh) -> dict:
    """This process's row slabs of a row-sharded image as
    ``{row0: ndarray}`` (the per-process piece of the frame, for host-side
    IO)."""
    rows = global_image.shape[0] // mesh.n_slabs
    return {i * rows: np.asarray(
        global_image[i * rows:(i + 1) * rows].detach().cpu())
        for i in mesh.slabs}
