"""Row sharding and multi-process helpers (port of
``cpu_based_ray_tracer_tpu.parallel``).

The JAX package shards the image's row axis over a device mesh with
``shard_map``, the scene replicated.  Here a ``Mesh`` of row slabs runs in
one process over its local devices (``make_mesh``), or one slab a process
over a ``torch.distributed`` group (``dist.global_mesh``); the renderers
and steppers of ``shard`` take either.
"""

from cpu_based_ray_tracer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, replicated, row_sharded)
from cpu_based_ray_tracer_tpu_torch.parallel.shard import (  # noqa: F401
    render_sharded, render_tiles, wavefront_init_sharded,
    wavefront_steps_fused_mesh_sharded, wavefront_steps_sharded)
