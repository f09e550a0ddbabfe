"""PyTorch + CUDA port of ``cpu_based_ray_tracer_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its module names so
each counterpart is easy to find, and holds every piece against it in the
``tests/test_torch_*.py`` files.  It imports ``torch`` and numpy only.

Entry points (``models.monte_carlo.render_turbo_exact``,
``ops.fused_whitted.render_fused``, ``models.mesh.render``,
``ops.fused_rtiow.render_fused``, ``models.denoiser.render_sequence`` and
friends) run
on the card unless the caller passes ``device="cpu"``; on a CUDA tensor every
kernel wrapper launches its hand-written kernel (``csrc/*.cu``, built with
``nvcc`` at first use by ``utils.kernels``) and on a CPU tensor it runs the
kernel's plain PyTorch version.

Subpackages
-----------
- ``ops``:    vector math, intersection, light sampling, tonemap, the BVH
              build, the denoising filters, and the wrappers of the
              kernels: the fused MC wavefront (``fused``, with the
              Denoiser's single-path mode), the fused RTIOW path tracer
              (``fused_rtiow``), the fused Whitted tree
              (``fused_whitted``), the packet and coherent mesh
              intersectors (``packet``, ``coherent``) and the fused mesh MC
              stepper (``fused_mesh``)
- ``models``: the Monte Carlo path tracer, the Whitted ray tree, the BVH
              mesh stage, the RTIOW stages (``offline``, ``nppt``,
              ``initial``) and the Denoiser
- ``scenes``: the Cornell box (and its mesh variant), the Whitted scene,
              the procedural meshes, the BVH-stage scene and scenes from an
              OBJ + MTL, the RTIOW and initial-framework scenes
- ``parallel``: row-sharded rendering and stepping over a mesh of row
              slabs, in one process or one slab a ``torch.distributed``
              rank (``parallel.worker`` runs one rank of a check)
- ``utils``:  RNG (and the JAX package's seed word), image and OBJ / MTL
              IO, kernel build and load, checkpoint / resume, profiling,
              the native BVH builder and OBJ loader, reference-image
              statistics
- ``tools``:  ``make_goldens`` (the golden tiers, and their check)

``python -m cpu_based_ray_tracer_tpu_torch`` is the CLI (``__main__``);
``graft_entry`` holds the compile-check entry and the sharded dry run.
"""

__version__ = "0.1.0"
