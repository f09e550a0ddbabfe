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
              the procedural meshes and the BVH-stage scene, the RTIOW and
              initial-framework scenes
- ``utils``:  RNG, image and OBJ IO, kernel build and load
"""

__version__ = "0.1.0"
