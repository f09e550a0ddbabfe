"""Entry points of a compile check and a multi-device dry run (port of the
repository's ``__graft_entry__.py``).

``entry`` hands out the flagship model's forward step; ``dryrun_multichip``
runs one sharded inverse-rendering step over a mesh and holds it against
the unsharded one: the image bit equal, the gradients allclose, and the
plain and fused mesh wavefront steppers under the mesh bit equal to
unsharded runs.
"""

from __future__ import annotations

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
from cpu_based_ray_tracer_tpu_torch.parallel import shard
from cpu_based_ray_tracer_tpu_torch.parallel.mesh import Mesh, make_mesh
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes
from cpu_based_ray_tracer_tpu_torch.utils import rng
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def entry(device=None):
    """``(fn, example_args)``: the forward step of the flagship model, one
    progressive-accumulation sample pass of the Monte Carlo Cornell-box
    path tracer at 256x256, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    cfg = RenderConfig(width=256, height=256, spp=1, max_depth=8)

    def forward(scene_, camera_, seed_):
        return monte_carlo.render(scene_, camera_, cfg, seed_, device=dev)

    return forward, (cornell.cornell_scene(dev), cornell.cornell_camera(dev),
                     rng.seed_word(0))


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what} failed")


def _local(x: torch.Tensor, mesh: Mesh, per: int) -> np.ndarray:
    """This process's lanes (its slabs are contiguous) of a whole-image
    plane."""
    return x[mesh.slabs[0] * per:(mesh.slabs[-1] + 1) * per].cpu().numpy()


def dryrun_multichip(n_devices: int, *, mesh: Mesh | None = None,
                     device=None) -> None:
    """One sharded training step (the sharded render, a scalar loss against
    a target image, the gradient w.r.t. the material table summed over the
    mesh, an SGD update) on tiny shapes over ``mesh`` (default: an
    ``n_devices``-slab mesh in this process on ``device``, default the
    card), asserted against the unsharded step: the image bit equal, the
    gradients allclose (rtol 1e-5, atol 1e-7); then the plain and the fused
    mesh wavefront steppers under the mesh, bit equal to unsharded runs on
    this process's lanes (overflow 0)."""
    if mesh is None:
        mesh = make_mesh(n_devices, devices=device)
    n, dev = mesh.n_slabs, mesh.device
    scene, camera = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    cfg = RenderConfig(width=16, height=4 * n, spp=1, max_depth=2)
    seed = rng.seed_word(0)
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                         device=dev)

    def loss_grad(sharded: bool):
        albedo = scene.materials.albedo.clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=albedo))
        img = (shard.render_sharded(s, camera, cfg, seed, mesh) if sharded
               else monte_carlo.render(s, camera, cfg, seed, device=dev))
        loss = torch.mean((img - target) ** 2)
        g, = torch.autograd.grad(loss, albedo)
        return loss.detach(), img.detach(), g, albedo.detach() - 0.1 * g

    loss, img, g, albedo = loss_grad(True)
    _check(albedo.shape == scene.materials.albedo.shape
           and bool(torch.isfinite(loss)), "the sharded SGD step")
    _, img_ref, g_ref, _ = loss_grad(False)
    np.testing.assert_array_equal(img.cpu().numpy(), img_ref.cpu().numpy())
    np.testing.assert_allclose(g.cpu().numpy(), g_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-7)

    per = cfg.height * cfg.width // n
    st = shard.wavefront_init_sharded(scene, camera, cfg, seed, mesh)
    st = shard.wavefront_steps_sharded(scene, camera, cfg, seed, st, 4, mesh)
    st_ref = monte_carlo.wavefront_init(scene, camera, cfg, seed, device=dev)
    st_ref = monte_carlo.wavefront_steps(scene, camera, cfg, seed, st_ref, 4)
    np.testing.assert_array_equal(st.acc.cpu().numpy(),
                                  _local(st_ref.acc, mesh, per))
    _check(int(st.nrays) == int(st_ref.nrays), "the sharded ray count")

    # The fused mesh stepper (csrc/fused_mesh.cu on the card, its plain
    # version on the CPU) under the same mesh.
    mscene = cornell.cornell_mesh_scene(meshes.icosphere(1, radius=1.0),
                                        device=dev)
    n_tri = mscene.triangles.count
    mp = fused_mesh.pack_mesh_scene(
        mscene, gate_mask=np.arange(n_tri) >= 22, cluster_size=64)
    stm = shard.wavefront_init_sharded(mscene, camera, cfg, seed, mesh)
    stm, of_sh, _ = shard.wavefront_steps_fused_mesh_sharded(
        mp, camera, cfg, seed, stm, 3, mesh)
    _check(int(of_sh) == 0, "no cap overflow in the sharded mesh step")
    stm_ref = monte_carlo.wavefront_init(mscene, camera, cfg, seed,
                                         device=dev)
    stm_ref, of_ref, _ = fused_mesh.wavefront_steps_fused_mesh(
        mp, camera, cfg, seed, stm_ref, 3, device=dev)
    _check(int(of_ref) == 0, "no cap overflow in the mesh step")
    np.testing.assert_array_equal(stm.acc.cpu().numpy(),
                                  _local(stm_ref.acc, mesh, per))
    np.testing.assert_array_equal(stm.n_done.cpu().numpy(),
                                  _local(stm_ref.n_done, mesh, per))


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip ok:", torch.cuda.device_count(), "devices")
