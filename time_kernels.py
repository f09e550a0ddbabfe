"""Time two kernels of the port alone in one or more checkouts, each in a
process of its own, in the order given:

- ``k1_ms``: K1 of the fused mesh step (csrc/fused_mesh.cu ``k1_kernel``)
  on ``bench.py``'s ``mc_bunny_mesh_fused`` cell (``cornell_mesh_scene``,
  896x896, depth 16, RR 0.8, caps rp//8 and rp//12), on the state that one
  16-step call from ``wavefront_init`` leaves: 20 launches timed by CUDA
  events with the card kept busy while the host enqueues them, ms a
  launch;
- ``sweep_ms``: the coherent shortlist sweep (csrc/coherent.cu
  ``sweep_kernel``) on ``bvh_stage_scene(4)``'s 896x896 camera rays and
  their lists, 20 launches the same way, ms a launch.

Each metric takes ``repeats`` samples.  Each run saves its outputs (K1's
ten hf planes, its packed lanes and rays as a set, the per-block counts
and the population; the sweep's t and index planes); every run must give
the same bits as the first.  To time variants of a kernel against the
parent commit, unpack each into a directory that .gitignore lists and
give them in an A B B A order:

    python3 time_kernels.py build/parent . . build/parent

Needs a CUDA card.  The output is time_checkouts.py's.
"""

from __future__ import annotations

import inspect

import time_checkouts

SEED = 4070199207          # render_key(0), bench.py's key
WIDTH = HEIGHT = 896
N_LAUNCHES = 20
METRICS = ("k1_ms", "sweep_ms")


def one(root: str, out: str, repeats: int) -> dict:
    """Measure the kernels of the port found under ``root``."""
    time_checkouts.use_checkout(root)
    import torch

    from cpu_based_ray_tracer_tpu_torch import camera
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import coherent, fused
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def busy_ms(launch) -> float:
        sync()
        torch.cuda._sleep(int(20e-3 * 1.98e9))
        ev0.record()
        for i in range(N_LAUNCHES):
            launch(i)
        ev1.record()
        sync()
        return ev0.elapsed_time(ev1) / N_LAUNCHES

    res = {k: [] for k in METRICS}
    saved = {}

    # K1 on the state one 16-step call leaves
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=4, max_depth=16,
                       rr_survival=0.8)
    scene, cam = cornell.cornell_mesh_scene(device=dev), \
        cornell.cornell_camera(dev)
    mp = fm.pack_mesh_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, SEED, device=dev)
    r = st.s.shape[0]
    rp = -(-r // fm.LANES_PER_TILE) * fm.LANES_PER_TILE
    caps = (rp // 8, rp // 12)
    st = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED, st, 16,
                                       cap_main=caps[0], cap_shadow=caps[1],
                                       device=dev)[0]
    p = fm.params(cfg, r, *caps)
    tb = fm._tables(mp, fused._camera_words(cam))
    sf, si = fm.state_planes(st)
    b = fm.step_buffers(r, p, 1, dev)
    bt = b._replace(cnt=torch.zeros((N_LAUNCHES + 1, 2), dtype=torch.int32,
                                    device=dev))

    def k1(i):
        fm.run_op(fm.KERNEL_OPS, "k1", tb, p, SEED, sf, si, bt, k=i)
    k1(N_LAUNCHES)                                               # warm-up
    for _ in range(repeats):
        bt.cnt.zero_()
        res["k1_ms"].append(busy_ms(k1))
    n = int(bt.cnt[0, 0])
    order = torch.argsort(bt.mr_id[:n])
    saved.update(k1_hf=bt.hf, k1_mr_id=bt.mr_id[:n][order],
                 k1_mr=bt.mr[:, :n][:, order],
                 k1_block_counts=bt.offs1[:, 1], k1_cnt=bt.cnt[0])

    # the coherent sweep on the camera rays of bvh_stage_scene(4)
    bscene = meshes.bvh_stage_scene(4, device=dev)
    pack = coherent.pack_coherent(bscene)
    bcam = meshes.bvh_stage_camera(dev)
    d = camera.perspective_rays(bcam, WIDTH, HEIGHT).reshape(-1, 3)
    o = bcam.position.expand(d.shape).contiguous()
    rays, _ = coherent._to_planes(o, d.contiguous(), (HEIGHT, WIDTH))
    ids, cnts = coherent._shortlists(pack.aabb, rays, cfg.t_min)
    # the sweep's arguments in this checkout: the cluster boxes since the
    # per-ray cull
    takes_aabb = "aabb" in inspect.signature(coherent._sweep_kernel).parameters
    args = ((pack.tri, pack.aabb) if takes_aabb else (pack.tri,)) + (
        rays, ids, cnts, cfg.t_min)
    outs = []

    def sweep(i):
        outs.append(coherent._sweep_kernel(*args))
    sweep(0)                                                     # warm-up
    for _ in range(repeats):
        outs.clear()
        res["sweep_ms"].append(busy_ms(sweep))
    saved["sweep_out"] = outs[-1]
    torch.save({k: x.cpu() for k, x in saved.items()}, out)
    return dict(root=root, repeats=repeats, **res)


if __name__ == "__main__":
    time_checkouts.main(__file__, __doc__, one, METRICS, repeats=7,
                        equal_across=True)
