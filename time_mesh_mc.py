"""Time the mesh-MC main paths in one or more checkouts of the port, each in
a process of its own, in the order given.

Each run measures, on the card, with `repeats` samples of each:

- ``step_ms``: the fused mesh stepper on ``bench.py``'s
  ``mc_bunny_mesh_fused`` cell (``cornell_mesh_scene``, 896x896, depth 16,
  RR 0.8, caps rp//8 and rp//12): ms a step over 3 calls of 16 steps after
  a warm-up call, the host's clock around synchronised calls;
- ``occl_ms`` / ``occl_busy_ms``: the resident occlusion entry point alone
  on one step's state (whatever it launches: the sweep, and the grouping
  where the checkout groups the shadow rays), 20 launches timed by CUDA
  events back to back, and again with the card kept busy while the host
  enqueues them;
- ``render_s``: ``render_turbo_mesh_exact`` on that cell at 4 spp, seconds;
- ``render_mc_s``: ``models.mesh.render_mc`` through ``packet`` on
  ``cornell_mesh_scene`` at 128x128, 4 spp (128 launches of 16,384 rays),
  seconds.

The two images of each run are saved; every run of one checkout must give
the same bits, and the summary says whether the checkouts agree.  To
compare two commits, unpack each into a directory that .gitignore lists
and give them as A B B A:

    python3 time_mesh_mc.py build/parent . . build/parent

Needs a CUDA card.  The output is time_checkouts.py's; the images go to
build/time_mesh_mc/.
"""

from __future__ import annotations

import time

import time_checkouts

SEED = 4070199207          # render_key(0), bench.py's key
WIDTH = HEIGHT = 896
METRICS = ("step_ms", "occl_ms", "occl_busy_ms", "render_s", "render_mc_s")


def one(root: str, out: str, repeats: int) -> dict:
    """Measure the paths with the port found under ``root``."""
    time_checkouts.use_checkout(root)
    import dataclasses

    import torch

    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=4, max_depth=16,
                       rr_survival=0.8)
    scene, cam = cornell.cornell_mesh_scene(device=dev), \
        cornell.cornell_camera(dev)
    mp = fm.pack_mesh_scene(scene)
    st0 = mc.wavefront_init(scene, cam, cfg, SEED, device=dev)
    r = st0.s.shape[0]
    rp = -(-r // fm.LANES_PER_TILE) * fm.LANES_PER_TILE
    caps = (rp // 8, rp // 12)
    kw = dict(cap_main=caps[0], cap_shadow=caps[1], device=dev)
    res = {k: [] for k in METRICS}

    # the stepper: a warm-up call, then 3 calls of 16 steps a sample
    st = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED, st0, 16, **kw)[0]
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            st, of, _ = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED, st,
                                                      16, **kw)
            int(of)             # one device read a call, as the render
        sync()
        res["step_ms"].append((time.perf_counter() - t0) / 48 * 1e3)

    # the occlusion entry point alone on the state one real step leaves
    p = fm.params(cfg, r, *caps)
    tb = fm._tables(mp, fused._camera_words(cam))
    sf, si = fm.state_planes(st)
    b = fm.step_buffers(r, p, 1, dev)
    fm.run_steps(fm.KERNEL_OPS, tb, p, SEED, sf.clone(), si.clone(), 1, b)
    n_it = 20
    bt = b._replace(cnt=b.cnt[0:1].repeat(n_it + 1, 1))
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def occl_ms(busy: bool) -> float:
        sync()
        if busy:
            torch.cuda._sleep(int(20e-3 * 1.98e9))
        ev0.record()
        for i in range(n_it):
            fm.run_op(fm.KERNEL_OPS, "occl", tb, p, SEED, sf, si, bt, k=i)
        ev1.record()
        sync()
        return ev0.elapsed_time(ev1) / n_it
    occl_ms(True)                                          # warm-up
    for _ in range(repeats):
        res["occl_ms"].append(occl_ms(False))
        res["occl_busy_ms"].append(occl_ms(True))

    # the 4-spp render and the packet MC oracle, each after a warm-up
    small = dataclasses.replace(cfg, width=128, height=128)
    bundle = mesh.prepare(cornell.cornell_mesh_scene())
    calls = {"render_s": lambda: fm.render_turbo_mesh_exact(
                 scene, cam, cfg, SEED, device=dev),
             "render_mc_s": lambda: mesh.render_mc(
                 bundle, cornell.cornell_camera(), small, SEED, device=dev)}
    images = {}
    for name, call in calls.items():
        images[name] = call()
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            img = call()
            sync()
            res[name].append(time.perf_counter() - t0)
            if not torch.equal(img.view(torch.int32),
                               images[name].view(torch.int32)):
                raise RuntimeError(f"{name}: two calls gave other images")
    torch.save({k: v.cpu() for k, v in images.items()}, out)
    return dict(root=root, repeats=repeats, **res)


if __name__ == "__main__":
    time_checkouts.main(__file__, __doc__, one, METRICS, repeats=5,
                        equal_across=False)
