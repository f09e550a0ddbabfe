"""Time the MC north-star render's fused_mc launches in one or more
checkouts of the port, each in a process of its own, in the order given.

The launches are those of ``models.monte_carlo.render_turbo_exact`` on the
Cornell box at 896x896, 4 spp, depth 16, RR 0.8 (bench.py's key): from
``wavefront_init``, chunks of 32, 64, ... steps in the ``stop_after`` mode
until every lane has its 4 samples.  Each checkout replays them alone from
the same initial state, ``repeats`` times, timed with CUDA events (a first
replay warms up), and writes the state planes they leave; every checkout
must leave the same planes, bit for bit.  To compare two commits, unpack
each into a directory that .gitignore lists and give them as A B B A:

    python3 time_mc_render.py build/parent . . build/parent

Needs a CUDA card.  The output is time_checkouts.py's; the state planes
go to build/time_mc_render/.
"""

from __future__ import annotations

import time_checkouts

SEED = 4070199207          # render_key(0), bench.py's key
WIDTH = HEIGHT = 896
SPP, DEPTH, RR = 4, 16, 0.8


def one(root: str, out: str, repeats: int) -> dict:
    """Time the render's launches with the port found under ``root``."""
    time_checkouts.use_checkout(root)
    import torch

    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused, fused_mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    dev = torch.device("cuda")
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, max_depth=DEPTH,
                       rr_survival=RR)
    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    fs, cam16 = fused.pack_scene(scene), fused._camera_words(cam)
    sf0, si0 = fused_mesh.state_planes(mc.wavefront_init(
        scene, cam, cfg, SEED, device=dev))
    r = WIDTH * HEIGHT
    p = fused._Params(1, WIDTH, HEIGHT, r, cfg.t_min, cfg.eps_offset,
                      cfg.rr_survival, cfg.shadow_tolerance, cfg.max_depth,
                      SPP)
    # render_turbo_exact's schedule: double the chunk until every lane is
    # done (one device read a launch, as the render polls).
    sf, si = sf0.clone(), si0.clone()
    chunks, chunk = [], max(32, DEPTH)
    while True:
        fused._steps_kernel(fs, cam16, SEED, sf, si,
                            p._replace(n_steps=chunk))
        chunks.append(chunk)
        if int(si[2].min()) >= SPP:
            break
        chunk *= 2
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for i in range(repeats + 1):                        # the first warms up
        sf.copy_(sf0)
        si.copy_(si0)
        torch.cuda.synchronize()
        ev0.record()
        for c in chunks:
            fused._steps_kernel(fs, cam16, SEED, sf, si,
                                p._replace(n_steps=c))
        ev1.record()
        torch.cuda.synchronize()
        if i:
            times.append(ev0.elapsed_time(ev1))
    torch.save({"sf": sf.cpu(), "si": si.cpu()}, out)
    return dict(root=root, chunks=chunks, lanes=r, ms=times,
                ms_mean=sum(times) / len(times), ms_min=min(times))


if __name__ == "__main__":
    time_checkouts.main(__file__, __doc__, one, ("ms",), repeats=10,
                        equal_across=True)
