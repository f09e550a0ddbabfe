"""Time the gradient paths of the port in one or more checkouts, each in a
process of its own, in the order given: ``tools/bench_passes.py``'s
``gradstep`` cells.

Each run measures, on the card, ``repeats`` samples of each pass (CUDA
events after a warm call), the gradient of mean(render(albedo)^2) w.r.t.
the albedo table:

- ``cornell_std_ms`` / ``cornell_record_ms`` / ``cornell_replay_ms``:
  ``cornell_scene``, 448x448, 4 spp, depth 8; the standard engine
  (``monte_carlo.render`` and ``loss.backward``), ``record_trace``, and the
  replay (``render_from_trace`` and its backward);
- ``mesh_std_ms`` / ``mesh_record_ms`` / ``mesh_replay_ms``: the same on
  ``cornell_mesh_scene`` (the icosphere stand-in, 1,302 triangles) through
  ``csrc/packet.cu``, 448x448, 2 spp, depth 8; the standard engine with
  ``make_intersect_fn(sort_rays=True, differentiable=True)``, the record
  pass with ``make_intersect_fn`` / ``make_nearest_t_fn(sort_rays=True)``.

It also profiles one standard and one replay step of each cell with
``torch.profiler`` and reports the kernels with the most device time, the
device time summed over every kernel, the kernel launches and the step's
wall time (device time / wall time is the card's busy share).  The losses
and images are saved (the gradients are summed by atomics, so their last
bits may vary): every run must give the same bits.  To compare two commits, unpack each into a
directory that .gitignore lists and give them as A B B A:

    python3 time_grad.py build/parent . . build/parent

Needs a CUDA card.  The output is time_checkouts.py's; the saved tensors
go to build/time_grad/.
"""

from __future__ import annotations

import time

import time_checkouts

SEED = 4070199207          # render_key(0), bench.py's key
SIZE = 448
METRICS = tuple(f"{c}_{p}_ms" for c in ("cornell", "mesh")
                for p in ("std", "record", "replay"))


def _profile(fn, top: int = 8) -> dict:
    """Device time of one fn() call by kernel (the kernels' own events, so
    no operator's time is counted twice), the kernel launches, and the
    call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key[:72], e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"wall_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [list(r) for r in rows[:top]]}


def one(root: str, out: str, repeats: int) -> dict:
    """Measure the passes with the port found under ``root``."""
    time_checkouts.use_checkout(root)
    import torch

    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    dev = torch.device("cuda")
    cam = cornell.cornell_camera(dev)
    msc = cornell.cornell_mesh_scene(device=dev)
    bundle = mesh.prepare(msc, method="packet")
    cells = {
        "cornell": (cornell.cornell_scene(dev),
                    RenderConfig(width=SIZE, height=SIZE, spp=4,
                                 max_depth=8), {}, None),
        "mesh": (msc, RenderConfig(width=SIZE, height=SIZE, spp=2,
                                   max_depth=8),
                 dict(intersect_fn=mesh.make_intersect_fn(bundle,
                                                          sort_rays=True),
                      nearest_t_fn=mesh.make_nearest_t_fn(bundle,
                                                          sort_rays=True)),
                 mesh.make_intersect_fn(bundle, sort_rays=True,
                                        differentiable=True))}
    res, saved = {"root": root}, {}
    for name, (scene, cfg, fns, dif) in cells.items():
        a0 = scene.materials.albedo

        def with_albedo(a, scene=scene):
            return scene.replace(materials=scene.materials.replace(albedo=a))

        def std(scene=scene, cfg=cfg, fns=fns, dif=dif, a0=a0,
                with_albedo=with_albedo):
            a = a0.clone().requires_grad_(True)
            kw = dict(fns, **({} if dif is None else {"intersect_fn": dif}))
            img = mc.render(with_albedo(a), cam, cfg, SEED, device=dev, **kw)
            loss = torch.mean(img ** 2)
            loss.backward()
            return loss.detach(), img.detach()

        def record(scene=scene, cfg=cfg, fns=fns):
            return mc.record_trace(scene, cam, cfg, SEED, dev, **fns)

        recs = record()

        def rep(cfg=cfg, a0=a0, with_albedo=with_albedo, recs=recs):
            a = a0.clone().requires_grad_(True)
            img = mc.render_from_trace(with_albedo(a), cam, cfg, SEED, recs,
                                       dev)
            loss = torch.mean(img ** 2)
            loss.backward()
            return loss.detach(), img.detach()

        for p, fn in (("std", std), ("record", record), ("replay", rep)):
            fn()
            samples = []
            for _ in range(repeats):
                ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                ev0.record()
                fn()
                ev1.record()
                torch.cuda.synchronize()
                samples.append(ev0.elapsed_time(ev1))
            res[f"{name}_{p}_ms"] = samples
        for p, fn in (("std", std), ("replay", rep)):
            res[f"{name}_{p}_profile"] = _profile(fn)
            loss, img = fn()
            saved[f"{name}_{p}_loss"] = loss.cpu()
            saved[f"{name}_{p}_image"] = img.cpu()
    torch.save(saved, out)
    return res


if __name__ == "__main__":
    time_checkouts.main(__file__, __doc__, one, METRICS, repeats=5,
                        equal_across=True)
