"""One rank of a multi-process check of the sharded renderers.

    python -m cpu_based_ray_tracer_tpu_torch.parallel.worker \\
        --init-method file:///tmp/pg --world-size 2 --rank 0 \\
        --out DIR --spec '{"device": "cpu", "render": {...}, ...}'

Joins the process group, builds ``dist.global_mesh()`` and runs the cases
the JSON ``spec`` names, each with a ``RenderConfig``'s fields
(``width``, ``height``, ``spp``, ``max_depth``, ``rr_survival``) and
``seed`` (the u32 seed word):

- ``render``: ``render_sharded``; saves this rank's rows (``row<r0>``);
- ``grad``: the gradient w.r.t. the albedo table of ``mean(img)``
  (``"loss": "mean"``) or ``mean(img ** 2)`` (``"mean_sq"``); saves it
  (``grad``);
- ``wavefront``: ``wavefront_init_sharded`` + ``wavefront_steps_sharded``
  for ``n_steps``; saves this rank's planes (``wf_<plane>``) and ``nrays``;
- ``fused_mesh``: the fused mesh stepper on ``cornell_mesh_scene`` (the
  icosphere of ``subdivisions`` when given, gated from triangle
  ``gate_from`` in clusters of ``cluster_size`` when given) for
  ``n_steps``; saves its planes (``fm_<plane>``), ``nrays``, overflow and
  populations;
- ``dryrun``: ``graft_entry.dryrun_multichip`` over the global mesh.

Writes ``rank<r>.npz`` into ``--out`` and prints ``RANK_OK <r>`` and a
JSON line of each case's seconds, its collectives (``all_reduce`` and
``all_gather`` calls, counted by wrapping them) and its
``csrc/fused_mesh.cu`` launches (the wrappers' counts, set to 0 before the
case).  Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.parallel.shard import PLANES

_FIELDS = {f.name for f in dataclasses.fields(RenderConfig)}


def config(case: dict) -> RenderConfig:
    return RenderConfig(**{k: v for k, v in case.items() if k in _FIELDS})


class Collectives:
    """Counts the calls of ``torch.distributed.all_reduce`` and
    ``all_gather`` while it is entered."""

    def __init__(self):
        self.counts = {"all_reduce": 0, "all_gather": 0}

    def __enter__(self):
        self._saved = {k: getattr(dist, k) for k in self.counts}
        for k, fn in self._saved.items():
            setattr(dist, k, self._counted(k, fn))
        return self

    def _counted(self, k, fn):
        def call(*a, **kw):
            self.counts[k] += 1
            return fn(*a, **kw)
        return call

    def __exit__(self, *exc):
        for k, fn in self._saved.items():
            setattr(dist, k, fn)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(spec: dict, out_dir: str) -> dict:
    from cpu_based_ray_tracer_tpu_torch import graft_entry
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
    from cpu_based_ray_tracer_tpu_torch.parallel import dist as pdist
    from cpu_based_ray_tracer_tpu_torch.parallel import shard
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

    mesh = pdist.global_mesh(device=spec.get("device"))
    dev = mesh.device
    rank = dist.get_rank()
    scene = pdist.replicate(cornell.cornell_scene(), mesh)
    cam = pdist.replicate(cornell.cornell_camera(), mesh)
    saved, report = {}, {"rank": rank, "device": str(dev),
                         "backend": dist.get_backend()}

    def timed(name, fn):
        _sync(dev)
        dist.barrier()
        fused_mesh.LAUNCHES.reset()
        with Collectives() as c:
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            report[name] = {"seconds": time.perf_counter() - t0,
                            "collectives": c.counts,
                            "fused_mesh_launches":
                                fused_mesh.LAUNCHES.snapshot()}
        return out

    if "render" in spec:
        case = spec["render"]
        img = timed("render", lambda: shard.render_sharded(
            scene, cam, config(case), case["seed"], mesh))
        for r0, rows in pdist.local_rows(img, mesh).items():
            saved[f"row{r0}"] = rows
    if "grad" in spec:
        case = spec["grad"]

        def grad():
            albedo = scene.materials.albedo.clone().requires_grad_(True)
            s = scene.replace(materials=scene.materials.replace(
                albedo=albedo))
            img = shard.render_sharded(s, cam, config(case), case["seed"],
                                       mesh)
            loss = torch.mean(img ** 2 if case.get("loss") == "mean_sq"
                              else img)
            loss.backward()
            return albedo.grad
        saved["grad"] = timed("grad", grad).cpu().numpy()
    if "wavefront" in spec:
        case = spec["wavefront"]
        cfg = config(case)

        def steps():
            st = shard.wavefront_init_sharded(scene, cam, cfg, case["seed"],
                                              mesh)
            return shard.wavefront_steps_sharded(
                scene, cam, cfg, case["seed"], st, case["n_steps"], mesh)
        st = timed("wavefront", steps)
        saved.update({f"wf_{f}": getattr(st, f).cpu().numpy()
                      for f in PLANES + ("nrays",)})
    if "fused_mesh" in spec:
        case = spec["fused_mesh"]
        cfg = config(case)
        sub = case.get("subdivisions")
        mscene = cornell.cornell_mesh_scene(
            None if sub is None else meshes.icosphere(sub, radius=1.0),
            device=dev)
        gate = case.get("gate_from")
        mp = fused_mesh.pack_mesh_scene(
            mscene, gate_mask=(None if gate is None else
                               np.arange(mscene.triangles.count) >= gate),
            cluster_size=case.get("cluster_size", 128))

        def steps():
            st = shard.wavefront_init_sharded(mscene, cam, cfg, case["seed"],
                                              mesh)
            return shard.wavefront_steps_fused_mesh_sharded(
                mp, cam, cfg, case["seed"], st, case["n_steps"], mesh)
        st, overflow, npred = timed("fused_mesh", steps)
        saved.update({f"fm_{f}": getattr(st, f).cpu().numpy()
                      for f in PLANES + ("nrays",)})
        saved["fm_overflow"] = overflow.cpu().numpy()
        saved["fm_npred"] = npred.cpu().numpy()
    if spec.get("dryrun"):
        timed("dryrun", lambda: graft_entry.dryrun_multichip(
            mesh.n_slabs, mesh=mesh))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--spec", required=True, help="JSON object of cases")
    args = ap.parse_args(argv)
    from cpu_based_ray_tracer_tpu_torch.parallel import dist as pdist

    pdist.initialize(args.init_method, args.world_size, args.rank,
                     args.backend)
    try:
        report = run(json.loads(args.spec), args.out)
    finally:
        dist.destroy_process_group()
    print(f"RANK_OK {args.rank}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
