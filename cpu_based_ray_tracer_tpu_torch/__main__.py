"""Application layer: ``python -m cpu_based_ray_tracer_tpu_torch`` (port of
``python -m cpu_based_ray_tracer_tpu``).

A headless CLI that renders any evolution stage to PNG/PPM, runs long
progressive renders with checkpoint/resume, sweeps the Denoiser's parameter
matrix, and drives a scripted fly-camera sequence with temporal
reaccumulation.

Subcommands
-----------
render     one image of any stage:      --stage mc --spp 256 --out img.png
           (stages: offline initial nppt whitted mesh mesh-mc mc denoiser)
           resumable MC accumulation:   --checkpoint state.npz (Ctrl-C safe)
           profiled:                    --trace-dir DIR (a Chrome trace)
sweep      denoiser parameter matrix -> grid of PNGs + manifest
fly        scripted WASD/mouse camera path through Cornell, denoised 1-SPP
           frames with temporal reprojection
artifacts  render every golden artifact of a tier into --outdir
           (default build/goldens/), or with --check compare them with
           goldens/<tier>/ (tools/make_goldens.py of this package)

Everything runs on the card; ``--cpu`` runs the plain PyTorch engines on
the CPU instead, and without it a machine with no card raises.  The choice
of engine follows the JAX package's per backend: on the card the fused
kernels (``render_turbo_exact``, ``fused_rtiow.render_fused``,
``fused_mesh.render_turbo_mesh``), with ``--cpu`` the engines the JAX
package runs on its CPU backend.  ``--seed k`` draws the JAX package's
samples for the same ``k`` (``utils.rng.seed_word``).  The JAX CLI's
``bench`` (``bench.py``, which measures the JAX package) has no
counterpart here.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time


def _u8(img, gamma):
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap

    return tonemap.quantize_u8(img, gamma).cpu().numpy()


def _write(path, u8):
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    if path.endswith(".ppm"):
        im.write_ppm(path, u8)
    else:
        im.write_png(path, u8)
    print("wrote", path)


# ---------------------------------------------------------------------------
# Stage registry: stage name -> (linear image, display gamma).  Display
# conventions follow the reference: offline/NPPT gamma-correct, the later
# GUI stages display linear radiance.
# ---------------------------------------------------------------------------

def render_stage(stage: str, cfg, seed: int, device):
    """(linear (H, W, 3) image, display gamma) of ``stage`` on ``device``:
    the engine the JAX CLI picks for that backend."""
    from cpu_based_ray_tracer_tpu_torch.models import (
        denoiser as dmodel, initial, mesh as mesh_model, monte_carlo, nppt,
        offline, whitted)
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh, fused_rtiow
    from cpu_based_ray_tracer_tpu_torch.scenes import (
        cornell, initial_scene, meshes, rtiow, whitted_scene)

    dev = device
    card = dev.type == "cuda"
    if stage == "offline":
        scene = rtiow.offline_two_sphere_scene(dev)
        cam = rtiow.offline_camera(cfg.width / cfg.height, device=dev)
        render = fused_rtiow.render_fused if card else offline.render
        return render(scene, cam, cfg, seed, device=dev), cfg.gamma
    if stage == "initial":
        return initial.render(initial_scene.initial_scene(dev),
                              initial_scene.initial_camera(dev), cfg, seed,
                              device=dev), 1.0
    if stage == "nppt":
        render = fused_rtiow.render_fused if card else nppt.render
        return render(rtiow.nppt_scene(dev), rtiow.nppt_camera(dev), cfg,
                      seed, device=dev), cfg.gamma
    if stage == "whitted":
        return whitted.render(whitted_scene.whitted_scene(dev),
                              whitted_scene.whitted_camera(dev), cfg,
                              device=dev), 1.0
    if stage == "mesh":
        bundle = mesh_model.prepare(meshes.bunny_teapot_scene(dev))
        return mesh_model.render(bundle, meshes.bvh_stage_camera(dev), cfg,
                                 device=dev), 1.0
    if stage == "mesh-mc":
        scene = cornell.cornell_mesh_scene(device=dev)  # bunny or stand-in
        cam = cornell.cornell_camera(dev)
        if card:
            return fused_mesh.render_turbo_mesh(scene, cam, cfg, seed,
                                                device=dev), 1.0
        bundle = mesh_model.prepare(scene, method="packet")
        return mesh_model.render_mc(bundle, cam, cfg, seed, device=dev), 1.0
    if stage == "mc":
        scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
        # The fused kernel in equal-spp mode on the card: the reference's
        # fixed-spp estimator, the same samples as the CPU engine.
        render = (monte_carlo.render_turbo_exact if card
                  else monte_carlo.render_fast)
        return render(scene, cam, cfg, seed, device=dev), 1.0
    if stage == "denoiser":
        scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
        params = dmodel.DenoiserParams(jbf_half_size=16)
        prev, color = None, None
        for i in range(max(cfg.spp, 1)):   # spp doubles as history frames
            color, prev = dmodel.render_frame(scene, cam, cfg, seed, i, prev,
                                              params, device=dev)
        return color, 1.0
    raise SystemExit(f"unknown stage {stage!r}")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _render_image(args, cfg, seed: int, log):
    """(linear image, display gamma) of ``render``'s stage, or of its
    checkpointed MC accumulation."""
    from cpu_based_ray_tracer_tpu_torch.utils import checkpoint as ckpt

    dev = args.device
    if args.checkpoint and args.stage == "mc":
        # Long-run progressive MC with interrupt/resume: accumulate in
        # chunks, checkpoint (accum, samples_done, seed) after each chunk.
        import torch

        from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
        from cpu_based_ray_tracer_tpu_torch.scenes import cornell

        scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
        chunk = cfg.replace(spp=min(args.checkpoint_every, cfg.spp))
        acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                          device=dev)
        done = 0
        if os.path.exists(args.checkpoint):
            acc, done, saved_seed = ckpt.load_render_state(
                args.checkpoint, chunk, device=dev)
            if saved_seed != seed:
                raise SystemExit(
                    f"checkpoint {args.checkpoint} was accumulated with seed "
                    f"word {saved_seed}, not that of --seed {args.seed} "
                    f"({seed}) — mixing RNG streams in one accumulator "
                    "would bias the image; pass the original seed (or a "
                    "fresh path)")
            print(f"resumed at {done}/{cfg.spp} spp")
        t0 = time.time()
        while done < cfg.spp:
            acc, done = monte_carlo.render_wavefront(scene, cam, chunk, seed,
                                                     acc, done, device=dev)
            ckpt.save_render_state(args.checkpoint, acc, done, seed, chunk)
            log.emit("mc_chunk", spp_done=done, spp_target=cfg.spp,
                     seconds=time.time() - t0)
            print(f"{done}/{cfg.spp} spp ({time.time() - t0:.0f}s)",
                  flush=True)
        # Normalize by the samples actually accumulated: chunks advance in
        # steps of checkpoint-every, so `done` may exceed cfg.spp (--spp 50
        # --checkpoint-every 32 accumulates 64), and a resumed state may
        # already be past the target.
        return acc / float(max(done, 1)), 1.0
    t0 = time.time()
    img, gamma = render_stage(args.stage, cfg, seed, dev)
    _sync(dev)
    print(f"rendered {args.stage} in {time.time() - t0:.1f}s")
    log.emit("render_done", stage=args.stage, seconds=time.time() - t0)
    return img, gamma


def cmd_render(args):
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.utils import profiling, rng

    dev = args.device
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, rr_survival=args.rr)
    seed = rng.seed_word(args.seed)
    log = profiling.RunLog(args.runlog)
    log.emit("render_start", stage=args.stage, config=dataclasses.asdict(cfg),
             seed=args.seed, backend=dev.type)

    with (profiling.device_trace(args.trace_dir) if args.trace_dir
          else contextlib.nullcontext()):
        img, gamma = _render_image(args, cfg, seed, log)
    _write(args.out, _u8(img, gamma))
    log.close()


def cmd_sweep(args):
    """Denoiser parameter matrix (the reference's Control Panel buttons):
    JBF kernel x temporal blend x clamping, each re-running the 1-SPP
    pipeline with fresh history."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dmodel
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell
    from cpu_based_ray_tracer_tpu_torch.utils import rng

    dev = args.device
    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    cfg = RenderConfig(width=args.width, height=args.height, max_depth=16,
                       rr_survival=0.8)
    seed = rng.seed_word(args.seed)
    os.makedirs(args.outdir, exist_ok=True)
    manifest = {}
    for jbf in args.jbf:
        for alpha in args.alpha:
            for clamp in ([True, False] if args.clamp_ablation else [True]):
                p = dmodel.DenoiserParams(
                    jbf_half_size=jbf, current_frame_weighting=alpha,
                    immediate_clamping=clamp)
                prev, color = None, None
                for i in range(args.frames):
                    color, prev = dmodel.render_frame(scene, cam, cfg, seed,
                                                      i, prev, p, device=dev)
                name = f"jbf{jbf}_a{int(alpha * 100)}" + (
                    "" if clamp else "_noclamp")
                _write(os.path.join(args.outdir, name + ".png"),
                       _u8(color, 1.0))
                manifest[name] = dataclasses.asdict(p)
    with open(os.path.join(args.outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def fly_cameras(n_frames: int, device):
    """The scripted fly path: strafe right, then walk forward while yawing
    left (parallax everywhere); one ``PerspectiveCamera`` a frame."""
    import numpy as np

    from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    base = cornell.cornell_camera()
    ctl = cam_mod.FlyCameraController(
        position=np.asarray(base.position, np.float64),
        forward=np.asarray(base.forward, np.float64),
        up=np.asarray(base.up, np.float64),
        vfov_degrees=float(base.vfov_degrees))
    script = ([({"d"}, (0.0, 0.0))] * (n_frames // 2)
              + [({"w"}, (-2.0, 0.0))] * (n_frames - n_frames // 2))
    cameras = []
    for keys, mouse in script:
        ctl = ctl.moved(keys, mouse, dt=0.05)
        cameras.append(ctl.camera(device))
    return cameras


def cmd_fly(args):
    """Scripted fly-camera path: WASD/mouse input frames fed to
    FlyCameraController, each pose rendered 1-SPP and temporally denoised
    against the moving history (motion-vector reprojection)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dmodel
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell
    from cpu_based_ray_tracer_tpu_torch.utils import rng

    dev = args.device
    cfg = RenderConfig(width=args.width, height=args.height, max_depth=16,
                       rr_survival=0.8)
    params = dmodel.DenoiserParams(jbf_half_size=args.jbf)
    frames = dmodel.render_sequence(
        cornell.cornell_scene(dev), fly_cameras(args.frames, dev), cfg,
        rng.seed_word(args.seed), params, device=dev)
    os.makedirs(args.outdir, exist_ok=True)
    for i, fr in enumerate(frames):
        _write(os.path.join(args.outdir, f"frame_{i:03d}.png"), _u8(fr, 1.0))


def cmd_artifacts(args):
    from cpu_based_ray_tracer_tpu_torch.tools import make_goldens

    rc = make_goldens.main(
        ["--tier", args.tier, "--outdir", args.outdir]
        + (["--cpu"] if args.cpu else []) + (["--check"] if args.check
                                             else []))
    if rc:
        raise SystemExit(rc)


def main(argv=None):
    from cpu_based_ray_tracer_tpu_torch.tools.make_goldens import OUT_DIR
    from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m cpu_based_ray_tracer_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain engines on the CPU (default: the "
                         "card; without one this raises)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render one stage to PNG/PPM")
    r.add_argument("--stage", default="mc",
                   choices=["offline", "initial", "nppt", "whitted", "mesh",
                            "mesh-mc", "mc", "denoiser"])
    r.add_argument("--width", type=int, default=400)
    r.add_argument("--height", type=int, default=400)
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--depth", type=int, default=16)
    r.add_argument("--rr", type=float, default=0.8)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out", default="render.png")
    r.add_argument("--checkpoint", default=None,
                   help="npz path: MC renders resume from it if present")
    r.add_argument("--checkpoint-every", type=int, default=32,
                   help="spp per checkpointed chunk")
    r.add_argument("--runlog", default=None,
                   help="append structured JSON-lines run records here "
                        "(default: print them)")
    r.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of the render "
                        "(the program's spans and the card's kernels) "
                        "into this directory")
    r.set_defaults(fn=cmd_render)

    s = sub.add_parser("sweep", help="denoiser parameter-matrix sweep")
    s.add_argument("--width", type=int, default=256)
    s.add_argument("--height", type=int, default=256)
    s.add_argument("--frames", type=int, default=8)
    s.add_argument("--jbf", type=int, nargs="+", default=[7, 16, 32])
    s.add_argument("--alpha", type=float, nargs="+", default=[0.1, 0.2, 0.5])
    s.add_argument("--clamp-ablation", action="store_true")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--outdir", default="sweep_out")
    s.set_defaults(fn=cmd_sweep)

    f = sub.add_parser("fly", help="scripted fly-camera denoised sequence")
    f.add_argument("--width", type=int, default=256)
    f.add_argument("--height", type=int, default=256)
    f.add_argument("--frames", type=int, default=16)
    f.add_argument("--jbf", type=int, default=16)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--outdir", default="fly_out")
    f.set_defaults(fn=cmd_fly)

    a = sub.add_parser("artifacts", help="render the golden artifacts")
    a.add_argument("--tier", default="test", choices=["test", "showcase",
                                                      "all"])
    a.add_argument("--outdir", default=OUT_DIR,
                   help="where the artifacts go (never goldens/)")
    a.add_argument("--check", action="store_true",
                   help="render the tier and compare it with the committed "
                        "goldens/<tier>/ (exit 1 on drift)")
    a.set_defaults(fn=cmd_artifacts)

    args = ap.parse_args(argv)
    args.device = resolve_device("cpu" if args.cpu else None)
    args.fn(args)


if __name__ == "__main__":
    main()
