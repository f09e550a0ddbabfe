"""Drive the PyTorch port on one NVIDIA GPU through its main paths — the
Monte Carlo Cornell path tracer, the Whitted stage, the BVH mesh stage
(packet and fused shortlist intersectors), the fused mesh Monte Carlo
stage (resident and shortlist-streaming sweeps), the RTIOW stages (offline
prototype and NPPT), the Denoiser, the gradients of the Monte Carlo
path (standard and record / replay engines, inverse rendering), row-sharded
rendering (in one process and over two ranks) and the CLI — and hold
every kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device     the card's name, power limit and clocks (nvidia-smi);
2. build      every csrc/*.cu of the port, one nvcc each, started together,
              into build/torch_kernels/; then sass: cuobjdump -sass of
              fused_mc, fused_mesh, coherent, fused_whitted and denoise
              (instructions per kernel; the listing under
              build/chip_smoke/);
3. parity     the fused_mc kernel against its plain version: Cornell at
              896x896 from wavefront_init for 32 steps (plain mode and
              stop_after=4), and Cornell + one sphere at 256x256; then
              render_turbo_exact's launches at 896x896 (32 and 64 steps,
              stop_after=4; lanes retire) against the plain version in
              lockstep: every plane bit equal after each;
4. golden     render_turbo_exact at 128x128, 64 spp, RR 0.8, depth 16 against
              goldens/test/mc_cornell.png (mean abs diff <= 2, p99 <= 16);
5. main       the MC main path at full width: render_turbo_exact at 896x896,
              4 spp, depth 16, RR 0.8; the image goes to build/; its
              fused_mc launches replayed alone (ms), their live
              lane-steps and shadow rays counted untimed, and the bound
              of that work;
6. speed      the fused stepper at 896x896 as bench.py times the JAX one
              (256 steps per call, 4 calls after a warm-up), the kernel
              alone with CUDA events, and the plain version over 16 steps;
7. whitted_parity  the fused_whitted kernel against render_fused_plain
              (truncated == 0 in both, every pixel within 1e-6) and against
              the ray-tree twin models.whitted.render (truncated == 0, p99
              < 1e-4, pixels off by more than 1e-3 below 0.5%), 896x896,
              depth 5, Q=4;
8. whitted_golden  models.whitted.render and render_fused at 128x128 against
              goldens/test/whitted.png (gamma 1, mean <= 1.0, p99 <= 4);
9. mesh_main  mesh.render(prepare(bvh_stage_scene())) at 896x896, depth 5,
              through the packet kernel (the whole image one chunk: the
              chunk is reported), against method="brute" and against the
              Whitted twin in each chunk of PACKET_CHUNKS (every pixel
              within rtol 1e-5, atol 1e-6); the image goes to build/; the
              shadow rays toward light 0 that it sends are kept;
10. mesh_parity  the packet kernel against nearest_plain on the 896x896
              camera rays of bvh_stage_scene (3,584 triangles), on the
              shadow rays kept from mesh_main, on 8,192 triangles in
              64-triangle clusters, and on one 16,384-ray chunk of the
              camera rays (hit masks and indices equal, t within rtol
              1e-6); then packet_in_render: the packet kernel inside
              mesh.render and inside the Whitted twin at each chunk of
              PACKET_CHUNKS (the frame's seconds; each launch replayed
              alone on the rays it was given, summed, beside the summed
              bound; the eager share), and the fastest chunk;
11. whitted_main  render_fused at 896x896, depth 5, Q=4; image to build/;
12. mesh_mc    mesh.render_mc through the packet kernel against
              method="brute" on cornell_mesh_scene, 128x128, 4 spp, depth 16
              (every pixel's radiance within 2e-3);
13. whitted_speed, packet_speed  each new kernel alone with CUDA events
              beside its plain version: ms per 896x896 Whitted frame (with
              the plain version's tally of each level's live slots by kind
              and the slot sections and branches 32-lane warps would run
              one slot at a time), ms per 802,816-ray packet pass on camera
              and on shadow rays and per 16,384-ray launch;
14. mesh_fused_parity  on cornell_mesh_scene at 896x896 from
              wavefront_init: each of the five csrc/fused_mesh.cu entry
              points against its plain version for one step (outputs bit
              equal, packed lane sets equal, each block's slice in lane
              order; the groupings of the main and of the shadow rays
              against group_plain), the grouped nearest and occlusion
              sweeps bit equal to their plain versions at every one of 16
              steps, then the whole stepper against
              wavefront_steps_fused_mesh_plain for 16 steps, plain mode and
              stop_after=4 (integer state, overflow 0, populations);
15. mesh_fused_main  render_turbo_mesh_exact at 896x896, 4 spp, depth 16,
              RR 0.8 (5 launches a step, no packet launch), the chunk and
              cap-doubling trace, image to build/; then render_turbo_mesh,
              the mesh-mc stage's call;
16. mesh_fused_oracle  render_turbo_mesh_exact against mesh.render_mc
              (packet) at 128x128, 4 spp, depth 16: rtol = atol = 2e-3 on
              all but 1e-4 of the pixels;
17. mesh_fused_speed  bench.py's mc_bunny_mesh_fused (896x896, caps rp//8
              and rp//12, 16 steps a call, 3 calls after a warm-up) in
              rays/s, and each entry point alone in ms per step beside its
              plain version and its bound (a sweep's: each packed ray's
              box tests over its list and the triangle tests of the
              clusters whose boxes it crosses, from the mask pass's
              per-ray planes; K1's: each lane's small primitives and the
              predicate's box tests up to its first crossed box, after the
              boxes' hull); each sweep also unsplit (each output bit
              equal to the plain one); each sweep op's grouping and its
              sweep each alone, the sweep also in pack order, and the
              boxes a warp's rays cross before and after grouping;
18. mesh_fused_whitted_main  mesh.render(prepare(bvh_stage_scene(4),
              method="fused")) at 896x896, depth 5 (7,424 triangles, 58
              clusters; no packet launch), against method="packet" at rtol
              1e-4, atol 1e-5 on every pixel but exact-t ties, each listed;
              image to build/; its light-0 shadow rays are kept; then both
              methods' frames timed warm (median, min, max of 7);
19. coherent_parity  csrc/coherent.cu's mask and sweep kernels against
              mask_plain / sweep_plain (masks, tile words, ids, counts, t
              and indices equal: the lists the mask kernel writes against
              _lists of the plain words, mask_plain's word and group box
              cull against the flat mask; the sweep at its default slice
              count and at each of SWEEP_SLICES) on the camera rays, those
              shadow rays, and the hit pixels' shadow rays compacted
              (strip tiles);
20. coherent_speed  the two kernels alone per 896x896 camera pass beside
              packet.cu on the same rays (the mask kernel as the lists run
              it, with and without the lists, and the host's wall around
              back-to-back shortlist calls; the sweep at each slice count,
              also on the shadow and compacted rays), the plain versions,
              the bounds (the mask's: each lane's tests of the cluster
              boxes it crosses, at least one, against its bytes; beside it
              the flat count, every lane against every cluster, and the
              kernel's own tests a lane and a warp; the sweep's: each
              ray's box tests over its
              tile's list and the rows whose triangle's box it crosses;
              beside it the kernel's own work, its 8-row groups, and the
              crossed and listed clusters' triangles; the boxes, groups
              and rows listed and crossed a ray and a warp);
21. mesh_fused_164k  tools/bench_passes.py's mc_mesh_fused_164k (two
              icospheres(6), 163,862 triangles, 1,280 clusters: past the
              SMEM budget, so resident=None takes the shortlists):
              render_turbo_mesh_exact 896x896 8 spp; 16 steps with
              resident=False against resident=True (integer state,
              populations, overflow 0); one step of each shortlist sweep
              against its plain version, and the mask kernel on each
              sweep's packed rays against the plain mask pass and lists
              (planes, tile words, ids, counts equal), with the list
              lengths;
22. sl_speed  the 164k cell timed as bench_passes' scale_case (caps rp//8
              and rp//16, 16 steps a call, 3 calls after a warm-up) in both
              modes; each shortlist sweep and the mask pass alone (with and
              without the lists) beside the all-cluster sweep on the same
              packed rays, and the bounds (the mask's as in 20);
              each shortlist sweep split and unsplit as in 17 (the slices
              K, the grid, blocks per SM; every output bit equal to the
              plain one) and the occlusion sweep's triangle tests, serial
              and by independent slices (the kernel's at most these); the
              list lengths of the step's primary, bounce and shadow rays as
              packed and sorted by lane;
23. rtiow_parity  csrc/fused_rtiow.cu against its plain version for 64
              steps from render_fused's initial state at full width: the
              offline cell (thin lens, 400x225, 100 spp, depth 50), its
              depth-of-field camera on the classic scene, and the NPPT cell
              (perspective, 883x824, 256 spp, with the glass bubble):
              integer planes equal on all but 1e-4 of the lanes (listed),
              float planes on agreeing lanes within 2e-3;
24. rtiow_golden  render_fused at tools/make_goldens.py's offline_rtiow,
              offline_dof and nppt configurations against their goldens
              (mean abs diff <= 1.5, p99 <= 8);
25. rtiow_main  the two headline renders through render_fused (one
              launch each): offline 400x225 100 spp depth 50 and NPPT
              883x824 256 spp depth 50, with their launch counts and
              seconds; images to build/; each against the lockstep render
              of the same cell by the step-mode kernel under the chunk
              schedule and by the plain version: every state plane bit
              equal to both; the render launch alone and the bound of every
              live lane-step of the render;
26. rtiow_speed  the step-mode kernel alone on the NPPT cell, 128 steps
              from render_fused's initial state (every lane live) in ms per
              step of 727,592 lanes, the plain version on the same steps
              (every plane bit equal), and the bound of the work those
              steps need (each live lane-step's spheres, plus its miss or
              its material's branch);
27. denoiser_parity  the single_path mode of csrc/fused_mc.cu against its
              plain version at 896x896, depth 16, RR 0.8: ids and the
              contributor flag equal, color within 2e-3, position and normal
              within 1e-4; every state and G-buffer plane bit equal;
28. denoiser_golden  the three denoiser_* goldens (128x128, 4 frames, JBF
              16) through the fused engine (mean <= 2, p99 <= 16); the
              denoised frames bit equal to those of the a-trous levels'
              plain twin on the card;
29. denoiser_main  render_sequence(engine="fused") over 12 frames of a
              static camera at 896x896, depth 16, RR 0.8, DenoiserParams():
              seconds per frame, one fused_mc launch and three
              csrc/denoise.cu launches a frame, every frame bit equal to
              the plain twin's; image to build/;
30. single_path_speed  one single_path launch alone, its plain version,
              the bound of its live lane-steps and shadow rays; then
              denoise_atrous_speed: each a-trous level of the default
              filter (half-size 7: steps 1, 2, 4) on an 896x896 fused
              G-buffer, one csrc/denoise.cu launch alone (ms), its plain
              twin (ms, bit equal), and the bound of its work (each
              in-frame tap's accumulation, each weighted tap's guidance
              terms; four planes in, one out);
31. mc_equal_spp  tools/bench_passes.py's mc_equal_spp: render_wavefront
              (the plain equal-spp engine, no kernel) at 896x896, 4 spp,
              depth 16, RR 0.8: seconds (median, min, max of 3 warm runs),
              rays/s, spp/s, steps and host polls, beside
              render_turbo_exact's seconds; against render_turbo_exact
              (<= 1e-4 of the pixels off by more than 2e-3 + 2e-3 |want|)
              and, at 1 spp, its ray count equal to count_rays';
32. mc_equal_spp_golden  render_wavefront at 128x128, 64 spp, against
              goldens/test/mc_cornell.png (mean <= 2, p99 <= 16);
33. slabs     wavefront_init / wavefront_steps at 896x896, 16 steps, on two
              slabs cut on a row boundary and off one: every plane bit
              equal to the whole image's state;
34. min_spp   render_turbo(min_spp=1) and render_turbo() at 896x896, 4 spp:
              launches and seconds; min(n_done) reaches the target at the
              last launch, the image bit equal to the launches replayed;
35. soft_shadow  soft_shadow_beta > 0: soft_visibility card against CPU on
              65,536 segments (1e-6); render and render_wavefront at
              896x896, 4 spp, beta 0.05 (seconds; finite, mean > 0) and at
              32x32 card against CPU (2e-3); beta 1e-4 against the hard test
              (every pixel within 1e-3 at tests/test_grad.py's 16x16, at
              most 0.5% of the pixels beyond it at 128x128); make_soft_vis_fn
              on cornell_mesh_scene against brute (rtol = atol = 2e-4), and
              mesh.render_mc through packet at 128x128, 4 spp, beta 0.05
              (seconds, packet launches, 0 pixels off against brute);
36. grad_step_cornell  tools/bench_passes.py's gradstep cell: the gradient
              of mean(render(albedo)^2) w.r.t. the albedo table on
              cornell_scene at 448x448, 4 spp, depth 8, by the standard
              engine (render, backward), record_trace and the replay
              (render_from_trace, backward): each timed (median of 3 CUDA-
              event timings after a warm call) with its peak memory, the
              speedups of a material stage (standard / replay) and of a
              geometry stage (standard / (replay + record)), whether the
              losses are bit equal; gates: the two engines' gradients
              allclose (rtol 1e-4, atol 1e-6), finite, the replay image
              against render's (rtol 1e-4, atol 4e-6; unequal pixels
              counted);
37. grad_step_mesh_bunny  the same on cornell_mesh_scene (the icosphere(3)
              stand-in for the bunny, 1,302 triangles), 448x448, 2 spp,
              depth 8, through csrc/packet.cu: the standard engine with
              make_intersect_fn(sort_rays=True, differentiable=True), the
              record pass with make_intersect_fn / make_nearest_t_fn
              (sort_rays=True); packet launches in each pass (the replay
              none);
38. inverse   recover_albedo on Cornell at 448x448, 4 spp, depth 8,
              engine="replay", 20 steps (seconds a step, loss ratio), and
              tests/test_inverse.py's convergence checks at 24x24 on the
              card (albedo: loss down 10x, error < 0.08; emission: loss
              down 10x, relative error < 0.15);
39. sharded   row sharding in this process, 2 slabs sharing the card:
              render_sharded (Cornell 896x896, 4 spp, depth 16, RR 0.8)
              bit equal to monte_carlo.render; wavefront_*_sharded (16
              steps) and wavefront_steps_fused_mesh_sharded
              (cornell_mesh_scene, 16 steps, csrc/fused_mesh.cu: its
              launches counted) on every plane bit equal to the unsharded
              runs, overflow 0; each timed beside the unsharded run;
40. sharded_ranks  two ranks on the card, each a process
              (parallel.worker; gloo, file:// rendezvous): the 896x896 rows
              bit equal, grad_step_cornell's gradient (448x448, 4 spp,
              depth 8) on every rank allclose to the unsharded one (rtol
              1e-4, atol 1e-6: the gradstep gate of tools/bench_passes.py;
              dryrun_multichip's 16-pixel-wide cell at rtol 1e-5, atol
              1e-7), the plain and fused mesh steppers bit
              equal, one collective a stepper call, dryrun_multichip over
              the ranks; each rank's seconds and fused_mesh launches;
41. cli       python -m cpu_based_ray_tracer_tpu_torch in this process:
              every render stage at 64x64 (the mesh stage reports the
              missing OBJ assets), fly, render --stage mc at 896x896 4 spp
              bit equal to render_turbo_exact, checkpoint and resume on the
              card (and a resume under another seed refused), artifacts
              --tier test --check against goldens/test/.

Each main path (5, 9, 11, 12, 15, 18, 21, 25, 29, 31, 34, 35, the sharded
fused mesh call of 39, each CLI render of 41, and each pass of 36, 37 and
38) runs with every launch counter set to 0 just before it and read just
after; the packet, fused_mc, fused_rtiow and fused_mesh lines of the
kernels line hold their launches by path.  Then
the kernels line, the nvidia-smi line, and the last line {"ok": true,
"device": {...}}.  Exits non-zero, printing no result, where CUDA is not
available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.work.bounds import PEAK_BYTES, PEAK_F32_FLOPS, mc_ops

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")

# u32 seed words of the JAX package's rng.seed_from_key(rng.render_key(k)):
# computed there (jax.random.bits of the key); the port takes the word.
SEED_KEY0 = 4070199207   # render_key(0): bench.py's key, the main path
SEED_KEY2 = 2752176745   # render_key(2): tools/make_goldens.mc_cornell
SEED_KEY15 = 1709130268  # render_key(15): tests/test_grad.py's beta limit

# H100 SXM peaks (NVIDIA data sheet, 700 W; portbench/work/bounds.py, with
# mc_ops): float32 outside the tensor cores (counting an FMA as two
# operations) and HBM bandwidth; every bound_ms is taken at these.  Beside it each kernel prints bound_no_fma_ms,
# its operations at one a lane a clock (132 SMs of 128 FP32 lanes at the
# 1,980 MHz boost clock, 33.45e12 a second): the port builds every kernel
# with -fmad=false, so no counted add or multiply fuses into an FMA, and
# that is the least time this build can take.  No kernel calls fmaf: the
# FFMAs in fused_mc's SASS come from the IEEE division, square root and
# sine/cosine sequences, which the counts charge as one operation each.
N_SM, F32_LANES_PER_SM, BOOST_HZ = 132, 128, 1.98e9
PEAK_F32_NO_FMA = N_SM * F32_LANES_PER_SM * BOOST_HZ

TOL = 2e-3                # the JAX package's float tolerance for lane state
MAX_INT_MISMATCH = 1e-4   # share of lanes whose (s, b, n_done) may differ
# The Whitted gate of tests/test_fused_whitted.py: p99 of the abs error and
# the share of knife-edge pixels (max channel error above 1e-3).
WHITTED_P99, KNIFE_EDGE, KNIFE_SHARE = 1e-4, 1e-3, 0.005
# The fused_whitted kernel against its plain version: a few ulp of a
# radiance near 1 (the two run the same operations in the same order).
PLAIN_ATOL = 1e-6
# models.whitted through two intersectors, on every pixel
# (tests/test_whitted.py:117).
WHITTED_RTOL, WHITTED_ATOL = 1e-5, 1e-6

# f32 add/sub/mul/div/sqrt/min/max counted in csrc/fused_whitted.cu and
# csrc/packet.cu (comparisons, selects and integer work not counted, so the
# bounds derived from them are floors).
TRI_OPS = 48        # one Moller-Trumbore ray/triangle test
SPH_OPS = 30        # one ray/sphere quadratic
SLOT_OPS = 40       # per live Whitted slot after the hit: normal, point,
                    # chessboard, colors
DIFFUSE_OPS = 32    # per Blinn-Phong hit: shading point, final rgb
LIGHT_OPS = 53      # per light of a Blinn-Phong hit, besides its shadow ray
SPECULAR_OPS = 131  # per specular hit: Fresnel, reflect, Snell, origins
SLAB_OPS = 22       # one ray/cluster-AABB slab test


def emit(**kw):
    print(json.dumps(kw), flush=True)


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]


def compare_states(got, want) -> dict:
    """Integer lane state (s, b, n_done): the share of lanes that differ.
    Float state: max abs error on the lanes that agree, and whether it is
    within rtol = atol = TOL."""
    bad = torch.zeros_like(got.s, dtype=torch.bool)
    for f in ("s", "b", "n_done"):
        bad |= getattr(got, f) != getattr(want, f)
    agree = ~bad
    max_err, within = 0.0, True
    for f in ("o", "d", "tp", "cur", "acc"):
        a, b = getattr(got, f)[agree], getattr(want, f)[agree]
        err = (a - b).abs()
        if err.numel():
            max_err = max(max_err, float(err.max()))
            within &= bool((err <= TOL + TOL * b.abs()).all())
    n_bad = int(bad.sum())
    return dict(lanes=int(bad.numel()), int_mismatch_lanes=n_bad,
                int_mismatch_share=n_bad / bad.numel(),
                nrays_equal=bool(got.nrays == want.nrays),
                max_abs_err=max_err, float_within_tol=within)


def build_phase():
    from cpu_based_ray_tracer_tpu_torch.utils import kernels

    sources = sorted(f[:-3] for f in os.listdir(kernels.CSRC)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    kernels.build(sources)
    emit(phase="build", sources=sources,
         seconds=time.perf_counter() - t0,
         ptxas={k: [ln for ln in v.splitlines() if "registers" in ln
                    or "spill" in ln or "entry function" in ln]
                for k, v in kernels.BUILD_LOG.items()})


def sass_phase(names=("fused_mc", "fused_mesh", "coherent",
                      "fused_whitted", "denoise")) -> dict:
    """cuobjdump -sass of the built libraries: each kernel's static
    instruction count, and its loops (a branch back to an earlier address)
    of 30 or more instructions with their f32 arithmetic, shared loads and
    special functions: the triangle loops, whose length is what a lane
    issues per triangle (per two where a loop is unrolled).  The whole
    listing goes under build/chip_smoke/."""
    import re

    from cpu_based_ray_tracer_tpu_torch.utils import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    os.makedirs(OUT, exist_ok=True)
    res = {}
    for name in names:
        sass = subprocess.run([tool, "-sass", kernels._target(name)[1]],
                              check=True, capture_output=True, text=True,
                              timeout=120).stdout
        with open(os.path.join(OUT, f"{name}.sass"), "w") as f:
            f.write(sass)
        code = {}
        for ln in sass.splitlines():
            if "Function :" in ln:
                kern = ln.split("Function :")[1].strip()
                code[kern] = []
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if m and code:
                ins = m.group(2).split()
                op = ins[1] if ins[0].startswith("@") else ins[0]
                code[kern].append((int(m.group(1), 16), op.split(".")[0],
                                   m.group(2)))
        res[name] = {}
        for kern, ins in code.items():
            at = {a: i for i, (a, _, _) in enumerate(ins)}
            loops = []
            for i, (a, op, text) in enumerate(ins):
                m = re.search(r"BRA\b.*?0x([0-9a-f]+)", text)
                if op == "BRA" and m and int(m.group(1), 16) < a:
                    body = [o for _, o, _ in ins[at.get(int(m.group(1), 16),
                                                        i):i + 1]]
                    if 30 <= len(body) < len(ins) // 2:
                        loops.append({"instructions": len(body), **{
                            k: body.count(k) for k in ("FMUL", "FADD",
                                                       "FFMA", "LDS",
                                                       "MUFU")}})
            res[name][kern] = {"instructions": len(ins), "loops": loops}
    emit(phase="sass", kernels=res,
         listing={n: os.path.relpath(os.path.join(OUT, f"{n}.sass"), ROOT)
                  for n in names})
    return res


def parity_phase(dev, full: RenderConfig, sphere_size: int,
                 n_steps: int) -> float:
    """The kernel against its plain version; returns the max abs error."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.scene import make_spheres
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    sphere_scene = scene.replace(
        spheres=make_spheres((1.6, 2.6, 1.7), 0.7, 0, dev))
    cases = [(f"cornell_{full.width}", scene, full, 0),
             (f"cornell_{full.width}_stop_after_4", scene, full, 4),
             (f"cornell_sphere_{sphere_size}", sphere_scene,
              full.replace(width=sphere_size, height=sphere_size), 0)]
    max_err = 0.0
    for label, sc, cfg, stop_after in cases:
        fs = fused.pack_scene(sc)
        st = mc.wavefront_init(sc, cam, cfg, SEED_KEY0, device=dev)
        want = fused.wavefront_steps_fused_plain(fs, cam, cfg, SEED_KEY0, st,
                                                 n_steps,
                                                 stop_after=stop_after)
        got = fused.wavefront_steps_fused(fs, cam, cfg, SEED_KEY0, st,
                                          n_steps, stop_after=stop_after,
                                          device=dev)
        sync(dev)
        res = compare_states(got, want)
        res["bit_equal"] = states_bit_equal(got, want)
        emit(phase="parity", case=label, n_steps=n_steps,
             stop_after=stop_after, **res)
        if (res["int_mismatch_share"] > MAX_INT_MISMATCH
                or not res["float_within_tol"] or not res["bit_equal"]):
            raise RuntimeError(f"fused_mc disagrees with its plain version "
                               f"on {label}: {res}")
        max_err = max(max_err, res["max_abs_err"])

    # The main path's launches: render_turbo_exact's chunks at full width
    # (lanes retire; most enter the second launch done), against the plain
    # version run in lockstep: every plane bit equal after each launch.
    fs = fused.pack_scene(scene)
    got = want = mc.wavefront_init(scene, cam, full, SEED_KEY0, device=dev)
    for chunk in render_chunks(full):
        want = fused.wavefront_steps_fused_plain(fs, cam, full, SEED_KEY0,
                                                 want, chunk,
                                                 stop_after=full.spp)
        got = fused.wavefront_steps_fused(fs, cam, full, SEED_KEY0, got,
                                          chunk, stop_after=full.spp,
                                          device=dev)
        sync(dev)
        res = compare_states(got, want)
        res["bit_equal"] = states_bit_equal(got, want)
        emit(phase="parity", case=f"render_launch_{full.width}",
             n_steps=chunk, stop_after=full.spp,
             lanes_done=int((want.n_done >= full.spp).sum()), **res)
        if not res["bit_equal"]:
            raise RuntimeError(f"fused_mc's render launch of {chunk} steps "
                               f"differs from its plain version: {res}")
        if int(torch.min(want.n_done)) >= full.spp:
            break
    return max_err


def render_chunks(cfg: RenderConfig):
    """render_turbo_exact's launch sizes (it stops at the first whose end
    finds every pixel done)."""
    chunk = max(32, cfg.max_depth)
    for _ in range(cfg.spp * cfg.max_depth):
        yield chunk
        chunk = min(2 * chunk, 4096)


def states_bit_equal(got, want) -> bool:
    """Every plane of two lane states equal bit for bit (floats as int32
    words: -0.0 and +0.0 differ)."""
    for f in ("s", "b", "n_done", "nrays"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            return False
    return all(torch.equal(getattr(got, f).contiguous().view(torch.int32),
                           getattr(want, f).contiguous().view(torch.int32))
               for f in ("o", "d", "tp", "cur", "acc"))


def golden_phase(dev, gcfg: RenderConfig, mean_tol=2.0, p99_tol=16):
    """render_turbo_exact against goldens/test/mc_cornell.png, with the
    rule of tests/test_golden.assert_close_u8."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    t0 = time.perf_counter()
    img = mc.render_turbo_exact(cornell.cornell_scene(dev),
                                cornell.cornell_camera(dev), gcfg, SEED_KEY2,
                                device=dev)
    u8 = tonemap.quantize_u8(img, gamma=1.0).cpu().numpy()
    secs = time.perf_counter() - t0
    gold = im.read_png(os.path.join(ROOT, "goldens", "test",
                                    "mc_cornell.png"))
    if u8.shape != gold.shape:
        raise RuntimeError(f"golden shape {gold.shape}, render {u8.shape}")
    d = np.abs(u8.astype(np.int32) - gold.astype(np.int32))
    g_mean, g_p99 = float(d.mean()), float(np.percentile(d, 99))
    emit(phase="golden", seconds=secs, mean_abs_diff=g_mean, p99=g_p99,
         mean_tol=mean_tol, p99_tol=p99_tol)
    if not (g_mean <= mean_tol and g_p99 <= p99_tol):
        raise RuntimeError("render_turbo_exact disagrees with "
                           "goldens/test/mc_cornell.png")


def main_phase(dev, full: RenderConfig) -> int:
    """The main path once, with the launch counter set to 0 just before and
    read just after; returns the launches."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused, tonemap
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    os.makedirs(OUT, exist_ok=True)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    img = mc.render_turbo_exact(scene, cam, full, SEED_KEY0, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = fused.LAUNCHES["fused_mc"]
    png = os.path.join(OUT, f"mc_cornell_{full.width}_{full.spp}spp.png")
    im.write_png(png, tonemap.quantize_u8(img, gamma=2.0).cpu().numpy())
    finite = bool(torch.isfinite(img).all())
    mean_rad = float(img.mean())
    work = render_work(dev, full, scene, cam, launches)
    emit(phase="main", config=f"{full.width}x{full.height} {full.spp}spp "
         f"depth{full.max_depth} rr{full.rr_survival}", seconds=secs,
         shape=list(img.shape), finite=finite, mean_radiance=mean_rad,
         launches={"fused_mc": launches}, png=os.path.relpath(png, ROOT),
         **work)
    if dev.type == "cuda" and launches <= 0:
        raise RuntimeError("the main path launched no fused_mc kernel")
    if (tuple(img.shape) != (full.height, full.width, 3) or not finite
            or not mean_rad > 0.0):
        raise RuntimeError("the main path's image is wrong")
    return launches, work


def render_work(dev, full: RenderConfig, scene, cam, launches: int,
                n_iters: int = 5) -> dict:
    """The 4-spp render's fused_mc launches replayed alone from
    wavefront_init (CUDA events, ms for all of them), and the work they
    need, counted untimed by stepping the kernel one step a launch: the
    live lane-steps (a lane whose quota is not met at the step's start)
    and the shadow rays; the bound charges mc_ops to those, and the lane
    state read and written once a launch."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    fs = fused.pack_scene(scene)
    cam16 = fused._camera_words(cam)
    sf0, si0 = fused.state_planes(mc.wavefront_init(
        scene, cam, full, SEED_KEY0, device=dev))
    r = full.width * full.height
    p = fused._Params(1, full.width, full.height, r, full.t_min,
                      full.eps_offset, full.rr_survival,
                      full.shadow_tolerance, full.max_depth, full.spp)
    chunks = list(render_chunks(full))[:launches]
    n = torch.zeros(2, dtype=torch.int64, device=dev)
    sf, si = sf0.clone(), si0.clone()
    for _ in range(sum(chunks)):
        live = (si[2] < full.spp).sum()
        fused._steps_kernel(fs, cam16, SEED_KEY0, sf, si, p)
        n += torch.stack([live, si[3].sum()])
    live, shadow = (int(x) for x in n)

    def replay():
        for c in chunks:
            fused._steps_kernel(fs, cam16, SEED_KEY0, sf, si,
                                p._replace(n_steps=c))
    ms = 0.0
    for i in range(n_iters + 1):                        # the first warms up
        sf.copy_(sf0)
        si.copy_(si0)
        t = timed(replay)
        ms += t / n_iters if i else 0.0
    nbytes = (15 + 4) * 4 * 2 * r * len(chunks)
    return dict(kernel_ms=ms, kernel_launch_steps=chunks,
                live_lane_steps=live, lane_steps_launched=r * sum(chunks),
                live_share=live / (r * sum(chunks)),
                live_steps_per_pixel=live / r, shadow_rays=shadow,
                **{"kernel_" + k: v for k, v in bound(
                    mc_ops(fs.n_tri, fs.n_sph, live, shadow),
                    nbytes).items()})



def speed_phase(dev, full: RenderConfig, max_sm_mhz: float, smi: str,
                n_steps=256, n_iters=4, n_plain=16) -> dict:
    """Rays/s and ms/step of the fused stepper as bench.py times the JAX
    one; the kernel alone and the plain version with CUDA events."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    fs = fused.pack_scene(scene)
    state0 = mc.wavefront_init(scene, cam, full, SEED_KEY0, device=dev)
    st = fused.wavefront_steps_fused(fs, cam, full, SEED_KEY0, state0,
                                     n_steps, device=dev)      # warm-up
    sync(dev)
    st = dataclasses.replace(st, nrays=torch.zeros_like(st.nrays))
    t0 = time.perf_counter()
    for _ in range(n_iters):
        st = fused.wavefront_steps_fused(fs, cam, full, SEED_KEY0, st,
                                         n_steps, device=dev)
    sync(dev)
    dt = time.perf_counter() - t0
    rays = int(st.nrays)
    if rays < 0:
        raise RuntimeError("ray counter wrapped")

    # The kernel alone: events around launches on prepared state planes.
    r = full.width * full.height
    cam16 = fused._camera_words(cam)
    sf = torch.cat([x.T for x in (state0.o, state0.d, state0.tp,
                                  state0.cur, state0.acc)], 0).contiguous()
    si = torch.stack([state0.s, state0.b, state0.n_done,
                      torch.zeros_like(state0.s)]).contiguous()
    p = fused._Params(n_steps, full.width, full.height, r, full.t_min,
                      full.eps_offset, full.rr_survival,
                      full.shadow_tolerance, full.max_depth, 0)
    fused._steps_kernel(fs, cam16, SEED_KEY0, sf, si, p)       # warm-up
    sfc, sic = sf.clone(), si.clone()
    kernel_ms = timed(lambda: [fused._steps_kernel(
        fs, cam16, SEED_KEY0, sf, si, p) for _ in range(n_iters)]
    ) / (n_iters * n_steps)
    plain_ms = timed(lambda: fused.wavefront_steps_fused_plain(
        fs, cam, full, SEED_KEY0, state0, n_plain)) / n_plain
    # The timed launches again from the same state, untimed, for the shadow
    # rays they trace (every lane is live at every step in this mode).
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        fused._steps_kernel(fs, cam16, SEED_KEY0, sfc, sic, p)
        shadow += sic[3].sum()
    shadow = int(shadow)

    flops = mc_ops(fs.n_tri, fs.n_sph, r * n_steps * n_iters,
                   shadow) / (n_iters * n_steps)
    bytes_per_step = (15 + 4) * 4 * 2 * r / n_steps   # state in + out per call
    res = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
               **bound(flops, bytes_per_step))
    emit(phase="speed", nvidia_smi=smi, lanes=r, n_steps=n_steps,
         n_iters=n_iters, rays_per_s=rays / dt,
         ms_per_step=dt / (n_iters * n_steps) * 1e3,
         kernel_ms_per_step=kernel_ms, plain_ms_per_step=plain_ms,
         shadow_ray_share=shadow / (r * n_steps * n_iters),
         flops_per_step=flops, bound_ms_per_step=res["bound_ms"],
         bound_no_fma_ms_per_step=res["bound_no_fma_ms"],
         bound_no_fma_issue_rate_ms_per_step=flops / (
             N_SM * F32_LANES_PER_SM * max_sm_mhz * 1e6) * 1e3,
         max_sm_mhz=max_sm_mhz)
    return res


# --- the Whitted and mesh stages --------------------------------------------

def reset_counts():
    # the six kernel modules register their launch counters when imported
    from cpu_based_ray_tracer_tpu_torch.ops import (  # noqa: F401
        coherent, fused, fused_mesh, fused_rtiow, fused_whitted, packet)
    from cpu_based_ray_tracer_tpu_torch.utils import profiling

    profiling.reset_counters()


def read_counts() -> dict:
    """The launches since ``reset_counts`` by kernel module: fused_mc,
    fused_whitted, fused_rtiow and packet as numbers, fused_mesh, coherent
    and denoise by entry point."""
    from cpu_based_ray_tracer_tpu_torch.utils import profiling

    return profiling.read_counters()


def image_gate(got, want) -> dict:
    """The Whitted gate's numbers for two (H, W, 3) images."""
    d = (got - want).abs().float()
    return dict(max_abs_err=float(d.max()),
                p99=float(torch.quantile(d.flatten(), 0.99)),
                knife_edge_share=float((d.amax(-1) > KNIFE_EDGE)
                                       .float().mean()))


def pixels_off(got, want, rtol: float, atol: float) -> dict:
    """Max abs error, and the pixels with a channel off by more than
    atol + rtol * |want|."""
    d = (got - want).abs()
    off = (d > atol + rtol * want.abs()).any(-1)
    return dict(max_abs_err=float(d.max()), rtol=rtol, atol=atol,
                pixels_off=int(off.sum()))


def check_gate(res: dict, what: str):
    if not (res["p99"] < WHITTED_P99 and res["knife_edge_share"] < KNIFE_SHARE):
        raise RuntimeError(f"{what} fails the Whitted gate: {res}")


def whitted_ops(n_tri, n_sph, n_light, counts) -> int:
    """f32 operations of one frame of csrc/fused_whitted.cu for the work
    this data needs (live slots, Blinn-Phong hits, specular hits)."""
    trace = n_tri * TRI_OPS + n_sph * SPH_OPS
    return (counts["live"] * (trace + SLOT_OPS)
            + counts["diffuse"] * (DIFFUSE_OPS + n_light * (LIGHT_OPS + trace))
            + counts["specular"] * SPECULAR_OPS)


def whitted_parity_phase(dev, cfg) -> tuple:
    """The kernel against its plain version and against the ray-tree twin;
    returns (max abs error vs plain, plain's work counts)."""
    from cpu_based_ray_tracer_tpu_torch.models import whitted
    from cpu_based_ray_tracer_tpu_torch.ops import fused_whitted as fw
    from cpu_based_ray_tracer_tpu_torch.scenes import whitted_scene as ws

    scene, cam = ws.whitted_scene(dev), ws.whitted_camera(dev)
    got, trunc = fw.render_fused(scene, cam, cfg, queue=4, device=dev)
    counts = {}
    plain, trunc_p = fw.render_fused_plain(scene, cam, cfg, queue=4,
                                           device=dev, counts=counts)
    t0 = time.perf_counter()
    twin = whitted.render(scene, cam, cfg, device=dev)
    sync(dev)
    twin_s = time.perf_counter() - t0
    vs_plain, vs_twin = image_gate(got, plain), image_gate(got, twin)
    emit(phase="whitted_parity", config=f"{cfg.width}x{cfg.height} depth"
         f"{cfg.whitted_depth} Q4", truncated=float(trunc),
         truncated_plain=float(trunc_p), vs_plain=vs_plain, vs_twin=vs_twin,
         twin_seconds=twin_s, work=counts)
    if float(trunc) != 0.0 or float(trunc_p) != 0.0:
        raise RuntimeError("the Q=4 queue truncated weight on the reference "
                           "scene")
    if not vs_plain["max_abs_err"] <= PLAIN_ATOL:
        raise RuntimeError(f"fused_whitted disagrees with render_fused_plain "
                           f"by more than {PLAIN_ATOL}: {vs_plain}")
    check_gate(vs_twin, "fused_whitted vs models.whitted.render")
    return vs_plain["max_abs_err"], counts


def whitted_golden_phase(dev, mean_tol=1.0, p99_tol=4):
    """models.whitted.render and render_fused against
    goldens/test/whitted.png, with test_golden.py's gate for it."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import whitted
    from cpu_based_ray_tracer_tpu_torch.ops import fused_whitted as fw
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap
    from cpu_based_ray_tracer_tpu_torch.scenes import whitted_scene as ws
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    scene, cam = ws.whitted_scene(dev), ws.whitted_camera(dev)
    cfg = RenderConfig(width=128, height=128, whitted_depth=5,
                       ray_chunk=65536)
    gold = im.read_png(os.path.join(ROOT, "goldens", "test", "whitted.png"))
    res = {}
    for name, img in (("whitted_render", whitted.render(scene, cam, cfg,
                                                        device=dev)),
                      ("render_fused", fw.render_fused(scene, cam, cfg,
                                                       device=dev)[0])):
        u8 = tonemap.quantize_u8(img, gamma=1.0).cpu().numpy()
        d = np.abs(u8.astype(np.int32) - gold.astype(np.int32))
        res[name] = dict(mean_abs_diff=float(d.mean()),
                         p99=float(np.percentile(d, 99)))
    emit(phase="whitted_golden", mean_tol=mean_tol, p99_tol=p99_tol, **res)
    for name, r in res.items():
        if not (r["mean_abs_diff"] <= mean_tol and r["p99"] <= p99_tol):
            raise RuntimeError(f"{name} disagrees with "
                               f"goldens/test/whitted.png: {r}")


def mesh_parity_phase(dev, cfg, shadow) -> tuple:
    """The packet kernel against nearest_plain on the camera rays, the
    ``shadow`` rays (o, d) kept from mesh_main and the streamed case;
    returns (max abs t error, {case: (clusters, origin, direction, passing
    pairs)})."""
    from cpu_based_ray_tracer_tpu_torch import camera
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.ops import packet
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes

    scene = meshes.bvh_stage_scene(device=dev)
    cam = meshes.bvh_stage_camera(dev)
    cl = mesh.prepare(scene).clusters
    d = camera.perspective_rays(cam, cfg.width, cfg.height).reshape(-1, 3)
    o = cam.position.expand(d.shape).contiguous()
    d = d.contiguous()
    g = np.random.default_rng(3)
    big = np.concatenate([meshes.icosphere(4), meshes.torus(1.5, 0.4, 48, 32)])
    ro = torch.as_tensor(g.uniform(-3, 3, (65536, 3)).astype(np.float32),
                         device=dev)
    rd = torch.as_tensor(g.normal(size=(65536, 3)).astype(np.float32),
                         device=dev)
    rd = (rd / rd.norm(dim=1, keepdim=True)).contiguous()
    cl_big = packet.build_clusters(big, 64, device=dev)
    # one 16,384-ray launch: the camera rays of the middle chunk of the
    # render's 49 when the Whitted twin runs in chunks of 16,384
    mid = slice(24 * 16384, 25 * 16384)
    cases = {"camera": (cl, o, d), "shadow": (cl, *shadow),
             "streamed_8192": (cl_big, ro, rd),
             "camera_16384": (cl, o[mid].contiguous(), d[mid].contiguous())}
    max_err, out = 0.0, {}
    for name, (c, oo, dd) in cases.items():
        want_t, want_i, n_pass = packet.nearest_plain(c, oo, dd, cfg.t_min,
                                                      return_passes=True)
        got_t, got_i = packet.nearest(c, oo, dd, cfg.t_min)
        sync(dev)
        hit = want_t < packet.NO_HIT
        same_hit = bool(torch.equal(got_t < packet.NO_HIT, hit))
        same_idx = bool(torch.equal(got_i, want_i))
        err = (got_t[hit] - want_t[hit]).abs()
        rel = float((err / want_t[hit].abs()).max()) if hit.any() else 0.0
        res = dict(rays=oo.shape[0], tris=int((c.tri_id >= 0).sum()),
                   clusters=c.n_clusters, hits=int(hit.sum()),
                   hit_masks_equal=same_hit, indices_equal=same_idx,
                   t_bit_equal_share=float((err == 0).float().mean())
                   if hit.any() else 1.0,
                   max_rel_err=rel, max_abs_err=float(err.max())
                   if hit.any() else 0.0,
                   passing_pairs=n_pass,
                   block_cluster_pairs=c.n_clusters
                   * -(-oo.shape[0] // packet.BLOCK))
        emit(phase="mesh_parity", case=name, **res)
        if not (same_hit and same_idx and rel <= 1e-6):
            raise RuntimeError(f"packet disagrees with nearest_plain on "
                               f"{name}: {res}")
        max_err = max(max_err, res["max_abs_err"])
        out[name] = (c, oo, dd, n_pass)
    return max_err, out


def save_png(img, name, gamma=1.0) -> str:
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    os.makedirs(OUT, exist_ok=True)
    png = os.path.join(OUT, name)
    im.write_png(png, tonemap.quantize_u8(img, gamma=gamma).cpu().numpy())
    return os.path.relpath(png, ROOT)


@contextlib.contextmanager
def recording_shadow_rays(sent: list):
    """Within the block, the shadow rays (o, d) that models.mesh's
    nearest_t_fn is called with are appended to ``sent``."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh

    make = mesh.make_nearest_t_fn

    def recording(b, sort_rays=False, hw=None):
        fn = make(b, sort_rays, hw)

        def rec(sc, o, d, t_min):
            sent.append((o, d))
            return fn(sc, o, d, t_min)
        return rec

    mesh.make_nearest_t_fn = recording
    try:
        yield
    finally:
        mesh.make_nearest_t_fn = make


def light0_rays(sent: list, scene, cfg) -> tuple:
    """The shadow rays toward light 0 of a mesh.render frame, all chunks
    concatenated: bvh_stage_scene has no specular surface, so each chunk's
    ray tree is its level 0 alone, one shadow pass of the chunk's rays per
    light, light 0 first."""
    light0 = sent[0::scene.lights.count]
    so = torch.cat([o for o, _ in light0]).contiguous()
    sd = torch.cat([d for _, d in light0]).contiguous()
    if (len(sent) % scene.lights.count or len({o.shape[0] for o, _ in sent})
            != 1 or so.shape[0] != cfg.width * cfg.height):
        raise RuntimeError(f"mesh.render sent {len(sent)} shadow passes, "
                           f"{so.shape[0]} light-0 rays in all")
    return so, sd


def mesh_main_phase(dev, cfg) -> tuple:
    """The mesh Whitted main path once, counters set to 0 just before and
    read just after; then method="brute", which must agree on every pixel.
    Returns (packet launches, the shadow rays (o, d) toward light 0 that
    the main path sent, all its chunks concatenated)."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes

    scene, cam = meshes.bvh_stage_scene(), meshes.bvh_stage_camera()
    bundle = mesh.prepare(scene)
    sent = []
    with recording_shadow_rays(sent):
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        img = mesh.render(bundle, cam, cfg, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = read_counts()
    so, sd = light0_rays(sent, scene, cfg)
    brute = mesh.render(mesh.prepare(scene, method="brute"), cam, cfg,
                        device=dev)
    vs_brute = pixels_off(img, brute, WHITTED_RTOL, WHITTED_ATOL)
    # per-ray results do not depend on the chunk of the Whitted twin
    vs_chunks = {c: pixels_off(mesh_render_chunked(bundle, cam, cfg, c, dev),
                               img, WHITTED_RTOL, WHITTED_ATOL)
                 for c in PACKET_CHUNKS}
    finite = bool(torch.isfinite(img).all())
    emit(phase="mesh_main", config=f"bvh_stage_scene {cfg.width}x"
         f"{cfg.height} depth{cfg.whitted_depth} method={bundle.method}",
         tris=scene.triangles.count, clusters=bundle.clusters.n_clusters,
         seconds=secs, launches=launches, chunk=sent[0][0].shape[0],
         vs_brute=vs_brute, vs_chunks=vs_chunks, finite=finite,
         mean_radiance=float(img.mean()),
         png=save_png(img, f"mesh_{cfg.width}.png"))
    if dev.type == "cuda" and launches["packet"] <= 0:
        raise RuntimeError("mesh.render launched no packet kernel")
    if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
            or not float(img.mean()) > 0.0):
        raise RuntimeError("the mesh main path's image is wrong")
    if vs_brute["pixels_off"] != 0 or any(v["pixels_off"]
                                          for v in vs_chunks.values()):
        raise RuntimeError(f"mesh.render packet vs brute: {vs_brute}, vs "
                           f"each chunk: {vs_chunks}")
    return launches["packet"], (so, sd)


# ray_chunk values of the Whitted twin timed for mesh.render through packet
# (16,384 is the twin's default chunk, the JAX package's; 802,816 is the
# whole 896x896 image, what mesh.render gives the packet branch).
PACKET_CHUNKS = (16384, 65536, 200704, 802816)


def mesh_render_chunked(bundle, cam, cfg, chunk: int, dev):
    """mesh.render's packet path with the Whitted twin cut into ``chunk``
    rays (mesh.render itself takes the whole image)."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh, whitted

    b = bundle.to(dev)
    return whitted.render(b.scene, cam, cfg.replace(ray_chunk=chunk),
                          intersect_fn=mesh.make_intersect_fn(b),
                          nearest_t_fn=mesh.make_nearest_t_fn(b), device=dev)


def packet_launches_in(render, dev, n_rep: int) -> dict:
    """packet.cu inside one call of ``render``: the call with every launch's
    rays recorded (and CUDA events around each launch, which also hold the
    wrapper's host work when the card waits for it); then each launch
    replayed alone on its rays (CUDA events, n_rep back to back after the
    card was kept busy while the host enqueued them), summed; the bound
    summed over the launches (each launch's slab tests and the triangle
    tests of its (ray, cluster) pairs where the ray crosses the padded box,
    or its bytes), and beside it PR 7's count (the triangle tests of the
    256-ray (block, cluster) pairs whose vote passed)."""
    from cpu_based_ray_tracer_tpu_torch.ops import packet

    rec, real = [], packet._nearest_kernel

    def recording(clusters, origin, direction, t_min):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = real(clusters, origin, direction, t_min)
        e1.record()
        rec.append((e0, e1, clusters, origin.clone(), direction.clone(),
                    t_min))
        return out
    sync(dev)
    packet._nearest_kernel = recording
    try:
        render()
        sync(dev)
    finally:
        packet._nearest_kernel = real
    inline_ms = sum(e0.elapsed_time(e1) for e0, e1, *_ in rec)
    ms = ops = nbytes = bound_ms = no_fma_ms = vote_bound_ms = 0.0
    rays = []
    for _, _, cl, o, d, t_min in rec:
        real(cl, o, d, t_min)                                   # warm-up
        ms += timed(lambda: [real(cl, o, d, t_min) for _ in range(n_rep)],
                    busy_ms=5.0) / n_rep
        r = o.shape[0]
        n_pass = packet.nearest_plain(cl, o, d, t_min,
                                      return_passes=True)[2]
        l_ops, l_bytes = packet_work(
            r, cl, packet_pairs(cl, o, d, t_min)["ray_pairs"])
        ops += l_ops
        nbytes += l_bytes
        bound_ms += bound(l_ops, l_bytes)["bound_ms"]
        no_fma_ms += bound(l_ops, l_bytes)["bound_no_fma_ms"]
        vote_bound_ms += bound(*packet_work(r, cl, n_pass * packet.BLOCK)
                               )["bound_ms"]
        rays.append(r)
    return dict(ms=ms, inline_event_ms=inline_ms, launches=len(rec),
                bound_ms=bound_ms, bound_by=bound(ops, nbytes)["bound_by"],
                bound_no_fma_ms=no_fma_ms, pr7_vote_bound_ms=vote_bound_ms,
                ops=ops, bytes=nbytes,
                rays_per_launch=dict(total=sum(rays), min=min(rays),
                                     mean=sum(rays) / len(rays),
                                     max=max(rays)))


def packet_work(r: int, cl, tested: int) -> tuple:
    """(ops, bytes) of one packet pass of r rays: every ray's slab test of
    every cluster and the CS triangle tests of each of ``tested`` (ray,
    cluster) pairs; the rays read and the results written once, the
    cluster table read once.  ``tested`` is what the pass needs, the pairs
    where the ray crosses the padded box (``packet_pairs``' ray_pairs);
    or 32 x its (warp, cluster) pairs, what the kernel's warps run; or PR
    7's count, 256 x the (block, cluster) pairs whose vote passed (the
    TPU kernel's cull, ``nearest_plain(return_passes=True)``)."""
    c, cs = cl.n_clusters, cl.cs
    return (r * c * SLAB_OPS + tested * cs * TRI_OPS,
            r * (24 + 8) + c * (cs * (48 + 4) + 32))


def packet_in_render_phase(dev, cfg, smi, n_rep=3, n_frames=3) -> dict:
    """packet.cu inside mesh.render (bvh_stage_scene, the mesh_main cell),
    for each ray chunk of PACKET_CHUNKS and for mesh.render itself: the
    frame's seconds (median of n_frames after a warm-up), its packet
    launches replayed alone and summed beside their summed bound
    (``packet_launches_in``), and the eager Whitted twin's share (the
    rest of the frame).  Returns mesh.render's."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes

    scene, cam = meshes.bvh_stage_scene(), meshes.bvh_stage_camera()
    bundle = mesh.prepare(scene)
    renders = {str(c): functools.partial(mesh_render_chunked, bundle, cam,
                                         cfg, c, dev) for c in PACKET_CHUNKS}
    renders["mesh.render"] = functools.partial(mesh.render, bundle, cam, cfg,
                                               device=dev)
    out = {}
    for name, render in renders.items():
        render()                                                # warm-up
        secs = []
        for _ in range(n_frames):
            sync(dev)
            t0 = time.perf_counter()
            render()
            sync(dev)
            secs.append(time.perf_counter() - t0)
        res = packet_launches_in(render, dev, n_rep)
        res.update(render_seconds=float(np.median(secs)),
                   render_seconds_all=secs,
                   eager_share=1.0 - res["ms"] * 1e-3 / float(np.median(secs)))
        emit(phase="packet_in_render", nvidia_smi=smi, chunk=name,
             config=f"bvh_stage_scene {cfg.width}x{cfg.height} "
                    f"depth{cfg.whitted_depth}", **res)
        out[name] = res
    best = min(PACKET_CHUNKS, key=lambda c: out[str(c)]["render_seconds"])
    emit(phase="packet_in_render", part="chunk_sweep", fastest_chunk=best,
         mesh_render_chunk=out["mesh.render"]["rays_per_launch"]["max"],
         seconds_by_chunk={k: v["render_seconds"] for k, v in out.items()},
         replayed_ms_by_chunk={k: v["ms"] for k, v in out.items()},
         launches_by_chunk={k: v["launches"] for k, v in out.items()})
    return out["mesh.render"] | {"chunk_sweep": {
        k: {f: v[f] for f in ("render_seconds", "launches", "ms",
                              "bound_ms", "pr7_vote_bound_ms",
                              "eager_share")}
        for k, v in out.items() if k != "mesh.render"}}


def whitted_main_phase(dev, cfg) -> int:
    """render_fused once, counters set to 0 just before and read just
    after; returns the fused_whitted launches."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_whitted as fw
    from cpu_based_ray_tracer_tpu_torch.scenes import whitted_scene as ws

    scene, cam = ws.whitted_scene(), ws.whitted_camera()
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    img, trunc = fw.render_fused(scene, cam, cfg, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = read_counts()
    finite = bool(torch.isfinite(img).all())
    emit(phase="whitted_main", config=f"whitted_scene {cfg.width}x"
         f"{cfg.height} depth{cfg.whitted_depth} Q4", seconds=secs,
         launches=launches, truncated=float(trunc), finite=finite,
         mean_radiance=float(img.mean()),
         png=save_png(img, f"whitted_{cfg.width}.png"))
    if dev.type == "cuda" and launches["fused_whitted"] <= 0:
        raise RuntimeError("render_fused launched no fused_whitted kernel")
    if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
            or float(trunc) != 0.0):
        raise RuntimeError("the Whitted main path's image is wrong")
    return launches["fused_whitted"]


def mesh_mc_phase(dev, cfg, tol=TOL) -> int:
    """mesh.render_mc through the packet kernel against method="brute" (the
    oracle of the fused mesh slice); returns the packet launches."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_mesh_scene(), cornell.cornell_camera()
    bundle = mesh.prepare(scene)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    img = mesh.render_mc(bundle, cam, cfg, SEED_KEY0, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = read_counts()
    brute = mesh.render_mc(mesh.prepare(scene, method="brute"), cam, cfg,
                           SEED_KEY0, device=dev)
    res = pixels_off(img, brute, tol, tol)
    emit(phase="mesh_mc", config=f"cornell_mesh_scene {cfg.width}x"
         f"{cfg.height} {cfg.spp}spp depth{cfg.max_depth} "
         f"rr{cfg.rr_survival} method={bundle.method}",
         tris=scene.triangles.count, seconds=secs, launches=launches,
         vs_brute=res, mean_radiance=float(img.mean()),
         png=save_png(img, f"mesh_mc_{cfg.width}.png"))
    if dev.type == "cuda" and launches["packet"] <= 0:
        raise RuntimeError("mesh.render_mc launched no packet kernel")
    if not (res["pixels_off"] == 0 and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise RuntimeError(f"mesh.render_mc packet vs brute: {res}")
    return launches["packet"]


def whitted_speed_phase(dev, cfg, counts, smi, n_iters=20) -> dict:
    """ms per frame of the fused_whitted kernel alone (CUDA events) and of
    its plain version; the bound from this frame's counted work."""
    from cpu_based_ray_tracer_tpu_torch import camera
    from cpu_based_ray_tracer_tpu_torch.ops import fused_whitted as fw
    from cpu_based_ray_tracer_tpu_torch.scenes import whitted_scene as ws

    scene, cam = ws.whitted_scene(dev), ws.whitted_camera(dev)
    wp = fw.pack_whitted_scene(scene)
    dirs = camera.perspective_rays(cam, cfg.width, cfg.height).reshape(
        -1, 3).T.contiguous()
    args = (wp, cam.position, dirs, cfg.whitted_depth, 4, cfg.t_min,
            cfg.eps_offset)
    fw._tree_kernel(*args)                                   # warm-up
    ms = timed(lambda: [fw._tree_kernel(*args) for _ in range(n_iters)]
               ) / n_iters
    plain_ms = timed(lambda: fw._tree_plain(*args))
    n_pix = cfg.width * cfg.height
    ops = whitted_ops(wp.n_tri, wp.n_sph, wp.n_light, counts)
    res = dict(ms=ms, plain_ms=plain_ms, **bound(ops, n_pix * (12 + 16)))
    levels = counts.get("levels", [])
    # per level: the live slots (the kernel's items) against the lane-slots
    # 32-lane warps run one slot section at a time, and the branches
    res["items_per_level"] = [lv["live"] for lv in levels]
    res["warp_lane_slots_per_level"] = [32 * lv["warp_slots"]
                                        for lv in levels]
    res["warp_branches_per_level"] = [lv["warp_branches"] for lv in levels]
    emit(phase="whitted_speed", nvidia_smi=smi, pixels=n_pix,
         frames_per_s=1e3 / ms, ops_per_frame=ops, work=counts, **res)
    return res


def packet_pairs(cl, o, d, t_min: float) -> dict:
    """The triangle-test work of csrc/packet.cu's cull on these rays: the
    (ray, cluster) pairs where the ray crosses the padded box, and the
    (32-ray warp, cluster) pairs where a ray of the warp does (the pairs
    the kernel runs Moller-Trumbore for; no cull by the best hit)."""
    from cpu_based_ray_tracer_tpu_torch.ops import clusters

    rays = torch.cat([o.T, d.T])
    r = rays.shape[1]
    nw = -(-r // 32)
    ray_pairs = warp_pairs = 0
    for c in range(cl.n_clusters):
        crossed = clusters.crosses_box_plain(cl.aabb[c:c + 1], rays, t_min,
                                             occl=False)[0]
        pad = torch.zeros((nw * 32,), dtype=torch.bool, device=o.device)
        pad[:r] = crossed
        ray_pairs += int(crossed.sum())
        warp_pairs += int(pad.view(nw, 32).any(1).sum())
    return dict(ray_pairs=ray_pairs, warp_pairs=warp_pairs,
                boxes_crossed_per_ray=ray_pairs / r,
                boxes_crossed_per_warp=warp_pairs / nw)


def packet_speed_phase(dev, cases, smi, n_iters=10) -> dict:
    """ms per pass of the packet kernel alone (CUDA events, the card kept
    busy while the host enqueues the launches) and of nearest_plain, on
    the camera and the shadow rays and one 16,384-ray chunk of camera
    rays; the bound counts the (ray, cluster) pairs where the ray crosses
    the padded box, with the (warp, cluster) pairs' count and PR 7's vote
    count beside it (``packet_work``)."""
    from cpu_based_ray_tracer_tpu_torch.ops import packet

    res = {}
    for name in ("camera", "shadow", "camera_16384"):
        cl, o, d, n_pass = cases[name]
        packet._nearest_kernel(cl, o, d, 1e-3)                 # warm-up
        ms = timed(lambda: [packet._nearest_kernel(cl, o, d, 1e-3)
                            for _ in range(n_iters)], busy_ms=5.0) / n_iters
        plain_ms = timed(lambda: packet.nearest_plain(cl, o, d, 1e-3))
        r, c = o.shape[0], cl.n_clusters
        pairs = packet_pairs(cl, o, d, 1e-3)
        ops, nbytes = packet_work(r, cl, pairs["ray_pairs"])
        res[name] = dict(ms=ms, plain_ms=plain_ms, **bound(ops, nbytes),
                         passing_pairs=n_pass,
                         **pairs, warp_pairs_bound_ms=bound(*packet_work(
                             r, cl, pairs["warp_pairs"] * 32))["bound_ms"],
                         pr7_vote_bound_ms=bound(*packet_work(
                             r, cl, n_pass * packet.BLOCK))["bound_ms"])
        emit(phase="packet_speed", case=name, nvidia_smi=smi, rays=r,
             clusters=c, rays_per_s=r / (ms * 1e-3), **res[name])
    return res


# --- the fused mesh MC stage -------------------------------------------------

MESH_TPU = {"k1": ("_k1_kernel", 226), "nearest": ("_mesh_nearest_kernel", 915),
            "k1b": ("_k1b_kernel", 1142), "occl": ("_mesh_occl_kernel", 943),
            "k2": ("_k2_kernel", 388),
            # the groupings before the resident sweeps: part of #3's and
            # #4's ports (the TPU kernels sweep the rays in pack order)
            "group": ("_mesh_nearest_kernel", 915),
            "group_occl": ("_mesh_occl_kernel", 943)}


def mesh_setup(dev, cfg):
    """The bench cell's pack, camera, fresh state and constants (caps
    rp // 8 and rp // 12, as bench.py's mc_bunny_mesh_fused)."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_mesh_scene(device=dev), cornell.cornell_camera(dev)
    mp = fm.pack_mesh_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, SEED_KEY0, device=dev)
    r = st.s.shape[0]
    rp = -(-r // fm.LANES_PER_TILE) * fm.LANES_PER_TILE
    caps = (rp // 8, rp // 12)
    p = fm.params(cfg, r, *caps)
    tb = fm._tables(mp, fused._camera_words(cam))
    return scene, cam, mp, st, caps, p, tb


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def pack_check(ids_k, ids_p, rays_k, rays_p, offs_k, offs_p) -> bool:
    """The kernel's pack holds the plain pack's lanes, each block's slice
    contiguous and in lane order (blocks land in any order)."""
    order = torch.argsort(ids_k)
    ok = (torch.equal(ids_k[order], ids_p)
          and torch.equal(rays_k[:, order], rays_p)
          and torch.equal(offs_k[:, 1], offs_p[:, 1]))
    for (bk, c), (bp, _) in zip(offs_k.tolist(), offs_p.tolist()):
        ok = ok and torch.equal(ids_k[bk:bk + c], ids_p[bp:bp + c])
    return ok


def grouping_equal(got, want, rays, ray_id, n: int) -> bool:
    """The grouping kernel's output holds the plain grouping's: the same
    keys (in pack order), the same key runs, the same lane ids in each run
    (the order inside a run is the atomics'), each with its own ray."""
    (rk, ik, kk), (_, ip, kp) = got, want
    if n == 0:
        return True
    if not torch.equal(kk[:n].long(), kp):
        return False
    key_of = torch.zeros(int(ray_id[:n].max()) + 1, dtype=torch.int64,
                         device=rays.device)
    key_of[ray_id[:n].long()] = kp
    pos = torch.zeros_like(key_of)
    pos[ray_id[:n].long()] = torch.arange(n, device=rays.device)
    run_k, run_p = key_of[ik[:n].long()], key_of[ip[:n].long()]
    return (torch.equal(run_k, run_p)
            and torch.equal(torch.sort(run_k * (1 << 32) + ik[:n]).values,
                            torch.sort(run_p * (1 << 32) + ip[:n]).values)
            and torch.equal(rk[:, :n], rays[:, pos[ik[:n].long()]]))


def mesh_fused_parity_phase(dev, cfg, n_steps=16) -> dict:
    """(a) each of the five entry points against its plain version on the
    same inputs, one step from wavefront_init; (b) the whole stepper,
    kernels against plain, n_steps in plain mode and with stop_after=4.
    Returns the max abs error of each entry point."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    scene, cam, mp, st, caps, p, tb = mesh_setup(dev, cfg)
    r = st.s.shape[0]
    sf, si = fused.state_planes(st)
    bp = fm.StepBuffers(*[torch.zeros_like(x)
                          for x in fm.step_buffers(r, p, 1, dev)])
    errs, res = {"group": 0.0, "group_occl": 0.0}, {}
    for name in fm.OP_NAMES:
        if name in ("nearest", "occl"):
            # the grouping alone, on the plain K1's or K1b's pack
            occl = name == "occl"
            key = "group_occl" if occl else "group"
            rays, ids = (bp.sr, bp.sr_id) if occl else (bp.mr, bp.mr_id)
            c = bp.cnt[0, 1:2] if occl else bp.cnt[0, 0:1]
            got = fm._group_kernel(tb, p, rays, ids, c, occl=occl)
            want = fm.group_plain(tb, p, rays, ids, c, occl=occl)
            sync(dev)
            res[key] = {"equal": grouping_equal(got, want, rays, ids,
                                                int(c))}
            if not res[key]["equal"]:
                raise RuntimeError(f"the grouping kernel disagrees with "
                                   f"group_plain (occl={occl})")
        bk = fm.StepBuffers(*[x.clone() for x in bp])
        sf_k, si_k = sf.clone(), si.clone()
        fm.run_op(fm.KERNEL_OPS, name, tb, p, SEED_KEY0, sf_k, si_k, bk)
        fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED_KEY0, sf, si, bp)
        sync(dev)
        same = {"cnt": torch.equal(bk.cnt, bp.cnt),
                "hf": torch.equal(bk.hf, bp.hf),
                "kb": torch.equal(bk.kb, bp.kb),
                "state": torch.equal(sf_k, sf) and torch.equal(si_k, si)}
        errs[name] = max(max_abs(bk.hf, bp.hf), max_abs(bk.kb, bp.kb),
                         max_abs(sf_k, sf))
        if name in ("k1", "k1b"):
            k = 0 if name == "k1" else 1
            n = int(bp.cnt[0, k])
            ids, rays, offs = (("mr_id", "mr", "offs1") if k == 0
                               else ("sr_id", "sr", "offs2"))
            same["pack"] = pack_check(
                getattr(bk, ids)[:n], getattr(bp, ids)[:n],
                getattr(bk, rays)[:, :n], getattr(bp, rays)[:, :n],
                getattr(bk, offs), getattr(bp, offs))
            res[f"packed_{name}"] = n
        res[name] = same
        if not all(same.values()):
            raise RuntimeError(f"fused_mesh {name} disagrees with its plain "
                               f"version: {same}, max abs err "
                               f"{errs[name]}")
    emit(phase="mesh_fused_parity", part="each_kernel", lanes=r,
         caps=list(caps), max_abs_err=errs, **res)

    # Every step of the stepper: the grouped nearest sweep's t, normal and
    # material id (hf rows 5-9) and the grouped occlusion sweep's flags (kb
    # row 8) bit equal to the plain version's.
    sf_k, si_k = fused.state_planes(st)
    sf_p, si_p = sf_k.clone(), si_k.clone()
    bk = fm.step_buffers(r, p, n_steps, dev)
    bp = fm.step_buffers(r, p, n_steps, dev)
    same_steps = {"nearest": 0, "occl": 0}
    rows = {"nearest": lambda b: b.hf[5:10], "occl": lambda b: b.kb[8:9]}
    for k in range(n_steps):
        for name in fm.OP_NAMES:
            fm.run_op(fm.KERNEL_OPS, name, tb, p, SEED_KEY0, sf_k, si_k, bk,
                      k)
            fm.run_op(fm.PLAIN_OPS, name, tb, p, SEED_KEY0, sf_p, si_p, bp,
                      k)
            if name in rows:
                sync(dev)
                same_steps[name] += int(torch.equal(
                    rows[name](bk).view(torch.int32),
                    rows[name](bp).view(torch.int32)))
    sync(dev)
    emit(phase="mesh_fused_parity", part="grouped_sweeps_every_step",
         n_steps=n_steps, steps_bit_equal=same_steps,
         packed_main=bp.cnt[:, 0].tolist(),
         packed_shadow=bp.cnt[:, 1].tolist(),
         state_bit_equal=bool(torch.equal(sf_k.view(torch.int32),
                                          sf_p.view(torch.int32))
                              and torch.equal(si_k, si_p)))
    for name, same in same_steps.items():
        if same != n_steps:
            raise RuntimeError(f"the grouped {name} sweep differs from its "
                               f"plain version on {n_steps - same} steps")

    for stop_after in (0, 4):
        kw = dict(cap_main=caps[0], cap_shadow=caps[1],
                  stop_after=stop_after)
        want, of_p, np_p = fm.wavefront_steps_fused_mesh_plain(
            mp, cam, cfg, SEED_KEY0, st, n_steps, **kw)
        got, of_k, np_k = fm.wavefront_steps_fused_mesh(
            mp, cam, cfg, SEED_KEY0, st, n_steps, device=dev, **kw)
        sync(dev)
        cmp = compare_states(got, want)
        emit(phase="mesh_fused_parity", part="stepper", n_steps=n_steps,
             stop_after=stop_after, overflow=[int(of_k), int(of_p)],
             npred=[np_k.tolist(), np_p.tolist()], **cmp)
        if (cmp["int_mismatch_share"] > MAX_INT_MISMATCH
                or not cmp["float_within_tol"] or int(of_k) or int(of_p)
                or not torch.equal(np_k, np_p)):
            raise RuntimeError(f"the fused mesh stepper disagrees with its "
                               f"plain version (stop_after={stop_after})")
        for k in errs:
            errs[k] = max(errs[k], cmp["max_abs_err"])
    return errs


def mesh_fused_main_phase(dev, cfg) -> dict:
    """render_turbo_mesh_exact at full width (the main path), then one
    render_turbo_mesh (the mesh-mc stage's call), each with the counters
    set to 0 just before and read just after; returns the first's
    fused_mesh launches."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_mesh_scene(), cornell.cornell_camera()
    runs = {}
    for name, fn in (("render_turbo_mesh_exact", fm.render_turbo_mesh_exact),
                     ("render_turbo_mesh", fm.render_turbo_mesh)):
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        img = fn(scene, cam, cfg, SEED_KEY0, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = read_counts()
        steps = sum(t["steps"] for t in fm.TRACE)
        finite = bool(torch.isfinite(img).all())
        emit(phase="mesh_fused_main", call=name, config=f"cornell_mesh_scene "
             f"{cfg.width}x{cfg.height} {cfg.spp}spp depth{cfg.max_depth} "
             f"rr{cfg.rr_survival}", tris=scene.triangles.count,
             seconds=secs, steps=steps, launches=launches, trace=fm.TRACE,
             finite=finite, mean_radiance=float(img.mean()),
             png=save_png(img, f"mesh_fused_{name}_{cfg.width}.png", 2.0))
        fmesh = launches["fused_mesh"]
        if (launches["packet"] != 0 or fmesh["nearest_sl"] or fmesh["occl_sl"]
                or any(fmesh[k] != steps or fmesh[k] <= 0 for k in MESH_TPU)):
            raise RuntimeError(f"{name}: launches {launches}, {steps} steps")
        if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
                or not float(img.mean()) > 0.0):
            raise RuntimeError(f"{name}'s image is wrong")
        runs[name] = launches["fused_mesh"]
    return runs["render_turbo_mesh_exact"]


def mesh_fused_oracle_phase(dev, cfg, tol=TOL):
    """render_turbo_mesh_exact against mesh.render_mc through the packet
    kernel: the same estimator through two exact intersectors; at most
    MAX_INT_MISMATCH of the pixels may differ (knife-edge hits)."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_mesh_scene(), cornell.cornell_camera()
    img = fm.render_turbo_mesh_exact(scene, cam, cfg, SEED_KEY0, device=dev)
    oracle = mesh.render_mc(mesh.prepare(scene), cam, cfg, SEED_KEY0,
                            device=dev)
    res = pixels_off(img, oracle, tol, tol)
    share = res["pixels_off"] / (cfg.width * cfg.height)
    emit(phase="mesh_fused_oracle", config=f"{cfg.width}x{cfg.height} "
         f"{cfg.spp}spp depth{cfg.max_depth}", vs_packet=res,
         pixels_off_share=share, max_share=MAX_INT_MISMATCH)
    if share > MAX_INT_MISMATCH:
        raise RuntimeError(f"render_turbo_mesh_exact vs mesh.render_mc: {res}")


# f32 operations counted in csrc/fused_mesh.cu (comparisons and selects not
# counted): per lane of K1 47 per small triangle, 28 per sphere and
# SLAB_OPS per predicate AABB; per lane of K1b K1B_OPS + SLAB_OPS per
# AABB (normal, shading point, light sample, cos); per lane of K2 150 +
# 50 per small triangle + 28 per sphere (as fused_mc's step); the sweeps
# SLAB_OPS per box test of a packed ray against each cluster of its list
# and TRI_OPS per triangle test it needs (sweep_tests).
K1B_OPS = 75


def crossed_counts(aabb, planes, t_min: float, cnt=None) -> tuple:
    """How many cluster boxes each ray of the (P, H, W) ray planes crosses
    (the first cnt in lane order; all without cnt), and the mean over
    warps (32 consecutive lanes) of the boxes any of a warp's rays
    crosses: the mask pass's per-ray planes, the boxes unpadded."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent

    masks, _ = coherent._mask_kernel(aabb, planes, t_min, cnt, planes=True)
    lanes = planes.shape[1] * planes.shape[2]
    n = lanes if cnt is None else min(int(cnt), lanes)
    m = masks.reshape(masks.shape[0], -1)[:, :n].to(torch.int64) & 0xFFFFFFFF
    nw = n // 32
    warp = torch.zeros_like(m[:, :nw])
    for lane in range(32):
        warp |= m[:, lane:nw * 32:32]
    c = torch.zeros((n,), dtype=torch.int64, device=planes.device)
    cw = torch.zeros((nw,), dtype=torch.int64, device=planes.device)
    for b in range(32):
        c += ((m >> b) & 1).sum(0)
        cw += ((warp >> b) & 1).sum(0)
    return c, float(cw.double().mean()) if nw else 0.0


def sweep_tests(mp, p, rays, cnt, ray_tests, listed) -> dict:
    """The work a sweep of the first cnt packed rays needs: each ray tests
    its tile's listed boxes (``listed``, per ray) and the triangles of the
    clusters whose boxes it crosses, and no more than the serial sweep
    (``ray_tests``, per ray: an occluded ray stops at its first occluder);
    with the boxes crossed per ray and per warp."""
    crossed, per_warp = crossed_counts(
        mp.smc_aabb, rays.view(rays.shape[0], -1, 128), p.t_min, cnt)
    tri = torch.minimum(ray_tests.to(torch.int64), crossed * mp.cs)
    return dict(needed_triangle_tests=int(tri.sum()),
                box_tests=int(listed.sum()),
                boxes_crossed_per_ray=float(crossed.double().mean()),
                boxes_crossed_per_warp=per_warp,
                boxes_listed_per_ray=float(listed.double().mean()))


def box_bits(aabb, planes, t_min: float, cnt=None):
    """(B, n) bool: which of the boxes aabb (B, 8) each of the first n lanes
    of the (P, H, W) ray planes crosses (the first cnt; all without cnt):
    the mask kernel's planes, unpacked."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent

    masks, _ = coherent._mask_kernel(aabb, planes, t_min, cnt, planes=True)
    lanes = planes.shape[1] * planes.shape[2]
    n = lanes if cnt is None else min(int(cnt), lanes)
    m = masks.reshape(masks.shape[0], -1)[:, :n].to(torch.int64) & 0xFFFFFFFF
    shift = torch.arange(32, device=m.device)[None, :, None]
    return ((m[:, None, :] >> shift) & 1).bool().reshape(-1, n)[
        :aabb.shape[0]]


def mask_work(aabb, planes, t_min: float, cnt=None) -> dict:
    """The mask pass's work on the first cnt lanes of these ray planes:
    each lane's slab tests of the cluster boxes it crosses, at least one a
    lane (``needed_tests``: what any mask pass must test; it does not move
    with the kernel's boxes); every lane against every cluster
    (``flat_tests``: a mask without a cull); and the kernel's own tests,
    a lane's and its warp's: each word box, the group boxes of the words
    it crosses, the clusters of the groups it crosses (``lane_tests``,
    ``warp_tests``: 32 lanes each for every box a lane of the warp
    crosses)."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent

    n_cl = aabb.shape[0]
    lv = coherent.level_boxes(aabb)
    b32, g_per = lv.shape[0], coherent.MASK_GROUP
    ng = -(-n_cl // g_per)
    words = lv[:, 0].contiguous()
    groups = lv[:, 1:].reshape(-1, 8)[:ng].contiguous()
    # what each crossed word and group makes a lane test inside it
    w_cost = torch.tensor([min(coherent.LEVEL_ROWS - 1,
                               -(-(n_cl - 32 * w) // g_per))
                           for w in range(b32)], device=aabb.device)
    g_cost = torch.tensor([min(g_per, n_cl - g_per * g) for g in range(ng)],
                          device=aabb.device)
    c_bits = box_bits(aabb, planes, t_min, cnt)
    w_bits = box_bits(words, planes, t_min, cnt)
    g_bits = box_bits(groups, planes, t_min, cnt)
    n = c_bits.shape[1]
    crossed = c_bits.sum(0)

    def per_warp(bits):
        nw = -(-n // 32)
        pad = torch.zeros((bits.shape[0], nw * 32), dtype=torch.bool,
                          device=bits.device)
        pad[:, :n] = bits
        return pad.view(bits.shape[0], nw, 32).any(2)
    lane = (b32 * n + int((w_bits * w_cost[:, None]).sum())
            + int((g_bits * g_cost[:, None]).sum()))
    warp = 32 * (b32 * -(-n // 32)
                 + int((per_warp(w_bits) * w_cost[:, None]).sum())
                 + int((per_warp(g_bits) * g_cost[:, None]).sum()))
    return dict(lanes=n, needed_tests=int(crossed.clamp(min=1).sum()),
                flat_tests=n * n_cl, lane_tests=lane, warp_tests=warp,
                boxes_crossed_per_lane=float(crossed.double().mean())
                if n else 0.0,
                words_crossed_per_lane=float(w_bits.sum(0).double().mean())
                if n else 0.0,
                groups_crossed_per_lane=float(g_bits.sum(0).double().mean())
                if n else 0.0)


def mask_bound(work: dict, n_planes: int, n_cl: int, n_tiles: int) -> dict:
    """The mask pass's bound: SLAB_OPS per needed test against its bytes
    (each lane's ray planes read, the boxes read, the tile words and the
    lists written); beside it the same at the flat count
    (``flat_bound_ms``) and at the kernel's own lane and warp tests."""
    nbytes = (work["lanes"] * n_planes * 4 + n_cl * 32
              + n_tiles * (-(-n_cl // 32) + n_cl + 1) * 4)
    res = bound(work["needed_tests"] * SLAB_OPS, nbytes)
    for k in ("flat", "lane", "warp"):
        res[f"{k}_bound_ms"] = bound(work[f"{k}_tests"] * SLAB_OPS,
                                     nbytes)["bound_ms"]
    return res


def k1_box_tests(mp, p, sf, best_t) -> int:
    """The slab tests K1's mesh predicate needs on these lanes (rays sf[0:6],
    the smalls' nearest t best_t): the predicate boxes' hull for every
    lane in the image; for a lane whose segment crosses the hull, the
    boxes in order up to the first one it crosses (all of them when it
    crosses none), since the predicate is their OR."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm

    o, d = sf[0:3].T, sf[3:6].T
    boxes = mp.pred_aabb
    hull = fm._slab_crosses(o, d, boxes[:, 0:3].amin(0),
                            boxes[:, 3:6].amax(0), p.t_min, best_t)
    crossed = torch.stack([fm._slab_crosses(o, d, b[0:3], b[3:6], p.t_min,
                                            best_t) for b in boxes])
    n_pred = boxes.shape[0]
    first = torch.where(crossed.any(0), crossed.int().argmax(0) + 1, n_pred)
    valid = fm._lanes(o.shape[0], p, o.device).valid
    return int((valid * (1 + hull * first)).sum())


def mesh_bounds(mp, r, n_main, n_shadow, near, occl, k1_boxes) -> dict:
    """(ops, bytes) of each entry point for one step with these packed
    populations, the sweeps' needed work ``near`` and ``occl``
    (sweep_tests) and K1's predicate box tests (k1_box_tests): each input
    read once, each output written once."""
    n_pred = mp.pred_aabb.shape[0]
    table = mp.n_clusters * mp.cs * 16 * 4
    return {
        "k1": (r * (47 * mp.n_stri + 28 * mp.n_sph) + SLAB_OPS * k1_boxes,
               r * (24 + 40) + n_main * 28),
        "nearest": (near["needed_triangle_tests"] * TRI_OPS
                    + near["box_tests"] * SLAB_OPS,
                    n_main * (28 + 20) + table),
        "k1b": (r * (K1B_OPS + SLAB_OPS * n_pred),
                r * (24 + 8 + 40 + 36) + n_shadow * 32),
        "occl": (occl["needed_triangle_tests"] * TRI_OPS
                 + occl["box_tests"] * SLAB_OPS,
                 n_shadow * (32 + 4) + table),
        "k2": (r * (150 + 50 * mp.n_stri + 28 * mp.n_sph), r * (100 + 76)),
        # each packed ray's box tests; its planes and id read once and
        # written once in key order (the key between the kernels is this
        # design's, not the sort's)
        "group": (n_main * mp.n_clusters * SLAB_OPS,
                  n_main * (28 + 28)),
        "group_occl": (n_shadow * mp.n_clusters * SLAB_OPS,
                       n_shadow * (32 + 32)),
    }


def group_speed(tb, p, rays, ray_id, cnt, n_iters: int, occl: bool) -> dict:
    """The grouping kernel alone (CUDA events, ms per launch: its three
    kernels; the card kept busy while the host enqueues them, and also
    back to back with the host's work between), its plain version, and
    each equal to the other."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm

    group = functools.partial(fm._group_kernel, tb, p, rays, ray_id, cnt,
                              occl=occl)
    got = group()                                               # warm-up
    ms = timed(lambda: [group() for _ in range(n_iters)],
               busy_ms=20.0) / n_iters
    host_ms = timed(lambda: [group() for _ in range(n_iters)]) / n_iters
    out = {}
    plain_ms = timed(lambda: out.update(
        want=fm.group_plain(tb, p, rays, ray_id, cnt, occl=occl)))
    sync(rays.device)
    if not grouping_equal(got, out["want"], rays, ray_id, int(cnt)):
        raise RuntimeError("the grouping kernel disagrees with group_plain")
    return dict(ms=ms, with_host_ms=host_ms, plain_ms=plain_ms, keys=int(
        torch.unique(out["want"][2]).numel()))


def sweep_splits(tb, p, rays, ray_id, cnt, want, occl: bool, lists,
                 n_iters: int) -> dict:
    """One sweep entry point alone (CUDA events, ms per launch), its ray
    blocks' cluster lists split as the default does and unsplit.  Every
    output must equal ``want`` (the plain version's) on the packed rays'
    lanes.  With the slices K each takes, the grid, and the card's resident
    sweep blocks per SM."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.ops import clusters

    per_sm, n_sm = fm.LIB.occupancy("fused_mesh_sweep_slots", int(occl),
                                    tb.mp.cs)
    n = min(int(cnt), rays.shape[1])
    lanes = ray_id[:n].long()
    ray_blocks = -(-rays.shape[1] // clusters.SWEEP_BLOCK)
    live_blocks = -(-n // clusters.SWEEP_BLOCK)
    res = dict(blocks_per_sm=per_sm, sms=n_sm, packed=n,
               ray_blocks=live_blocks, waves=clusters.SWEEP_WAVES)
    for name, k_max in (("default", clusters.SPLIT_MAX), ("unsplit", 1)):
        out = torch.full_like(want, -7.0)

        def run():
            fm._sweep_kernel(tb, p, rays, ray_id, cnt, out, occl=occl,
                             lists=lists, k_max=k_max)
        run()                                                   # warm-up
        sync(rays.device)
        equal = torch.equal(out[:, lanes], want[:, lanes])
        if not equal:
            raise RuntimeError(f"the {'occlusion' if occl else 'nearest'} "
                               f"sweep ({name}) differs from its plain "
                               f"version")
        ms = timed(lambda: [run() for _ in range(n_iters)]) / n_iters
        k_max = max(1, min(k_max, tb.mp.n_clusters))
        k = clusters.split_count(n, per_sm * n_sm * clusters.SWEEP_WAVES,
                                 k_max)
        res[name] = dict(ms=ms, k=k, k_max=k_max,
                         grid_blocks=ray_blocks * k_max,
                         live_blocks=live_blocks * k,
                         live_blocks_per_sm=live_blocks * k / n_sm,
                         bit_equal=equal)
    return res


def mesh_fused_speed_phase(dev, cfg, smi, n_calls=3, n_steps=16,
                           n_iters=20) -> dict:
    """bench.py's mc_bunny_mesh_fused: n_steps per call, a warm-up, then
    n_calls timed calls -> rays/s.  Then each entry point alone on the
    state the calls left (CUDA events, ms per launch = per step), its
    plain version once, and its bound from this step's populations."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    scene, cam, mp, st, caps, p, tb = mesh_setup(dev, cfg)
    kw = dict(cap_main=caps[0], cap_shadow=caps[1], device=dev)
    st, of, _ = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED_KEY0, st,
                                              n_steps, **kw)   # warm-up
    sync(dev)
    st = dataclasses.replace(st, nrays=torch.zeros_like(st.nrays))
    overflow = 0
    t0 = time.perf_counter()
    for _ in range(n_calls):
        st, of, npred = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED_KEY0,
                                                      st, n_steps, **kw)
        overflow += int(of)     # one device read per call, as in _drive
    sync(dev)
    dt = time.perf_counter() - t0
    rays = int(st.nrays)

    # one real step fills the buffers; then each entry point alone
    r = st.s.shape[0]
    sf, si = fused.state_planes(st)
    b = fm.step_buffers(r, p, 1, dev)
    fm.run_steps(fm.KERNEL_OPS, tb, p, SEED_KEY0, sf.clone(), si.clone(), 1,
                 b)
    n_main, n_shadow = b.cnt[0].tolist()
    sf2, si2 = sf.clone(), si.clone()
    res, plain_out, tests = {}, {}, {}
    for name in fm.OP_NAMES:
        def counters(n):
            """A step's populations: the packers add to 0s, the sweeps
            read this step's."""
            if name in ("nearest", "occl"):
                return b.cnt[0:1].repeat(n, 1)
            return torch.zeros((n, 2), dtype=torch.int32, device=dev)
        bt = b._replace(cnt=counters(n_iters + 1))

        def launch(i):
            fm.run_op(fm.KERNEL_OPS, name, tb, p, SEED_KEY0, sf2, si2, bt, k=i)
        launch(n_iters)                                         # warm-up
        # on the device (the card kept busy while the host enqueues the
        # launches), and back to back with the host's work between them
        ms = timed(lambda: [launch(i) for i in range(n_iters)],
                   busy_ms=20.0) / n_iters
        host_ms = timed(lambda: [launch(i) for i in range(n_iters)]) / n_iters
        bp = fm.StepBuffers(*[x.clone() for x in b])._replace(cnt=counters(1))
        plain_ms = timed(lambda: plain_out.update({name: fm.run_op(
            fm.PLAIN_OPS, name, tb, p, SEED_KEY0, sf.clone(), si.clone(),
            bp)}))
        res[name] = dict(ms=ms, with_host_ms=host_ms, plain_ms=plain_ms)
        if name in ("nearest", "occl"):
            occl = name == "occl"
            packed = b.sr if occl else b.mr
            ids = b.sr_id if occl else b.mr_id
            cnt = b.cnt[0, 1:2] if occl else b.cnt[0, 0:1]
            want = bp.kb[8:9] if occl else bp.hf[5:10]
            serial = plain_out[name]
            tests[name] = sweep_tests(
                mp, p, packed, cnt, serial,
                torch.full_like(serial, mp.n_clusters))
            res[name].update(serial_triangle_tests=int(serial.sum()),
                             **tests[name])
            # The op is the grouping, then the sweep over the grouped
            # rays: each alone, and the sweep in pack order.
            group = "group_occl" if occl else "group"
            res[group] = group_speed(tb, p, packed, ids, cnt, n_iters, occl)
            g_rays, g_id, _ = fm._group_kernel(tb, p, packed, ids, cnt,
                                               occl=occl)
            res[name]["pack_order_splits"] = sweep_splits(
                tb, p, packed, ids, cnt, want, occl, None, n_iters)
            packed, ids = g_rays, g_id
            res[name]["boxes_crossed_per_warp_grouped"] = crossed_counts(
                mp.smc_aabb, packed.view(packed.shape[0], -1, 128), p.t_min,
                cnt)[1]
            res[name]["splits"] = sweep_splits(
                tb, p, packed, ids, cnt, want, occl, None, n_iters)
            res[name]["sweep_ms"] = res[name]["splits"]["default"]["ms"]
            if occl:
                occl_tests = int(serial.sum())
                occluded = int(bp.kb[8].sum())
    k1_boxes = k1_box_tests(mp, p, sf, b.hf[0])
    res["k1"].update(box_tests_per_lane=k1_boxes / r,
                     box_tests_per_lane_every_box=mp.pred_aabb.shape[0])
    bounds = mesh_bounds(mp, r, n_main, n_shadow, tests["nearest"],
                         tests["occl"], k1_boxes)
    for name in list(fm.OP_NAMES) + ["group", "group_occl"]:
        res[name].update(bound(*bounds[name]))
    emit(phase="mesh_fused_speed", nvidia_smi=smi, lanes=r,
         n_steps=n_steps, n_calls=n_calls, caps=list(caps),
         rays_per_s=rays / dt, ms_per_step=dt / (n_calls * n_steps) * 1e3,
         overflow=overflow, packed_per_step=[n_main, n_shadow],
         occl_triangle_tests=occl_tests,
         occl_tests_per_shadow_ray=occl_tests / max(n_shadow, 1),
         occl_tests_all_clusters=n_shadow * mp.n_clusters * mp.cs,
         occluded_share=occluded / max(n_shadow, 1),
         kernel_ms_per_step=sum(res[k]["ms"] for k in fm.OP_NAMES),
         bound_ms_per_step=sum(res[k]["bound_ms"] for k in fm.OP_NAMES),
         per_kernel=res)
    return res


# --- the coherent shortlist intersector and the shortlist sweep --------------

COHERENT_TPU = {"mask": ("ops/coherent.py::_mask_kernel",
                         "cpu_based_ray_tracer_tpu/ops/coherent.py:86"),
                "sweep": ("ops/coherent.py::_sweep_kernel",
                          "cpu_based_ray_tracer_tpu/ops/coherent.py:165")}
SL_TPU = ("ops/fused_mesh.py::_mesh_sl_kernel",
          "cpu_based_ray_tracer_tpu/ops/fused_mesh.py:984")
BVH_SUBDIVISIONS = 4     # bvh_stage_scene(4): 7,424 triangles, 58 clusters
SWEEP_SLICES = (1, 2, 3, 5, 8, 16)   # slice counts the sweep is held at


def list_stats(cnts, n_tiles=None) -> dict:
    """Mean and max list length over the first n_tiles tiles (default
    all)."""
    c = cnts[:n_tiles].double() if n_tiles is not None else cnts.double()
    return dict(tiles=int(c.numel()), mean=float(c.mean()) if c.numel()
                else 0.0, max=int(c.max()) if c.numel() else 0)


def listed_clusters(ids, cnts, n_cl: int, n_tiles: int) -> int:
    """How many clusters the first n_tiles tiles' lists name, together."""
    listed = torch.zeros(n_cl, dtype=torch.bool, device=ids.device)
    flat = ids.view(-1, n_cl)
    for t, c in enumerate(cnts[:n_tiles].tolist()):
        listed[flat[t, :c].long()] = True
    return int(listed.sum())


def rows_crossed(rays, tri, t_min: float, chunk: int = 8192):
    """How many rows of the cluster table tri (C, CS, 16) each lane of the
    (6, H, W) ray planes needs to test: the rows holding a triangle (slot
    13 >= 0) whose own box, the least and greatest of v0, v0 + e1 and
    v0 + e2 widened by one ulp, the ray's line crosses from min(t_min, 0)
    on.  A ray can hit no other row.  Counted here, apart from the kernel
    and its package, a chunk of lanes at a time against every row."""
    rows = tri.reshape(-1, tri.shape[-1])
    rows = rows[rows[:, 13] >= 0]
    v0 = rows[:, 0:3]
    corners = torch.stack([v0, v0 + rows[:, 3:6], v0 + rows[:, 6:9]])
    lo = torch.nextafter(corners.amin(0), torch.full_like(v0, -math.inf))
    hi = torch.nextafter(corners.amax(0), torch.full_like(v0, math.inf))
    planes = rays.reshape(rays.shape[0], -1)
    o, d = planes[0:3].T, planes[3:6].T
    # 1 / d with |d| raised to at least 1e-20, keeping its sign (the
    # kernels' safe reciprocal)
    inv = 1.0 / torch.where(d.abs() < 1e-20,
                            torch.where(d < 0, -1e-20, 1e-20), d)
    t_lo = min(t_min, 0.0)
    counts = []
    for a in range(0, o.shape[0], chunk):
        t_in = t_out = None
        for ax in range(3):
            oa, ia = o[a:a + chunk, ax:ax + 1], inv[a:a + chunk, ax:ax + 1]
            t0, t1 = (lo[:, ax] - oa) * ia, (hi[:, ax] - oa) * ia
            near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
            t_in = near if t_in is None else torch.maximum(t_in, near)
            t_out = far if t_out is None else torch.minimum(t_out, far)
        counts.append(((t_out >= t_lo) & (t_in <= t_out)).sum(1))
    return torch.cat(counts)


def coherent_bounds(rays, tri, aabb, cnts, ids, t_min: float) -> dict:
    """(ops, bytes) of the shortlist sweep over these ray planes, and its
    work: each lane's box tests over its tile's list (SLAB_OPS each) and TRI_OPS per row whose triangle's box it
    crosses (``rows_crossed``), against the rays, the lists, the clusters
    listed anywhere and the (t, index) planes.  Beside it, each as a
    bound: the kernel's own work (the rows of the 8-row groups whose boxes
    a ray crosses, and the boxes of those groups), the triangles of every
    crossed cluster, and of every listed one (every lane against every
    triangle of its tile's list, the count of PR 8's bound)."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent

    _, hp, wp = rays.shape
    n_cl, cs = tri.shape[0], tri.shape[1]
    lanes, n_tiles = hp * wp, cnts.numel()
    rows = rows_crossed(rays, tri, t_min)
    gbox = coherent.group_boxes_plain(tri)
    n_groups = gbox.shape[1]
    crossed, per_warp = crossed_counts(aabb, rays, t_min)
    g_crossed, g_per_warp = crossed_counts(gbox.reshape(-1, 8), rays, t_min)
    listed = int(cnts.long().sum()) * 4096
    work = dict(boxes_listed_per_ray=listed / lanes,
                boxes_crossed_per_ray=float(crossed.double().mean()),
                boxes_crossed_per_warp=per_warp,
                rows_crossed_per_ray=float(rows.double().mean()),
                groups_crossed_per_ray=float(g_crossed.double().mean()),
                groups_crossed_per_warp=g_per_warp,
                box_tests=listed,
                needed_triangle_tests=int(rows.sum()),
                group_box_tests=listed + int(crossed.sum()) * n_groups,
                group_triangle_tests=int(g_crossed.sum())
                * coherent.GROUP_ROWS,
                crossed_cluster_triangle_tests=int(crossed.sum()) * cs,
                listed_triangle_tests=listed * cs)
    sweep_bytes = (lanes * (24 + 8) + n_tiles * (n_cl + 1) * 4
                   + listed_clusters(ids, cnts, n_cl, n_tiles) * cs * 64)
    for k, tests, boxes in (
            ("group", "group_triangle_tests", "group_box_tests"),
            ("crossed_cluster", "crossed_cluster_triangle_tests",
             "box_tests"),
            ("listed", "listed_triangle_tests", "box_tests")):
        work[f"{k}_bound_ms"] = bound(
            work[tests] * TRI_OPS + work[boxes] * SLAB_OPS,
            sweep_bytes)["bound_ms"]
    return {
        "sweep": (work["needed_triangle_tests"] * TRI_OPS
                  + work["box_tests"] * SLAB_OPS, sweep_bytes),
        "work": work}


def spread(xs) -> dict:
    """Median, min and max of a list of samples."""
    xs = sorted(xs)
    return dict(median=xs[len(xs) // 2], min=xs[0], max=xs[-1])


def bound(ops: float, nbytes: float) -> dict:
    """The least time of ``ops`` f32 operations and ``nbytes`` bytes at the
    card's peaks (bound_ms, and what bounds it), and at the issue rate of
    the port's -fmad=false build (bound_no_fma_ms)."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_no_fma_ms=max(ops / PEAK_F32_NO_FMA, t_bytes) * 1e3,
                ops=ops, bytes=nbytes)


def camera_rays(cam, cfg):
    from cpu_based_ray_tracer_tpu_torch import camera

    d = camera.perspective_rays(cam, cfg.width, cfg.height).reshape(-1, 3)
    return cam.position.expand(d.shape).contiguous(), d.contiguous()


def mesh_fused_whitted_main_phase(dev, cfg, n_frames=7) -> tuple:
    """mesh.render(prepare(bvh_stage_scene(4), method="fused")) once,
    counters set to 0 just before and read just after; then the packet
    oracle, which must agree on every pixel but those whose camera ray
    hits two triangles at the same t (the two intersectors' clusters order
    ties differently); each such pixel is listed.  Then both methods'
    frames timed warm, n_frames each (median, min, max seconds).  Returns
    (coherent launches, the light-0 shadow rays the frame sent)."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.ops import coherent, packet
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes

    scene = meshes.bvh_stage_scene(BVH_SUBDIVISIONS, device=dev)
    cam = meshes.bvh_stage_camera(dev)
    bundle = mesh.prepare(scene, method="fused")
    sent = []
    with recording_shadow_rays(sent):
        sync(dev)
        reset_counts()
        img = mesh.render(bundle, cam, cfg, device=dev)
        sync(dev)
        launches = read_counts()
    shadow = light0_rays(sent, scene, cfg)
    pbundle = mesh.prepare(scene)
    oracle = mesh.render(pbundle, cam, cfg, device=dev)
    # both frames warm, n_frames each, the host's clock around a
    # synchronised call
    secs = {}
    for name, b in (("fused", bundle), ("packet", pbundle)):
        secs[name] = []
        for _ in range(n_frames):
            sync(dev)
            t0 = time.perf_counter()
            mesh.render(b, cam, cfg, device=dev)
            sync(dev)
            secs[name].append(time.perf_counter() - t0)
    res = pixels_off(img, oracle, 1e-4, 1e-5)
    d = (img - oracle).abs()
    off = (d > 1e-5 + 1e-4 * oracle.abs()).any(-1).reshape(-1)
    o, dd = camera_rays(cam, cfg)
    t_f, i_f = coherent.nearest(bundle.coherent, o, dd, cfg.t_min,
                                hw=(cfg.height, cfg.width))
    t_p, i_p = packet.nearest(pbundle.clusters, o, dd, cfg.t_min)
    tie = (t_f == t_p) & (i_f != i_p)
    listed = [dict(pixel=[k // cfg.width, k % cfg.width],
                   fused=img.reshape(-1, 3)[k].tolist(),
                   packet=oracle.reshape(-1, 3)[k].tolist(),
                   t=float(t_f[k]), tris=[int(i_f[k]), int(i_p[k])],
                   exact_t_tie=bool(tie[k]))
              for k in torch.nonzero(off)[:, 0].tolist()]
    finite = bool(torch.isfinite(img).all())
    emit(phase="mesh_fused_whitted_main", config=f"bvh_stage_scene"
         f"({BVH_SUBDIVISIONS}) {cfg.width}x{cfg.height} depth"
         f"{cfg.whitted_depth} method=fused", tris=scene.triangles.count,
         clusters=bundle.coherent.n_clusters,
         seconds=spread(secs["fused"]), packet_seconds=spread(secs["packet"]),
         frames_timed=n_frames, launches=launches, vs_packet=res,
         camera_t_bit_equal_share=float((t_f == t_p).float().mean()),
         camera_index_ties=int(tie.sum()), pixels_off_listed=listed[:64],
         finite=finite, mean_radiance=float(img.mean()),
         png=save_png(img, f"mesh_fused_{cfg.width}.png"))
    if (launches["packet"] != 0 or launches["coherent"]["mask"] <= 0
            or launches["coherent"]["sweep"] <= 0):
        raise RuntimeError(f"mesh.render(fused) launches {launches}")
    if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
            or not float(img.mean()) > 0.0):
        raise RuntimeError("the fused mesh Whitted image is wrong")
    if not all(p["exact_t_tie"] for p in listed):
        raise RuntimeError(f"mesh.render fused vs packet: {res}, pixels off "
                           f"that are no exact-t tie: "
                           f"{[p for p in listed if not p['exact_t_tie']]}")
    return launches["coherent"], shadow


def coherent_parity_phase(dev, cfg, shadow) -> tuple:
    """The mask and the sweep kernels against mask_plain and sweep_plain
    on bvh_stage_scene(4)'s camera rays and the fused frame's light-0
    shadow rays (pixel tiles), and on the shadow rays of the pixels whose
    camera ray hits the mesh, compacted (a flat set: strip tiles).
    Returns ({kernel: max abs error}, the pack, the camera rays, {case:
    (ray planes, ids, cnts)})."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent
    from cpu_based_ray_tracer_tpu_torch.ops.intersect import NO_HIT_T
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes
    from cpu_based_ray_tracer_tpu_torch.ops import clusters

    scene = meshes.bvh_stage_scene(BVH_SUBDIVISIONS, device=dev)
    pack = coherent.pack_coherent(scene)
    o, d = camera_rays(meshes.bvh_stage_camera(dev), cfg)
    hw = (cfg.height, cfg.width)
    t_cam, _ = coherent.nearest(pack, o, d, cfg.t_min, hw=hw)
    hit = t_cam < NO_HIT_T
    cases = {"camera": (o, d, hw), "shadow": (*shadow, hw),
             "shadow_compacted": (shadow[0][hit].contiguous(),
                                  shadow[1][hit].contiguous(), None)}
    errs = {"mask": 0.0, "sweep": 0.0}
    swept = {}
    for name, (oo, dd, hw_) in cases.items():
        rays, _ = coherent._to_planes(oo, dd, hw_)
        mk, wk = coherent._mask_kernel(pack.aabb, rays, cfg.t_min,
                                       boxes=pack.boxes)
        # as the lists run it: no planes, the lists in the same launch
        _, wk0, ids_k, cnts_k = coherent._mask_kernel(
            pack.aabb, rays, cfg.t_min, planes=False, boxes=pack.boxes,
            lists=True)
        mp_, wp_ = coherent.mask_plain(pack.aabb, rays, cfg.t_min)
        mc_, wc_ = coherent.mask_plain(pack.aabb, rays, cfg.t_min,
                                       boxes=pack.boxes)
        ids, cnts = coherent._lists(wp_, pack.n_clusters)
        out_p = coherent.sweep_plain(pack.tri, rays, ids, cnts, cfg.t_min)
        k_default = clusters.slices(
            coherent.LIB, "coherent_sweep_slots",
            rays.shape[1] * rays.shape[2], pack.n_clusters, pack.cs)
        same = {"masks": torch.equal(mk, mp_), "tile_words": torch.equal(wk, wp_),
                "tile_words_no_planes": torch.equal(wk0, wp_),
                "ids": torch.equal(ids_k, ids), "cnts": torch.equal(cnts_k, cnts),
                "plain_cull": torch.equal(mc_, mp_) and torch.equal(wc_, wp_)}
        err = 0.0
        hits = out_p[0] < NO_HIT_T
        # the sweep at the default slice count and at each of SWEEP_SLICES:
        # t and index bit equal to the serial unculled plain sweep
        for k in sorted({k_default, *SWEEP_SLICES}):
            out_k = coherent._sweep_kernel(pack.tri, pack.aabb, rays, ids,
                                           cnts, cfg.t_min, k=k)
            sync(dev)
            same[f"t_k{k}"] = torch.equal(out_k[0].view(torch.int32),
                                          out_p[0].view(torch.int32))
            same[f"index_k{k}"] = torch.equal(out_k[1], out_p[1])
            err = max(err, max_abs(out_k[0][hits], out_p[0][hits]))
        emit(phase="coherent_parity", case=name, rays=oo.shape[0],
             planes=list(rays.shape), tiling="pixel" if hw_ else "strip",
             clusters=pack.n_clusters, lists=list_stats(cnts),
             slices_default=k_default,
             hits=int((out_p[1] >= 0).sum()), equal=same, max_abs_err=err)
        if not all(same.values()):
            raise RuntimeError(f"csrc/coherent.cu disagrees with its plain "
                               f"version on {name}: {same}")
        errs["mask"] = max(errs["mask"], max_abs(wk, wp_), max_abs(mk, mp_))
        errs["sweep"] = max(errs["sweep"], err)
        swept[name] = (rays, ids, cnts)
    return errs, pack, (o, d), swept


def coherent_speed_phase(dev, cfg, pack, cam_rays, swept, smi,
                         n_iters=20) -> dict:
    """The mask and the sweep kernels alone (CUDA events) in ms per 896x896
    camera pass of bvh_stage_scene(4), beside packet.cu on the same rays
    and the plain versions; the sweep at its default slice count and at
    each of SWEEP_SLICES, here and on the other cases' rays (``swept``);
    the bounds from this pass's lists and the boxes each ray crosses
    (``coherent_bounds``)."""
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.ops import coherent, packet
    from cpu_based_ray_tracer_tpu_torch.scenes import meshes
    from cpu_based_ray_tracer_tpu_torch.ops import clusters

    o, d = cam_rays
    rays, _ = coherent._to_planes(o, d, (cfg.height, cfg.width))
    t_min = cfg.t_min
    # the mask kernel as the lists run it (one launch: the tile words and
    # the lists), and without the lists (the tile words alone)
    lists = functools.partial(coherent._shortlists, pack.aabb, rays, t_min,
                              boxes=pack.boxes)
    words_only = functools.partial(coherent._mask_kernel, pack.aabb, rays,
                                   t_min, planes=False, boxes=pack.boxes)
    lists()
    words_only()                                                # warm-up
    mask_ms = timed(lambda: [lists() for _ in range(n_iters)]) / n_iters
    words_ms = timed(lambda: [words_only() for _ in range(n_iters)]
                     ) / n_iters
    # the host's wall around back-to-back calls on an idle card: what
    # mesh.render, host-bound, waits for the lists
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        lists()
    sync(dev)
    lists_wall_ms = (time.perf_counter() - t0) / n_iters * 1e3
    ids, cnts = lists()
    lanes = rays.shape[1] * rays.shape[2]
    k_default = clusters.slices(coherent.LIB, "coherent_sweep_slots",
                                lanes, pack.n_clusters, pack.cs)
    sweep_ms = {}
    for k in sorted({k_default, *SWEEP_SLICES}):
        def sweep(k=k):
            coherent._sweep_kernel(pack.tri, pack.aabb, rays, ids, cnts,
                                   t_min, k=k)
        sweep()                                                 # warm-up
        sweep_ms[k] = timed(lambda: [sweep() for _ in range(n_iters)]
                            ) / n_iters
    # the sweep at each slice count on the other cases' rays too
    by_case = {}
    for name, (c_rays, c_ids, c_cnts) in swept.items():
        if name == "camera":
            continue
        k_c = clusters.slices(coherent.LIB, "coherent_sweep_slots",
                              c_rays.shape[1] * c_rays.shape[2],
                              pack.n_clusters, pack.cs)
        by_case[name] = {"slices_default": k_c, "ms_by_slices": {}}
        for k in sorted({k_c, *SWEEP_SLICES}):
            def sweep(k=k):
                coherent._sweep_kernel(pack.tri, pack.aabb, c_rays, c_ids,
                                       c_cnts, t_min, k=k)
            sweep()                                             # warm-up
            by_case[name]["ms_by_slices"][k] = timed(
                lambda: [sweep() for _ in range(n_iters)]) / n_iters
    mask_plain_ms = timed(lambda: coherent._lists(coherent.mask_plain(
        pack.aabb, rays, t_min, planes=False)[1], pack.n_clusters))
    sweep_plain_ms = timed(lambda: coherent.sweep_plain(pack.tri, rays, ids,
                                                        cnts, t_min))
    cl = mesh.prepare(meshes.bvh_stage_scene(BVH_SUBDIVISIONS,
                                             device=dev)).clusters
    packet._nearest_kernel(cl, o, d, t_min)                      # warm-up
    packet_ms = timed(lambda: [packet._nearest_kernel(cl, o, d, t_min)
                               for _ in range(n_iters)]) / n_iters
    bounds = coherent_bounds(rays, pack.tri, pack.aabb, cnts, ids, t_min)
    work = bounds["work"]
    m_work = mask_work(pack.aabb, rays, t_min)
    res = {"mask": dict(ms=mask_ms, plain_ms=mask_plain_ms,
                        words_only_ms=words_ms, lists_wall_ms=lists_wall_ms,
                        work=m_work,
                        **mask_bound(m_work, rays.shape[0], pack.n_clusters,
                                     cnts.numel())),
           "sweep": dict(ms=sweep_ms[k_default], plain_ms=sweep_plain_ms,
                         slices=k_default, unsplit_ms=sweep_ms[1],
                         ms_by_slices=sweep_ms,
                         group_bound_ms=work["group_bound_ms"],
                         crossed_cluster_bound_ms=work[
                             "crossed_cluster_bound_ms"],
                         listed_triangle_bound_ms=work["listed_bound_ms"],
                         **bound(*bounds["sweep"]))}
    emit(phase="coherent_speed", nvidia_smi=smi, rays=o.shape[0],
         clusters=pack.n_clusters, lists=list_stats(cnts), work=work,
         mask_plus_sweep_ms=mask_ms + sweep_ms[k_default],
         packet_ms=packet_ms, packet_clusters=cl.n_clusters, per_kernel=res,
         sweep_other_cases=by_case)
    return res


def mesh_164k_setup(dev, cfg):
    """tools/bench_passes.py's mc_mesh_fused_164k: two icospheres(6) in the
    Cornell box (163,862 triangles, 1,280 clusters), caps rp//8 and
    rp//16."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes

    ico = meshes.icosphere(6)
    scene = cornell.cornell_mesh_scene(
        np.concatenate([ico, ico * 0.6 + [1.2, 0.9, 0.3]]), device=dev)
    cam = cornell.cornell_camera(dev)
    mp = fm.pack_mesh_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg, SEED_KEY0, device=dev)
    rp = -(-st.s.shape[0] // fm.LANES_PER_TILE) * fm.LANES_PER_TILE
    caps = (rp // 8, rp // 16)
    p = fm.params(cfg, st.s.shape[0], *caps)
    tb = fm._tables(mp, fused._camera_words(cam))
    return scene, cam, mp, st, caps, p, tb


def mesh_fused_164k_phase(dev, cfg, n_steps=16) -> dict:
    """The 164k cell: the auto rule; render_turbo_mesh_exact (the main path,
    counters set to 0 just before and read just after); n_steps from
    wavefront_init with resident=False against resident=True; then one
    step of each shortlist sweep against its plain version, and the mask
    kernel on each sweep's packed rays against the plain mask pass and
    lists, with the list lengths.  Returns the main path's launches and
    the max abs errors."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    scene, cam, mp, st, caps, p, tb = mesh_164k_setup(dev, cfg)
    if fm.fits_resident(mp.n_clusters, mp.cs):
        raise RuntimeError("the 164k table fits the SMEM budget: the auto "
                           "rule would not take the shortlists")
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    img = fm.render_turbo_mesh_exact(scene, cam, cfg, SEED_KEY0, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = read_counts()
    steps = sum(t["steps"] for t in fm.TRACE)    # overflowed chunks included
    finite = bool(torch.isfinite(img).all())
    emit(phase="mesh_fused_164k", part="main", config=f"two icospheres(6) "
         f"{cfg.width}x{cfg.height} {cfg.spp}spp depth{cfg.max_depth} "
         f"rr{cfg.rr_survival}", tris=scene.triangles.count,
         clusters=mp.n_clusters, resident=False, seconds=secs, steps=steps,
         launches=launches, trace=fm.TRACE, finite=finite,
         mean_radiance=float(img.mean()),
         png=save_png(img, f"mesh_fused_164k_{cfg.width}.png", 2.0))
    fmesh = launches["fused_mesh"]
    if (launches["packet"] != 0 or fmesh["nearest"] or fmesh["occl"]
            or fmesh["group"] or fmesh["group_occl"]
            or any(fmesh[k] != steps for k in ("k1", "k1b", "k2",
                                              "nearest_sl", "occl_sl"))
            or launches["coherent"]["mask"] != 2 * steps or steps <= 0):
        raise RuntimeError(f"164k main path: launches {launches}, {steps} "
                           f"steps run")
    if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
            or not float(img.mean()) > 0.0):
        raise RuntimeError("the 164k image is wrong")

    kw = dict(cap_main=caps[0], cap_shadow=caps[1], device=dev)
    a, of_a, np_a = fm.wavefront_steps_fused_mesh(
        mp, cam, cfg, SEED_KEY0, st, n_steps, resident=True, **kw)
    b, of_b, np_b = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED_KEY0,
                                                  st, n_steps, **kw)
    sync(dev)
    cmp = compare_states(b, a)
    bits = {f: torch.equal(getattr(a, f), getattr(b, f))
            for f in ("s", "b", "n_done", "nrays", "o", "d", "tp", "cur",
                      "acc")}
    lanes_off = torch.zeros_like(a.s, dtype=torch.bool)
    for f in ("o", "d", "tp", "cur", "acc"):
        lanes_off |= (getattr(a, f) != getattr(b, f)).any(-1)
    emit(phase="mesh_fused_164k", part="shortlist_vs_resident",
         n_steps=n_steps, caps=list(caps), overflow=[int(of_b), int(of_a)],
         npred=[np_b.tolist(), np_a.tolist()], bit_equal=bits,
         float_lanes_off=torch.nonzero(lanes_off)[:64, 0].tolist(), **cmp)
    if (cmp["int_mismatch_lanes"] or not torch.equal(np_a, np_b)
            or not bits["nrays"] or int(of_a) or int(of_b)):
        raise RuntimeError("resident=False disagrees with resident=True on "
                           "the 164k cell")

    # one step of each shortlist sweep against its plain version, from the
    # state three kernel steps in (primary and bounce rays mixed)
    st3, _, _ = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED_KEY0, st, 3,
                                              **kw)
    sf, si = fused.state_planes(st3)
    bp = fm.StepBuffers(*[torch.zeros_like(x) for x in
                          fm.step_buffers(sf.shape[1], p, 1, dev)])
    fm.run_op(fm.PLAIN_OPS, "k1", tb, p, SEED_KEY0, sf, si, bp)
    errs, same, lists = {}, {}, {}
    for name, prep in (("nearest", None), ("occl", "k1b")):
        if prep:
            fm.run_op(fm.PLAIN_OPS, prep, tb, p, SEED_KEY0, sf, si, bp)
        bk = fm.StepBuffers(*[x.clone() for x in bp])
        fm.run_op(fm.KERNEL_SL_OPS, name, tb, p, SEED_KEY0, sf, si, bk)
        fm.run_op(fm.PLAIN_SL_OPS, name, tb, p, SEED_KEY0, sf, si, bp)
        sync(dev)
        out_k, out_p = (bk.hf, bp.hf) if name == "nearest" else (bk.kb, bp.kb)
        same[name] = torch.equal(out_k, out_p)
        errs[name] = max_abs(out_k, out_p)
        k = 0 if name == "nearest" else 1
        n = min(int(bp.cnt[0, k]), bp.mr.shape[1] if k == 0
                else bp.sr.shape[1])
        rays = bp.mr if k == 0 else bp.sr
        # the mask kernel on this pass's packed rays against the plain
        # mask pass and lists: planes, tile words, ids and counts
        planes, c = rays.view(rays.shape[0], -1, 128), bp.cnt[0, k:k + 1]
        mk, wk, ids_k, cnts_k = coherent._mask_kernel(
            mp.smc_aabb, planes, p.t_min, c, boxes=mp.smc_level_boxes,
            lists=True)
        m_p, w_p = coherent.mask_plain(mp.smc_aabb, planes, p.t_min, c)
        ids_p, cnts = coherent._lists(w_p, mp.n_clusters)
        ids_l, cnts_l = fm._lists(tb, p, rays, c, kernel=True)
        same[f"{name}_mask"] = (torch.equal(mk, m_p) and torch.equal(wk, w_p)
                                and torch.equal(ids_k, ids_p)
                                and torch.equal(cnts_k, cnts)
                                and torch.equal(ids_l, ids_p)
                                and torch.equal(cnts_l, cnts))
        errs[f"{name}_mask"] = max_abs(wk, w_p)
        lists[name] = dict(packed=n, **list_stats(cnts, -(-n // 4096)))
    emit(phase="mesh_fused_164k", part="shortlist_sweeps_vs_plain",
         equal=same, max_abs_err=errs, lists=lists)
    if not all(same.values()):
        raise RuntimeError(f"the shortlist sweeps or the mask passes "
                           f"disagree with their plain versions: {same}")
    return launches, errs


def sl_speed_phase(dev, cfg, smi, n_calls=3, n_steps=16, n_iters=10) -> dict:
    """The 164k cell timed as tools/bench_passes.py's scale_case (a warm-up,
    then n_calls of n_steps) in both modes -> rays/s; then, on a real
    step's buffers, the shortlist sweeps and the mask pass alone (CUDA
    events) beside the all-cluster sweeps on the same packed rays, the
    plain versions, and the bounds from this step's lists."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.ops import clusters
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    scene, cam, mp, st0, caps, p, tb = mesh_164k_setup(dev, cfg)
    modes = {}
    for resident in (False, True):
        kw = dict(cap_main=caps[0], cap_shadow=caps[1], resident=resident,
                  device=dev)
        st, _, _ = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED_KEY0, st0,
                                                 n_steps, **kw)   # warm-up
        sync(dev)
        st = dataclasses.replace(st, nrays=torch.zeros_like(st.nrays))
        overflow = 0
        t0 = time.perf_counter()
        for _ in range(n_calls):
            st, of, _ = fm.wavefront_steps_fused_mesh(mp, cam, cfg, SEED_KEY0,
                                                      st, n_steps, **kw)
            overflow += int(of)
        sync(dev)
        dt = time.perf_counter() - t0
        modes["shortlists" if not resident else "all_clusters"] = dict(
            rays_per_s=int(st.nrays) / dt,
            ms_per_step=dt / (n_calls * n_steps) * 1e3, overflow=overflow)
        if not resident:
            st_sl = st
    # one real step fills the buffers
    r = st_sl.s.shape[0]
    sf, si = fused.state_planes(st_sl)
    b = fm.step_buffers(r, p, 1, dev)
    fm.run_steps(fm.KERNEL_SL_OPS, tb, p, SEED_KEY0, sf.clone(), si.clone(),
                 1, b)
    n_main, n_shadow = b.cnt[0].tolist()
    res, lists = {}, {}
    for occl in (False, True):
        rays, ids_, out = ((b.sr, b.sr_id, b.kb[8:9].clone()) if occl
                           else (b.mr, b.mr_id, b.hf[5:10].clone()))
        cnt = b.cnt[0, 1:2] if occl else b.cnt[0, 0:1]
        n = min(int(cnt), rays.shape[1])
        lst = fm._lists(tb, p, rays, cnt, kernel=True)

        def run(lists):
            fm._sweep_kernel(tb, p, rays, ids_, cnt, out, occl=occl,
                             lists=lists)
        run(lst)                                                # warm-up
        ms = timed(lambda: [run(lst) for _ in range(n_iters)]) / n_iters
        run(None)
        all_ms = timed(lambda: [run(None) for _ in range(n_iters)]) / n_iters
        # the mask kernel as the step runs it (fm._lists: one launch, the
        # tile words and the lists) and without the lists
        planes = rays.view(rays.shape[0], -1, 128)
        mask = functools.partial(fm._lists, tb, p, rays, cnt, kernel=True)
        words_only = functools.partial(
            coherent._mask_kernel, mp.smc_aabb, planes, p.t_min, cnt,
            planes=False, boxes=mp.smc_level_boxes)
        mask()
        words_only()                                            # warm-up
        mask_ms = timed(lambda: [mask() for _ in range(n_iters)]) / n_iters
        words_ms = timed(lambda: [words_only() for _ in range(n_iters)]
                         ) / n_iters
        mask_plain_ms = timed(lambda: fm._lists(tb, p, rays, cnt,
                                                kernel=False))
        m_work = mask_work(mp.smc_aabb, planes, p.t_min, cnt)
        m_bound = mask_bound(m_work, rays.shape[0], mp.n_clusters,
                             -(-n // 4096))
        outp = out.clone()
        tests = {}
        plain_ms = timed(lambda: tests.update(t=fm._sweep_plain(
            tb, p, rays, ids_, cnt, outp, occl=occl, lists=lst)))
        splits = sweep_splits(tb, p, rays, ids_, cnt, outp, occl, lst,
                              n_iters)
        n_tiles = -(-n // 4096)
        if occl:
            # the tests of the default split's K slices if each stopped a
            # ray only at its own first occluder (the plain split sweep):
            # the kernel's slices, which also stop once another slice has
            # set the ray's flag, make at most these
            n_t = rays.shape[1] // 4096
            _, _, t_split = clusters.split_sweep_plain(
                mp.smc_tri, rays.view(7, n_t, 4096),
                lst[0].view(n_t, mp.n_clusters), lst[1], p.t_min,
                splits["default"]["k"], occl=True, n_live=n)
            splits["triangle_tests_serial"] = int(tests["t"].sum())
            splits["triangle_tests_slices"] = int(t_split.sum())
        per_ray = 32 + 4 if occl else 28 + 20
        listed = lst[1].to(torch.int64).repeat_interleave(4096)[:n]
        need = sweep_tests(mp, p, rays, cnt, tests["t"], listed)
        ops = (need["needed_triangle_tests"] * TRI_OPS
               + need["box_tests"] * SLAB_OPS)
        nbytes = (n * per_ray + n_tiles * (mp.n_clusters + 1) * 4
                  + listed_clusters(*lst, mp.n_clusters, n_tiles) * mp.cs
                  * 64)
        key = "occl_sl" if occl else "nearest_sl"
        res[key] = dict(ms=ms, plain_ms=plain_ms, all_clusters_ms=all_ms,
                        mask_ms=mask_ms, mask_words_only_ms=words_ms,
                        mask_plain_ms=mask_plain_ms, mask_work=m_work,
                        mask_bound=m_bound, packed=n,
                        serial_triangle_tests=int(tests["t"].sum()),
                        **need, splits=splits, **bound(ops, nbytes))
        lists[key] = list_stats(lst[1], n_tiles)
    emit(phase="sl_speed", nvidia_smi=smi, lanes=r, n_steps=n_steps,
         n_calls=n_calls, caps=list(caps), modes=modes,
         packed_per_step=[n_main, n_shadow], lists=lists, per_kernel=res,
         pack_order=pack_order_lists(tb, p, b, si))
    return res


def pack_order_lists(tb, p, b, si) -> dict:
    """The shortlists of one step's packed rays by ray kind (primary,
    bounce, shadow): in the order K1 / K1b packed them (256-lane blocks
    in completion order) and sorted by lane id (the JAX package's lane
    order), each kind packed alone from the buffer's start; mean and max
    list length over its tiles."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm

    n_main, n_shadow = b.cnt[0].tolist()
    bounce = si[1][b.mr_id[:n_main].long()]
    kinds = {"primary": (b.mr, b.mr_id, n_main, bounce == 0),
             "bounce": (b.mr, b.mr_id, n_main, bounce > 0),
             "shadow": (b.sr, b.sr_id, n_shadow, None)}
    out = {}
    for kind, (rays, ids, n, sel) in kinds.items():
        rk, ik = rays[:, :n], ids[:n]
        if sel is not None:
            rk, ik = rk[:, sel], ik[sel]
        m = ik.shape[0]
        out[kind] = dict(rays=m)
        for order in ("packed", "lane"):
            ro = rk[:, torch.argsort(ik)] if order == "lane" else rk
            buf = torch.zeros_like(rays)
            buf[:, :m] = ro
            cnt = torch.tensor([m], dtype=torch.int32, device=rays.device)
            _, cnts = fm._lists(tb, p, buf, cnt, kernel=True)
            out[kind][order] = list_stats(cnts, -(-m // 4096))
    return out


# --- the RTIOW stages and the Denoiser --------------------------------------

RTIOW_TPU = "cpu_based_ray_tracer_tpu/ops/fused_rtiow.py:99"
# f32 add/sub/mul/div/sqrt/rsqrt/min/max/cos/sin/pow that a live lane-step
# of csrc/fused_rtiow.cu needs, counted from its source, by what the step's
# ray meets.  Every live lane-step: 28 per ray/sphere quadratic.  A miss:
# 28 (the ray's normalization, the sky weight and the sky term).  A hit:
# 41 (the winner's normal, its normalization, the facing test, the scatter
# normalization, the throughput) plus its material's branch: Lambert by
# the diffuse model (the sphere sample and the sum; in-sphere adds the
# ball's cube root; in-hemisphere the ball and the side test), metal 48
# (the ray's normalization, the mirror, the ball, the fuzz, the
# below-surface test), dielectric 64 (the ray's normalization, Schlick,
# the mirror and Snell).  Each finished sample's next primary ray: 33
# (perspective) or 50 (thin lens).  The kernel runs every branch on every
# lane and every step, idle lanes too; the function needs only these.  The
# continuation's origin and the integer RNG are not counted: a floor.
RTIOW_SPH_OPS, RTIOW_MISS_OPS, RTIOW_HIT_OPS = 28, 28, 41
RTIOW_LAMBERT_OPS = {0: 18, 1: 14, 2: 20}   # by config.diffuse_model
RTIOW_METAL_OPS, RTIOW_DIELECTRIC_OPS = 48, 64
RTIOW_REGEN_OPS = {False: 33, True: 50}     # by thin lens
SEED_KEY1 = 1883912375   # render_key(1): tools/make_goldens.nppt
SEED_KEY3 = 318053758    # render_key(3): tools/make_goldens.denoiser_triple
SEED_KEY4 = 3781919339   # render_key(4): tools/make_goldens.offline_dof


def rtiow_configs(dev):
    """The two headline RTIOW configurations (tools/bench_passes.py's
    rtiowfused): name -> (scene, camera, config)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.scenes import rtiow

    return {
        "offline": (rtiow.offline_two_sphere_scene(dev),
                    rtiow.offline_camera(400 / 225, device=dev),
                    RenderConfig(width=400, height=225, spp=100,
                                 max_depth=50)),
        "nppt": (rtiow.nppt_scene(dev), rtiow.nppt_camera(dev),
                 RenderConfig(width=883, height=824, spp=256, max_depth=50,
                              gamma=1.0))}


def compare_planes(got_f, got_i, want_f, want_i) -> dict:
    """Integer planes: the lanes that differ (share and the first few);
    float planes: max abs error on the lanes that agree, within rtol = atol
    = TOL or not."""
    bad = (got_i != want_i).any(0)
    agree = ~bad
    err = (got_f[:, agree] - want_f[:, agree]).abs()
    within = bool((err <= TOL + TOL * want_f[:, agree].abs()).all())
    n_bad = int(bad.sum())
    return dict(lanes=int(bad.numel()), int_mismatch_lanes=n_bad,
                int_mismatch_share=n_bad / bad.numel(),
                mismatched=torch.nonzero(bad)[:8, 0].tolist(),
                max_abs_err=float(err.max()) if err.numel() else 0.0,
                float_within_tol=within)


def rtiow_parity_phase(dev, n_steps=64) -> float:
    """csrc/fused_rtiow.cu against _steps_plain at full width from
    render_fused's initial state, for each camera mode (the default
    diffuse model; the depth-of-field camera too); returns the max abs
    error."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_rtiow as fr
    from cpu_based_ray_tracer_tpu_torch.scenes import rtiow

    cases = dict(rtiow_configs(dev))
    cfg_dof = cases["offline"][2]
    cases["offline_dof"] = (rtiow.rtiow_classic_scene(dev),
                            rtiow.offline_dof_camera(400 / 225, device=dev),
                            cfg_dof)
    max_err = 0.0
    for name, (scene, cam, cfg) in cases.items():
        pk, cam24, sf, si, p = fr._setup(scene, cam, cfg, SEED_KEY0, dev)
        p = p._replace(n_steps=n_steps)
        want_f, want_i = fr._steps_plain(pk, cam24, SEED_KEY0, sf, si, p)
        got_f, got_i = fr.rtiow_steps(pk, cam24, SEED_KEY0, sf.clone(),
                                      si.clone(), p)
        sync(dev)
        res = compare_planes(got_f, got_i, want_f, want_i)
        emit(phase="rtiow_parity", case=name, mode="thinlens" if p.thinlens
             else "perspective", config=f"{cfg.width}x{cfg.height} "
             f"spp{cfg.spp} depth{cfg.max_depth}", n_steps=n_steps,
             mean_n_done=float(want_i[2].float().mean()), **res)
        if (res["int_mismatch_share"] > MAX_INT_MISMATCH
                or not res["float_within_tol"]):
            raise RuntimeError(f"fused_rtiow disagrees with its plain "
                               f"version on {name}: {res}")
        max_err = max(max_err, res["max_abs_err"])
    return max_err


def u8_gate(img, name: str, gamma: float, mean_tol, p99_tol) -> dict:
    """An image against goldens/test/<name>.png by assert_close_u8's rule."""
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    u8 = tonemap.quantize_u8(img, gamma=gamma).cpu().numpy()
    gold = im.read_png(os.path.join(ROOT, "goldens", "test", name + ".png"))
    if u8.shape != gold.shape:
        raise RuntimeError(f"{name}: golden shape {gold.shape}, render "
                           f"{u8.shape}")
    d = np.abs(u8.astype(np.int32) - gold.astype(np.int32))
    res = dict(mean_abs_diff=float(d.mean()), p99=float(np.percentile(d, 99)),
               mean_tol=mean_tol, p99_tol=p99_tol)
    if not (res["mean_abs_diff"] <= mean_tol and res["p99"] <= p99_tol):
        raise RuntimeError(f"{name} disagrees with its golden: {res}")
    return res


def rtiow_golden_phase(dev, mean_tol=1.5, p99_tol=8):
    """render_fused through the kernel at tools/make_goldens.py's test-tier
    configurations of offline_rtiow, offline_dof and nppt."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.ops import fused_rtiow as fr
    from cpu_based_ray_tracer_tpu_torch.scenes import rtiow

    cases = {
        "offline_rtiow": (rtiow.offline_two_sphere_scene(dev),
                          rtiow.offline_camera(200 / 112, device=dev),
                          RenderConfig(width=200, height=112, spp=16,
                                       max_depth=50), SEED_KEY0),
        "offline_dof": (rtiow.rtiow_classic_scene(dev),
                        rtiow.offline_dof_camera(200 / 112, device=dev),
                        RenderConfig(width=200, height=112, spp=32,
                                     max_depth=50), SEED_KEY4),
        "nppt": (rtiow.nppt_scene(dev), rtiow.nppt_camera(dev),
                 RenderConfig(width=128, height=128, spp=16, max_depth=50,
                              gamma=1.0), SEED_KEY1)}
    launches = fr.LAUNCHES["fused_rtiow"]
    res = {name: u8_gate(fr.render_fused(sc, cam, cfg, seed, device=dev),
                         name, cfg.gamma, mean_tol, p99_tol)
           for name, (sc, cam, cfg, seed) in cases.items()}
    emit(phase="rtiow_golden",
         launches=fr.LAUNCHES["fused_rtiow"] - launches, **res)
    if dev.type == "cuda" and fr.LAUNCHES["fused_rtiow"] == launches:
        raise RuntimeError("the RTIOW goldens launched no fused_rtiow kernel")


# render_fused's seconds on the same cells under the JAX package's chunk
# schedule (many launches, one poll each; NVIDIA H100 80GB HBM3, 700 W,
# PERF.md section 6): the yardstick of the one-launch render.
RTIOW_CHUNKED_SECONDS = {"offline": 0.0133, "nppt": 0.1674}


def rtiow_main_phase(dev, smi, n_iters=3) -> dict:
    """The two headline renders through render_fused (one launch each),
    each with the launch counters set to 0 just before and read just after;
    then, from the same initial state, the lockstep render of the step-mode
    kernel under the chunk schedule and of the plain version one step at a
    time (both untimed), each of which must give the render kernel's
    planes bit for bit; the render kernel alone by CUDA events, with each
    pixel's samples in 1 to 32 chunks and in the default number (each
    bit equal to the lockstep planes); and the bound of the operations of
    every live lane-step of the render, counted in the plain run.
    Returns {cell: dict(launches, ms, bound ...)}."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_rtiow as fr
    from cpu_based_ray_tracer_tpu_torch.ops import vec

    out = {}
    for name, (scene, cam, cfg) in rtiow_configs(dev).items():
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        img = fr.render_fused(scene, cam, cfg, SEED_KEY0, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
        counts = read_counts()
        png = save_png(img, f"rtiow_{name}_{cfg.width}x{cfg.height}_"
                       f"{cfg.spp}spp.png", gamma=cfg.gamma)
        finite = bool(torch.isfinite(img).all())
        mean_rad = float(img.mean())
        if dev.type == "cuda" and counts["fused_rtiow"] != 1:
            raise RuntimeError(f"rtiow_main {name}: {counts['fused_rtiow']} "
                               f"fused_rtiow launches, not one")
        if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
                or not mean_rad > 0.0):
            raise RuntimeError(f"the {name} image is wrong")

        pk, cam24, sf0, si0, p = fr._setup(scene, cam, cfg, SEED_KEY0, dev)
        lf, li = fr.render_lockstep(pk, cam24, SEED_KEY0, sf0.clone(),
                                    si0.clone(), p)
        sf, si = sf0.clone(), si0.clone()
        fr._render_kernel(pk, cam24, SEED_KEY0, sf, si, p)
        sync(dev)
        lock_img = vec.div(lf[9:12].T, float(cfg.spp)).reshape(img.shape)
        equal = dict(image=torch.equal(img, lock_img),
                     float_planes=torch.equal(sf, lf),
                     int_planes=torch.equal(si, li),
                     all_done=bool((li[2] == cfg.spp).all()))
        if not all(equal.values()):
            raise RuntimeError(f"the one-launch {name} render differs from "
                               f"the lockstep render: {equal}")
        work, pf, pi = rtiow_ops(pk, cam24, sf0, si0, p._replace(
            n_steps=cfg.spp * cfg.max_depth))
        plain = dict(float_planes=torch.equal(sf, pf),
                     int_planes=torch.equal(si, pi),
                     all_done=bool((pi[2] == cfg.spp).all()),
                     max_abs_err=float((sf - pf).abs().max()),
                     int_lanes_off=int((si != pi).any(0).sum()))
        if not (plain["float_planes"] and plain["int_planes"]
                and plain["all_done"]):
            raise RuntimeError(f"the one-launch {name} render differs from "
                               f"the plain lockstep render: {plain}")

        per_sm, n_sm = fr.LIB.occupancy(
            "fused_rtiow_render_slots",
            pk.sph.numel() + pk.mat.numel() + 8 + 24, p.diffuse_model,
            int(p.thinlens))
        threads = per_sm * n_sm * 256
        auto = fr.default_chunks(pk, p, dev)
        chunk_ms = {}
        for chunks in sorted({1, 2, 4, 16, 32, auto}):
            def once():
                sf.copy_(sf0)
                si.copy_(si0)
                fr._render_kernel(pk, cam24, SEED_KEY0, sf, si, p,
                                  chunks=chunks)
            once()                                              # warm-up
            sync(dev)
            if not (torch.equal(sf, lf) and torch.equal(si, li)):
                raise RuntimeError(f"the {name} render in {chunks} sample "
                                   f"chunks differs from the lockstep one")
            chunk_ms[chunks] = sum(timed(once) for _ in range(n_iters)
                                   ) / n_iters
        ms = chunk_ms[auto]
        nbytes = (12 + 3) * 4 * 2 * p.n_pix    # state in + out, once
        res = dict(launches=counts["fused_rtiow"], ms=ms, chunks=auto,
                   **bound(work["ops"], nbytes))
        emit(phase="rtiow_main", case=name, config=f"{cfg.width}x"
             f"{cfg.height} {cfg.spp}spp depth{cfg.max_depth}",
             nvidia_smi=smi, seconds=secs,
             chunk_schedule_seconds=RTIOW_CHUNKED_SECONDS[name],
             shape=list(img.shape),
             finite=finite, mean_radiance=mean_rad, counts=counts,
             bit_equal_to_lockstep=equal, bit_equal_to_plain=plain,
             kernel_ms=ms,
             ms_by_chunks=chunk_ms, blocks_per_sm=per_sm, sms=n_sm,
             resident_threads=threads, pixels=p.n_pix,
             pixels_per_resident_thread=p.n_pix / max(threads, 1),
             work=work, live_lane_steps_per_s=work["live_lane_steps"]
             / (ms * 1e-3), png=png, **res)
        out[name] = res
    return out


def rtiow_kinds(pk, sf, t_min: float):
    """What each lane's ray meets, found independently of the kernel: the
    nearest sphere by near-then-far roots -> its material's kind, -1 on a
    miss."""
    o, d = sf[0:3], sf[3:6]
    best = torch.full_like(o[0], float("inf"))
    mid = torch.full_like(o[0], -1.0)
    for m in range(pk.n_sph):
        oc = o - pk.sph[m, 0:3, None]
        a = (d * d).sum(0)
        hb = (oc * d).sum(0)
        disc = hb * hb - a * ((oc * oc).sum(0) - pk.sph[m, 3] ** 2)
        sq = torch.sqrt(disc.clamp(min=0.0))
        t_near, t_far = (-hb - sq) / a, (-hb + sq) / a
        ts = torch.where(t_near > t_min, t_near,
                         torch.where(t_far > t_min, t_far, float("inf")))
        ts = torch.where(disc > 0.0, ts, float("inf"))
        closer = ts < best
        best = torch.where(closer, ts, best)
        mid = torch.where(closer, pk.sph[m, 4], mid)
    kind = torch.full_like(mid, -1.0)
    for k in range(pk.n_mat):
        kind = torch.where(mid == k, pk.mat[k, 0], kind)
    return kind


def rtiow_ops(pk, cam24, sf, si, p) -> tuple:
    """The operations that p.n_steps steps from (sf, si) need: the plain
    version steps the lanes (not timed) and each live lane's ray is
    classified before its step; the finished samples are the change in
    n_done.  Stops early once every lane is done (checked every 64 steps;
    a finished lane's state no longer changes).  -> (the work, the plain
    version's final planes sf, si)."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_rtiow as fr

    sf, si = sf.clone(), si.clone()
    nd0 = si[2].clone()
    n = torch.zeros(5, dtype=torch.int64, device=sf.device)
    steps = torch.zeros_like(nd0)        # live steps of each lane
    one = p._replace(n_steps=1)
    for step in range(p.n_steps):
        if step % 64 == 63 and int(si[2].min()) >= p.spp:
            break
        kind = rtiow_kinds(pk, sf, p.t_min)
        live = si[2] < p.spp
        steps += live.to(steps.dtype)
        n += torch.stack([live.sum(), (live & (kind < 0)).sum(),
                          (live & (kind == 0)).sum(),
                          (live & (kind == 1)).sum(),
                          (live & (kind == 2)).sum()])
        sf, si = fr._steps_plain(pk, cam24, SEED_KEY0, sf, si, one)
    live, miss, lam, met, die = (int(x) for x in n)
    regen = int((si[2] - nd0).sum())
    q = torch.quantile(steps.float(), torch.tensor(
        [0.5, 0.99, 0.999], device=steps.device)).tolist()
    per_lane = dict(mean=float(steps.float().mean()), p50=q[0], p99=q[1],
                    p999=q[2], max=int(steps.max()))
    ops = ((RTIOW_SPH_OPS * pk.n_sph) * live + RTIOW_MISS_OPS * miss
           + RTIOW_HIT_OPS * (lam + met + die)
           + RTIOW_LAMBERT_OPS[p.diffuse_model] * lam
           + RTIOW_METAL_OPS * met + RTIOW_DIELECTRIC_OPS * die
           + RTIOW_REGEN_OPS[p.thinlens] * regen)
    return dict(ops=ops, live_lane_steps=live, miss=miss, lambert=lam,
                metal=met, dielectric=die, samples_finished=regen,
                steps_per_lane=per_lane), sf, si


def rtiow_speed_phase(dev, smi, n_steps=128, n_iters=4) -> dict:
    """The kernel alone on the NPPT cell (883x824 lanes): n_steps steps
    from render_fused's initial state by CUDA events, ms per step of the
    whole image; the plain version over the same steps from the same state;
    the bound from the operations those steps need (rtiow_ops).  A lane
    finishes at most one sample a step, so with n_steps < spp every lane
    is live at every step of the window (checked).  The last timed run's
    planes must equal the plain version's bit for bit."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_rtiow as fr

    scene, cam, cfg = rtiow_configs(dev)["nppt"]
    pk, cam24, sf0, si0, p = fr._setup(scene, cam, cfg, SEED_KEY0, dev)
    p = p._replace(n_steps=n_steps)
    sf, si = sf0.clone(), si0.clone()
    fr.rtiow_steps(pk, cam24, SEED_KEY0, sf, si, p)            # warm-up
    ms = 0.0
    for _ in range(n_iters):
        sf.copy_(sf0)
        si.copy_(si0)
        ms += timed(lambda: fr.rtiow_steps(pk, cam24, SEED_KEY0, sf, si, p)
                    ) / (n_iters * n_steps)
    plain_ms = timed(lambda: fr._steps_plain(pk, cam24, SEED_KEY0, sf0, si0,
                                             p)) / n_steps
    r = p.n_pix
    work, pf, pi = rtiow_ops(pk, cam24, sf0, si0, p)
    if work["live_lane_steps"] != r * n_steps:
        raise RuntimeError(f"lanes went idle inside the timed window: {work}")
    if not (torch.equal(sf, pf) and torch.equal(si, pi)):
        raise RuntimeError("the timed steps differ from the plain version's")
    nbytes = (12 + 3) * 4 * 2 * r          # state in + out, one launch
    res = dict(ms=ms, plain_ms=plain_ms,
               **bound(work["ops"] / n_steps, nbytes / n_steps))
    emit(phase="rtiow_speed", nvidia_smi=smi, lanes=r, n_steps=n_steps,
         n_iters=n_iters, spheres=pk.n_sph, work=work,
         lane_steps_per_s=r / (ms * 1e-3), unit="ms per step", **res)
    return res


def denoiser_parity_phase(dev, cfg) -> dict:
    """The single_path kernel against its plain version at full width:
    ids and the contributor flag exact, color 2e-3, position and normal
    1e-4 (tests/test_fused.py's gate)."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    fs = fused.pack_scene(scene)
    want = fused._gbuffer(fused._steps_plain, fs, cam, cfg, SEED_KEY0, 3,
                          dev)
    got = fused.single_sample_gbuffer(fs, cam, cfg, SEED_KEY0, 3,
                                      device=dev)
    sync(dev)
    res = dict(lanes=int(got[4].numel()),
               contributors=int(got[4].sum()),
               ids_equal=bool(torch.equal(got[3], want[3])),
               contributor_equal=bool(torch.equal(got[4], want[4])))
    ok = res["ids_equal"] and res["contributor_equal"]
    for i, name, tol in ((0, "color", TOL), (1, "world_pos", 1e-4),
                         (2, "normal", 1e-4)):
        err = (got[i] - want[i]).abs()
        res[name + "_max_abs_err"] = float(err.max())
        ok &= bool((err <= tol + tol * want[i].abs()).all())
    # The launch itself: every state plane and G-buffer plane bit equal
    # (lanes retire when their one path ends).
    cam16, sf, si, gb, p = fused._gbuffer_setup(cam, cfg, 3, dev)
    gb_k = gb.clone()
    planes_p = fused._steps_plain(fs, cam16, SEED_KEY0, sf.clone(),
                                  si.clone(), p, gb=gb)
    planes_k = fused._steps_kernel(fs, cam16, SEED_KEY0, sf.clone(),
                                   si.clone(), p, gb=gb_k)
    sync(dev)
    res["planes_bit_equal"] = all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(planes_k + (gb_k,), planes_p + (gb,)))
    ok &= res["planes_bit_equal"]
    emit(phase="denoiser_parity", config=f"{cfg.width}x{cfg.height} "
         f"depth{cfg.max_depth} rr{cfg.rr_survival}", **res)
    if not ok:
        raise RuntimeError(f"the single_path kernel disagrees with its "
                           f"plain version: {res}")
    return res["color_max_abs_err"]


@contextlib.contextmanager
def plain_atrous():
    """ops.denoise.joint_bilateral_atrous by the plain twin of its levels,
    on any device, inside the block."""
    from cpu_based_ray_tracer_tpu_torch.ops import denoise

    routed = denoise.joint_bilateral_atrous

    def plain(g, half_size, clamp=True):
        return denoise._atrous(g, half_size, clamp, denoise._weights(),
                               on_card=False)

    denoise.joint_bilateral_atrous = plain
    try:
        yield
    finally:
        denoise.joint_bilateral_atrous = routed


def equal_to_plain_twin(frames, scene, cams, cfg, seed, params,
                        dev) -> bool:
    """Whether ``frames``, from render_sequence(engine="fused") with the
    a-trous kernel, are bit equal to the same sequence by its plain twin."""
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dn

    with plain_atrous():
        twins = dn.render_sequence(scene, cams, cfg, seed, params,
                                   engine="fused", device=dev)
    return all(torch.equal(a, b) for a, b in zip(frames, twins))


def denoiser_golden_phase(dev, mean_tol=2.0, p99_tol=16, n_frames=4):
    """tools/make_goldens.denoiser_triple (128x128, 4 frames of a static
    camera, JBF half-size 16) through the fused engine; every denoised
    frame bit equal to the a-trous plain twin's."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dn
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    cfg = RenderConfig(width=128, height=128, max_depth=16, rr_survival=0.8)
    params = dn.DenoiserParams(jbf_half_size=16)
    launches = fused.LAUNCHES["fused_mc"]
    imgs = {"denoiser_noisy_1spp": dn.render_gbuffer_fused(
        scene, cam, cfg, SEED_KEY3, n_frames - 1, True, device=dev).color}
    twins_equal = {}
    for name, p in (("denoiser_denoised", params),
                    ("denoiser_denoised_noclamp",
                     params.replace(immediate_clamping=False))):
        frames = dn.render_sequence(scene, [cam] * n_frames, cfg,
                                    SEED_KEY3, p, engine="fused", device=dev)
        twins_equal[name] = equal_to_plain_twin(
            frames, scene, [cam] * n_frames, cfg, SEED_KEY3, p, dev)
        imgs[name] = frames[-1]
    res = {name: u8_gate(img, name, 1.0, mean_tol, p99_tol)
           for name, img in imgs.items()}
    emit(phase="denoiser_golden",
         launches=fused.LAUNCHES["fused_mc"] - launches,
         atrous_bit_equal_to_plain=twins_equal, **res)
    if not all(twins_equal.values()):
        raise RuntimeError(f"the a-trous kernel's frames differ from the "
                           f"plain twin's: {twins_equal}")


def denoiser_main_phase(dev, cfg, n_frames=12) -> dict:
    """bench_passes' denoiser_fused_frame: render_sequence over 12 frames
    of a static camera through the fused engine, the launch counters set
    to 0 just before and read just after (returned); one fused_mc launch
    and three a-trous launches a frame."""
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dn
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    params = dn.DenoiserParams()
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    frames = dn.render_sequence(scene, [cam] * n_frames, cfg, SEED_KEY0,
                                params, engine="fused", device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = read_counts()
    twins_equal = equal_to_plain_twin(frames, scene, [cam] * n_frames, cfg,
                                      SEED_KEY0, params, dev)
    # Steady state: a frame with history (temporal pass on), timed alone.
    _, hist = dn.render_frame(scene, cam, cfg, SEED_KEY0, n_frames, None,
                              params, engine="fused", device=dev)
    sync(dev)
    t1 = time.perf_counter()
    dn.render_frame(scene, cam, cfg, SEED_KEY0, n_frames + 1, hist, params,
                    engine="fused", device=dev)
    sync(dev)
    frame_s = time.perf_counter() - t1
    img = frames[-1]
    finite = all(bool(torch.isfinite(f).all()) for f in frames)
    png = save_png(img, f"denoiser_{cfg.width}_{n_frames}frames.png")
    emit(phase="denoiser_main", config=f"{cfg.width}x{cfg.height} spp1 "
         f"depth{cfg.max_depth} rr{cfg.rr_survival} {params}",
         frames=n_frames, seconds=secs, seconds_per_frame=secs / n_frames,
         one_frame_seconds=frame_s, shape=list(img.shape), finite=finite,
         mean=float(img.mean()), launches=counts,
         atrous_bit_equal_to_plain=twins_equal, png=png)
    if dev.type == "cuda" and (counts["fused_mc"] != n_frames or
                               counts["denoise"]["atrous"] != 3 * n_frames):
        raise RuntimeError(f"the Denoiser sequence made {counts} launches "
                           f"for {n_frames} frames")
    if not twins_equal:
        raise RuntimeError("the a-trous kernel's frames differ from the "
                           "plain twin's")
    if (tuple(img.shape) != (cfg.height, cfg.width, 3) or not finite
            or not float(img.mean()) > 0.0):
        raise RuntimeError("the Denoiser frames are wrong")
    return counts


def single_path_work(fs, cam16, sf, si, gb, p) -> tuple:
    """(live lane-steps, shadow rays) of one single_path launch from
    (sf, si): the launch again one step at a time, untimed."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    core = fused._steps_kernel if sf.is_cuda else fused._steps_plain
    one = p._replace(n_steps=1)
    n = torch.zeros(2, dtype=torch.int64, device=sf.device)
    for _ in range(p.n_steps):
        live = (si[2] < 1).sum()
        sf, si = core(fs, cam16, SEED_KEY0, sf.clone(), si.clone(), one,
                      gb=gb)
        n += torch.stack([live, si[3].sum()])
    return tuple(int(x) for x in n)


def single_path_speed_phase(dev, cfg, smi, n_iters=10) -> dict:
    """One single_path launch of cfg.max_depth steps (the Denoiser frame's
    G-buffer pass) alone by CUDA events, from the same initial state each
    time; its plain version; the bound from the live lane-steps and the
    shadow rays of that launch (counted by stepping the kernel one launch
    a step, untimed: a lane is live until its one path ends)."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    fs = fused.pack_scene(scene)
    cam16, sf0, si0, gb, p = fused._gbuffer_setup(cam, cfg, 3, dev)
    sf, si = sf0.clone(), si0.clone()
    fused._steps_kernel(fs, cam16, SEED_KEY0, sf, si, p, gb=gb)  # warm-up
    ms = 0.0
    for _ in range(n_iters):
        sf.copy_(sf0)
        si.copy_(si0)
        ms += timed(lambda: fused._steps_kernel(fs, cam16, SEED_KEY0, sf, si,
                                                p, gb=gb)) / n_iters
    plain_ms = timed(lambda: fused._steps_plain(fs, cam16, SEED_KEY0, sf0,
                                                si0, p, gb=gb.clone()))
    n = single_path_work(fs, cam16, sf0, si0, gb, p)
    live, shadow = n
    r = cfg.width * cfg.height
    nbytes = ((15 + 4) * 4 * 2 + 8 * 4) * r      # state in + out, G-buffer
    res = dict(ms=ms, plain_ms=plain_ms,
               **bound(mc_ops(fs.n_tri, fs.n_sph, live, shadow), nbytes))
    emit(phase="single_path_speed", nvidia_smi=smi, lanes=r,
         n_steps=cfg.max_depth, n_iters=n_iters, live_lane_steps=live,
         shadow_rays=shadow, lane_steps_of_launch=r * cfg.max_depth,
         unit="ms per single_path launch of max_depth steps", **res)
    return res


# f32 operations of one a-trous tap (csrc/denoise.cu), an IEEE division,
# square root, acosf or expf counted as one: a weighted (off-center,
# in-frame, contributor) tap's guidance terms (d_pos 9, d_col 9, normal
# angle 10, coplanarity 12, the sum, negation and exp 5), and every
# in-frame tap's accumulation (3 mul, 4 add).
ATROUS_WEIGHT_OPS, ATROUS_ACC_OPS = 45, 7


def atrous_work(g, level: int) -> tuple:
    """(f32 operations, bytes) that one a-trous level of G-buffer ``g``
    needs: ATROUS_ACC_OPS per in-frame tap, ATROUS_WEIGHT_OPS more per
    weighted tap, 4 a pixel for the normalisation (max, 3 div); color,
    position, normal (12 B each) and contributor (1 B) in, 12 B out."""
    con = g.contributor
    h, w = con.shape
    step = 1 << level
    in_frame = weighted = 0
    for ty in range(5):
        for tx in range(5):
            dy, dx = (ty - 2) * step, (tx - 2) * step
            ny, nx = max(0, h - abs(dy)), max(0, w - abs(dx))
            in_frame += ny * nx
            if (ty, tx) != (2, 2) and ny and nx:
                weighted += int(con[max(dy, 0):max(dy, 0) + ny,
                                    max(dx, 0):max(dx, 0) + nx].sum())
    ops = (in_frame * ATROUS_ACC_OPS + weighted * ATROUS_WEIGHT_OPS
           + 4 * h * w)
    return ops, (37 + 12) * h * w


def denoise_atrous_speed_phase(dev, cfg, smi, n_iters=10) -> dict:
    """Each level of the default a-trous filter (DenoiserParams(): half-size
    7, three levels) on the 896x896 fused G-buffer of the Cornell box: one
    csrc/denoise.cu launch alone by CUDA events (n_iters launches
    enqueued behind a busy card, the mean), its
    plain twin once, both outputs bit equal, and the bound of the level's
    work."""
    from cpu_based_ray_tracer_tpu_torch.models import denoiser as dn
    from cpu_based_ray_tracer_tpu_torch.ops import denoise
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    params = dn.DenoiserParams()
    g = dn.render_gbuffer_fused(scene, cam, cfg, SEED_KEY0, 3, True,
                                device=dev)
    wts = denoise._weights()
    levels, color, ok = [], g.color, True
    for level in range(denoise._levels(params.jbf_half_size)):
        out = torch.empty_like(color)
        denoise._atrous_level_kernel(g, color, level, wts,
                                     out=out)  # warm-up
        ms = timed(lambda: [denoise._atrous_level_kernel(
            g, color, level, wts, out=out) for _ in range(n_iters)],
            busy_ms=5.0) / n_iters
        plain = []
        plain_ms = timed(lambda: plain.append(denoise._atrous_level_plain(
            g, color, level, wts)))
        equal = bool(torch.equal(out, plain[0]))
        ok &= equal
        ops, nbytes = atrous_work(g, level)
        b = bound(ops, nbytes)
        levels.append(dict(step=1 << level, ms=ms, plain_ms=plain_ms,
                           bit_equal=equal,
                           max_abs_err=float((out - plain[0]).abs().max()),
                           share_pct=100.0 * b["bound_ms"] / ms,
                           share_no_fma_pct=100.0 * b["bound_no_fma_ms"] / ms,
                           **b))
        color = plain[0]
    res = dict(ms=sum(x["ms"] for x in levels) / len(levels),
               plain_ms=sum(x["plain_ms"] for x in levels) / len(levels),
               bound_ms=sum(x["bound_ms"] for x in levels) / len(levels),
               bound_no_fma_ms=sum(x["bound_no_fma_ms"] for x in levels)
               / len(levels),
               bound_by=levels[0]["bound_by"],
               max_abs_err=max(x["max_abs_err"] for x in levels),
               levels=levels)
    emit(phase="denoise_atrous_speed", nvidia_smi=smi,
         config=f"{cfg.width}x{cfg.height} half-size "
                f"{params.jbf_half_size}", n_iters=n_iters,
         contributors=int(g.contributor.sum()),
         unit="ms per a-trous level (one launch), mean of the levels", **res)
    if not ok:
        raise RuntimeError("an a-trous level differs from its plain twin")
    return res


# --- the equal-spp engine, the slabs, min_spp and soft shadows -------------

@contextlib.contextmanager
def counting_steps():
    """Count the calls of models.monte_carlo._bounce_step made inside the
    block: the bounce steps of a plain-engine render."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc

    calls = [0]
    step = mc._bounce_step

    def counted(*args, **kw):
        calls[0] += 1
        return step(*args, **kw)

    mc._bounce_step = counted
    try:
        yield calls
    finally:
        mc._bounce_step = step


def timed_runs(fn, dev, n_iters: int) -> dict:
    """Host seconds of n_iters calls of fn() ending in a synchronise:
    spread() of the samples."""
    secs = []
    for _ in range(n_iters):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        secs.append(time.perf_counter() - t0)
    return spread(secs)


def mc_equal_spp_phase(dev, full: RenderConfig, smi: str, n_iters=3) -> dict:
    """tools/bench_passes.py's mc_equal_spp: render_wavefront, the plain
    equal-spp engine, at the main path's configuration, the launch
    counters set to 0 just before its first run and read just after (it
    launches no kernel); then timed warm.  Gates: against
    render_turbo_exact (the same estimator in one kernel) at most
    MAX_INT_MISMATCH of the pixels off by more than TOL + TOL * |want|;
    at 1 spp its ray count equals the scan engine's count_rays."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    acc0 = torch.zeros((full.height, full.width, 3), dtype=torch.float32,
                       device=dev)

    def render(cfg=full):
        return mc.render_wavefront(scene, cam, cfg, SEED_KEY0, acc0, 0,
                                   return_rays=True, device=dev)

    sync(dev)
    reset_counts()
    with counting_steps() as steps:
        acc, nxt, nrays = render()
    sync(dev)
    launches = read_counts()
    n_steps, max_steps = steps[0], full.spp * full.max_depth
    secs = timed_runs(render, dev, n_iters)
    img = acc / torch.tensor(float(full.spp), device=dev)
    turbo = mc.render_turbo_exact(scene, cam, full, SEED_KEY0, device=dev)
    turbo_secs = timed_runs(lambda: mc.render_turbo_exact(
        scene, cam, full, SEED_KEY0, device=dev), dev, n_iters)
    vs_turbo = pixels_off(img, turbo, TOL, TOL)
    share = vs_turbo["pixels_off"] / (full.width * full.height)
    one = full.replace(spp=1)
    _, _, n_wf1 = render(one)
    n_scan1 = mc.count_rays(scene, cam, one, SEED_KEY0)
    rays = int(nrays)
    res = dict(seconds=secs, rays_per_s=rays / secs["median"],
               spp_per_s=full.spp / secs["median"], nrays=rays,
               steps=n_steps, max_steps=max_steps,
               host_polls=n_steps + (n_steps < max_steps),
               next_sample=nxt, launches=launches,
               fused_equal_spp_seconds=turbo_secs)
    emit(phase="mc_equal_spp", nvidia_smi=smi,
         config=f"{full.width}x{full.height} {full.spp}spp "
         f"depth{full.max_depth} rr{full.rr_survival}", **res,
         finite=bool(torch.isfinite(img).all()),
         mean_radiance=float(img.mean()), vs_render_turbo_exact=vs_turbo,
         pixels_off_share=share, max_share=MAX_INT_MISMATCH,
         nrays_1spp=int(n_wf1), count_rays_1spp=int(n_scan1),
         png=save_png(img, f"mc_equal_spp_{full.width}.png", gamma=2.0))
    if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
            and nxt == full.spp):
        raise RuntimeError("render_wavefront's image is wrong")
    if share > MAX_INT_MISMATCH:
        raise RuntimeError(f"render_wavefront vs render_turbo_exact: "
                           f"{vs_turbo}")
    if int(n_wf1) != int(n_scan1):
        raise RuntimeError(f"render_wavefront traced {int(n_wf1)} rays at 1 "
                           f"spp, the scan engine {int(n_scan1)}")
    return res


def mc_equal_spp_golden_phase(dev, gcfg: RenderConfig, smi: str) -> dict:
    """render_wavefront, the engine that rendered goldens/test/
    mc_cornell.png, at its configuration and seed, against it."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    sync(dev)
    t0 = time.perf_counter()
    with counting_steps() as steps:
        acc, _ = mc.render_wavefront(
            cornell.cornell_scene(dev), cornell.cornell_camera(dev), gcfg,
            SEED_KEY2, torch.zeros((gcfg.height, gcfg.width, 3),
                                   dtype=torch.float32, device=dev), 0,
            device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    img = acc / torch.tensor(float(gcfg.spp), device=dev)
    res = u8_gate(img, "mc_cornell", 1.0, 2.0, 16)
    emit(phase="mc_equal_spp_golden", nvidia_smi=smi,
         config=f"{gcfg.width}x{gcfg.height} "
         f"{gcfg.spp}spp depth{gcfg.max_depth} rr{gcfg.rr_survival}",
         seconds=secs, steps=steps[0], **res)
    return res


def concat_states(parts):
    """Slab lane states, in pixel order, as one state; the ray counts
    summed as int32."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused

    cat = {f: torch.cat([getattr(p, f) for p in parts])
           for f in ("s", "b", "o", "d", "tp", "cur", "acc", "n_done")}
    nrays = fused.wrap_i32(sum(p.nrays.to(torch.int64) for p in parts))
    return mc.WavefrontState(nrays=nrays, **cat)


def slabs_phase(dev, full: RenderConfig, smi: str, n_steps=16) -> dict:
    """wavefront_init / wavefront_steps on two slabs of the image, cut on a
    row boundary and off one: every plane of the slabs, concatenated, bit
    equal to the whole image's state, at init and after n_steps."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    r = full.width * full.height
    t0 = time.perf_counter()
    whole0 = mc.wavefront_init(scene, cam, full, SEED_KEY0, device=dev)
    whole1 = mc.wavefront_steps(scene, cam, full, SEED_KEY0, whole0, n_steps)
    sync(dev)
    whole_secs = time.perf_counter() - t0
    cuts = {"rows": (full.height // 2) * full.width,
            "ragged": (full.height // 2) * full.width + full.width // 3 + 1}
    res = {}
    for name, cut in cuts.items():
        parts0, parts1 = [], []
        for a, b in ((0, cut), (cut, r)):
            st = mc.wavefront_init(scene, cam, full, SEED_KEY0,
                                   pixel_offset=a, n_lanes=b - a, device=dev)
            parts0.append(st)
            parts1.append(mc.wavefront_steps(scene, cam, full, SEED_KEY0, st,
                                             n_steps, pixel_offset=a))
        res[name] = dict(cut=cut, on_row=cut % full.width == 0,
                         init_bit_equal=states_bit_equal(
                             concat_states(parts0), whole0),
                         steps_bit_equal=states_bit_equal(
                             concat_states(parts1), whole1))
    emit(phase="slabs", nvidia_smi=smi,
         config=f"{full.width}x{full.height} depth"
         f"{full.max_depth} rr{full.rr_survival}", steps=n_steps,
         whole_seconds=whole_secs, nrays=int(whole1.nrays), **res)
    if not all(v["init_bit_equal"] and v["steps_bit_equal"]
               for v in res.values()):
        raise RuntimeError(f"slab states differ from the whole image's: "
                           f"{res}")
    return res


def min_spp_phase(dev, full: RenderConfig, smi: str) -> dict:
    """render_turbo(min_spp=1) and render_turbo() at the main path's
    configuration, the launch counters set to 0 just before each and read
    just after; each against its chunks replayed from wavefront_init until
    min(n_done) reaches the target: as many launches, and the same image,
    bit for bit."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    fs = fused.pack_scene(scene)
    chunk = max(32, full.max_depth)
    res = {}
    for min_spp in (1, None):
        target = full.spp if min_spp is None else min_spp
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        img = mc.render_turbo(scene, cam, full, SEED_KEY0, min_spp=min_spp,
                              device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
        launches = read_counts()["fused_mc"]
        st = mc.wavefront_init(scene, cam, full, SEED_KEY0, device=dev)
        chunks = 0
        while int(st.n_done.min()) < target:
            st = fused.wavefront_steps_fused(fs, cam, full, SEED_KEY0, st,
                                             chunk, device=dev)
            chunks += 1
        want = mc.wavefront_image(st, full)
        res[f"min_spp_{target}"] = dict(
            seconds=secs, launches=launches, chunks=chunks,
            steps=chunks * chunk, target=target,
            min_n_done=int(st.n_done.min()), max_n_done=int(st.n_done.max()),
            image_bit_equal=bool(torch.equal(img.view(torch.int32),
                                             want.view(torch.int32))))
    emit(phase="min_spp", nvidia_smi=smi,
         config=f"{full.width}x{full.height} "
         f"{full.spp}spp depth{full.max_depth} rr{full.rr_survival}",
         chunk=chunk, **res)
    for k, v in res.items():
        kernel_ok = dev.type != "cuda" or v["launches"] == v["chunks"]
        if not (kernel_ok and v["min_n_done"] >= v["target"]
                and v["image_bit_equal"]):
            raise RuntimeError(f"render_turbo {k}: {v}")
    return res


def shadow_segments(n: int, seed: int):
    """Seeded shadow segments in the Cornell room: each from a point in
    the room to a point on the ceiling light quad, its length dist."""
    g = np.random.default_rng(seed)
    p = g.uniform([0.2, 0.2, 0.2], [3.5, 3.5, 3.3], (n, 3))
    q = np.stack([g.uniform(1.4, 2.2, n), np.full(n, 3.59),
                  g.uniform(1.3, 2.1, n)], -1)
    w = q - p
    dist = np.linalg.norm(w, axis=-1)
    return ((p).astype(np.float32), (w / dist[:, None]).astype(np.float32),
            dist.astype(np.float32))


def soft_shadow_phase(dev, smi: str, full: RenderConfig,
                      mcfg: RenderConfig, n_seg=65536) -> dict:
    """Soft shadows (soft_shadow_beta > 0) in the plain engines, on the card:
    (a) soft_visibility card against CPU on seeded segments; (b) the scan
    render and render_wavefront at ``full`` (timed; finite, mean > 0), and
    at 32x32 card against CPU; (c) beta = 1e-4 against the hard test; (d)
    make_soft_vis_fn on cornell_mesh_scene against brute soft_visibility,
    and mesh.render_mc through the packet kernel at ``mcfg`` against
    method="brute".  ``full.soft_shadow_beta`` is the beta of (a), (b) and
    (d)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import intersect
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    cpu = torch.device("cpu")
    beta = full.soft_shadow_beta
    res = {}
    # (a)
    seg = shadow_segments(n_seg, 11)
    vis = {}
    for d in (dev, cpu):
        args = [torch.as_tensor(x, device=d) for x in seg]
        vis[d.type] = intersect.soft_visibility(
            cornell.cornell_scene(d), *args, 1e-3, beta, 0.01)
    err = max_abs(vis[dev.type].cpu(), vis["cpu"])
    res["visibility"] = dict(segments=n_seg, beta=beta, max_abs_err=err,
                             tol=1e-6, mean=float(vis["cpu"].mean()))
    # (b)
    small = RenderConfig(width=32, height=32, spp=2, max_depth=4,
                         rr_survival=0.8, soft_shadow_beta=beta)
    zeros = lambda c, d: torch.zeros((c.height, c.width, 3),  # noqa: E731
                                     dtype=torch.float32, device=d)
    engines = {
        "render": lambda c, d: mc.render(
            cornell.cornell_scene(d), cornell.cornell_camera(d), c,
            SEED_KEY0, device=d),
        "render_wavefront": lambda c, d: mc.render_wavefront(
            cornell.cornell_scene(d), cornell.cornell_camera(d), c,
            SEED_KEY0, zeros(c, d), 0, device=d)[0]
        / torch.tensor(float(c.spp), device=d)}
    for name, fn in engines.items():
        sync(dev)
        t0 = time.perf_counter()
        img = fn(full, dev)
        sync(dev)
        secs = time.perf_counter() - t0
        got, want = fn(small, dev).cpu(), fn(small, cpu)
        res[name] = dict(seconds=secs, finite=bool(torch.isfinite(img).all()),
                         mean_radiance=float(img.mean()),
                         small_vs_cpu=pixels_off(got, want, 0.0, TOL),
                         png=save_png(img, f"soft_{name}_{full.width}.png",
                                      gamma=2.0))
    # (c)
    for name, c, seed in (
            ("limit_16", RenderConfig(width=16, height=16, spp=2,
                                      max_depth=2), SEED_KEY15),
            ("limit_128", RenderConfig(width=128, height=128, spp=2,
                                       max_depth=2), SEED_KEY0)):
        scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
        hard = mc.render(scene, cam, c, seed, device=dev)
        soft = mc.render(scene, cam, c.replace(soft_shadow_beta=1e-4), seed,
                         device=dev)
        off = pixels_off(soft, hard, 0.0, 1e-3)
        res[name] = dict(off, pixels_off_share=off["pixels_off"]
                         / (c.width * c.height))
    # (d)
    mscene = cornell.cornell_mesh_scene(device=dev)
    fn = mesh.make_soft_vis_fn(mscene)
    args = [torch.as_tensor(x, device=dev) for x in shadow_segments(
        n_seg, 12)]
    got = fn(mscene, *args, 1e-3, beta, 0.01)
    brute = intersect.soft_visibility(mscene, *args, 1e-3, beta, 0.01)
    res["gated"] = dict(pixels_off(got[:, None], brute[:, None], 2e-4, 2e-4),
                        tris=mscene.triangles.count, segments=n_seg)
    cam = cornell.cornell_camera(dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    img = mesh.render_mc(mesh.prepare(mscene), cam, mcfg, SEED_KEY0,
                         device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    launches = read_counts()
    brute_img = mesh.render_mc(mesh.prepare(mscene, method="brute"), cam,
                               mcfg, SEED_KEY0, device=dev)
    res["mesh_render_mc"] = dict(
        seconds=secs, launches=launches, finite=bool(torch.isfinite(img)
                                                     .all()),
        mean_radiance=float(img.mean()),
        vs_brute=pixels_off(img, brute_img, TOL, TOL),
        png=save_png(img, f"soft_mesh_mc_{mcfg.width}.png"))
    emit(phase="soft_shadow", nvidia_smi=smi, beta=beta,
         config=f"{full.width}x{full.height} {full.spp}spp depth"
         f"{full.max_depth} rr{full.rr_survival}; small {small.width}x"
         f"{small.height} {small.spp}spp depth{small.max_depth}; mesh "
         f"{mcfg.width}x{mcfg.height} {mcfg.spp}spp", **res)
    bad = []
    if not res["visibility"]["max_abs_err"] <= 1e-6:
        bad.append("visibility")
    for name in engines:
        v = res[name]
        if not (v["finite"] and v["mean_radiance"] > 0.0
                and v["small_vs_cpu"]["pixels_off"] == 0):
            bad.append(name)
    if res["limit_16"]["pixels_off"] != 0:
        bad.append("limit_16")
    if res["limit_128"]["pixels_off_share"] > KNIFE_SHARE:
        bad.append("limit_128")
    if res["gated"]["pixels_off"] != 0:
        bad.append("gated")
    m = res["mesh_render_mc"]
    if not ((dev.type != "cuda" or m["launches"]["packet"] > 0)
            and m["finite"]
            and m["mean_radiance"] > 0.0 and m["vs_brute"]["pixels_off"] == 0):
        bad.append("mesh_render_mc")
    if bad:
        raise RuntimeError(f"soft_shadow gates failed: {bad}")
    return res


# --- gradients, record / replay and inverse rendering ------------------------

def median_ms(fn, n_iters=3) -> float:
    """Median of n_iters CUDA-event timings of fn() after one warm call."""
    fn()
    return float(np.median([timed(fn) for _ in range(n_iters)]))


def peak_mb(fn, dev) -> float:
    """Peak device memory allocated while fn() runs, in MB."""
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    sync(dev)
    return torch.cuda.max_memory_allocated(dev) / 1e6


def grad_case(dev, smi, tag, scene, cam, cfg, isect=None, near=None,
              isect_dif=None, n_iters=3) -> dict:
    """tools/bench_passes.py's gradstep case in the port: the gradient of
    mean(render(albedo)^2) w.r.t. the albedo table by the standard engine
    (through ``isect_dif or isect``) and by the replay from a record made
    through ``isect`` / ``near``; each pass timed (median of n_iters after
    a warm call), its peak memory and its launches (counts set to 0 just
    before one run, read just after); the gates: standard against replay
    gradients (rtol 1e-4, atol 1e-6), every gradient finite, the replay
    image against render's (rtol 1e-4, atol 4e-6, unequal pixels
    counted)."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc

    a0 = scene.materials.albedo

    def with_albedo(a):
        return scene.replace(materials=scene.materials.replace(albedo=a))

    def std():
        a = a0.clone().requires_grad_(True)
        img = mc.render(with_albedo(a), cam, cfg, SEED_KEY0, device=dev,
                        intersect_fn=isect_dif or isect, nearest_t_fn=near)
        loss = torch.mean(img ** 2)
        return loss.detach(), torch.autograd.grad(loss, a)[0], img.detach()

    def record():
        return mc.record_trace(scene, cam, cfg, SEED_KEY0, dev,
                               intersect_fn=isect, nearest_t_fn=near)

    recs = record()

    def rep():
        a = a0.clone().requires_grad_(True)
        img = mc.render_from_trace(with_albedo(a), cam, cfg, SEED_KEY0, recs,
                                   dev)
        loss = torch.mean(img ** 2)
        return loss.detach(), torch.autograd.grad(loss, a)[0], img.detach()

    res, outs = {}, {}
    for name, fn in (("grad_std", std), ("record_pass", record),
                     ("grad_replay", rep)):
        res[f"{name}_ms"] = median_ms(fn, n_iters)
        res[f"{name}_peak_mb"] = peak_mb(fn, dev)
        sync(dev)
        reset_counts()
        outs[name] = fn()
        sync(dev)
        res[f"{name}_launches"] = read_counts()
    (l_std, g_std, img_std), (l_rep, g_rep, img_rep) = (outs["grad_std"],
                                                        outs["grad_replay"])
    res["speedup_material_stage"] = res["grad_std_ms"] / res["grad_replay_ms"]
    res["speedup_geometry_stage"] = res["grad_std_ms"] / (
        res["grad_replay_ms"] + res["record_pass_ms"])
    res["loss_equal"] = bool(l_std == l_rep)
    res["loss"] = [float(l_std), float(l_rep)]
    res["grads_finite"] = bool(torch.isfinite(g_std).all()
                               and torch.isfinite(g_rep).all())
    res["grads_allclose"] = bool(torch.allclose(g_rep, g_std, rtol=1e-4,
                                                atol=1e-6))
    res["grad_max_abs_diff"] = float((g_rep - g_std).abs().max())
    res["grad_max_abs"] = float(g_std.abs().max())
    res["replay_vs_render"] = pixels_off(img_rep, img_std, 1e-4, 4e-6)
    res["replay_vs_render"]["pixels_unequal"] = int(
        (img_rep != img_std).any(-1).sum())
    res["record_mb"] = sum(getattr(recs, f.name).numel()
                           * getattr(recs, f.name).element_size()
                           for f in dataclasses.fields(recs)) / 1e6
    emit(phase=tag, nvidia_smi=smi, tris=scene.triangles.count,
         config=f"{cfg.width}x{cfg.height} {cfg.spp}spp depth{cfg.max_depth} "
         f"rr{cfg.rr_survival}; loss mean(render(albedo)^2); timed: median "
         f"of {n_iters} CUDA-event timings after a warm call", **res)
    bad = [k for k in ("grads_finite", "grads_allclose") if not res[k]]
    if res["replay_vs_render"]["pixels_off"] != 0:
        bad.append("replay_vs_render")
    if bad:
        raise RuntimeError(f"{tag} gates failed: {bad}")
    return res


def grad_step_phases(dev, smi, size=448) -> dict:
    """The gradstep cells of tools/bench_passes.py: grad_step_cornell
    (cornell_scene, 448x448, 4 spp, depth 8) and grad_step_mesh_bunny
    (cornell_mesh_scene's icosphere(3) stand-in for the bunny, through
    csrc/packet.cu: the standard engine with make_intersect_fn(sort_rays,
    differentiable=True), the record pass with make_intersect_fn /
    make_nearest_t_fn(sort_rays); 448x448, 2 spp, depth 8)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    cam = cornell.cornell_camera(dev)
    out = {"grad_step_cornell": grad_case(
        dev, smi, "grad_step_cornell", cornell.cornell_scene(dev), cam,
        RenderConfig(width=size, height=size, spp=4, max_depth=8))}
    msc = cornell.cornell_mesh_scene(device=dev)
    bundle = mesh.prepare(msc, method="packet")
    res = grad_case(
        dev, smi, "grad_step_mesh_bunny", msc, cam,
        RenderConfig(width=size, height=size, spp=2, max_depth=8),
        isect=mesh.make_intersect_fn(bundle, sort_rays=True),
        near=mesh.make_nearest_t_fn(bundle, sort_rays=True),
        isect_dif=mesh.make_intersect_fn(bundle, sort_rays=True,
                                         differentiable=True))
    if dev.type == "cuda" and not (res["grad_std_launches"]["packet"] > 0
            and res["record_pass_launches"]["packet"] > 0
            and res["grad_replay_launches"]["packet"] == 0):
        raise RuntimeError("grad_step_mesh_bunny: packet.cu launches "
                           f"{res['grad_std_launches']['packet']}, "
                           f"{res['record_pass_launches']['packet']}, "
                           f"{res['grad_replay_launches']['packet']}")
    out["grad_step_mesh_bunny"] = res
    return out


def inverse_phase(dev, smi, size=448, n_steps=20) -> dict:
    """recover_albedo on Cornell at 448x448, 4 spp, depth 8,
    engine="replay", n_steps steps (seconds a step, loss ratio); then
    tests/test_inverse.py's checks on the card (24x24, 2 spp, depth 3:
    recover_albedo 60 steps lr 0.2, loss down >= 10x, albedo error < 0.08;
    recover_emission 50 steps lr 0.3, loss down >= 10x, relative emission
    error < 0.15)."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import inverse
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    res = {}
    cfg = RenderConfig(width=size, height=size, spp=4, max_depth=8)
    target = mc.render(scene, cam, cfg, SEED_KEY0, device=dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    r = inverse.recover_albedo(scene, cam, cfg, SEED_KEY0, target,
                               n_steps=n_steps, lr=0.1, engine="replay",
                               device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    losses = r.losses.cpu().numpy()
    res["cornell_448"] = dict(
        steps=n_steps, seconds=secs, seconds_per_step=secs / n_steps,
        launches=read_counts(), loss_first=float(losses[0]),
        loss_last=float(losses[-1]),
        loss_ratio=float(losses[-1] / losses[0]),
        note="seconds include the one record pass and the final render")
    free = ~scene.materials.emissive
    small = RenderConfig(width=24, height=24, spp=2, max_depth=3,
                         rr_survival=0.8)
    target = mc.render(scene, cam, small, SEED_KEY0, device=dev)
    t0 = time.perf_counter()
    r = inverse.recover_albedo(scene, cam, small, SEED_KEY0, target,
                               n_steps=60, lr=0.2, device=dev)
    sync(dev)
    losses = r.losses.cpu().numpy()
    res["albedo_24"] = dict(
        seconds=time.perf_counter() - t0, loss_ratio=float(
            losses[-1] / losses[0]),
        albedo_err=float((scene.materials.albedo - r.params).abs()[free]
                         .max()))
    t0 = time.perf_counter()
    r = inverse.recover_emission(scene, cam, small, SEED_KEY0, target,
                                 n_steps=50, lr=0.3, device=dev)
    sync(dev)
    losses = r.losses.cpu().numpy()
    em, true_em = scene.materials.emissive, scene.materials.emission
    res["emission_24"] = dict(
        seconds=time.perf_counter() - t0, loss_ratio=float(
            losses[-1] / losses[0]),
        emission_rel_err=float(((true_em - r.params).abs()
                                / torch.clamp(true_em, min=1.0))[em].max()))
    emit(phase="inverse", nvidia_smi=smi,
         config=f"cornell_scene {cfg.width}x{cfg.height} {cfg.spp}spp depth"
         f"{cfg.max_depth} replay lr 0.1; small {small.width}x{small.height}"
         f" {small.spp}spp depth{small.max_depth}", **res)
    bad = []
    if not (res["cornell_448"]["loss_ratio"] < 1.0
            and math.isfinite(res["cornell_448"]["loss_last"])):
        bad.append("cornell_448")
    if not (res["albedo_24"]["loss_ratio"] < 0.1
            and res["albedo_24"]["albedo_err"] < 0.08):
        bad.append("albedo_24")
    if not (res["emission_24"]["loss_ratio"] < 0.1
            and res["emission_24"]["emission_rel_err"] < 0.15):
        bad.append("emission_24")
    if bad:
        raise RuntimeError(f"inverse gates failed: {bad}")
    return res


# --- row sharding, the CLI --------------------------------------------------

SHARDED_SLABS = 2
# The 448^2 gradient cell's tolerance (tools/bench_passes.py:478-479, the
# gradstep gate): its albedo gradient sums ~10^6 lane contributions in
# float32, and the ranks sum them in another order (the atomic backward of
# a gather on the card orders them anew on every run), so the 16x16 checks'
# rtol 1e-5 (tests/test_sharding.py:50) is below its rounding.
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def sharded_phase(dev, full: RenderConfig, smi: str, n_steps=16) -> dict:
    """The sharded renderers in one process, SHARDED_SLABS slabs sharing
    the card: render_sharded (Cornell 896^2, 4 spp, depth 16, RR 0.8) bit
    equal to monte_carlo.render; wavefront_init/steps_sharded (16 steps)
    and wavefront_steps_fused_mesh_sharded (cornell_mesh_scene, 16 steps,
    its caps by default from each slab's lanes) on every plane bit equal to
    the unsharded runs, nrays equal, overflow 0, populations equal.  Each
    timed beside its unsharded run; the sharded fused mesh call's launches
    counted (the counters set to 0 just before it).  Returns the unsharded
    results the ranks phase is held against, and those launches."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.parallel import shard
    from cpu_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    mesh = make_mesh(SHARDED_SLABS, devices=dev)
    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)

    def run(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    res = {}
    ref, res["render_unsharded_seconds"] = run(
        lambda: mc.render(scene, cam, full, SEED_KEY0, device=dev))
    img, res["render_sharded_seconds"] = run(
        lambda: shard.render_sharded(scene, cam, full, SEED_KEY0, mesh))
    res["render_bit_equal"] = torch.equal(img.view(torch.int32),
                                          ref.view(torch.int32))

    wf0 = mc.wavefront_init(scene, cam, full, SEED_KEY0, device=dev)
    wf_ref, res["wavefront_unsharded_seconds"] = run(
        lambda: mc.wavefront_steps(scene, cam, full, SEED_KEY0, wf0, n_steps))
    wf, res["wavefront_sharded_seconds"] = run(
        lambda: shard.wavefront_steps_sharded(
            scene, cam, full, SEED_KEY0, shard.wavefront_init_sharded(
                scene, cam, full, SEED_KEY0, mesh), n_steps, mesh))
    res["wavefront_bit_equal"] = states_bit_equal(wf, wf_ref)

    mscene = cornell.cornell_mesh_scene(device=dev)
    mp = fm.pack_mesh_scene(mscene)
    st0 = mc.wavefront_init(mscene, cam, full, SEED_KEY0, device=dev)
    (fm_ref, of_ref, np_ref), res["fused_mesh_unsharded_seconds"] = run(
        lambda: fm.wavefront_steps_fused_mesh(mp, cam, full, SEED_KEY0, st0,
                                              n_steps, device=dev))
    sst0 = shard.wavefront_init_sharded(mscene, cam, full, SEED_KEY0, mesh)
    sync(dev)
    reset_counts()
    (fm_sh, of_sh, np_sh), res["fused_mesh_sharded_seconds"] = run(
        lambda: shard.wavefront_steps_fused_mesh_sharded(
            mp, cam, full, SEED_KEY0, sst0, n_steps, mesh))
    launches = read_counts()
    res.update(
        fused_mesh_bit_equal=states_bit_equal(fm_sh, fm_ref),
        overflow=[int(of_sh), int(of_ref)],
        npred=[np_sh.tolist(), np_ref.tolist()],
        fused_mesh_launches=launches["fused_mesh"])
    emit(phase="sharded", nvidia_smi=smi, slabs=SHARDED_SLABS,
         devices=[str(d) for d in mesh.devices], collectives="none (one "
         "process)", config=f"{full.width}x{full.height} {full.spp}spp "
         f"depth{full.max_depth} rr{full.rr_survival}; steppers {n_steps} "
         f"steps; fused mesh on cornell_mesh_scene", **res)
    steps_fm = n_steps * SHARDED_SLABS
    if not (res["render_bit_equal"] and res["wavefront_bit_equal"]
            and res["fused_mesh_bit_equal"] and res["overflow"] == [0, 0]
            and res["npred"][0] == res["npred"][1]
            and (dev.type != "cuda" or all(
                launches["fused_mesh"][k] == steps_fm for k in MESH_TPU))):
        raise RuntimeError(f"sharded: {res}")
    return dict(img=ref.cpu(), wf=wf_ref, fm=(fm_ref, np_ref),
                launches=launches["fused_mesh"])


def grad_reference(dev, cfg, seed):
    """grad_step_cornell's gradient on the card, unsharded: d mean(render(
    albedo)^2) / d albedo."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    a = scene.materials.albedo.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(albedo=a))
    torch.mean(mc.render(s, cam, cfg, seed, device=dev) ** 2).backward()
    return a.grad


def grad_witnesses(dev, cfg, seed, chunk_rows=32):
    """Two witnesses of where the ranks' gradient gap to grad_reference
    comes from.  The gradient over SHARDED_SLABS slabs in this process: the
    ranks' split of the sum, without their collectives.  A float64
    reference: each run of ``chunk_rows`` rows' float32 gradient of its
    share of mean(img^2), the runs summed in float64, so each float32 sum
    holds a (H / chunk_rows)-th of the terms."""
    from cpu_based_ray_tracer_tpu_torch.parallel import shard
    from cpu_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell

    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)

    def grad(loss):
        a = scene.materials.albedo.clone().requires_grad_(True)
        loss(scene.replace(materials=scene.materials.replace(
            albedo=a))).backward()
        return a.grad

    mesh = make_mesh(SHARDED_SLABS, devices=dev)
    g_slabs = grad(lambda s: torch.mean(
        shard.render_sharded(s, cam, cfg, seed, mesh) ** 2))
    n = cfg.height * cfg.width * 3
    g64 = torch.zeros(scene.materials.albedo.shape, dtype=torch.float64,
                      device=dev)
    for r0 in range(0, cfg.height, chunk_rows):
        g64 += grad(lambda s: torch.sum((shard.render_tiles(
            s, cam, cfg, seed, r0, chunk_rows) / cfg.spp) ** 2) / n).double()
    return g_slabs.cpu().numpy(), g64.cpu().numpy()


def sharded_ranks_phase(dev, full: RenderConfig, smi: str, refs: dict,
                        n_steps=16, world=2, timeout=600) -> dict:
    """Two ranks on the one card, each its own process
    (cpu_based_ray_tracer_tpu_torch.parallel.worker, gloo: nccl refuses two
    ranks on one card): the 896^2 image rows bit equal to monte_carlo.render;
    grad_step_cornell's cell (448^2, 4 spp, depth 8, mean(render(albedo)^2))
    with every rank's gradient allclose (GRAD_TOL: rtol 1e-4, atol 1e-6) to
    the unsharded gradient, beside the spread of two unsharded runs and
    each one's gap to grad_witnesses' float64 reference; the
    plain and fused mesh steppers (16 steps) bit
    equal on every plane of each rank's lanes; dryrun_multichip over the
    ranks; one collective a stepper call.  Each rank's seconds and
    csrc/fused_mesh.cu launches."""
    import tempfile

    from cpu_based_ray_tracer_tpu_torch.parallel.shard import PLANES

    base = dict(width=full.width, height=full.height, spp=full.spp,
                max_depth=full.max_depth, rr_survival=full.rr_survival,
                seed=SEED_KEY0)
    gcfg = full.replace(width=448, height=448, max_depth=8)
    spec = {"device": dev.type, "render": base,
            "grad": dict(base, width=448, height=448, max_depth=8,
                         loss="mean_sq"),
            "wavefront": dict(base, n_steps=n_steps),
            "fused_mesh": dict(base, n_steps=n_steps), "dryrun": True}
    os.makedirs(OUT, exist_ok=True)
    sync(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "cpu_based_ray_tracer_tpu_torch.parallel.worker", "--init-method",
             f"file://{tmp}/rendezvous", "--world-size", str(world), "--rank",
             str(r), "--backend", "gloo", "--out", tmp, "--spec",
             json.dumps(spec)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"RANK_OK {r}" not in out:
                raise RuntimeError(f"sharded_ranks: rank {r} failed:\n"
                                   f"{out[-4000:]}")
        reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        data = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(world)]
    g_ref = grad_reference(dev, gcfg, SEED_KEY0).cpu().numpy()
    img = refs["img"].numpy()
    rows = {int(k[3:]): v for d in data for k, v in d.items()
            if k.startswith("row")}
    res = {"rows": sorted(rows), "rows_bit_equal": all(
        np.array_equal(v.view(np.int32),
                       img[r0:r0 + v.shape[0]].view(np.int32))
        for r0, v in rows.items()) and len(rows) == world}
    g_rep = grad_reference(dev, gcfg, SEED_KEY0).cpu().numpy()
    res["grad_max_abs_err"] = [float(np.abs(d["grad"] - g_ref).max())
                               for d in data]
    scale = np.maximum(np.abs(g_ref), 1e-30)
    res["grad_max_rel_err"] = [float((np.abs(d["grad"] - g_ref) / scale).max())
                               for d in data]
    res["grad_unsharded_repeat_max_abs_err"] = float(
        np.abs(g_rep - g_ref).max())
    g_slabs, g64 = grad_witnesses(dev, gcfg, SEED_KEY0)

    def gap(g, h):
        return float(np.abs(g.astype(np.float64) - h).max())
    res["grad_to_f64_max_abs_err"] = {
        "unsharded": gap(g_ref, g64), "unsharded_repeat": gap(g_rep, g64),
        "slabs_in_process": gap(g_slabs, g64),
        "ranks": [gap(d["grad"], g64) for d in data]}
    res["grad_ranks_to_slabs_in_process_max_abs_err"] = [
        gap(d["grad"], g_slabs) for d in data]
    res["grad_slabs_in_process_max_abs_err"] = gap(g_slabs, g_ref)
    res["grad_tol"] = GRAD_TOL
    res["grad_allclose"] = all(np.allclose(d["grad"], g_ref, **GRAD_TOL)
                               for d in data)

    def lanes_equal(prefix, st):
        """The ranks' lanes, in rank order, bit equal to ``st`` on every
        plane (floats as int32 words), and every rank's nrays."""
        for f in PLANES:
            want = getattr(st, f).cpu().numpy()
            got = np.concatenate([d[f"{prefix}_{f}"] for d in data])
            if not np.array_equal(got.view(np.int32), want.view(np.int32)):
                return False
        return all(int(d[f"{prefix}_nrays"]) == int(st.nrays) for d in data)

    fm_ref, np_ref = refs["fm"]
    res["wavefront_bit_equal"] = lanes_equal("wf", refs["wf"])
    res["fused_mesh_bit_equal"] = lanes_equal("fm", fm_ref) and all(
        int(d["fm_overflow"]) == 0
        and d["fm_npred"].tolist() == np_ref.tolist() for d in data)
    res["collectives"] = [{k: v["collectives"] for k, v in rep.items()
                           if isinstance(v, dict)} for rep in reports]
    one = {"all_reduce": 1, "all_gather": 0}
    res["one_collective_a_step_call"] = all(
        c["wavefront"] == one and c["fused_mesh"] == one
        for c in res["collectives"])
    launches = [rep["fused_mesh"]["fused_mesh_launches"] for rep in reports]
    emit(phase="sharded_ranks", nvidia_smi=smi, world=world,
         backend=[rep["backend"] for rep in reports],
         devices=[rep["device"] for rep in reports],
         config=f"render {full.width}x{full.height} {full.spp}spp depth"
         f"{full.max_depth}; grad {gcfg.width}x{gcfg.height} {gcfg.spp}spp "
         f"depth{gcfg.max_depth} loss mean(render(albedo)^2); steppers "
         f"{n_steps} steps", wall_seconds=wall,
         seconds=[{k: v["seconds"] for k, v in rep.items()
                   if isinstance(v, dict)} for rep in reports],
         fused_mesh_launches=launches, dryrun_multichip=all(
             "dryrun" in rep for rep in reports), **res)
    if not (res["rows_bit_equal"] and res["grad_allclose"]
            and res["wavefront_bit_equal"] and res["fused_mesh_bit_equal"]
            and res["one_collective_a_step_call"]
            and (dev.type != "cuda" or all(
                ln[k] == n_steps for ln in launches for k in MESH_TPU))):
        raise RuntimeError(f"sharded_ranks: {res}")
    return {"launches": launches}


def cli_phase(dev, full: RenderConfig, smi: str, small=64) -> dict:
    """The port's CLI in this process (``python -m
    cpu_based_ray_tracer_tpu_torch``): every render stage at small x small,
    2 spp, depth 8 (the mesh stage needs the reference's OBJ assets:
    without them it raises FileNotFoundError, as the JAX CLI's does),
    each's launches; fly for 2
    frames; render --stage mc at 896^2, 4 spp, depth 16 bit equal to
    render_turbo_exact (the image and its PNG); checkpoint and resume on
    the card (2 + 2 spp in chunks of 2, bit equal to the uninterrupted
    chunks; a resume under another seed refused); artifacts --tier test
    --check against goldens/test/ at tests/test_golden.py's tolerances."""
    from cpu_based_ray_tracer_tpu_torch.__main__ import main, render_stage
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import tonemap
    from cpu_based_ray_tracer_tpu_torch.scenes import cornell
    from cpu_based_ray_tracer_tpu_torch.utils import image as im

    d = os.path.join(OUT, "cli")
    os.makedirs(d, exist_ok=True)
    on_cpu = ["--cpu"] if dev.type == "cpu" else []   # a dry run off the card

    def cli(argv):
        main(on_cpu + argv)

    stages = {}
    for stage in ("offline", "initial", "nppt", "whitted", "mesh", "mesh-mc",
                  "mc", "denoiser"):
        out = os.path.join(d, f"{stage}.png")
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        try:
            cli(["render", "--stage", stage, "--width", str(small),
                 "--height", str(small), "--spp", "2", "--depth", "8",
                 "--out", out])
        except FileNotFoundError as e:
            if stage != "mesh":
                raise
            stages[stage] = {"skipped": str(e)}
            continue
        sync(dev)
        png = im.read_png(out)
        stages[stage] = dict(seconds=time.perf_counter() - t0,
                             launches=read_counts(),
                             shape=list(png.shape), std=float(png.std()))
        if png.shape != (small, small, 3) or not png.std() > 0:
            raise RuntimeError(f"cli render {stage}: {stages[stage]}")
    cli(["fly", "--width", str(small), "--height", str(small), "--frames",
         "2", "--outdir", os.path.join(d, "fly")])

    seed = SEED_KEY0     # --seed 0
    scene, cam = cornell.cornell_scene(dev), cornell.cornell_camera(dev)
    want = (mc.render_turbo_exact if dev.type == "cuda" else mc.render_fast)(
        scene, cam, full, seed, device=dev)
    img, _ = render_stage("mc", full, seed, dev)
    out = os.path.join(d, f"mc_{full.width}.png")
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    cli(["render", "--stage", "mc", "--width", str(full.width), "--height",
         str(full.height), "--spp", str(full.spp), "--depth",
         str(full.max_depth), "--rr", str(full.rr_survival), "--out", out])
    mc_secs = time.perf_counter() - t0
    mc_launches = read_counts()["fused_mc"]
    res = dict(mc_bit_equal=torch.equal(img.view(torch.int32),
                                        want.view(torch.int32)),
               mc_png_equal=bool(np.array_equal(
                   im.read_png(out),
                   tonemap.quantize_u8(want, 1.0).cpu().numpy())),
               mc_seconds=mc_secs, mc_fused_mc_launches=mc_launches)

    ck = os.path.join(d, "state.npz")
    if os.path.exists(ck):
        os.remove(ck)
    ck_args = ["render", "--stage", "mc", "--width", "128", "--height",
               "128", "--depth", "16", "--checkpoint", ck,
               "--checkpoint-every", "2", "--out", os.path.join(d, "ck.png")]
    cli(ck_args + ["--spp", "2"])
    cli(ck_args + ["--spp", "4"])
    with np.load(ck) as z:
        acc, done = z["accum"], int(z["samples_done"])
    ccfg = full.replace(width=128, height=128, spp=2)
    a = torch.zeros((128, 128, 3), dtype=torch.float32, device=dev)
    a, s = mc.render_wavefront(scene, cam, ccfg, seed, a, 0, device=dev)
    a, s = mc.render_wavefront(scene, cam, ccfg, seed, a, s, device=dev)
    res["resume_bit_equal"] = bool(done == 4 and np.array_equal(
        acc.view(np.int32), a.cpu().numpy().view(np.int32)))
    try:
        cli(ck_args + ["--spp", "6", "--seed", "1"])
        res["other_seed_refused"] = False
    except SystemExit:
        res["other_seed_refused"] = True

    t0 = time.perf_counter()
    try:
        cli(["artifacts", "--tier", "test", "--check", "--outdir",
             os.path.join(d, "goldens")])
        res["artifacts_check"] = "0 failures"
    except SystemExit as e:
        res["artifacts_check"] = f"exit {e.code}"
    res["artifacts_seconds"] = time.perf_counter() - t0
    emit(phase="cli", nvidia_smi=smi, stages=stages,
         config=f"stages {small}x{small} 2spp depth8; mc {full.width}x"
         f"{full.height} {full.spp}spp depth{full.max_depth}", **res)
    if not (res["mc_bit_equal"] and res["mc_png_equal"]
            and (dev.type != "cuda" or mc_launches > 0)
            and res["resume_bit_equal"] and res["other_seed_refused"]
            and res["artifacts_check"] == "0 failures"):
        raise RuntimeError(f"cli: {res}")
    return {"stages": stages, "mc_launches": mc_launches}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, busy_ms: float = 0.0) -> float:
    """Milliseconds of fn() on the card, by CUDA events.  busy_ms > 0
    first keeps the card busy that long (torch.cuda._sleep), so that the
    host has enqueued fn's launches before the first event fires: the time
    of launches too small to hide the host's own work between them."""
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if busy_ms > 0.0:
        torch.cuda._sleep(int(busy_ms * 1e-3 * BOOST_HZ))
    ev0.record()
    fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clocks = nvidia_smi("clocks.max.sm,clocks.sm")
    max_sm_mhz = float(clocks.split(",")[0].split()[0])
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, clocks_max_sm_and_sm=clocks,
         torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_phase()
    sass_phase()
    full = RenderConfig(width=896, height=896, spp=4, max_depth=16,
                        rr_survival=0.8)
    max_err = parity_phase(dev, full, sphere_size=256, n_steps=32)
    golden_phase(dev, RenderConfig(width=128, height=128, spp=64,
                                   max_depth=16, rr_survival=0.8))
    launches, mc_render = main_phase(dev, full)
    sp = speed_phase(dev, full, max_sm_mhz, smi)

    wfull = RenderConfig(width=896, height=896, whitted_depth=5)
    w_err, w_counts = whitted_parity_phase(dev, wfull)
    whitted_golden_phase(dev)
    p_launches, shadow = mesh_main_phase(dev, wfull)
    p_err, p_cases = mesh_parity_phase(dev, wfull, shadow)
    pir = packet_in_render_phase(dev, wfull, smi)
    w_launches = whitted_main_phase(dev, wfull)
    mesh_mc_phase(dev, RenderConfig(width=128, height=128, spp=4,
                                    max_depth=16, rr_survival=0.8))
    wsp = whitted_speed_phase(dev, wfull, w_counts, smi)
    psp = packet_speed_phase(dev, p_cases, smi)

    m_err = mesh_fused_parity_phase(dev, full)
    m_launches = mesh_fused_main_phase(dev, full)
    mesh_fused_oracle_phase(dev, RenderConfig(width=128, height=128, spp=4,
                                              max_depth=16, rr_survival=0.8))
    msp = mesh_fused_speed_phase(dev, full, smi)

    c_launches, f_shadow = mesh_fused_whitted_main_phase(dev, wfull)
    c_err, c_pack, c_rays, c_swept = coherent_parity_phase(dev, wfull,
                                                           f_shadow)
    csp = coherent_speed_phase(dev, wfull, c_pack, c_rays, c_swept, smi)
    cfg164 = RenderConfig(width=896, height=896, spp=8, max_depth=16,
                          rr_survival=0.8)
    sl_launches, sl_err = mesh_fused_164k_phase(dev, cfg164)
    ssp = sl_speed_phase(dev, cfg164, smi)

    r_err = rtiow_parity_phase(dev)
    rtiow_golden_phase(dev)
    r_main = rtiow_main_phase(dev, smi)
    rsp = rtiow_speed_phase(dev, smi)
    dcfg = RenderConfig(width=896, height=896, spp=1, max_depth=16,
                        rr_survival=0.8)
    d_err = denoiser_parity_phase(dev, dcfg)
    denoiser_golden_phase(dev)
    d_counts = denoiser_main_phase(dev, dcfg)
    dsp = single_path_speed_phase(dev, dcfg, smi)
    asp = denoise_atrous_speed_phase(dev, dcfg, smi)

    mc_equal_spp_phase(dev, full, smi)
    mc_equal_spp_golden_phase(dev, RenderConfig(width=128, height=128,
                                                spp=64, max_depth=16,
                                                rr_survival=0.8), smi)
    slabs_phase(dev, full, smi)
    min_spp_phase(dev, full, smi)
    soft_shadow_phase(dev, smi, full.replace(soft_shadow_beta=0.05),
                      RenderConfig(width=128, height=128, spp=4, max_depth=16,
                                   rr_survival=0.8, soft_shadow_beta=0.05))
    grads = grad_step_phases(dev, smi)
    inverse_phase(dev, smi)
    bunny = grads["grad_step_mesh_bunny"]
    sh = sharded_phase(dev, full, smi)
    shr = sharded_ranks_phase(dev, full, smi, sh)
    cl = cli_phase(dev, full, smi)

    r = full.width * full.height
    mesh_kernels = [{
        "name": f"fused_mesh_{k}", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/fused_mesh.cu",
        "replaces": f"cpu_based_ray_tracer_tpu/ops/fused_mesh.py:"
                    f"{MESH_TPU[k][1]}",
        "tpu_kernel": f"ops/fused_mesh.py::{MESH_TPU[k][0]}",
        "unit": f"ms per bounce step, {r} lanes, cornell_mesh_scene "
                f"(one launch per step)",
        "launches": m_launches[k], "max_abs_err": m_err[k],
        "launches_by_path": {
            "render_turbo_mesh_exact": m_launches[k],
            "sharded_in_process": sh["launches"][k],
            "sharded_ranks": [ln[k] for ln in shr["launches"]],
            "cli_mesh_mc":
                cl["stages"]["mesh-mc"]["launches"]["fused_mesh"][k]},
        "ms": msp[k]["ms"], "plain_ms": msp[k]["plain_ms"],
        "bound_ms": msp[k]["bound_ms"], "bound_by": msp[k]["bound_by"],
        "bound_no_fma_ms": msp[k]["bound_no_fma_ms"],
        **({"slices": msp[k]["splits"]["default"]["k"],
            "unsplit_ms": msp[k]["splits"]["unsplit"]["ms"]}
           if "splits" in msp[k] else {}),
        **({"sweep_ms": msp[k]["sweep_ms"],
            "group_ms": msp["group_occl" if k == "occl" else "group"]["ms"],
            "pack_order_sweep_ms":
                msp[k]["pack_order_splits"]["default"]["ms"],
            "boxes_crossed_per_warp": msp[k]["boxes_crossed_per_warp"],
            "boxes_crossed_per_warp_grouped":
                msp[k]["boxes_crossed_per_warp_grouped"]}
           if k in ("nearest", "occl") else {}),
        "library_ms": None} for k in MESH_TPU]
    coherent_src = "cpu_based_ray_tracer_tpu_torch/csrc/coherent.cu"
    coherent_kernels = [{
        "name": f"coherent_{k}", "route": "cuda", "source": coherent_src,
        "replaces": COHERENT_TPU[k][1], "tpu_kernel": COHERENT_TPU[k][0],
        "unit": f"ms per {r}-ray camera pass of bvh_stage_scene"
                f"({BVH_SUBDIVISIONS}), {c_pack.n_clusters} clusters",
        "launches": c_launches[k],
        "launches_mc_164k": sl_launches["coherent"][k],
        "max_abs_err": c_err[k], "ms": csp[k]["ms"],
        "plain_ms": csp[k]["plain_ms"], "bound_ms": csp[k]["bound_ms"],
        "bound_by": csp[k]["bound_by"],
        "bound_no_fma_ms": csp[k]["bound_no_fma_ms"],
        **({"slices": csp[k]["slices"], "unsplit_ms": csp[k]["unsplit_ms"],
            "group_bound_ms": csp[k]["group_bound_ms"],
            "crossed_cluster_bound_ms": csp[k]["crossed_cluster_bound_ms"],
            "listed_triangle_bound_ms": csp[k]["listed_triangle_bound_ms"]}
           if k == "sweep" else {
            "words_only_ms": csp[k]["words_only_ms"],
            "lists_wall_ms": csp[k]["lists_wall_ms"],
            **{f"{b}_bound_ms": csp[k][f"{b}_bound_ms"]
               for b in ("flat", "lane", "warp")},
            "unit_164k": "ms per step of the 164k cell, its nearest and "
                         "occlusion passes over their packed rays",
            **{f"{f}_164k": [ssp[sl][f"mask_{f}"]
                             for sl in ("nearest_sl", "occl_sl")]
               for f in ("ms", "plain_ms", "words_only_ms")},
            **{f"{f}_164k": [ssp[sl]["mask_bound"][f]
                             for sl in ("nearest_sl", "occl_sl")]
               for f in ("bound_ms", "bound_by", "bound_no_fma_ms",
                         "flat_bound_ms", "warp_bound_ms")}}),
        "library_ms": None} for k in COHERENT_TPU]
    sl_kernels = [{
        "name": f"fused_mesh_{k}", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/fused_mesh.cu",
        "replaces": SL_TPU[1], "tpu_kernel": SL_TPU[0],
        "unit": f"ms per bounce step, {r} lanes, the 164k-triangle cell "
                f"(one launch per step, lists given)",
        "launches": sl_launches["fused_mesh"][k],
        "max_abs_err": sl_err[k[:-3]], "ms": ssp[k]["ms"],
        "plain_ms": ssp[k]["plain_ms"], "bound_ms": ssp[k]["bound_ms"],
        "bound_by": ssp[k]["bound_by"],
        "bound_no_fma_ms": ssp[k]["bound_no_fma_ms"],
        "all_clusters_ms": ssp[k]["all_clusters_ms"],
        "slices": ssp[k]["splits"]["default"]["k"],
        "unsplit_ms": ssp[k]["splits"]["unsplit"]["ms"], "library_ms": None}
        for k in ("nearest_sl", "occl_sl")]
    print(json.dumps({"kernels": [{
        "name": "fused_mc", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/fused_mc.cu",
        "replaces": "cpu_based_ray_tracer_tpu/ops/fused.py:202",
        "tpu_kernel": "ops/fused.py::_kernel",
        "unit": f"ms per bounce step, {r} lanes, 256-step launches",
        "launches": launches, "max_abs_err": max_err, "max_err": max_err,
        "launches_by_path": {"render_turbo_exact": launches,
                             "cli_mc": cl["mc_launches"]},
        "ms": sp["kernel_ms"], "ms_per_step": sp["kernel_ms"],
        "plain_ms": sp["plain_ms"], "bound_ms": sp["bound_ms"],
        "bound_ms_per_step": sp["bound_ms"], "bound_by": sp["bound_by"],
        "bound_no_fma_ms": sp["bound_no_fma_ms"],
        "library_ms": None, "single_path_unit":
            f"ms per single_path launch, {dcfg.width}x{dcfg.height} lanes, "
            f"{dcfg.max_depth} steps (the Denoiser frame's G-buffer)",
        "single_path_launches": d_counts["fused_mc"],
        "single_path_max_abs_err": d_err,
        "single_path_ms": dsp["ms"], "single_path_plain_ms": dsp["plain_ms"],
        "single_path_bound_ms": dsp["bound_ms"],
        "single_path_bound_by": dsp["bound_by"],
        "single_path_bound_no_fma_ms": dsp["bound_no_fma_ms"],
        "render_unit": f"ms of the {full.width}x{full.height} {full.spp}-spp "
                       f"render's launches {mc_render['kernel_launch_steps']}",
        "render_ms": mc_render["kernel_ms"],
        "render_bound_ms": mc_render["kernel_bound_ms"],
        "render_bound_no_fma_ms": mc_render["kernel_bound_no_fma_ms"],
        "render_live_lane_steps": mc_render["live_lane_steps"]}, {
        "name": "fused_rtiow", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/fused_rtiow.cu",
        "replaces": RTIOW_TPU, "tpu_kernel": "ops/fused_rtiow.py::_kernel",
        "unit": "ms per step of 883x824 lanes, the NPPT cell, 128-step "
                "step-mode launches from the initial state (render_ms: one "
                "render-mode launch, the whole render)",
        "launches": sum(v["launches"] for v in r_main.values()),
        "launches_by_render": {k: v["launches"] for k, v in r_main.items()},
        "launches_by_path": {
            **{k: v["launches"] for k, v in r_main.items()},
            **{f"cli_{k}": cl["stages"][k]["launches"]["fused_rtiow"]
               for k in ("offline", "nppt")}},
        "max_abs_err": r_err,
        "ms": rsp["ms"], "plain_ms": rsp["plain_ms"],
        "bound_ms": rsp["bound_ms"], "bound_by": rsp["bound_by"],
        "bound_no_fma_ms": rsp["bound_no_fma_ms"],
        "render_ms": {k: v["ms"] for k, v in r_main.items()},
        "render_bound_ms": {k: v["bound_ms"] for k, v in r_main.items()},
        "render_bound_no_fma_ms": {k: v["bound_no_fma_ms"]
                                   for k, v in r_main.items()},
        "render_chunks": {k: v["chunks"] for k, v in r_main.items()},
        "library_ms": None}, {
        "name": "fused_whitted", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/fused_whitted.cu",
        "replaces": "cpu_based_ray_tracer_tpu/ops/fused_whitted.py:131",
        "tpu_kernel": "ops/fused_whitted.py::_kernel",
        "unit": f"ms per {wfull.width}x{wfull.height} frame, depth "
                f"{wfull.whitted_depth}, Q=4",
        "launches": w_launches, "max_abs_err": w_err, "ms": wsp["ms"],
        "plain_ms": wsp["plain_ms"], "bound_ms": wsp["bound_ms"],
        "bound_by": wsp["bound_by"], "bound_no_fma_ms": wsp["bound_no_fma_ms"],
        "items_per_level": wsp["items_per_level"],
        "warp_lane_slots_per_level": wsp["warp_lane_slots_per_level"],
        "library_ms": None}, {
        "name": "packet", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/packet.cu",
        "replaces": "cpu_based_ray_tracer_tpu/ops/packet.py:117",
        "tpu_kernel": "ops/packet.py::_kernel",
        "unit": f"ms per {r}-ray pass, bvh_stage_scene camera rays "
                f"(shadow rays: shadow_ms)",
        "launches": p_launches, "max_abs_err": p_err,
        "launches_by_path": {
            "mesh_render": p_launches,
            **{f"grad_step_mesh_bunny_{k}": bunny[f"{k}_launches"]["packet"]
               for k in ("grad_std", "record_pass", "grad_replay")}},
        "ms": psp["camera"]["ms"], "plain_ms": psp["camera"]["plain_ms"],
        "bound_ms": psp["camera"]["bound_ms"],
        "bound_by": psp["camera"]["bound_by"],
        "bound_no_fma_ms": psp["camera"]["bound_no_fma_ms"],
        "shadow_ms": psp["shadow"]["ms"],
        "shadow_plain_ms": psp["shadow"]["plain_ms"],
        "shadow_bound_ms": psp["shadow"]["bound_ms"],
        "in_render_ms": pir["ms"], "in_render_launches": pir["launches"],
        "in_render_bound_ms": pir["bound_ms"],
        "in_render_bound_no_fma_ms": pir["bound_no_fma_ms"],
        "in_render_seconds": pir["render_seconds"],
        "in_render_chunk": pir["rays_per_launch"]["max"],
        "in_render_chunk_sweep": pir["chunk_sweep"],
        "chunk_16384_ms": psp["camera_16384"]["ms"],
        "chunk_16384_bound_ms": psp["camera_16384"]["bound_ms"],
        "chunk_16384_bound_no_fma_ms":
            psp["camera_16384"]["bound_no_fma_ms"],
        "boxes_crossed_per_warp": psp["camera"]["boxes_crossed_per_warp"],
        "warp_pairs_bound_ms": psp["camera"]["warp_pairs_bound_ms"],
        "pr7_vote_bound_ms": psp["camera"]["pr7_vote_bound_ms"],
        "chunk_16384_pr7_vote_bound_ms":
            psp["camera_16384"]["pr7_vote_bound_ms"],
        "in_render_pr7_vote_bound_ms": pir["pr7_vote_bound_ms"],
        "library_ms": None}, {
        "name": "denoise_atrous", "route": "cuda",
        "source": "cpu_based_ray_tracer_tpu_torch/csrc/denoise.cu",
        "replaces": "the eager operations of cpu_based_ray_tracer_tpu_torch/"
                    "ops/denoise.py::_atrous_level_plain",
        "tpu_kernel": None,
        "unit": f"ms per a-trous level, {dcfg.width}x{dcfg.height}, "
                f"DenoiserParams() (three levels a frame)",
        "launches": d_counts["denoise"]["atrous"],
        "max_abs_err": asp["max_abs_err"],
        "ms": asp["ms"], "plain_ms": asp["plain_ms"],
        "bound_ms": asp["bound_ms"], "bound_by": asp["bound_by"],
        "bound_no_fma_ms": asp["bound_no_fma_ms"],
        "ms_by_level": [x["ms"] for x in asp["levels"]],
        "library_ms": None}] + mesh_kernels + coherent_kernels
        + sl_kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
