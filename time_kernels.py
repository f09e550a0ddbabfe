"""Time kernels of the port alone in one or more checkouts, each in a
process of its own, in the order given:

- ``k1_ms``: K1 of the fused mesh step (csrc/fused_mesh.cu ``k1_kernel``)
  on ``bench.py``'s ``mc_bunny_mesh_fused`` cell (``cornell_mesh_scene``,
  896x896, depth 16, RR 0.8, caps rp//8 and rp//12), on the state that one
  16-step call from ``wavefront_init`` leaves: 20 launches timed by CUDA
  events with the card kept busy while the host enqueues them, ms a
  launch;
- ``sweep_ms``: the coherent shortlist sweep (csrc/coherent.cu
  ``sweep_kernel``) on ``bvh_stage_scene(4)``'s 896x896 camera rays and
  their lists, 20 launches the same way, ms a launch;
- ``mask_ms``: the mask pass (csrc/coherent.cu ``mask_kernel``, tile
  words only, as the lists need) on the same camera rays; ``mask_164k_ms``
  on the packed main and shadow rays of a step of the 164k cell (two
  icospheres(6), 1,280 clusters, caps rp//8 and rp//16, ``resident=False``)
  the step's two passes summed; 20 launches each the same way, ms a
  launch;
- ``shortlists_ms``: ``coherent._shortlists`` whole on the camera rays
  (the mask pass and the lists: where the kernel does not write the lists,
  the PyTorch ops that make them), 20 calls the same way, ms a call;
  ``shortlists_wall_ms``: the same calls back to back on an idle card,
  by the host's clock around them and a synchronise (what a host-bound
  caller waits);
- ``whitted_ms``: the fused Whitted kernel (csrc/fused_whitted.cu) on an
  896x896 frame of ``whitted_scene()``, depth 5, Q = 4, 20 launches the
  same way, ms a launch; ``whitted_depth0_ms`` the same at depth 0 (the
  primary rays' level alone: the rest is the deeper levels');
- end to end, where the kernels above sit: ``mesh_render_fused_s``, one
  warm 896x896 frame of ``mesh.render`` on ``bvh_stage_scene(4)`` with
  ``method="fused"`` (3 mask and 3 sweep launches and the eager Whitted
  twin), and ``render_164k_s``, ``render_turbo_mesh_exact`` on the 164k
  cell at 896x896, 8 spp (192 mask launches among its kernels), each by
  the host's clock around the call and a synchronise.

Each metric takes ``repeats`` samples.  Each run saves its outputs (K1's
ten hf planes, its packed lanes and rays as a set, the per-block counts
and the population; the sweep's t and index planes; the mask passes'
tile words; the lists; the Whitted frame); every run must give the same
bits as the first.  To time variants of a kernel against the
parent commit, unpack each into a directory that .gitignore lists and
give them in an A B B A order:

    python3 time_kernels.py build/parent . . build/parent

Needs a CUDA card.  The output is time_checkouts.py's.
"""

from __future__ import annotations

import inspect
import time

import numpy as np

import time_checkouts

SEED = 4070199207          # render_key(0), bench.py's key
WIDTH = HEIGHT = 896
N_LAUNCHES = 20
METRICS = ("k1_ms", "sweep_ms", "mask_ms", "mask_164k_ms", "shortlists_ms",
           "shortlists_wall_ms", "whitted_ms", "whitted_depth0_ms",
           "mesh_render_fused_s", "render_164k_s")


def one(root: str, out: str, repeats: int) -> dict:
    """Measure the kernels of the port found under ``root``."""
    time_checkouts.use_checkout(root)
    import torch

    from cpu_based_ray_tracer_tpu_torch import camera
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
    from cpu_based_ray_tracer_tpu_torch.models import mesh
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
    from cpu_based_ray_tracer_tpu_torch.ops import coherent, fused
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh as fm
    from cpu_based_ray_tracer_tpu_torch.ops import fused_whitted as fw
    from cpu_based_ray_tracer_tpu_torch.scenes import (cornell, meshes,
                                                       whitted_scene)

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

    # the mask pass alone, and the lists whole, on the same rays; the
    # word and group boxes where this checkout's kernel takes them
    takes_boxes = "boxes" in inspect.signature(
        coherent._mask_kernel).parameters

    def mask_args(boxes):
        return dict(planes=False, **({"boxes": boxes} if takes_boxes
                                     else {}))
    words = []

    def mask(i):
        words.append(coherent._mask_kernel(
            pack.aabb, rays, cfg.t_min,
            **mask_args(getattr(pack, "boxes", None)))[1])
    mask(0)                                                      # warm-up
    for _ in range(repeats):
        words.clear()
        res["mask_ms"].append(busy_ms(mask))
    saved["mask_words"] = words[-1]
    lists = []
    sl_kw = {"boxes": pack.boxes} if "boxes" in inspect.signature(
        coherent._shortlists).parameters else {}

    def shortlists(i):
        lists.append(coherent._shortlists(pack.aabb, rays, cfg.t_min,
                                          **sl_kw))
    shortlists(0)                                                # warm-up
    for _ in range(repeats):
        lists.clear()
        res["shortlists_ms"].append(busy_ms(shortlists))
        sync()
        t0 = time.perf_counter()
        for i in range(N_LAUNCHES):
            shortlists(i)
        sync()
        res["shortlists_wall_ms"].append(
            (time.perf_counter() - t0) / N_LAUNCHES * 1e3)
    saved["list_ids"], saved["list_cnts"] = lists[-1]

    # the mask pass on a step's packed rays of the 164k cell
    ico = meshes.icosphere(6)
    scene = cornell.cornell_mesh_scene(
        np.concatenate([ico, ico * 0.6 + [1.2, 0.9, 0.3]]), device=dev)
    cfg8 = RenderConfig(width=WIDTH, height=HEIGHT, spp=8, max_depth=16,
                        rr_survival=0.8)
    mp = fm.pack_mesh_scene(scene)
    st = mc.wavefront_init(scene, cam, cfg8, SEED, device=dev)
    caps = (rp // 8, rp // 16)
    st = fm.wavefront_steps_fused_mesh(mp, cam, cfg8, SEED, st, 3,
                                       cap_main=caps[0], cap_shadow=caps[1],
                                       resident=False, device=dev)[0]
    p8 = fm.params(cfg8, r, *caps)
    tb8 = fm._tables(mp, fused._camera_words(cam))
    sf, si = fm.state_planes(st)
    b8 = fm.step_buffers(r, p8, 1, dev)
    fm.run_steps(fm.KERNEL_SL_OPS, tb8, p8, SEED, sf, si, 1, b8)
    # each pass's packed rays in lane order (blocks pack in the order they
    # finish, so the packed order changes from run to run)
    passes = []
    for rays_, ids_, k in ((b8.mr, b8.mr_id, 0), (b8.sr, b8.sr_id, 1)):
        n = int(b8.cnt[0, k])
        rays_ = rays_.clone()
        rays_[:, :n] = rays_[:, :n][:, torch.argsort(ids_[:n])]
        passes.append((rays_.view(rays_.shape[0], -1, coherent.TILE_W),
                       b8.cnt[0, k:k + 1].clone()))
    boxes = getattr(mp, "smc_level_boxes", None)
    words.clear()

    def mask164(i):
        for planes, cnt in passes:
            words.append(coherent._mask_kernel(mp.smc_aabb, planes, p8.t_min,
                                               cnt, **mask_args(boxes))[1])
    mask164(0)                                                   # warm-up
    for _ in range(repeats):
        words.clear()
        res["mask_164k_ms"].append(busy_ms(mask164))
    saved["mask_164k_main_words"], saved["mask_164k_shadow_words"] = \
        words[-2:]

    # the fused Whitted kernel on a 896x896 frame, Q = 4
    wscene = whitted_scene.whitted_scene(dev)
    wcam = whitted_scene.whitted_camera(dev)
    wpack = fw.pack_whitted_scene(wscene)
    dirs = camera.perspective_rays(wcam, WIDTH, HEIGHT).reshape(
        -1, 3).T.contiguous()
    for depth, key in ((5, "whitted_ms"), (0, "whitted_depth0_ms")):
        frames = []

        def whitted(i):
            frames.append(fw._tree_kernel(wpack, wcam.position, dirs, depth,
                                          4, cfg.t_min, cfg.eps_offset))
        whitted(0)                                               # warm-up
        for _ in range(repeats):
            frames.clear()
            res[key].append(busy_ms(whitted))
        saved[f"whitted_frame_depth{depth}"] = frames[-1]

    def wall_s(fn) -> tuple:
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out
    # a warm mesh.render frame through the fused intersector
    bundle = mesh.prepare(bscene, method="fused")
    wcfg = RenderConfig(width=WIDTH, height=HEIGHT, whitted_depth=5)
    mesh.render(bundle, bcam, wcfg, device=dev)                  # warm-up
    for _ in range(repeats):
        secs, img = wall_s(lambda: mesh.render(bundle, bcam, wcfg,
                                               device=dev))
        res["mesh_render_fused_s"].append(secs)
    saved["mesh_render_fused"] = img
    # the 164k cell's 8-spp render, 3 samples (2 s each)
    for _ in range(min(repeats, 3)):
        secs, img = wall_s(lambda: fm.render_turbo_mesh_exact(
            scene, cam, cfg8, SEED, device=dev))
        res["render_164k_s"].append(secs)
    saved["render_164k"] = img
    torch.save({k: x.cpu() for k, x in saved.items()}, out)
    return dict(root=root, repeats=repeats, **res)


if __name__ == "__main__":
    time_checkouts.main(__file__, __doc__, one, METRICS, repeats=7,
                        equal_across=True)
