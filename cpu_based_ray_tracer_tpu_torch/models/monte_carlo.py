"""Monte Carlo path tracer, forward (port of
``cpu_based_ray_tracer_tpu.models.monte_carlo``).

The reference's estimator (``Monte Carlo Path Tracer/.../Renderer.cpp:
136-214``): primary miss -> night sky; primary emissive hit -> emission;
at every shading point one uniform area-light sample (NEE, hard shadow
test with +0.01 tolerance) plus an RR-gated uniform-hemisphere bounce;
indirect rays that escape or hit the emitter add nothing.  Paths are
truncated at ``cfg.max_depth`` bounces.

Two engines trace identical paths per (pixel, sample) — all randomness is
the counter-based pcg4d hash of (pixel, sample, bounce, stream):

- ``wavefront_steps``: the persistent-wavefront stepper in plain PyTorch,
  the twin of the JAX package's XLA engine (one ``_bounce_step`` per step);
- ``ops.fused.wavefront_steps_fused``: the same stepper as one CUDA kernel
  launch for ``n_steps`` steps — what ``render_turbo_exact`` and
  ``render_turbo`` run.

- ``render_wavefront`` / ``render_fast``: the equal-spp wavefront engine,
  the same stepper run until every pixel has its ``cfg.spp`` samples.

``intersect_fn`` / ``nearest_t_fn`` swap in an accelerated intersector
(``models.mesh``: the packet kernel) for the main and the shadow rays.
``cfg.soft_shadow_beta > 0`` replaces the hard shadow test by the
sigmoid-relaxed visibility (``soft_vis_fn``, default brute-force
``intersect.soft_visibility``).

Gradients: the fixed-depth engine (``render`` -> ``trace``) is reverse
differentiable through torch autograd, with the traversal detached (the
winner indices) and the shading attached (the recomputed hit, the light
sample, the BRDF), as the JAX package's scan engine.  ``render_replay``
gives the same image and the same gradients with an O(R x depth) graph:
``record_trace`` runs the index pass once without gradients (a
``BounceRecord`` a bounce), and ``render_from_trace`` replays the
estimator from it, each sample rematerialized in the backward pass; on
the card the replay and its backward run as two CUDA graphs
(``utils.graphs``), one launch each.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils import checkpoint

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.ops import fused, intersect, sampling, vec
from cpu_based_ray_tracer_tpu_torch.ops.fused import WavefrontState
from cpu_based_ray_tracer_tpu_torch.scene import (Scene, flatten, to_device,
                                                  unflatten)
from cpu_based_ray_tracer_tpu_torch.utils import (consts, graphs, profiling,
                                                  rng)
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


def _brdf_diffuse(albedo, cos_in):
    """Lambertian BRDF albedo/pi, zero below the horizon."""
    pi = consts.scalar(math.pi, albedo.dtype, albedo.device)
    return torch.where(cos_in[..., None] >= 0.0, albedo / pi, 0.0)


@dataclasses.dataclass(frozen=True)
class BounceRecord:
    """The discrete outcome of a bounce, per lane: what a replay cannot
    recompute cheaply (the winner) or continuously (the hard shadow bit),
    7 bytes a lane a bounce.  The randomness is counter-based and not
    recorded.  Leaves (R,), (max_depth, R) in ``trace`` or (spp,
    max_depth, R) in ``record_trace``."""

    prim: torch.Tensor         # i32 winner primitive index (raw hit)
    is_triangle: torch.Tensor  # bool
    hit: torch.Tensor          # bool raw hit flag
    visible: torch.Tensor      # bool hard shadow-test result

    def to(self, device) -> "BounceRecord":
        return to_device(self, device)

    def __getitem__(self, i) -> "BounceRecord":
        return BounceRecord(*(getattr(self, f.name)[i]
                              for f in dataclasses.fields(self)))

    @staticmethod
    def stack(recs) -> "BounceRecord":
        return BounceRecord(*(torch.stack([getattr(r, f.name) for r in recs])
                              for f in dataclasses.fields(BounceRecord)))


def _bounce_step(scene: Scene, cfg: RenderConfig, *, seed, pixel, sample,
                 bounce, o, d, throughput, alive, intersect_fn=None,
                 nearest_t_fn=None, soft_vis_fn=None,
                 replay_rec: BounceRecord | None = None,
                 with_record: bool = False):
    """One path-tracing bounce for a batch of lanes.

    ``intersect_fn(scene, o, d, t_min) -> Hit`` and ``nearest_t_fn(scene,
    o, d, t_min) -> t`` default to exact brute force.  With
    ``cfg.soft_shadow_beta > 0`` the shadow test is ``soft_vis_fn(scene,
    p, wi, dist, t_min, beta, tolerance) -> (R,)`` (default
    ``intersect.soft_visibility``) and ``nearest_t_fn`` is not called.
    Returns ``(radiance_delta, o', d', throughput', continues, n_main,
    n_shadow)``; the n_* are the ray counts of this step.

    ``replay_rec``: this bounce's recorded ``BounceRecord``; the scene
    intersection and the shadow test are replayed from it (bit equal,
    O(R)).  ``with_record``: also return this bounce's ``BounceRecord``
    as a last element (soft-shadow mode records ``visible`` all true)."""
    mats = scene.materials
    if intersect_fn is None:
        intersect_fn = lambda s, oo, dd, tm: intersect.intersect_scene(  # noqa: E731
            s, oo, dd, t_min=tm)
    if nearest_t_fn is None:
        nearest_t_fn = lambda s, oo, dd, tm: intersect.nearest_t(  # noqa: E731
            s, oo, dd, t_min=tm)
    if replay_rec is not None:
        hit = intersect.hit_from_record(scene, o, d, replay_rec.prim,
                                        replay_rec.is_triangle,
                                        replay_rec.hit, cfg.t_min)
    else:
        hit = intersect_fn(scene, o, d, cfg.t_min)
    n_main = torch.sum(alive)

    m = hit.material.long()
    emit, albedo = vec.take(mats.emission, m), vec.take(mats.albedo, m)
    hit_emissive = hit.hit & mats.emissive[m]
    is_primary = ((bounce == 0).expand(alive.shape)
                  if isinstance(bounce, torch.Tensor) else
                  alive.new_full(alive.shape, bounce == 0))
    sky = torch.where(is_primary[:, None], scene.sky(vec.normalize(d)), 0.0)
    radiance = torch.where((alive & ~hit.hit)[:, None], throughput * sky, 0.0)
    radiance = radiance + torch.where(
        (alive & hit_emissive & is_primary)[:, None], throughput * emit, 0.0)

    alive = alive & hit.hit & ~hit_emissive

    # Shading point: normal flipped toward the viewer, epsilon offset.
    n = hit.facing_normal
    p = hit.point + n * cfg.eps_offset

    # --- Direct: one area-light sample (NEE).
    ul = rng.uniforms4(seed, pixel, sample, bounce, rng.LIGHT)
    ls = sampling.sample_area_light(scene, ul[0], ul[1], ul[2])
    to_l = ls.position - p
    dist = vec.norm(to_l)[:, 0]
    wi_l = to_l / torch.clamp(dist, min=1e-20)[:, None]
    ln = torch.where(vec.dot(ls.normal, -wi_l) < 0.0, -ls.normal, ls.normal)
    visible = None
    if replay_rec is not None:
        # The recorded bit: the live test compares, so its occluder t
        # carries no cotangent; only dist, recomputed here, does.
        visible = replay_rec.visible
        vis_w = visible.to(torch.float32)
    elif cfg.soft_shadow_beta > 0.0:
        svf = soft_vis_fn or intersect.soft_visibility
        vis_w = svf(scene, p, wi_l, dist, cfg.t_min, cfg.soft_shadow_beta,
                    cfg.shadow_tolerance)
    else:
        occ_t = nearest_t_fn(scene, p, wi_l, cfg.t_min)
        visible = dist < occ_t + cfg.shadow_tolerance
        vis_w = visible.to(torch.float32)
    n_shadow = torch.sum(alive)
    cos_s = vec.dot(wi_l, n)[:, 0]
    cos_l = vec.dot(-wi_l, ln)[:, 0]
    geom = cos_s * cos_l / torch.clamp(dist * dist, min=1e-20)
    direct = (ls.emission * _brdf_diffuse(albedo, cos_s)
              * (geom / torch.clamp(ls.pdf, min=1e-20))[:, None]
              * vis_w[:, None])
    use = alive & ls.valid
    radiance = radiance + torch.where(use[:, None], throughput * direct, 0.0)

    # --- Indirect: RR then uniform hemisphere.
    us = rng.uniforms4(seed, pixel, sample, bounce, rng.SCATTER)
    survive = us[2] < cfg.rr_survival
    wi = vec.hemisphere_surface_from(n, us[0], us[1])
    cos_i = vec.dot(wi, n)[:, 0]
    pdf = consts.scalar(1.0 / (2.0 * math.pi), torch.float32, wi.device)
    rr = consts.scalar(cfg.rr_survival, torch.float32, wi.device)
    weight = _brdf_diffuse(albedo, cos_i) * cos_i[:, None] / pdf / rr
    continues = alive & survive
    throughput = torch.where(continues[:, None], throughput * weight,
                             throughput)
    o = torch.where(continues[:, None], p, o)
    d = torch.where(continues[:, None], wi, d)
    out = (radiance, o, d, throughput, continues, n_main, n_shadow)
    if with_record:
        if visible is None:  # soft-shadow mode: no meaningful bit
            visible = torch.ones(alive.shape, dtype=torch.bool,
                                 device=alive.device)
        out = out + (BounceRecord(prim=hit.prim, is_triangle=hit.is_triangle,
                                  hit=hit.hit, visible=visible),)
    return out


def _check_replay(cfg: RenderConfig, first_hit=None):
    """Record and replay need the hard shadow bit and every bounce
    intersected (no ``first_hit`` peel)."""
    if first_hit is not None:
        raise ValueError("record/replay does not compose with the first_hit "
                         "peel (the Denoiser G-buffer path)")
    if cfg.soft_shadow_beta != 0.0:
        raise ValueError("record/replay requires hard shadows "
                         "(soft_shadow_beta == 0: a binary visibility bit)")


def trace(scene: Scene, origin, direction, cfg: RenderConfig, *, seed, pixel,
          sample, count_rays: bool = False, intersect_fn=None,
          nearest_t_fn=None, soft_vis_fn=None,
          first_hit: intersect.Hit | None = None,
          record: BounceRecord | None = None, return_record: bool = False):
    """Path radiance for a batch of primary rays, (R, 3): the fixed-depth
    engine (every lane runs all ``cfg.max_depth`` bounces, dead ones
    masked), reverse differentiable.  ``count_rays``: also return the rays
    traced (main + shadow).  ``first_hit``: the already-computed
    ``intersect.Hit`` of these primary rays (the Denoiser's G-buffer needs
    it anyway); bounce 0 uses it in place of a second intersection, with
    the same result.

    ``return_record``: also return the stacked ``BounceRecord`` of every
    bounce, (max_depth, R) leaves.  ``record``: replay the bounces from
    such a record instead of intersecting the scene (``render_replay``).
    Both raise ValueError with ``first_hit`` or soft shadows."""
    if record is not None or return_record:
        _check_replay(cfg, first_hit)
    r = origin.shape[0]
    o, d = origin, direction
    tp = torch.ones((r, 3), dtype=origin.dtype, device=origin.device)
    radiance = torch.zeros_like(tp)
    alive = torch.ones((r,), dtype=torch.bool, device=origin.device)
    nrays = torch.zeros((), dtype=torch.int64, device=origin.device)
    recs = []
    for bounce in range(cfg.max_depth):
        fn = intersect_fn
        if bounce == 0 and first_hit is not None:
            fn = lambda *_args: first_hit  # noqa: E731
        delta, o, d, tp, alive, n_main, n_shadow, *rec = _bounce_step(
            scene, cfg, seed=seed, pixel=pixel, sample=sample, bounce=bounce,
            o=o, d=d, throughput=tp, alive=alive, intersect_fn=fn,
            nearest_t_fn=nearest_t_fn, soft_vis_fn=soft_vis_fn,
            replay_rec=None if record is None else record[bounce],
            with_record=return_record)
        radiance = radiance + delta
        nrays = nrays + n_main + n_shadow
        recs += rec
    out = (radiance,)
    if count_rays:
        out = out + (fused.wrap_i32(nrays),)
    if return_record:
        out = out + (BounceRecord.stack(recs),)
    return out if len(out) > 1 else radiance


def _primary_rays(camera, cfg: RenderConfig, seed, sample,
                  pixel_offset: int = 0, height: int | None = None):
    """Jittered primary rays of a row-major image slab for one sample index:
    ``height`` rows (default: the whole image) from the absolute pixel
    ``pixel_offset``, the RNG counter, so slabs compose into the whole
    image."""
    h = cfg.height if height is None else height
    w = cfg.width
    pixel = torch.arange(h * w, dtype=torch.int64,
                         device=camera.position.device) + pixel_offset
    uj = rng.uniforms4(seed, pixel, sample, 0, rng.JITTER)
    jitter = torch.stack([uj[0].reshape(h, w), uj[1].reshape(h, w)], -1)
    d = cam_mod.perspective_rays_slab(camera, w, cfg.height,
                                      pixel_offset // w, h,
                                      jitter).reshape(-1, 3)
    return camera.position.expand(d.shape), d, pixel


def render(scene: Scene, camera, cfg: RenderConfig, seed: int,
           device=None, *, intersect_fn=None, nearest_t_fn=None,
           soft_vis_fn=None) -> torch.Tensor:
    """Mean linear radiance, (H, W, 3), by the fixed-depth engine: one
    jittered frame per sample, ``cfg.spp`` samples, on ``device`` (default:
    the card), through ``intersect_fn`` / ``nearest_t_fn`` (default: brute
    force) and, at ``cfg.soft_shadow_beta > 0``, ``soft_vis_fn``."""
    dev = resolve_device(device)
    acc, _ = render_progressive(
        scene.to(dev), camera.to(dev), cfg, seed,
        torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                    device=dev), 0, intersect_fn=intersect_fn,
        nearest_t_fn=nearest_t_fn, soft_vis_fn=soft_vis_fn)
    return acc / torch.tensor(float(cfg.spp), device=dev)


def render_progressive(scene: Scene, camera, cfg: RenderConfig, seed: int,
                       accum, start_sample: int, *, intersect_fn=None,
                       nearest_t_fn=None, soft_vis_fn=None):
    """Accumulate ``cfg.spp`` more samples (indices ``start_sample`` ..
    ``start_sample + spp``) on top of ``accum``; returns the checkpointable
    ``(accum', next_sample)`` pair."""
    h, w = cfg.height, cfg.width
    for s in range(start_sample, start_sample + cfg.spp):
        o, d, pixel = _primary_rays(camera, cfg, seed, s)
        rad = trace(scene, o, d, cfg, seed=seed, pixel=pixel, sample=s,
                    intersect_fn=intersect_fn, nearest_t_fn=nearest_t_fn,
                    soft_vis_fn=soft_vis_fn)
        accum = accum + rad.reshape(h, w, 3)
    return accum, start_sample + cfg.spp


def render_replay(scene: Scene, camera, cfg: RenderConfig, seed: int,
                  device=None, *, intersect_fn=None, nearest_t_fn=None
                  ) -> torch.Tensor:
    """``render`` with an O(R x depth) gradient graph, on ``device``
    (default: the card): record the traversal, differentiate the replay.

    The standard engine pays the (R, N) intersection producers forward and,
    where the rays or the geometry carry gradients, backward.  But the
    estimator's gradient only touches the winner, so this engine (1) runs
    ``record_trace``, the index pass without gradients through any
    intersector (the mesh kernels included), and (2) replays the
    estimator from the record (``render_from_trace``): every hit rebuilt
    from its winner by bit-equal per-lane twins
    (``intersect.hit_from_record``), the randomness regenerated from the
    counter-based RNG, the hard shadow bit substituted.  The image equals
    ``render``'s and so do the gradients.  Silhouette and visibility
    discontinuities are not differentiated, as in the standard engine;
    soft shadows raise ValueError here."""
    recs = record_trace(scene, camera, cfg, seed, device,
                        intersect_fn=intersect_fn, nearest_t_fn=nearest_t_fn)
    return render_from_trace(scene, camera, cfg, seed, recs, device)


def record_trace(scene: Scene, camera, cfg: RenderConfig, seed: int,
                 device=None, *, intersect_fn=None, nearest_t_fn=None
                 ) -> BounceRecord:
    """The index pass of ``render_replay``, on ``device`` (default: the
    card), without gradients: the stacked (spp, max_depth, R)
    ``BounceRecord`` of every bounce.  The record is a function of the
    discrete scene only, so a material or emission loop records once and
    replays every step; a geometry loop records again when it moves."""
    _check_replay(cfg)
    dev = resolve_device(device)
    with profiling.span("mc.record_trace"), torch.no_grad():
        scene, camera = scene.to(dev), camera.to(dev)
        recs = []
        for s in range(cfg.spp):
            o, d, pixel = _primary_rays(camera, cfg, seed, s)
            _, rec = trace(scene, o.detach(), d.detach(), cfg, seed=seed,
                           pixel=pixel, sample=s, return_record=True,
                           intersect_fn=intersect_fn,
                           nearest_t_fn=nearest_t_fn)
            recs.append(rec)
        return BounceRecord.stack(recs)


REPLAY_GRAPH = profiling.Counter("mc_replay_graph",
                                 ("captures", "replays", "eager"))
_REPLAY_GRAPHS = graphs.GraphCache(REPLAY_GRAPH)


def render_from_trace(scene: Scene, camera, cfg: RenderConfig, seed: int,
                      recs: BounceRecord, device=None) -> torch.Tensor:
    """The differentiable replay of ``render_replay`` from a recorded
    trace, mean linear radiance (H, W, 3) on ``device`` (default: the
    card).  Each sample is rematerialized in the backward pass
    (``torch.utils.checkpoint``): its recompute is O(R) a bounce, and the
    counter-based RNG makes it exact.

    On the card, ``_replay`` and its backward run as two CUDA graphs
    (``utils.graphs``) for a configuration, seed, and shapes and
    requires-grad pattern of the scene's, the camera's and the record's
    tensors that repeat: eagerly at their first call, captured at the
    second, replayed in every later one, with the same image.  On the CPU
    ``_replay`` runs as it is.  Counter ``mc_replay_graph``:
    ``captures``, ``replays``, ``eager`` calls."""
    _check_replay(cfg)
    dev = resolve_device(device)
    with profiling.span("mc.replay.forward"):
        args = (scene.to(dev), camera.to(dev), recs.to(dev))
        if dev.type != "cuda":
            REPLAY_GRAPH.add("eager")
            return _replay(cfg, seed, *args)
        seed = int(seed)

        def replay(*tensors):
            it = iter(tensors)
            return _replay(cfg, seed, *(unflatten(a, it) for a in args))

        return _REPLAY_GRAPHS((cfg, seed, *map(type, args)), replay,
                              [t for a in args for t in flatten(a)])


def _replay(cfg: RenderConfig, seed, scene: Scene, camera,
            recs: BounceRecord) -> torch.Tensor:
    """The body of ``render_from_trace``, everything on one device: the
    ``cfg.spp`` checkpointed samples' mean."""
    h, w = cfg.height, cfg.width
    dev = scene.device

    def one_sample(s, rec, scene, camera):
        # runs in the forward, and again in the backward's recomputation
        with profiling.span("mc.replay.sample"):
            o, d, pixel = _primary_rays(camera, cfg, seed, s)
            return trace(scene, o, d, cfg, seed=seed, pixel=pixel, sample=s,
                         record=rec).reshape(h, w, 3)

    acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        acc = acc + checkpoint.checkpoint(
            one_sample, s, recs[s], scene, camera,
            use_reentrant=False, preserve_rng_state=False)
    return acc / consts.scalar(float(cfg.spp), torch.float32, dev)


def count_rays(scene: Scene, camera, cfg: RenderConfig, seed: int
               ) -> torch.Tensor:
    """Rays traced (main + shadow) by one sample pass of the fixed-depth
    engine, on the device the scene lies on."""
    o, d, pixel = _primary_rays(camera.to(scene.device), cfg, seed, 0)
    _, n = trace(scene, o, d, cfg, seed=seed, pixel=pixel, sample=0,
                 count_rays=True)
    return n


def _camera_rays_at(camera, cfg: RenderConfig, seed, pixel, sample):
    """(o, d) of the jittered camera ray of sample ``sample`` of each flat
    pixel index ``pixel``: the ray a lane (re)starts its path with."""
    uj = rng.uniforms4(seed, pixel, sample, 0, rng.JITTER)
    d = cam_mod.perspective_ray_at(camera, cfg.width, cfg.height, pixel,
                                   uj[0], uj[1])
    return camera.position.expand(d.shape), d


def render_wavefront(scene: Scene, camera, cfg: RenderConfig, seed: int,
                     accum, start_sample: int, *, return_rays: bool = False,
                     device=None):
    """The equal-spp wavefront engine, on ``device`` (default: the card).

    Each lane is a persistent worker for its pixel: when its path ends
    (miss, emissive hit, RR death, depth cap) it regenerates the primary
    ray of its pixel's next sample, until every lane has finished samples
    ``start_sample .. start_sample + cfg.spp`` (at most ``spp *
    max_depth`` steps).  The paths are the scan engine's, bit for bit (the
    RNG is a hash of pixel, sample, bounce); only the order of the sums
    differs.  A lane past its quota adds +0.0 and traces no ray.  The
    host reads whether a lane is still live once a step, as JAX's
    ``while_loop`` tests its condition.

    Returns ``(accum', next_sample)`` like ``render_progressive``; with
    ``return_rays`` also the traced-ray count (int32, wrapping)."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    h, w = cfg.height, cfg.width
    n_lanes = h * w
    pixel = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    end = start_sample + cfg.spp

    s = torch.full((n_lanes,), start_sample, dtype=torch.int32, device=dev)
    b = torch.zeros_like(s)
    o, d = _camera_rays_at(camera, cfg, seed, pixel, s)
    tp = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    nrays = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.spp * cfg.max_depth):
        alive = s < end
        if not bool(torch.any(alive)):
            break
        delta, o2, d2, tp2, continues, n_main, n_shadow = _bounce_step(
            scene, cfg, seed=seed, pixel=pixel, sample=s, bounce=b, o=o,
            d=d, throughput=tp, alive=alive)
        acc = acc + delta
        nrays = fused.wrap_i32(nrays.to(torch.int64) + n_main + n_shadow)
        # A path continues only below the depth cap (the scan engine's
        # truncation at cfg.max_depth).
        cont = continues & (b + 1 < cfg.max_depth)
        s = torch.where(alive & ~cont, s + 1, s)
        b = torch.where(cont, b + 1, 0).to(torch.int32)
        po, pd = _camera_rays_at(camera, cfg, seed, pixel, s)
        o = torch.where(cont[:, None], o2, po)
        d = torch.where(cont[:, None], d2, pd)
        tp = torch.where(cont[:, None], tp2, 1.0)
    out = accum.to(dev) + acc.reshape(h, w, 3)
    if return_rays:
        return out, end, nrays
    return out, end


def render_fast(scene: Scene, camera, cfg: RenderConfig, seed: int,
                device=None) -> torch.Tensor:
    """Mean linear radiance, (H, W, 3), by the equal-spp wavefront engine,
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    with profiling.span("mc.render"):
        acc, _ = render_wavefront(
            scene, camera, cfg, seed,
            torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                        device=dev), 0, device=dev)
        return acc / torch.tensor(float(cfg.spp), device=dev)


# --- Persistent wavefront stepper ------------------------------------------
#
# Each lane is a persistent worker for its pixel: when its path ends (miss,
# emissive hit, RR death, depth cap) it regenerates the primary ray of its
# pixel's next sample.  A fixed number of full-width steps runs per call and
# the in-flight state carries across calls.  The state, ``WavefrontState``,
# lives in ``ops.fused`` beside the kernels' layout of it.

def wavefront_init(scene: Scene, camera, cfg: RenderConfig, seed: int,
                   pixel_offset: int = 0, n_lanes: int | None = None,
                   device=None) -> WavefrontState:
    """Fresh lane state on ``device`` (default: the card): every lane on its
    pixel's sample 0 primary ray.  ``pixel_offset`` / ``n_lanes`` (default
    the whole image) select a row-major slab of the image's lanes: the RNG
    counter is the absolute pixel index, so slab states concatenate into
    the whole image's state bit for bit."""
    dev = resolve_device(device)
    camera = camera.to(dev)
    if n_lanes is None:
        n_lanes = cfg.height * cfg.width
    pixel = torch.arange(n_lanes, dtype=torch.int64, device=dev) + pixel_offset
    s0 = torch.zeros((n_lanes,), dtype=torch.int32, device=dev)
    o, d = _camera_rays_at(camera, cfg, seed, pixel, s0)
    o = o.clone()
    z3 = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    return WavefrontState(
        s=s0, b=torch.zeros_like(s0), o=o, d=d,
        tp=torch.ones((n_lanes, 3), dtype=torch.float32, device=dev),
        cur=z3, acc=z3.clone(), n_done=torch.zeros_like(s0),
        nrays=torch.zeros((), dtype=torch.int32, device=dev))


def wavefront_steps(scene: Scene, camera, cfg: RenderConfig, seed: int,
                    state: WavefrontState, n_steps: int, intersect_fn=None,
                    nearest_t_fn=None, pixel_offset: int = 0
                    ) -> WavefrontState:
    """Advance every lane by ``n_steps`` bounce steps, one ``_bounce_step``
    per step in plain PyTorch, on the device ``state`` lies on.
    ``pixel_offset``: the absolute pixel of the state's first lane (see
    ``wavefront_init``)."""
    dev = state.s.device
    scene, camera = scene.to(dev), camera.to(dev)
    n_lanes = state.s.shape[0]
    pixel = torch.arange(n_lanes, dtype=torch.int64, device=dev) + pixel_offset
    alive = torch.ones((n_lanes,), dtype=torch.bool, device=dev)
    st = state
    for _ in range(n_steps):
        delta, o2, d2, tp2, continues, n_main, n_shadow = _bounce_step(
            scene, cfg, seed=seed, pixel=pixel, sample=st.s, bounce=st.b,
            o=st.o, d=st.d, throughput=st.tp, alive=alive,
            intersect_fn=intersect_fn, nearest_t_fn=nearest_t_fn)
        cur = st.cur + delta
        cont = continues & (st.b + 1 < cfg.max_depth)
        done = ~cont
        s_next = st.s + done.to(torch.int32)
        po, pd = _camera_rays_at(camera, cfg, seed, pixel, s_next)
        st = WavefrontState(
            s=s_next, b=torch.where(cont, st.b + 1, 0).to(torch.int32),
            o=torch.where(cont[:, None], o2, po),
            d=torch.where(cont[:, None], d2, pd),
            tp=torch.where(cont[:, None], tp2, 1.0),
            cur=torch.where(done[:, None], 0.0, cur),
            acc=st.acc + torch.where(done[:, None], cur, 0.0),
            n_done=st.n_done + done.to(torch.int32),
            nrays=fused.wrap_i32(st.nrays.to(torch.int64) + n_main
                                  + n_shadow))
    return st


def wavefront_image(state: WavefrontState, cfg: RenderConfig) -> torch.Tensor:
    """Mean linear radiance over each pixel's completed samples, (H, W, 3)."""
    n = torch.clamp(state.n_done, min=1).to(torch.float32)
    return (state.acc / n[:, None]).reshape(cfg.height, cfg.width, 3)


def render_turbo(scene: Scene, camera, cfg: RenderConfig, seed: int,
                 min_spp: int | None = None, device=None) -> torch.Tensor:
    """Mean linear radiance via the fused kernel, equal-*time* progressive:
    steps in chunks until every pixel has completed at least ``min_spp``
    (default ``cfg.spp``) samples, then averages each pixel's completed
    samples (a small stopping-time bias; ``render_turbo_exact`` has
    none)."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    target = cfg.spp if min_spp is None else min_spp
    fs = fused.pack_scene(scene)
    state = wavefront_init(scene, camera, cfg, seed, device=dev)
    chunk = max(32, cfg.max_depth)
    for _ in range(target * cfg.max_depth):
        state = fused.wavefront_steps_fused(fs, camera, cfg, seed, state,
                                            chunk, device=dev)
        if int(torch.min(state.n_done)) >= target:
            break
    return wavefront_image(state, cfg)


def render_turbo_exact(scene: Scene, camera, cfg: RenderConfig, seed: int,
                       device=None) -> torch.Tensor:
    """Mean linear radiance, (H, W, 3), via the fused kernel in EQUAL-SPP
    mode (``stop_after=cfg.spp``): every pixel completes exactly ``cfg.spp``
    samples and then idles — the reference's fixed-spp estimator.  Runs on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    with profiling.span("mc.render"):
        with profiling.span("mc.pack"):
            scene = scene.to(dev)
            fs = fused.pack_scene(scene)
        with profiling.span("mc.init"):
            state = wavefront_init(scene, camera, cfg, seed, device=dev)
        # Chunk doubling: each poll of n_done is a device round trip.
        chunk = max(32, cfg.max_depth)
        for _ in range(cfg.spp * cfg.max_depth):
            with profiling.span("mc.launch"):
                state = fused.wavefront_steps_fused(
                    fs, camera, cfg, seed, state, chunk, stop_after=cfg.spp,
                    device=dev)
            with profiling.span("mc.poll"):
                least = int(torch.min(state.n_done))
            if least >= cfg.spp:
                break
            chunk = min(2 * chunk, 4096)
        spp = torch.tensor(float(cfg.spp), dtype=torch.float32, device=dev)
        return (state.acc / spp).reshape(cfg.height, cfg.width, 3)
