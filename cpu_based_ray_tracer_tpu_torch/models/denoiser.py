"""The Denoiser stage: 1-spp path tracing and spatial/temporal denoising
(port of ``cpu_based_ray_tracer_tpu.models.denoiser``).

Per frame: path-trace a 1-spp G-buffer (deterministic pixel-center primary
rays) -> joint-bilateral filter -> keep the frame's view/projection
matrices -> temporal reprojection filter.  Two engines render the
G-buffer with the same estimator and the same pcg4d streams:
``render_gbuffer`` (the fixed-depth plain engine, ``monte_carlo.trace``)
and ``render_gbuffer_fused`` (``ops.fused.single_sample_gbuffer``: on the
card one launch of ``csrc/fused_mc.cu`` in ``single_path`` mode).

``DenoiserParams`` is the reference's parameter matrix: JBF half-size
7/16/32, temporal half-size 3/7/16, tolerance 1/2/3, current-frame
weighting 0.05/0.1/0.2/0.5, immediate clamping on/off.
"""

from __future__ import annotations

import dataclasses

import torch

from cpu_based_ray_tracer_tpu_torch import camera as cam_mod
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
from cpu_based_ray_tracer_tpu_torch.ops import denoise, fused, intersect
from cpu_based_ray_tracer_tpu_torch.scene import Scene
from cpu_based_ray_tracer_tpu_torch.utils import profiling
from cpu_based_ray_tracer_tpu_torch.utils.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class DenoiserParams:
    """Runtime denoiser settings (the reference's defaults)."""

    use_jbf: bool = True
    jbf_half_size: int = 7            # "try 7, 16, 32"
    # "atrous" (the a-trous approximation, the default) or "jbf" (the
    # reference's dense window, the quality oracle).
    spatial: str = "atrous"
    use_temporal: bool = True
    temporal_half_size: int = 3
    tolerance: float = 1.0
    current_frame_weighting: float = 0.2
    immediate_clamping: bool = True   # clamp the 1-spp radiance before JBF

    def replace(self, **kw) -> "DenoiserParams":
        return dataclasses.replace(self, **kw)


def global_prim_id(hit: intersect.Hit, n_triangles: int) -> torch.Tensor:
    """Global primitive ids from 1 (triangles first, then spheres), -1 on a
    miss."""
    pid = torch.where(hit.is_triangle, hit.prim + 1,
                      n_triangles + hit.prim + 1)
    return torch.where(hit.hit, pid, -1).to(torch.int32)


def _gbuffer(camera, cfg: RenderConfig, color, pos, normal, contrib, pid,
             immediate_clamping: bool) -> denoise.GBuffer:
    h, w = cfg.height, cfg.width
    if immediate_clamping:
        color = torch.clamp(color, 0.0, 1.0)
    view, proj = cam_mod.view_proj_matrices(camera, w, h)
    # Contiguous planes: the a-trous kernel reads (H, W, 3) rows and (H, W)
    # flags, and the fused engine's planes are transposed views of its
    # planar buffers.
    return denoise.GBuffer(
        color=color.reshape(h, w, 3).contiguous(),
        world_pos=pos.reshape(h, w, 3).contiguous(),
        normal=normal.reshape(h, w, 3).contiguous(),
        contributor=contrib.reshape(h, w).contiguous(),
        prim_id=pid.reshape(h, w), view=view, proj=proj)


def render_gbuffer(scene: Scene, camera: cam_mod.PerspectiveCamera,
                   cfg: RenderConfig, seed: int, frame_index: int,
                   immediate_clamping: bool = True,
                   device=None) -> denoise.GBuffer:
    """One 1-spp frame into a G-buffer by the fixed-depth engine, on
    ``device`` (default: the card): pixel-center primaries; color = the
    full path radiance, optionally clamped to [0, 1]; aux = the primary
    hit's world position, viewer-facing normal, contributor flag and global
    primitive id; and this frame's view/proj matrices.  One intersection
    serves the aux planes and the path's first bounce."""
    dev = resolve_device(device)
    scene, camera = scene.to(dev), camera.to(dev)
    h, w = cfg.height, cfg.width
    d = cam_mod.perspective_rays(camera, w, h).reshape(-1, 3)
    o = camera.position.expand(d.shape)
    pixel = torch.arange(h * w, dtype=torch.int64, device=dev)
    hit = intersect.intersect_scene(scene, o, d, t_min=cfg.t_min)
    color = monte_carlo.trace(scene, o, d, cfg, seed=seed, pixel=pixel,
                              sample=frame_index, first_hit=hit)
    return _gbuffer(camera, cfg, color, hit.point, hit.facing_normal,
                    hit.hit, global_prim_id(hit, scene.triangles.count),
                    immediate_clamping)


def render_gbuffer_fused(scene: Scene, camera: cam_mod.PerspectiveCamera,
                         cfg: RenderConfig, seed: int, frame_index: int,
                         immediate_clamping: bool = True,
                         device=None) -> denoise.GBuffer:
    """``render_gbuffer`` through the fused stepper's single-path mode
    (``ops.fused.single_sample_gbuffer``): the same estimator and
    G-buffer planes; on the card one ``csrc/fused_mc.cu`` launch."""
    dev = resolve_device(device)
    with profiling.span("denoiser.gbuffer"):
        camera = camera.to(dev)
        with profiling.span("mc.pack"):
            fs = fused.pack_scene(scene)
        color, pos, normal, pid, contrib = fused.single_sample_gbuffer(
            fs, camera, cfg, seed, frame_index, device=dev)
        return _gbuffer(camera, cfg, color, pos, normal, contrib, pid,
                        immediate_clamping)


def denoise_frame(g: denoise.GBuffer, prev: denoise.GBuffer | None,
                  params: DenoiserParams):
    """(filtered color, the G-buffer to carry as history).  The history
    holds the JBF-filtered color, as the reference filters in place before
    it saves the previous frame's G-buffer."""
    with profiling.span("denoiser.filter"):
        color = g.color
        if params.use_jbf:
            spatial = (denoise.joint_bilateral_atrous
                       if params.spatial == "atrous"
                       else denoise.joint_bilateral)
            color = spatial(g, params.jbf_half_size,
                            clamp=params.immediate_clamping)
        g = g.replace(color=color)
        if params.use_temporal and prev is not None:
            color = denoise.temporal(g, prev, params.temporal_half_size,
                                     params.tolerance,
                                     params.current_frame_weighting)
            g = g.replace(color=color)
        return color, g


def render_frame(scene: Scene, camera, cfg: RenderConfig, seed: int,
                 frame_index: int, prev: denoise.GBuffer | None,
                 params: DenoiserParams, engine: str = "scan", device=None):
    """The per-frame pipeline (render -> JBF -> temporal) on ``device``
    (default: the card).  ``engine``: "scan" (the fixed-depth engine) or
    "fused" (the single-path mode of the fused stepper).  Returns
    ``(color (H, W, 3), history G-buffer)``."""
    if engine not in ("scan", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    render = render_gbuffer_fused if engine == "fused" else render_gbuffer
    g = render(scene, camera, cfg, seed, frame_index,
               params.immediate_clamping, device=device)
    return denoise_frame(g, prev, params)


def render_sequence(scene: Scene, cameras, cfg: RenderConfig, seed: int,
                    params: DenoiserParams, engine: str = "scan",
                    device=None) -> list:
    """Denoised frames over a list of camera poses, frame i rendering
    sample i, each frame's history carried into the next."""
    frames, prev = [], None
    for i, cam in enumerate(cameras):
        color, prev = render_frame(scene, cam, cfg, seed, i, prev, params,
                                   engine, device)
        frames.append(color)
    return frames
