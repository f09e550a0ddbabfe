"""Traffic of interactive Denoiser frames: ``models.denoiser.render_frame``
with the fused engine, frame ``i`` rendering sample ``i`` of one seed word
from pose ``i`` of a camera path drawn from the run's seed (small moves
around the Cornell camera), each frame's history carried into the next.

Checked: the window's first ``replay_frames`` frames against the plain
reference's own run of them from scratch (its G-buffers, filters and
history), and a sample of the later frames drawn from the run's seed,
each against the reference's G-buffer and filters of that frame applied
to the history the program carried into it (the reference cannot follow
a history of hundreds of frames within a run's time).

A traced run times ``denoise_frame`` inside each ``render_frame`` call by
two CUDA events around it, with no synchronise added."""

from __future__ import annotations

import math
import random
import time
import numpy as np
import torch

from portbench.common import (Check, Reservoir, estimator_settings,
                              request_seed, share_off)
from portbench.reference import denoise as ref_denoise
from portbench.reference import geometry, mc


def camera_path(seed: int, amplitude: float, turn: float):
    """pose(i) -> (position, forward) in float64: the Cornell camera moved
    along a smooth closed path (three sines of periods and phases drawn
    from the seed, position within +-amplitude, forward within +-turn)."""
    rnd = random.Random(request_seed(seed, -3))
    per = [rnd.uniform(40.0, 160.0) for _ in range(5)]
    ph = [rnd.uniform(0.0, 2.0 * math.pi) for _ in range(5)]
    p0 = np.asarray(geometry.CAMERA_POSITION, np.float64)
    f0 = np.asarray(geometry.CAMERA_FORWARD, np.float64)

    def pose(i: int):
        s = [math.sin(2.0 * math.pi * i / per[k] + ph[k]) for k in range(5)]
        pos = p0 + amplitude * np.array([s[0], s[1], s[2]])
        fwd = f0 + turn * np.array([s[3], s[4], 0.0])
        return pos, fwd

    return pose


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.kept = Reservoir(self.p["check_requests"], ctx.seed)
        self.filter_marks = []  # (start, end) events of each traced frame
        self.word = request_seed(ctx.seed, -2)
        self.pose = camera_path(ctx.seed, self.p["camera_amplitude"],
                                self.p["camera_turn"])

    def setup(self):
        from cpu_based_ray_tracer_tpu_torch import camera
        from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
        from cpu_based_ray_tracer_tpu_torch.models import denoiser
        from cpu_based_ray_tracer_tpu_torch.scenes import cornell

        p, dev = self.p, self.ctx.device
        self.dn = denoiser
        self.cfg = RenderConfig(width=p["width"], height=p["height"], spp=1,
                                max_depth=p["max_depth"],
                                **estimator_settings(self.ctx.config))
        self.params = denoiser.DenoiserParams(
            jbf_half_size=p["jbf_half_size"],
            temporal_half_size=p["temporal_half_size"],
            tolerance=p["tolerance"],
            current_frame_weighting=p["current_frame_weighting"])
        self.scene = cornell.cornell_scene(dev)

        def cam(i):
            pos, fwd = self.pose(i)
            return camera.make_perspective_camera(
                pos, fwd, vfov_degrees=geometry.CAMERA_VFOV, device=dev)

        self.camera = cam
        self.prev = None
        self.first = []
        # Warm-up: a frame without and one with history, at another seed
        # word and poses no frame of the window takes.
        warm, prev = request_seed(self.ctx.seed, -4), None
        for k in (1, 2):
            _, prev = denoiser.render_frame(
                self.scene, cam(-k), self.cfg, warm, k, prev, self.params,
                engine="fused", device=dev)
        if self.ctx.tracing:
            self._time_filters()

    def _time_filters(self) -> None:
        """Puts a timed span around ``denoiser.denoise_frame``, which
        ``render_frame`` calls: two CUDA events on the card (the host's
        clock on the CPU), read once the window has closed."""
        real = self.dn.denoise_frame
        cuda = self.ctx.device.type == "cuda"

        def mark():
            if not cuda:
                return time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def timed(g, prev, params):
            start = mark()
            out = real(g, prev, params)
            self.filter_marks.append((start, mark()))
            return out

        self.real_denoise_frame = real
        self.dn.denoise_frame = timed

    def filter_seconds(self, first: int, end: int) -> list:
        """Seconds of ``denoise_frame`` in the frames ``first`` to
        ``end - 1``."""
        out = []
        for a, b in self.filter_marks[first:end]:
            if isinstance(a, float):
                out.append(b - a)
            else:
                b.synchronize()
                out.append(1e-3 * a.elapsed_time(b))
        return out

    def request(self, i: int) -> None:
        slot = self.kept.slot(i)
        prev = self.prev
        color, self.prev = self.dn.render_frame(
            self.scene, self.camera(i), self.cfg, self.word, i, prev,
            self.params, engine="fused", device=self.ctx.device)
        if i < self.p["replay_frames"]:
            self.first.append(color)
        self.kept.keep(slot, (i, prev, color))

    def release(self) -> None:
        self.scene = self.prev = None
        if hasattr(self, "real_denoise_frame"):
            self.dn.denoise_frame = self.real_denoise_frame

    def reference_frame(self, sc, i: int, prev, dtype=torch.float32):
        """The reference's denoised frame i over the history ``prev`` (the
        previous frame's denoised color and primitive ids; None for none),
        reprojected through frame i - 1's view and projection: (color,
        primitive ids)."""
        p, dev = self.p, self.ctx.device
        h, w = p["height"], p["width"]
        pos, fwd = self.pose(i)
        cam = geometry.ref_camera(pos, fwd, geometry.CAMERA_VFOV, dev)
        st = mc.Settings(w, h, 1, p["max_depth"],
                         **estimator_settings(self.ctx.config))
        tr = mc.trace(sc, cam, st, self.word, torch.arange(h * w, device=dev),
                      frame=i, dtype=dtype)
        gb = tr.gbuffer
        g = {"color": torch.clamp(tr.radiance, 0.0, 1.0).reshape(h, w, 3),
             "world_pos": gb["world_pos"].reshape(h, w, 3),
             "normal": gb["normal"].reshape(h, w, 3),
             "contributor": gb["contributor"].reshape(h, w),
             "prim_id": gb["prim_id"].reshape(h, w)}
        out = ref_denoise.atrous(g, p["jbf_half_size"], clamp=True)
        if prev is None:
            return out, g["prim_id"]
        g["color"] = out
        pos, fwd = self.pose(i - 1)
        view, proj = geometry.view_proj(
            geometry.ref_camera(pos, fwd, geometry.CAMERA_VFOV, dev), w, h)
        prev = dict(prev, view=view.to(dtype), proj=proj.to(dtype))
        return ref_denoise.temporal(g, prev, p["temporal_half_size"],
                                    p["tolerance"],
                                    p["current_frame_weighting"]), g["prim_id"]

    def replay(self, sc, n: int, dtype=torch.float32) -> list:
        """The reference's frames 0 .. n - 1 from scratch, each over its own
        previous frame."""
        out, hist = [], None
        for i in range(n):
            color, ids = self.reference_frame(sc, i, hist, dtype)
            out.append(color)
            hist = {"color": color, "prim_id": ids}
        return out

    def check(self) -> list:
        dev = self.ctx.device
        sc = geometry.ref_scene(*geometry.config_triangles(self.ctx.config)[:2],
                                dev)
        worst = 0.0
        for got, want in zip(self.first, self.replay(sc, len(self.first))):
            worst = max(worst, share_off(got, want))
        for i, prev, color in self.kept.kept():
            hist = None if prev is None else {
                "color": prev.color, "prim_id": prev.prim_id}
            worst = max(worst, share_off(
                color, self.reference_frame(sc, i, hist)[0]))
        return [Check("pixels_off", worst, self.p["limits"]["pixels_off"])]

    def control(self, dtype) -> dict:
        """The comparison's numbers with the reference computed in
        ``dtype`` put in the program's place: the first ``replay_frames``
        frames, each side over its own history."""
        sc = geometry.ref_scene(*geometry.config_triangles(self.ctx.config)[:2],
                                self.ctx.device)
        n = self.p["replay_frames"]
        return {"pixels_off": max(
            share_off(got.float(), want) for got, want in
            zip(self.replay(sc, n, dtype), self.replay(sc, n)))}
