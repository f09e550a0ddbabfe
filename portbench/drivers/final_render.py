"""Traffic of final renders: back-to-back equal-spp Monte Carlo renders of
one scene from one camera, each request a fresh seed word (so a fresh
image), through the fused engine the configuration names:
``models.monte_carlo.render_turbo_exact`` (``fused_mc``) or
``ops.fused_mesh.render_turbo_mesh_exact`` (``fused_mesh``).

Checked: a sample of the requests drawn from the run's seed (reservoir
sampling over the window); for each, the linear radiance of every pixel
(or of ``check_pixels`` pixels drawn from the request's seed) against the
plain reference's paths of the same pixels and samples."""

from __future__ import annotations

import numpy as np
import torch

from portbench.common import (Check, Reservoir, estimator_settings,
                              request_seed, share_off)
from portbench.reference import geometry, mc


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.kept = Reservoir(self.p["check_requests"], ctx.seed)
        self.work = None        # what the reference counted (check())
        self.chunks = []        # fused_mesh.TRACE of each traced request

    def _scene_input(self):
        """The scene the configuration names, as (program scene, reference
        vertices, reference materials)."""
        from cpu_based_ray_tracer_tpu_torch.scenes import cornell

        c, dev = self.ctx.config, self.ctx.device
        verts, mats, soup = geometry.config_triangles(c)
        if soup is None:
            return cornell.cornell_scene(dev), verts, mats
        self.mesh_tris = len(soup)
        return (cornell.cornell_mesh_scene(soup, height=c["mesh"]["height"],
                                           device=dev), verts, mats)

    def setup(self):
        from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
        from cpu_based_ray_tracer_tpu_torch.scenes import cornell

        c, p, dev = self.ctx.config, self.p, self.ctx.device
        self.cfg = RenderConfig(width=p["width"], height=p["height"],
                                spp=p["spp"], max_depth=p["max_depth"],
                                **estimator_settings(c))
        scene, self.ref_verts, self.ref_mats = self._scene_input()
        cam = cornell.cornell_camera(dev)
        if c["engine"] == "fused_mc":
            from cpu_based_ray_tracer_tpu_torch.models import monte_carlo

            def render(word):
                return monte_carlo.render_turbo_exact(scene, cam, self.cfg,
                                                      word, device=dev)
        else:
            from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh

            self.fm = fused_mesh

            def render(word):
                return fused_mesh.render_turbo_mesh_exact(
                    scene, cam, self.cfg, word,
                    cluster_size=c["cluster_size"], device=dev)
        self.render = render
        # Warm-up: builds the kernels and runs every launch size once, at a
        # seed word no request of the window uses.
        self.render(request_seed(self.ctx.seed, -1))

    def request(self, i: int) -> None:
        word = request_seed(self.ctx.seed, i)
        slot = self.kept.slot(i)
        img = self.render(word)
        self.kept.keep(slot, (i, word, img))
        if self.ctx.tracing and hasattr(self, "fm"):
            self.chunks.append([dict(t) for t in self.fm.TRACE])

    def release(self) -> None:
        self.render = None

    def _reference(self, verts, mats):
        c, p, dev = self.ctx.config, self.p, self.ctx.device
        sc = geometry.ref_scene(verts, mats, dev)
        cam = geometry.ref_camera(geometry.CAMERA_POSITION,
                                  geometry.CAMERA_FORWARD,
                                  geometry.CAMERA_VFOV, dev)
        st = mc.Settings(p["width"], p["height"], p["spp"], p["max_depth"],
                         **estimator_settings(c))
        return sc, cam, st

    def _pixels(self, word: int):
        """Every pixel, or ``check_pixels`` of them drawn from the word."""
        p, dev = self.p, self.ctx.device
        n_pix = p["width"] * p["height"]
        if p.get("check_pixels") is None:
            return torch.arange(n_pix, device=dev)
        rng = np.random.default_rng(word)
        return torch.as_tensor(np.sort(rng.choice(
            n_pix, p["check_pixels"], replace=False)), device=dev)

    def check(self) -> list:
        p, dev = self.p, self.ctx.device
        sc, cam, st = self._reference(self.ref_verts, self.ref_mats)
        worst, steps, shadows, n_full = 0.0, 0, 0, 0
        spp = torch.tensor(float(p["spp"]), dtype=torch.float32, device=dev)
        for _, word, img in self.kept.kept():
            pixel = self._pixels(word)
            tr = mc.trace(sc, cam, st, word, pixel)
            got = img.reshape(-1, 3)[pixel]
            worst = max(worst, share_off(got, tr.radiance / spp))
            if p.get("check_pixels") is None:
                steps += tr.lane_steps
                shadows += tr.shadow_rays
                n_full += 1
        if n_full:
            self.work = {"n_tri": sc.count, "n_lanes": p["width"] * p["height"],
                         "lane_steps": steps / n_full,
                         "shadow_rays": shadows / n_full}
        return [Check("pixels_off", worst, p["limits"]["pixels_off"])]

    def control(self, dtype) -> dict:
        """The comparison's numbers with the reference computed in
        ``dtype`` put in the program's place, over the requests a run
        checks first."""
        verts, mats, _ = geometry.config_triangles(self.ctx.config)
        sc, cam, st = self._reference(verts, mats)
        worst = 0.0
        for i in range(self.p["check_requests"]):
            word = request_seed(self.ctx.seed, i)
            pixel = self._pixels(word)
            want = mc.trace(sc, cam, st, word, pixel).radiance
            got = mc.trace(sc, cam, st, word, pixel, dtype=dtype).radiance
            worst = max(worst, share_off(got.float(), want))
        return {"pixels_off": worst}
