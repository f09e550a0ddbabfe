"""Traffic of inverse-rendering steps: the replay loop of
``models.inverse.recover_albedo`` one Adam step a request.  Set-up records
the trace once (``models.monte_carlo.record_trace``, the scene's discrete
hits at one seed word) and builds the one optimiser state (the albedo
logits from 0.5, ``torch.optim.Adam`` at the program's settings); each
step renders ``render_from_trace`` with the sigmoid albedos (emissive rows
held), takes the pixel MSE against the step's target, runs the backward
and the Adam update.  Each step's target is an image drawn on the device
from the step's seed word, so no two steps see the same data.

Checked: set-up drives the same state through its first ``checked_steps``
steps by the same call, and the plain reference follows them from the same
inputs: each step's loss, the first gradient as Adam received it (from its
first moment after one step), and the logits' change after the steps.
Also one step of the window, drawn from the run's seed: the reference
takes the program's logits and Adam state from before that step (kept by
the driver, twelve numbers a plane) and follows it; the step's loss, its
gradient as Adam received it (from the moments before and after) and the
logits' change join the three numbers above, each the worse of the two
readings."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.common import Check, Reservoir, estimator_settings, request_seed
from portbench.reference import geometry, grad, mc

BETAS, EPS = (0.9, 0.999), 1e-8


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.word = request_seed(ctx.seed, -2)
        self.watched = Reservoir(1, ctx.seed)

    def target(self, j: int) -> torch.Tensor:
        """The target image of step j (set-up steps: j < 0)."""
        p, dev = self.p, self.ctx.device
        g = torch.Generator(device=dev)
        g.manual_seed(request_seed(self.ctx.seed, j))
        return torch.rand((p["height"], p["width"], 3), generator=g,
                          device=dev) * p["target_scale"]

    def setup(self):
        from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
        from cpu_based_ray_tracer_tpu_torch.models import monte_carlo
        from cpu_based_ray_tracer_tpu_torch.scenes import cornell

        p, dev = self.p, self.ctx.device
        self.mc = monte_carlo
        self.cfg = RenderConfig(width=p["width"], height=p["height"],
                                spp=p["spp"], max_depth=p["max_depth"],
                                **estimator_settings(self.ctx.config))
        self.scene = cornell.cornell_scene(dev)
        self.camera = cornell.cornell_camera(dev)
        self.recs = monte_carlo.record_trace(self.scene, self.camera,
                                             self.cfg, self.word, dev)
        mats = self.scene.materials
        a0 = torch.clamp(torch.full_like(mats.albedo, 0.5), 1e-4, 1 - 1e-4)
        self.param = torch.log(a0 / (1 - a0)).requires_grad_(True)
        self.opt = torch.optim.Adam([self.param], lr=p["lr"], betas=BETAS,
                                    eps=EPS)
        self.theta0 = self.param.detach().clone()
        self.losses = []
        for k in range(p["checked_steps"]):
            self.losses.append(float(self.step(self.target(-10 - k))))
            if k == 0:     # an optimiser that kept no state reads 0
                self.moment1 = self.opt.state.get(self.param, {}).get(
                    "exp_avg", torch.zeros_like(self.param)).detach().clone()
        self.change = (self.param.detach() - self.theta0).clone()

    def step(self, target) -> torch.Tensor:
        mats = self.scene.materials
        self.opt.zero_grad(set_to_none=True)
        albedo = torch.where(~mats.emissive[:, None],
                             torch.sigmoid(self.param), mats.albedo)
        scene = self.scene.replace(materials=mats.replace(albedo=albedo))
        img = self.mc.render_from_trace(scene, self.camera, self.cfg,
                                        self.word, self.recs,
                                        self.ctx.device)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def _state(self) -> tuple:
        """Copies of (logits, first moment, second moment, steps) as the
        optimiser holds them; zeros where it holds no state."""
        st = self.opt.state.get(self.param, {})
        zero = torch.zeros_like(self.param)
        return (self.param.detach().clone(),
                st.get("exp_avg", zero).detach().clone(),
                st.get("exp_avg_sq", zero).detach().clone(),
                torch.as_tensor(st.get("step", 0.0)).detach().clone())

    def request(self, i: int) -> None:
        slot = self.watched.slot(i)
        if slot is None:
            self.step(self.target(i))
            return
        before = self._state()
        loss = self.step(self.target(i))
        self.watched.keep(slot, (i, before, loss, self._state()))

    def release(self) -> None:
        self.scene = self.recs = self.opt = None

    def _reference(self, targets=None):
        p, dev = self.p, self.ctx.device
        sc = geometry.ref_scene(*geometry.cornell_triangles(), dev)
        cam = geometry.ref_camera(geometry.CAMERA_POSITION,
                                  geometry.CAMERA_FORWARD,
                                  geometry.CAMERA_VFOV, dev)
        st = mc.Settings(p["width"], p["height"], p["spp"], p["max_depth"],
                         **estimator_settings(self.ctx.config))
        emissive = torch.as_tensor(
            np.linalg.norm(np.asarray(geometry.EMISSION), axis=-1) > 1e-5,
            device=dev)
        albedo = torch.as_tensor(np.asarray(geometry.ALBEDO, np.float32),
                                 device=dev)
        if targets is None:
            targets = [self.target(-10 - k) for k in range(p["checked_steps"])]
        return (sc, cam, st, self.word, albedo, emissive, targets, p["lr"])

    @staticmethod
    def gaps(losses, moment1_or_grad, change, ref) -> dict:
        """The three compared numbers of a run's readings against the
        reference's ``ref`` = (losses, first gradient, change)."""
        r_losses, r_g1, r_change = ref
        norm = lambda x: float(torch.linalg.vector_norm(x.float()))  # noqa: E731
        g_ref, c_ref = norm(r_g1), norm(r_change)
        out = {"loss_gap": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, r_losses)),
               "grad_norm_gap": abs(norm(moment1_or_grad) - g_ref) / g_ref,
               "change_norm_gap": abs(norm(change) - c_ref) / c_ref}
        return {k: v if math.isfinite(v) else float("inf")
                for k, v in out.items()}

    def check(self) -> list:
        ref = grad.adam_steps(*self._reference())
        gaps = self.gaps(self.losses, self.moment1 / (1.0 - BETAS[0]),
                         self.change, ref)
        for i, before, loss, after in self.watched.kept():
            theta, m, v, t = (x.to(self.ctx.device) for x in before)
            r_losses, r_g, r_theta = grad.adam_steps(
                *self._reference([self.target(i)]), start=(theta, m, v, t))
            g = (after[1] - BETAS[0] * m) / (1.0 - BETAS[0])
            step = self.gaps([float(loss)], g, after[0] - theta,
                             (r_losses, r_g, r_theta - theta))
            gaps = {k: max(v, step[k]) for k, v in gaps.items()}
        return [Check(k, v, self.p["limits"][k]) for k, v in gaps.items()]

    def control(self, dtype, fault: str | None = None) -> dict:
        """The comparison's numbers with the reference computed in
        ``dtype`` (and with ``fault`` planted) put in the program's
        place."""
        args = self._reference()
        ref = grad.adam_steps(*args)
        got = grad.adam_steps(*args, dtype=dtype, fault=fault)
        return self.gaps(got[0], got[1], got[2], ref)
