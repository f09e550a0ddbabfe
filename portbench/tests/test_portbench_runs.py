"""Whole runs of every cell on the CPU at small sizes (the program's plain
versions in place of its kernels): a sound run is correct and prints the
result's keys; the control (the reference in bfloat16 in the program's
place) fails every cell's comparison; and each fault the cell can have,
planted in the program underneath a run, makes ``correct`` false."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.tests.cpu_run import run_cpu

SMALL = {
    "cornell_mc.final_4spp": dict(width=16, height=12, spp=2, max_depth=4,
                                  check_requests=2),
    "cornell_mesh_164k.final_8spp": dict(width=12, height=8, spp=1,
                                         max_depth=3, check_requests=2,
                                         check_pixels=None),
    "cornell_mc.inverse_448": dict(width=16, height=12, spp=2, max_depth=4),
    "cornell_mc.denoise_1spp": dict(width=16, height=12, max_depth=4,
                                    check_requests=2),
}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload, trace):
    seconds = 0.05 if "mesh" in workload else 0.3
    r = run_cpu(workload, 2 ** 31 + 77, seconds, trace=trace,
                params=SMALL[workload])
    assert r["correct"], r["checks"]
    assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
    assert set(r) <= set(KEYS) | {"breakdown", "card", "checks"}
    assert ("breakdown" in r) == trace
    assert r["attempted"] >= 1 and r["failed"] == 0
    if not trace:
        assert "setup_s" in r["metrics"]
        for m in r["metrics"].values():
            assert m["value"] > 0 and set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_fails(workload):
    params = {k: v for k, v in SMALL[workload].items()}
    rows, limits = control.readings(workload, 31, torch.device("cpu"),
                                    False, params)
    (what, nums), = rows
    assert what == "control_bfloat16"
    assert any(not v <= limits[k] for k, v in nums.items()), nums


def test_the_training_faults_fail_in_the_reference():
    rows, limits = control.readings("cornell_mc.inverse_448", 32,
                                    torch.device("cpu"), True,
                                    SMALL["cornell_mc.inverse_448"])
    assert len(rows) == 3
    for what, nums in rows:
        assert any(not v <= limits[k] for k, v in nums.items()), (what, nums)


def _fault(kind: str):
    """What a faulty entry point returns in place of its image ``out``:
    the state left unchanged (the previous request's image), half of the
    image left out, or one answer altered where it is produced."""
    last = {}

    def apply(out):
        if kind == "unchanged":
            prev = last.get("img", out)
            last["img"] = out
            return prev
        out = out.clone()
        if kind == "half_left_out":
            out[out.shape[0] // 2:] = 0.0
        else:
            out[0, 0, 0] += 0.5
        return out

    return apply


FAULTS = ["unchanged", "half_left_out", "altered"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_final_render_fails(fault, monkeypatch):
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo

    real, f = monte_carlo.render_turbo_exact, _fault(fault)
    monkeypatch.setattr(monte_carlo, "render_turbo_exact",
                        lambda *a, **k: f(real(*a, **k)))
    r = run_cpu("cornell_mc.final_4spp", 5, 0.3,
                params=SMALL["cornell_mc.final_4spp"])
    assert not r["correct"], r


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_mesh_render_fails(fault, monkeypatch):
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh

    real, f = fused_mesh.render_turbo_mesh_exact, _fault(fault)
    monkeypatch.setattr(fused_mesh, "render_turbo_mesh_exact",
                        lambda *a, **k: f(real(*a, **k)))
    r = run_cpu("cornell_mesh_164k.final_8spp", 6, 2.0,
                params=SMALL["cornell_mesh_164k.final_8spp"])
    assert not r["correct"], r


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_denoiser_fails(fault, monkeypatch):
    from cpu_based_ray_tracer_tpu_torch.models import denoiser

    real, f = denoiser.render_frame, _fault(fault)

    def frame(*a, **k):
        color, g = real(*a, **k)
        return f(color), g

    monkeypatch.setattr(denoiser, "render_frame", frame)
    r = run_cpu("cornell_mc.denoise_1spp", 7, 0.5,
                params=SMALL["cornell_mc.denoise_1spp"])
    assert not r["correct"], r


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_gradient_step_fails(fault, monkeypatch):
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "half_left_out":
        real = monte_carlo.render_from_trace

        def half(*a, **k):
            img = real(*a, **k)
            top = img[:img.shape[0] // 2]
            return torch.cat([top, top], 0)

        monkeypatch.setattr(monte_carlo, "render_from_trace", half)
    else:
        real_step = torch.optim.Adam.step

        def altered(self, closure=None):
            out = real_step(self, closure)
            with torch.no_grad():
                self.param_groups[0]["params"][0][0, 0] += 0.01
            return out

        monkeypatch.setattr(torch.optim.Adam, "step", altered)
    r = run_cpu("cornell_mc.inverse_448", 8, 0.1,
                params=SMALL["cornell_mc.inverse_448"])
    assert not r["correct"], r


def test_a_fault_in_the_window_steps_alone_fails(monkeypatch):
    """Set-up's three checked steps sound, every later step altered: only
    the window step that the check follows can see it."""
    real_step, calls = torch.optim.Adam.step, [0]

    def late(self, closure=None):
        out = real_step(self, closure)
        calls[0] += 1
        if calls[0] > 3:
            with torch.no_grad():
                self.param_groups[0]["params"][0][0, 0] += 0.01
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", late)
    r = run_cpu("cornell_mc.inverse_448", 9, 0.1,
                params=SMALL["cornell_mc.inverse_448"])
    assert not r["correct"], r


def test_a_fault_in_the_carried_history_fails(monkeypatch):
    """Each frame shown as the program filters it, the history it carries
    into the next frame dimmed: the frames the reference replays from
    scratch see it."""
    from cpu_based_ray_tracer_tpu_torch.models import denoiser

    real = denoiser.render_frame

    def frame(*a, **k):
        color, g = real(*a, **k)
        return color, g.replace(color=g.color * 0.9)

    monkeypatch.setattr(denoiser, "render_frame", frame)
    r = run_cpu("cornell_mc.denoise_1spp", 10, 0.5,
                params=SMALL["cornell_mc.denoise_1spp"])
    assert not r["correct"], r


def test_a_traced_run_profiles_the_windows_tail():
    """The traffic's ``trace_seconds`` of profile at the window's end; the
    filter span read from the frames before it."""
    r = run_cpu("cornell_mc.denoise_1spp", 11, 3.5, trace=True,
                params=SMALL["cornell_mc.denoise_1spp"])
    assert r["correct"], r["checks"]
    assert r["metrics"]["denoise_filter_ms"]["value"] > 0
    assert r["device"]["window_s"] >= 3.0
