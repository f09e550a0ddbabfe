"""Whole runs of the ``cornell_mesh.final_4spp`` cell on the CPU at a small
size (the fused mesh engine's plain versions in place of its kernels, on
the resident route): a sound run is correct; the control (the reference in
bfloat16 in the program's place) fails; a fault planted in the resident
sweeps' output makes ``correct`` false; and a traced run reports both of
the cell's own per-layer metrics."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import control, harness
from portbench.tests.cpu_run import run_cpu
from portbench.work.trace import DeviceTrace, Kernel

CELL = "cornell_mesh.final_4spp"
SMALL = dict(width=12, height=8, spp=1, max_depth=3, check_requests=2)


def test_a_sound_run_is_correct():
    r = run_cpu(CELL, 2 ** 31 + 91, 0.05, params=SMALL)
    assert r["correct"], r["checks"]
    assert r["checks"]["pixels_off"]["value"] == 0.0
    assert {"image_s", "image_p95_s", "setup_s"} <= set(r["metrics"])


def test_the_control_fails():
    rows, limits = control.readings(CELL, 33, torch.device("cpu"), False,
                                    SMALL)
    (what, nums), = rows
    assert what == "control_bfloat16"
    assert any(not v <= limits[k] for k, v in nums.items()), nums


@pytest.mark.parametrize("op", ["nearest", "occl"])
def test_a_fault_in_the_resident_sweep_fails(op, monkeypatch):
    """The resident sweep drops every second packed ray's answer: the lane
    keeps what its plane held before the sweep (nearest: the mesh missed;
    occlusion: the mesh flag of an earlier step)."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh

    real = getattr(fused_mesh.PLAIN_OPS, op)

    def dropped(tb, p, rays, ray_id, cnt, out):
        before = out.clone()
        tests = real(tb, p, rays, ray_id, cnt, out)
        lanes = ray_id[:min(int(cnt), ray_id.shape[0])][1::2].long()
        out[:, lanes] = before[:, lanes]
        return tests

    monkeypatch.setattr(fused_mesh, "PLAIN_OPS",
                        fused_mesh.PLAIN_OPS._replace(**{op: dropped}))
    r = run_cpu(CELL, 12, 0.05, params=SMALL)
    assert not r["correct"], r


def test_a_traced_run_reports_the_cells_metrics():
    """The span reader reads the CPU run's own spans; the roofline reader
    reads the run's TRACE chunks against the card's kernel names (a CPU run
    launches none), and nothing from a program whose TRACE does not say
    which route ran.  An icosphere(2) (3 clusters) in the configuration's
    mesh: the profiler's event list grows with the clusters that the plain
    sweep loops over, and takes minutes at 40."""
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    _, config, traffic = harness.cell_spec(bench, CELL)
    config = dict(config, triangles=342, mesh=dict(
        config["mesh"], icospheres=[dict(config["mesh"]["icospheres"][0],
                                         subdivisions=2)]))
    p = dict(traffic["params"], **SMALL)
    ctx = harness.Context(CELL, config, p, 13, torch.device("cpu"), True)
    from portbench.drivers.final_render import Driver

    run = harness.measure(ctx, Driver(ctx), 0.05, time.perf_counter(), None)
    r = harness.finish(bench, run, torch)
    assert r["correct"], r["checks"]
    assert r["metrics"]["mesh_group_dispatch_ms"]["value"] > 0
    assert "mesh_resident_sweep_roofline" not in r["metrics"]   # no kernels

    chunks = run.driver.chunks[run.first_traced:][:run.n_traced]
    assert all(ch["resident"] for req in chunks for ch in req)
    w0, w1 = run.trace.window_us
    run.trace = DeviceTrace(
        [Kernel("void (anonymous namespace)::sweep_kernel<false>(Params)",
                w0, w0 + 300.0),
         Kernel("group_key_kernel(Params)", w0 + 300.0, w0 + 400.0),
         Kernel("k2_kernel(Params)", w0 + 400.0, w0 + 900.0)],
        run.trace.host_ops, (w0, w1))
    main = sum(ch["npred"][0] for req in chunks for ch in req
               if ch["overflow"] == 0)
    shadow = sum(ch["npred"][1] for req in chunks for ch in req
                 if ch["overflow"] == 0)
    steps = sum(ch["steps"] for req in chunks for ch in req
                if ch["overflow"] == 0)
    nbytes = (3 * 128 * 16 * 4 * 2 * steps + main * 44 + shadow * 32)
    ops = (main + shadow) * 3 * 22
    read = harness.load_reader("metrics", "mesh_resident_sweep_roofline")
    assert read(run) == pytest.approx(
        100.0 * max(ops / 67e12, nbytes / 3.35e12) / 400e-6, rel=1e-12)
    for req in run.driver.chunks:       # a TRACE that names no route
        for ch in req:
            del ch["resident"]
    assert read(run) is None
