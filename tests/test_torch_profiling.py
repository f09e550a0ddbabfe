"""``utils.profiling``: the program's spans (``span``) and launch counters
(``Counter``).  With no profiler running a span is one shared no-op and
never enters ``record_function``; under ``torch.profiler`` on the CPU each
path records its spans by name, nested as the program runs its phases, and
renders the same bits as without the profiler; ``render --trace-dir``
writes them into a Chrome trace; ``kernels.build`` marks each compile."""

import json
import os
import stat

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpu_based_ray_tracer_tpu_torch.__main__ import main
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import denoiser
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import fused, fused_mesh
from cpu_based_ray_tracer_tpu_torch.scenes import cornell, meshes
from cpu_based_ray_tracer_tpu_torch.utils import kernels, profiling

CPU = torch.device("cpu")
SEED = 1234567


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def profiled(fn):
    """fn() under a CPU ``torch.profiler``: (its result, the spans as
    (name, start ns, end ns), by start).  Read from the profiler's raw
    events: ``prof.events()`` would take ~20 s to build its tree over the
    300,000 operations of the plain steppers' chunks."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()), key=lambda s: s[1])
    return out, spans


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def all_inside(spans, child, parent) -> bool:
    return all(inside(c, named(spans, parent)) for c in named(spans, child))


def test_span_without_a_profiler_is_a_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("a.b") is profiling.span("c.d")
    with profiling.span("a.b"):
        pass
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2)
    img = mc.render_turbo_exact(cornell.cornell_scene(),
                                cornell.cornell_camera(), cfg, SEED,
                                device=CPU)
    assert img.shape == (8, 8, 3)


def test_render_turbo_exact_spans():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=32, height=32, spp=1, max_depth=4)

    def run():
        return mc.render_turbo_exact(scene, cam, cfg, SEED, device=CPU)

    img, spans = profiled(run)
    assert torch.equal(img, run())
    assert len(named(spans, "mc.render")) == 1
    for phase in ("mc.pack", "mc.init"):
        assert len(named(spans, phase)) == 1
        assert all_inside(spans, phase, "mc.render")
    launches, polls = named(spans, "mc.launch"), named(spans, "mc.poll")
    assert len(launches) >= 1 and len(polls) == len(launches)
    assert all_inside(spans, "mc.launch", "mc.render")
    assert all_inside(spans, "mc.poll", "mc.render")


def test_render_turbo_mesh_exact_spans():
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    cam = cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)

    def run():
        return fused_mesh.render_turbo_mesh_exact(scene, cam, cfg, SEED,
                                                  cluster_size=64, device=CPU)

    img, spans = profiled(run)
    trace = [dict(t) for t in fused_mesh.TRACE]
    assert torch.equal(img, run())
    assert fused_mesh.TRACE == trace
    assert len(named(spans, "fused_mesh.render")) == 1
    for phase in ("fused_mesh.pack", "fused_mesh.init"):
        assert len(named(spans, phase)) == 1
        assert all_inside(spans, phase, "fused_mesh.render")
    chunks = named(spans, "fused_mesh.chunk")
    assert len(chunks) == len(trace) >= 1
    assert len(named(spans, "fused_mesh.poll")) == len(chunks)
    assert len(named(spans, "fused_mesh.tables")) == len(chunks)
    assert all_inside(spans, "fused_mesh.tables", "fused_mesh.chunk")
    assert named(spans, "fused_mesh.group")       # the resident grouping
    assert all_inside(spans, "fused_mesh.group", "fused_mesh.chunk")
    assert all_inside(spans, "fused_mesh.chunk", "fused_mesh.render")
    assert all_inside(spans, "fused_mesh.poll", "fused_mesh.render")


def test_replay_spans_forward_and_recomputation():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=3)
    mats = scene.materials

    def step(recs):
        logits = torch.zeros_like(mats.albedo).requires_grad_(True)
        albedo = torch.where(~mats.emissive[:, None], torch.sigmoid(logits),
                             mats.albedo)
        sc = scene.replace(materials=mats.replace(albedo=albedo))
        img = mc.render_from_trace(sc, cam, cfg, SEED, recs, CPU)
        torch.mean(img * img).backward()
        return img.detach(), logits.grad

    recs, rec_spans = profiled(
        lambda: mc.record_trace(scene, cam, cfg, SEED, CPU))
    assert [s[0] for s in rec_spans] == ["mc.record_trace"]
    (img, grad), spans = profiled(lambda: step(recs))
    want_img, want_grad = step(mc.record_trace(scene, cam, cfg, SEED, CPU))
    assert torch.equal(img, want_img) and torch.equal(grad, want_grad)
    fwd = named(spans, "mc.replay.forward")
    samples = named(spans, "mc.replay.sample")
    assert len(fwd) == 1
    assert sum(inside(s, fwd) for s in samples) == cfg.spp
    assert sum(not inside(s, fwd) for s in samples) == cfg.spp


def test_denoiser_frame_spans():
    scene, cam = cornell.cornell_scene(), cornell.cornell_camera()
    cfg = RenderConfig(width=24, height=16, spp=1, max_depth=3)
    params = denoiser.DenoiserParams()
    _, prev = denoiser.render_frame(scene, cam, cfg, SEED, 0, None, params,
                                    engine="fused", device=CPU)

    def run():
        return denoiser.render_frame(scene, cam, cfg, SEED, 1, prev, params,
                                     engine="fused", device=CPU)

    (color, hist), spans = profiled(run)
    want_color, want_hist = run()
    assert torch.equal(color, want_color)
    assert torch.equal(hist.color, want_hist.color)
    levels = 1
    while 2 * ((1 << levels) - 1) < params.jbf_half_size:
        levels += 1
    for name, n, parent in (("denoiser.gbuffer", 1, None),
                            ("mc.pack", 1, "denoiser.gbuffer"),
                            ("denoiser.filter", 1, None),
                            ("denoise.atrous", 1, "denoiser.filter"),
                            ("denoise.atrous.level", levels,
                             "denoise.atrous"),
                            ("denoise.temporal", 1, "denoiser.filter")):
        assert len(named(spans, name)) == n, name
        assert parent is None or all_inside(spans, name, parent), name


def test_counter_counts_resets_and_snapshots(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", {})
    one = profiling.Counter("one")
    many = profiling.Counter("many", ("a", "b"))
    one.add()
    one.add()
    many.add("b")
    many.add("a")
    assert one["one"] == 2 and many["a"] == 1 and many["b"] == 1
    snap = many.snapshot()
    many.add("b")
    assert snap == {"a": 1, "b": 1} and many.snapshot() == {"a": 1, "b": 2}
    assert profiling.read_counters() == {"one": 2, "many": {"a": 1, "b": 2}}
    many.reset()
    assert many.snapshot() == {"a": 0, "b": 0} and one["one"] == 2
    profiling.reset_counters()
    assert profiling.read_counters() == {"one": 0, "many": {"a": 0, "b": 0}}
    with pytest.raises(KeyError):
        many.add("c")


def test_the_kernel_modules_register_their_launch_counters():
    counts = profiling.read_counters()
    assert counts["fused_mc"] == fused.LAUNCHES["fused_mc"]
    assert set(counts["fused_mesh"]) == {
        "k1", "group", "nearest", "k1b", "group_occl", "occl", "k2",
        "nearest_sl", "occl_sl"}
    assert fused.LAUNCHES is profiling.COUNTERS["fused_mc"]
    assert fused_mesh.LAUNCHES is profiling.COUNTERS["fused_mesh"]


def test_a_mesh_render_packs_once():
    """``fused_mesh_pack``: one pack a render, one level pass a level of its
    BVH (80 gated triangles in leaves of 8: 4 levels), three reads."""
    assert fused_mesh.PACK is profiling.COUNTERS["fused_mesh_pack"]
    scene = cornell.cornell_mesh_scene(meshes.icosphere(1))
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=3)
    fused_mesh.PACK.reset()
    fused_mesh.render_turbo_mesh_exact(scene, cornell.cornell_camera(), cfg,
                                       SEED, cluster_size=64, device=CPU)
    assert profiling.read_counters()["fused_mesh_pack"] == {
        "packs": 1, "levels": 4, "host_reads": 3}


def test_cli_render_trace_dir_holds_the_spans(tmp_path):
    out, traces = str(tmp_path / "mc.png"), tmp_path / "trace"
    main(["--cpu", "render", "--stage", "mc", "--width", "16", "--height",
          "16", "--spp", "1", "--depth", "2", "--out", out,
          "--trace-dir", str(traces)])
    assert os.path.isfile(out)
    files = os.listdir(traces)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(traces / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mc.render" in names


def test_kernels_build_marks_each_compile(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\n'
                    'done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "BUILD_LOG", {})
    _, spans = profiled(lambda: kernels.build(["fused_mc", "packet"]))
    assert [s[0] for s in spans] == ["kernels.build"]
    assert os.path.isfile(kernels._target("fused_mc")[1])
    assert set(kernels.BUILD_LOG) == {"fused_mc", "packet"}
    _, spans = profiled(lambda: kernels.build(["fused_mc"]))
    assert spans == []           # built already: no compile, no span
