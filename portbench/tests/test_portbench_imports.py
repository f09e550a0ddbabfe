"""The import guard: nothing the benchmark runs loads JAX or the JAX package
(top-level module names compared whole: ``cpu_based_ray_tracer_tpu_torch``
is the system under test, ``cpu_based_ray_tracer_tpu`` is not), and the
plain reference imports nothing of the program."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "cpu_based_ray_tracer_tpu"}


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _all_benchmark_modules() -> list:
    mods = ["portbench.harness", "portbench.control", "portbench.common"]
    for folder in ("drivers", "reference", "work"):
        for f in sorted(glob.glob(os.path.join(harness.PB, folder, "*.py"))):
            name = os.path.basename(f)[:-3]
            if name != "__init__":
                mods.append(f"portbench.{folder}.{name}")
    return mods


def test_a_whole_cpu_run_loads_no_jax():
    code = ("from portbench.tests.cpu_run import run_cpu\n"
            "r = run_cpu('cornell_mc.final_4spp', 5, 0.01, trace=True, "
            "params=dict(width=8, height=8, spp=1, max_depth=2, "
            "check_requests=1))\n"
            "assert r['correct']\n")
    for folder in ("metrics", "end_to_end"):
        for f in sorted(glob.glob(os.path.join(harness.PB, folder, "*.py"))):
            name = os.path.basename(f)[:-3]
            code += (f"from portbench.harness import load_reader\n"
                     f"load_reader({folder!r}, {name!r})\n")
    for m in _all_benchmark_modules():
        code += f"import {m}\n"
    mods = _modules_after(code)
    assert "cpu_based_ray_tracer_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    code = "".join(f"import portbench.{m}\n" for m in (
        "reference.geometry", "reference.rng", "reference.mc",
        "reference.denoise", "reference.grad", "work.bounds", "work.trace",
        "common"))
    mods = _modules_after(code)
    assert not mods & (FORBIDDEN | {"cpu_based_ray_tracer_tpu_torch"})


def test_the_harness_guard_names_forbidden_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "cpu_based_ray_tracer_tpu.scene",
                        object())
    assert "cpu_based_ray_tracer_tpu" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "cpu_based_ray_tracer_tpu.scene")
    monkeypatch.setitem(sys.modules, "cpu_based_ray_tracer_tpu_torch_x",
                        object())
    assert "cpu_based_ray_tracer_tpu" not in harness.forbidden_modules()


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "cornell_mc.final_4spp", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
