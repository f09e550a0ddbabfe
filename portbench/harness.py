"""One run of one cell of the port's benchmark.

``BENCHMARK.json`` names the cell; the cell names its configuration (a file
of sizes under ``portbench/configs/``) and its traffic (a data file
``portbench/traffic/<traffic>.json`` naming the driver under
``portbench/drivers/`` that generates it, and its parameters).  Each
end-to-end metric is read by ``portbench/end_to_end/<name>.py`` and each
per-layer metric by ``portbench/metrics/<name>.py``, found by name.

A run: set-up (the scene, the kernels' build, the warm-up of every shape
the traffic uses), then a closed loop of one client (request ``i`` starts
when ``i - 1`` has finished) until the first completion after
``--seconds``; the window is the time from the first request's start to
that completion.  With ``--trace 1`` a ``torch.profiler`` trace covers the
window (or its last ``trace_seconds``) and the per-layer metrics are
read.  After the window: the device's peak memory, the program's state
freed, the comparison of the checked requests with the plain reference,
and the last line of standard output, one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "portbench")
# The modules that may not be loaded in the process that prints a result
# (compared by the top-level name, the part before the first dot).
FORBIDDEN = ("jax", "jaxlib", "flax", "cpu_based_ray_tracer_tpu")


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic
    parameters, the run's seed, the device, and whether the run traces."""

    workload: str
    config: dict
    params: dict
    seed: int
    device: object
    tracing: bool


@dataclasses.dataclass
class Run:
    """What a metric reader gets once the window has closed."""

    ctx: Context
    driver: object
    setup_s: float
    window_s: float
    latencies: list          # seconds of each request of the window
    n_traced: int = 0        # requests inside the traced part
    first_traced: int = 0    # the first of them
    trace: object = None     # work.trace.DeviceTrace of the traced part


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str, root: str = ROOT):
    """(the workload entry, the configuration, the traffic file) of a
    cell named in ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The metric entries of ``kind`` ("end_to_end" or "per_layer") that
    the cell reports: those without a ``workloads`` key, and those that
    list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(folder: str, name: str):
    """The ``read(run)`` function of ``portbench/<folder>/<name>.py``."""
    path = os.path.join(PB, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def use_fixed_caches(root: str = ROOT) -> None:
    """Every build and kernel cache a library could use, in fixed
    directories of the checkout (the port's own kernels build into
    ``build/torch_kernels/``)."""
    base = os.path.join(root, "build", "portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"


def few_threads() -> None:
    """One intra-op thread for every library that reads the environment
    (set before torch is imported; torch's own pool is set after): the
    host side of these cells is one Python thread launching work, and
    idle thread pools only compete with it for the host's cores."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info(torch) -> dict:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not read"
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def start_profiler(ctx: Context):
    """A started ``torch.profiler`` and the record_function that marks the
    traced part of the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench.work.trace import WINDOW

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    marker = record_function(WINDOW)
    marker.__enter__()
    return prof, marker


def measure(ctx: Context, driver, seconds: float, t_start: float,
            trace_seconds: float | None):
    """Set-up, the window and its optional trace: the Run.  A traced run
    profiles the window's last ``trace_seconds`` (all of it where None),
    so the requests before run as in an untraced run: a profiler once
    started leaves every later launch of the process slower.  The window
    of a traced run closes once ``trace_seconds`` have been profiled too
    (the profiler's start takes its own time)."""
    import torch

    driver.setup()
    sync = (torch.cuda.synchronize if ctx.device.type == "cuda"
            else (lambda: None))
    sync()
    trace_from = (0.0 if trace_seconds is None
                  else max(seconds - trace_seconds, 0.0))
    prof = marker = None
    if ctx.tracing and trace_from == 0.0:
        prof, marker = start_profiler(ctx)
    latencies, i, first_traced = [], 0, 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    r1 = traced_t0 = t0
    while True:
        if ctx.tracing and prof is None and r1 - t0 >= trace_from:
            prof, marker = start_profiler(ctx)
            first_traced, traced_t0 = i, time.perf_counter()
        r0 = time.perf_counter()
        driver.request(i)
        sync()
        r1 = time.perf_counter()
        latencies.append(r1 - r0)
        i += 1
        if r1 - t0 >= seconds and (trace_from == 0.0 or prof is None
                                   or r1 - traced_t0 >= trace_seconds):
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        marker.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    half = len(latencies) // 2
    print(f"portbench: window {window_s:.3f} s, {len(latencies)} requests, "
          f"mean latency {sum(latencies[:half]) / max(half, 1):.6f} s in "
          f"the first half, {sum(latencies[half:]) / max(len(latencies) - half, 1):.6f} s in "
          f"the second", file=sys.stderr)
    run = Run(ctx, driver, setup_s, window_s, latencies,
              i - first_traced if prof is not None else 0, first_traced)
    if prof is not None:
        from portbench.work import trace as trace_mod

        run.trace = trace_mod.from_profiler(prof)
    return run


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_fixed_caches()
    few_threads()

    bench = load_benchmark()
    cell, config, traffic = cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"CUDA available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(args.workload, config, traffic["params"], args.seed,
                  torch.device("cuda"), bool(args.trace))
    driver = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver(ctx)
    run = measure(ctx, driver, args.seconds, t_start,
                  traffic.get("trace_seconds"))
    result = finish(bench, run, torch)
    return emit(result)


def finish(bench: dict, run: Run, torch) -> dict:
    """After the window: peak memory, metrics, the freed program state, the
    comparison with the reference; the result object (``checks`` last)."""
    ctx, dev = run.ctx, run.ctx.device
    cuda = dev.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.top_ops(10),
                     "idle_gaps": run.trace.idle_gaps(10)}
    run.driver.release()
    if cuda:
        torch.cuda.empty_cache()
    # A request that raises ends the run without a result, so every
    # request of a finished window completed.
    t_check = time.perf_counter()
    checks = run.driver.check()
    print(f"portbench: the reference's check took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = bool(checks) and all(c.ok for c in checks)
    # Read after the check: a reader may use what the reference counted.
    kind = "per_layer" if ctx.tracing else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, ctx.workload, kind):
        value = load_reader("metrics" if ctx.tracing else "end_to_end",
                            m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.latencies),
              "failed": 0, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = card_info(torch) if cuda else {}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def emit(result: dict) -> int:
    """The guard against the JAX package, then the checks on standard
    error and the result as the last line of standard output."""
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
