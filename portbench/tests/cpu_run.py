"""Drive a whole run of a cell on the CPU, at sizes the tests choose: the
harness's look for a card skipped, the program's plain PyTorch versions in
place of its kernels."""

from __future__ import annotations

import importlib
import time

import torch

from portbench import harness


def run_cpu(workload: str, seed: int, seconds: float, *, trace=False,
            params=None) -> dict:
    torch.set_num_threads(1)       # as a run on the card (harness.main)
    bench = harness.load_benchmark()
    _, config, traffic = harness.cell_spec(bench, workload)
    p = dict(traffic["params"])
    p.update(params or {})
    ctx = harness.Context(workload, config, p, seed, torch.device("cpu"),
                          trace)
    driver = importlib.import_module(
        f"portbench.drivers.{traffic['driver']}").Driver(ctx)
    run = harness.measure(ctx, driver, seconds, time.perf_counter(),
                          traffic.get("trace_seconds"))
    return harness.finish(bench, run, torch)
