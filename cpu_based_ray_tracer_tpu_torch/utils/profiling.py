"""Profiling / observability (port of
``cpu_based_ray_tracer_tpu.utils.profiling``).

Wall-clock timers that wait for the card when given a CUDA device, rays/s
accounting, structured JSON-lines run logs, and ``device_trace``, a region
traced by ``torch.profiler`` (host and, where CUDA is present, the card's
kernels) into a Chrome trace under ``log_dir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch


def _sync(x) -> None:
    """Wait for the card behind ``x`` (a device, a tensor, or a nest of
    tensors); a no-op on the CPU."""
    if isinstance(x, (str, torch.device)):
        dev = torch.device(x)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    elif isinstance(x, torch.Tensor):
        _sync(x.device)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _sync(y)
    elif isinstance(x, dict):
        for y in x.values():
            _sync(y)


class Timer:
    """ns-resolution wall timer; ``elapsed_ms`` first waits for the work
    queued on the card of ``device`` (or of the tensors in ``sync``)."""

    def __init__(self, device=None):
        self.device = device
        self.reset()

    def reset(self) -> None:
        if self.device is not None:
            _sync(self.device)
        self._t0 = time.perf_counter_ns()

    def elapsed_ms(self, sync: Any = None) -> float:
        if sync is not None:
            _sync(sync)
        if self.device is not None:
            _sync(self.device)
        return (time.perf_counter_ns() - self._t0) / 1e6


@contextlib.contextmanager
def scoped_timer(name: str, log=None, device=None):
    """Print timer ("[TIMER] name - ms") around a region."""
    t = Timer(device)
    try:
        yield t
    finally:
        ms = t.elapsed_ms()
        (log or print)(f"[TIMER] {name} - {ms:.3f}ms")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of a region (CPU, and CUDA where present),
    written as ``log_dir/trace_<pid>_<ns>.json`` (chrome://tracing,
    Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / max(seconds, 1e-12)


class RunLog:
    """Structured JSON-lines run log (config, per-pass ms, rays/s, checks)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "a") if path else None

    def emit(self, event: str, **fields) -> None:
        rec = {"event": event, "t": time.time(), **fields}
        line = json.dumps(rec, default=_jsonable)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        else:
            print(line)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def _jsonable(x):
    import numpy as np

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)
