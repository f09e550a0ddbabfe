"""Profiling / observability (port of
``cpu_based_ray_tracer_tpu.utils.profiling``).

- ``span``: a named range of the program's host work, recorded into the
  trace of a running ``torch.profiler`` (the Kineto trace that holds the
  card's kernels, on the same clock), and nothing at all when no profiler
  runs.  Names are ``<module>.<phase>``.
- ``Counter``: named integer counts (the kernels' launches), registered by
  name so ``reset_counters`` / ``read_counters`` reach every one.
- ``device_trace``: a region traced by ``torch.profiler`` (host, spans and,
  where CUDA is present, the card's kernels) into a Chrome trace under
  ``log_dir`` (the CLI's ``render --trace-dir``).
- ``RunLog``: structured JSON-lines run logs.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    runs in this thread; otherwise one shared no-op context (no allocation,
    no ``record_function``: the check costs well under a microsecond)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


COUNTERS: dict[str, "Counter"] = {}


class Counter:
    """Named integer counts, registered in ``COUNTERS`` under ``name``.
    ``keys`` names the counts; without them the counter holds one count
    under its own name."""

    def __init__(self, name: str, keys=()):
        self.name = name
        self._counts = dict.fromkeys(keys or (name,), 0)
        COUNTERS[name] = self

    def add(self, key: Optional[str] = None) -> None:
        self._counts[self.name if key is None else key] += 1

    def __getitem__(self, key: str) -> int:
        return self._counts[key]

    def reset(self) -> None:
        self._counts = dict.fromkeys(self._counts, 0)

    def snapshot(self) -> dict:
        return dict(self._counts)


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def read_counters() -> dict:
    """Every registered counter's counts by its name; a counter of one
    count reads as that number."""
    out = {}
    for name, c in COUNTERS.items():
        counts = c.snapshot()
        out[name] = counts[name] if list(counts) == [name] else counts
    return out


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
