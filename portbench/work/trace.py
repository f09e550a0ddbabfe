"""What the benchmark reads from a ``torch.profiler`` trace of its window:
the CUDA kernels (name, start, end), the union of their intervals (the
seconds in which the device ran something), the kernel time by name, and
the longest idle gaps with the host operation that was running when each
began.  The method of ``time_grad.py::_profile`` (kernel events only, so
no operator's time is counted twice), with intervals merged instead of
summed."""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class DeviceTrace:
    kernels: list          # [Kernel], sorted by start
    host_ops: list         # [(name, start_us, end_us)] host operations
    window_us: tuple       # (start, end) of the traced window

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window covered by at least one kernel."""
        busy, end = 0.0, None
        w0, w1 = self.window_us
        for k in self.kernels:
            s, e = max(k.start_us, w0), min(k.end_us, w1)
            if e <= s:
                continue
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-6

    def kernel_s(self, match) -> float:
        """Seconds of the kernels whose name ``match(name)`` accepts."""
        return sum(k.end_us - k.start_us for k in self.kernels
                   if match(k.name)) * 1e-6

    def count(self, match=lambda n: True) -> int:
        return sum(1 for k in self.kernels if match(k.name))

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for k in self.kernels:
            by[k.name] = by.get(k.name, 0.0) + (k.end_us - k.start_us) * 1e-6
        return sorted(([name[:120], s] for name, s in by.items()),
                      key=lambda r: -r[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle gaps between kernels inside the window, each named by
        the innermost host operation running when it began ("python" where
        none was: the interpreter between operations), summed by that
        name: the longest first."""
        gaps, end = [], self.window_us[0]
        for k in self.kernels:
            if k.start_us > end:
                gaps.append((end, k.start_us))
            end = max(end, k.end_us)
        if self.window_us[1] > end:
            gaps.append((end, self.window_us[1]))
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by = {}
        for g0, g1 in gaps:
            name = "python"
            i = bisect.bisect_right(starts, g0) - 1
            for j in range(i, max(i - 4096, -1), -1):
                if ops[j][2] >= g0:
                    name = ops[j][0]
                    break
            by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda r: -r[1])[:n]


WINDOW = "portbench.window"   # the harness's record_function


def from_profiler(prof) -> DeviceTrace:
    """The kernels and the host operations of a finished
    ``torch.profiler.profile``; the window is the span of the host
    operation named ``WINDOW`` (around the traced requests), else the
    first to the last event."""
    from torch.autograd import DeviceType

    kernels, host, window_us = [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the device side of a record_function range is no device work
            if not getattr(e, "is_user_annotation", False) and \
                    e.name != WINDOW:
                kernels.append(Kernel(e.name, float(tr.start),
                                      float(tr.end)))
        elif e.name == WINDOW:
            window_us = (float(tr.start), float(tr.end))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    kernels.sort(key=lambda k: k.start_us)
    if window_us is None:
        pts = [k.start_us for k in kernels] + [k.end_us for k in kernels]
        pts += [h[1] for h in host] + [h[2] for h in host]
        window_us = (min(pts), max(pts)) if pts else (0.0, 0.0)
    return DeviceTrace(kernels, host, window_us)
