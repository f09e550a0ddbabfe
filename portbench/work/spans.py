"""The program's spans in a traced window: the host operations that the
program's ``utils.profiling.span`` records under a name while a profiler
runs (``torch.profiler.record_function`` ranges, on the clock of the
kernels).  A program that records no such span gives an empty list."""

from __future__ import annotations


def within(trace, name: str) -> list:
    """(start_us, end_us) of every host operation named ``name`` that lies
    inside the trace's window."""
    w0, w1 = trace.window_us
    return [(s, e) for n, s, e in trace.host_ops
            if n == name and w0 <= s and e <= w1]


def inside(spans: list, outer: list) -> list:
    """The spans that lie inside one of the ``outer`` spans."""
    return [(s, e) for s, e in spans
            if any(o0 <= s and e <= o1 for o0, o1 in outer)]


def ms(spans: list) -> float:
    """Their summed duration in milliseconds."""
    return 1e-3 * sum(e - s for s, e in spans)
