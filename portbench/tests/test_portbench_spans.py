"""The readers of the program's spans on hand-made traces: each sums or
counts its spans inside the window (one outside it, or outside the span
that must hold it, is left out) over the traced requests, and reads None
where the program records no such span (a program without spans)."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.harness import Context, Run
from portbench.work.trace import DeviceTrace, Kernel

WINDOW = (1000.0, 9000.0)
OPS = [
    ("fused_mesh.pack", 500.0, 1500.0),        # starts before the window
    ("mc.render", 1000.0, 3000.0),
    ("mc.pack", 1100.0, 1350.0),
    ("mc.init", 1400.0, 1500.0),
    ("mc.poll", 1600.0, 1700.0),
    ("mc.poll", 2000.0, 2050.0),
    ("fused_mesh.pack", 1100.0, 1600.0),
    ("mc.render", 4000.0, 6000.0),
    ("mc.pack", 4100.0, 4200.0),
    ("mc.init", 4300.0, 4325.0),
    ("mc.poll", 4500.0, 4600.0),
    ("mc.pack", 6100.0, 6300.0),               # a pack outside mc.render
    ("fused_mesh.pack", 4000.0, 6500.0),
    ("mc.replay.forward", 2000.0, 2600.0),
    ("mc.replay.forward", 5000.0, 5400.0),
    ("denoise.atrous", 2000.0, 2300.0),
    ("denoise.atrous.level", 2000.0, 2100.0),
    ("denoise.atrous", 7000.0, 7700.0),
    ("aten::add", 1200.0, 1210.0),
    ("mc.poll", 8900.0, 9100.0),               # ends after the window
]
WANT = {"mesh_pack_ms": (0.5 + 2.5) / 2,
        "mc_pack_init_ms": (0.25 + 0.1 + 0.1 + 0.025) / 2,
        "mc_polls_per_image": 3 / 2,
        "replay_forward_ms": (0.6 + 0.4) / 2,
        "denoise_atrous_ms": (0.3 + 0.7) / 2}


def run_of(host_ops, n_traced=2):
    trace = DeviceTrace([Kernel("k", 1100.0, 1200.0)], host_ops, WINDOW)
    ctx = Context("x", {}, {}, 0, None, True)
    return Run(ctx, None, 1.0, 8e-3, [4e-3, 4e-3], n_traced, 0, trace)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_span_reader_reads_its_spans(name):
    read = harness.load_reader("metrics", name)
    assert read(run_of(OPS)) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_span_reader_reads_none_without_spans(name):
    read = harness.load_reader("metrics", name)
    others = [op for op in OPS if op[0] in ("aten::add",)]
    assert read(run_of(others)) is None
    assert read(run_of(OPS, n_traced=0)) is None
    untraced = run_of(OPS)
    untraced.trace = None
    assert read(untraced) is None
