"""The yardstick's arithmetic: the frozen bounds against the numbers
chip_smoke.py logged, the window's rate and tail, the trace's busy time,
and the seeds."""

from __future__ import annotations

import statistics

import pytest

from portbench import common
from portbench.drivers import denoise_frame
from portbench.harness import Context, Run
from portbench.work import bounds, trace


def test_mc_bound_reproduces_chip_smoke():
    # chip_smoke.py "main" phase (NVIDIA H100 80GB HBM3, 700 W): the 4-spp
    # render's live lane-steps and shadow rays, two launches of 802,816
    # lanes -> kernel_ops 29431424838, kernel_bytes 244056064,
    # kernel_bound_ms 0.43927499758208954.
    ops = bounds.mc_ops(32, 0, 9869772, 8335593)
    nbytes = bounds.mc_state_bytes(896 * 896, 2)
    assert ops == 29431424838
    assert nbytes == 244056064
    assert bounds.bound_s(ops, nbytes) * 1e3 == pytest.approx(
        0.43927499758208954, rel=1e-12)


def test_mesh_sweep_bytes():
    # 1,280 clusters of 128 rows of 16 floats, 2 launches, 10 main and 20
    # shadow rays
    table = 1280 * 128 * 16 * 4
    assert bounds.mesh_sweep_bytes(1280, 128, 16, 2, 10, 20) == (
        2 * table + 10 * 44 + 20 * 32)


def test_rate_and_p95():
    from portbench.end_to_end import image_p95_s, image_s

    lat = [0.010, 0.012, 0.011, 0.030, 0.009, 0.010, 0.010, 0.011, 0.012,
           0.010]
    run = Run(Context("x", {}, {}, 0, None, False), None, 1.0, 0.125, lat)
    assert image_s.read(run) == 0.125 / 10
    assert image_p95_s.read(run) == pytest.approx(0.0219)   # numpy default
    assert common.percentile(range(101), 95) == 95.0
    assert common.percentile([3.0], 95) == 3.0


def test_percentile_matches_statistics_inclusive():
    xs = [0.3, 0.1, 0.7, 0.2, 0.9, 0.4]
    q = statistics.quantiles(xs, n=20, method="inclusive")[18]
    assert common.percentile(xs, 95) == pytest.approx(q)


def test_busy_is_the_union_of_kernel_intervals():
    ks = [trace.Kernel("a", 0.0, 10.0), trace.Kernel("b", 5.0, 15.0),
          trace.Kernel("c", 20.0, 30.0), trace.Kernel("d", 22.0, 25.0),
          trace.Kernel("e", 95.0, 120.0)]
    t = trace.DeviceTrace(ks, [("poll", 14.0, 21.0), ("step", 0.0, 100.0)],
                          (0.0, 100.0))
    assert t.busy_s() == pytest.approx(30e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert t.kernel_s(lambda n: n in ("a", "b")) == pytest.approx(20e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["poll"] == pytest.approx(5e-6)       # 15 .. 20
    assert gaps["step"] == pytest.approx(65e-6)      # 30 .. 95
    assert t.top_ops(1) == [["e", pytest.approx(25e-6)]]


def test_request_seeds_are_deterministic_words():
    big = 2 ** 31 + 12345
    a = [common.request_seed(big, i) for i in range(5)]
    assert a == [common.request_seed(big, i) for i in range(5)]
    assert len(set(a)) == 5 and all(0 <= x < 2 ** 32 for x in a)
    assert common.request_seed(big, 0) != common.request_seed(big + 1, 0)


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed):
        r = common.Reservoir(3, seed)
        for i in range(1000):
            r.keep(r.slot(i), i)
        return r.kept()

    assert draw(7) == draw(7)
    assert draw(7) != draw(8)
    assert len(draw(7)) == 3 and max(draw(7)) > 100


def test_camera_path_is_deterministic():
    p1 = denoise_frame.camera_path(99, 0.1, 0.02)
    p2 = denoise_frame.camera_path(99, 0.1, 0.02)
    for i in (0, 1, 500):
        assert (p1(i)[0] == p2(i)[0]).all() and (p1(i)[1] == p2(i)[1]).all()
    pos, _ = p1(3)
    assert abs(pos - denoise_frame.geometry.CAMERA_POSITION).max() <= 0.1
    assert (denoise_frame.camera_path(100, 0.1, 0.02)(3)[0] != pos).any()


def test_share_off():
    import torch

    want = torch.ones((4, 3))
    got = want.clone()
    got[1, 2] += 0.1
    assert common.share_off(got, want) == 0.25
    got[2, 0] = float("nan")
    assert common.share_off(got, want) == 0.5
