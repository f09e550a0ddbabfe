"""The port's CLI, ``python -m cpu_based_ray_tracer_tpu_torch``, with
``--cpu``: the cases of ``tests/test_cli.py``, the fly path, ``render
--stage mc`` against a direct ``render_fast`` call, the checkpoint's
sample normalisation and seed guard, and no silent CPU fallback."""

import os

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu_torch.__main__ import main, render_stage
from cpu_based_ray_tracer_tpu_torch.config import RenderConfig
from cpu_based_ray_tracer_tpu_torch.models import monte_carlo as mc
from cpu_based_ray_tracer_tpu_torch.ops import tonemap
from cpu_based_ray_tracer_tpu_torch.scenes import cornell
from cpu_based_ray_tracer_tpu_torch.utils import image as im
from cpu_based_ray_tracer_tpu_torch.utils import rng

from torch_ref import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = torch.device("cpu")


def test_cli_render_offline(tmp_path):
    out = str(tmp_path / "offline.png")
    main(["--cpu", "render", "--stage", "offline", "--width", "64",
          "--height", "36", "--spp", "2", "--depth", "8", "--out", out])
    img = im.read_png(out)
    assert img.shape == (36, 64, 3)
    assert img.std() > 0  # not a blank frame


def test_cli_render_mc_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "state.npz")
    out1 = str(tmp_path / "a.png")
    out2 = str(tmp_path / "b.png")
    args = ["--cpu", "render", "--stage", "mc", "--width", "16", "--height",
            "16", "--depth", "2", "--checkpoint", ck, "--checkpoint-every",
            "2"]
    main(args + ["--spp", "2", "--out", out1])
    assert os.path.exists(ck)
    main(args + ["--spp", "4", "--out", out2])     # resumes at 2 of 4
    a = im.read_png(out1).astype(np.int32)
    b = im.read_png(out2).astype(np.int32)
    assert a.shape == b.shape == (16, 16, 3)
    assert np.abs(a - b).mean() < 64  # same scene, more samples
    # the resumed render is the uninterrupted one
    want = main_u8(["--spp", "4", "--depth", "2"], tmp_path)
    np.testing.assert_array_equal(b, want.astype(np.int32))


def main_u8(extra, tmp_path, size=16):
    out = str(tmp_path / "direct.png")
    main(["--cpu", "render", "--stage", "mc", "--width", str(size),
          "--height", str(size), "--out", out] + extra)
    return im.read_png(out)


def test_cli_sweep(tmp_path):
    outdir = str(tmp_path / "sweep")
    main(["--cpu", "sweep", "--width", "16", "--height", "16", "--frames",
          "2", "--jbf", "2", "--alpha", "0.2", "--outdir", outdir])
    assert os.path.exists(os.path.join(outdir, "jbf2_a20.png"))
    assert os.path.exists(os.path.join(outdir, "manifest.json"))


def test_cli_fly_two_frames(tmp_path):
    outdir = str(tmp_path / "fly")
    main(["--cpu", "fly", "--width", "16", "--height", "16", "--frames",
          "2", "--jbf", "2", "--outdir", outdir])
    a = im.read_png(os.path.join(outdir, "frame_000.png"))
    b = im.read_png(os.path.join(outdir, "frame_001.png"))
    assert a.shape == b.shape == (16, 16, 3)
    assert not np.array_equal(a, b)     # the camera moved


def test_cli_render_mc_equals_render_fast(tmp_path):
    cfg = RenderConfig(width=24, height=24, spp=3, max_depth=4,
                       rr_survival=0.8)
    seed = rng.seed_word(7)
    want = mc.render_fast(cornell.cornell_scene(), cornell.cornell_camera(),
                          cfg, seed, device="cpu")
    img, gamma = render_stage("mc", cfg, seed, CPU)
    assert gamma == 1.0
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))
    got = main_u8(["--spp", "3", "--depth", "4", "--seed", "7"], tmp_path,
                  size=24)
    np.testing.assert_array_equal(got, tonemap.quantize_u8(want, 1.0).numpy())


def test_cli_checkpoint_normalises_by_samples_done(tmp_path):
    """--spp 50 --checkpoint-every 32 accumulates 64 samples: the image is
    their mean, not the sum over 50."""
    ck = str(tmp_path / "s.npz")
    out = str(tmp_path / "c.png")
    main(["--cpu", "render", "--stage", "mc", "--width", "8", "--height",
          "8", "--depth", "2", "--spp", "50", "--checkpoint-every", "32",
          "--checkpoint", ck, "--out", out])
    with np.load(ck) as z:
        assert int(z["samples_done"]) == 64
        acc = z["accum"]
    want = tonemap.quantize_u8(torch.from_numpy(acc) / 64.0, 1.0).numpy()
    np.testing.assert_array_equal(im.read_png(out), want)


def test_cli_refuses_resume_under_another_seed(tmp_path):
    ck = str(tmp_path / "s.npz")
    args = ["--cpu", "render", "--stage", "mc", "--width", "8", "--height",
            "8", "--depth", "2", "--checkpoint", ck, "--checkpoint-every",
            "1", "--out", str(tmp_path / "x.png")]
    main(args + ["--spp", "1", "--seed", "1"])
    with pytest.raises(SystemExit, match="seed"):
        main(args + ["--spp", "2", "--seed", "2"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA: there the CLI must raise")
def test_cli_without_cpu_flag_raises_on_a_machine_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["render", "--stage", "mc", "--width", "8", "--height", "8",
              "--spp", "1", "--out", str(tmp_path / "n.png")])
    assert not os.path.exists(tmp_path / "n.png")
