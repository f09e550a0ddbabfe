"""Shared helpers of the ``test_torch_*`` files: carry JAX-package scenes,
cameras and keys across to the PyTorch port as numpy arrays, and compare
lane states."""

import dataclasses

import numpy as np
import pytest
import torch

from cpu_based_ray_tracer_tpu import scene as jscene
from cpu_based_ray_tracer_tpu.scenes import cornell as jcornell
from cpu_based_ray_tracer_tpu.utils import rng as jrng

from cpu_based_ray_tracer_tpu_torch import interop

# The JAX package's own tolerance for float lane state (tests/test_fused.py).
RTOL = ATOL = 2e-3

# A diffuse sphere (white material 0) inside the room, above the short box.
SPHERE_CENTER, SPHERE_RADIUS = (1.6, 2.6, 1.7), 0.7


def seed_word(k: int) -> int:
    """The u32 seed word the JAX package derives from ``render_key(k)``."""
    return int(jrng.seed_from_key(jrng.render_key(k)))


def jax_cornell_sphere():
    return jcornell.cornell_scene().replace(
        spheres=jscene.make_spheres(SPHERE_CENTER, SPHERE_RADIUS, 0))


def jax_scene(name: str):
    return {"cornell": jcornell.cornell_scene,
            "cornell_sphere": jax_cornell_sphere}[name]()


def scene_arrays(s) -> dict:
    """A JAX-package Scene's leaves as nested numpy arrays."""
    out = {k: {f.name: np.asarray(getattr(getattr(s, k), f.name))
               for f in dataclasses.fields(getattr(s, k))}
           for k in ("triangles", "spheres", "materials", "lights")}
    out["sky_bottom"] = np.asarray(s.sky_bottom)
    out["sky_top"] = np.asarray(s.sky_top)
    return out


def camera_arrays(c) -> dict:
    return {f.name: np.asarray(getattr(c, f.name))
            for f in dataclasses.fields(c)}


def port_scene(name: str):
    return interop.scene_from_arrays(scene_arrays(jax_scene(name)), "cpu")


def port_camera():
    return interop.camera_from_arrays(
        camera_arrays(jcornell.cornell_camera()), "cpu")


def state_numpy(st) -> dict:
    """A lane state (either package) as numpy arrays by field name."""
    conv = (lambda x: x.cpu().numpy()) if isinstance(st.s, torch.Tensor) \
        else np.asarray
    return {f: conv(getattr(st, f)) for f in
            ("s", "b", "n_done", "nrays", "o", "d", "tp", "cur", "acc")}


def assert_states_match(ref: dict, got: dict):
    """Integer lane state and the ray counter exactly; float state to the
    JAX package's tolerance."""
    for name in ("s", "b", "n_done", "nrays"):
        np.testing.assert_array_equal(ref[name], got[name],
                                      err_msg=f"integer state {name}")
    for name in ("o", "d", "tp", "cur", "acc"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                   atol=ATOL, err_msg=f"float state {name}")


@pytest.fixture
def one_torch_thread():
    """Run the test with one PyTorch intra-op thread, restoring the count
    after.  The tier-1 run puts six test workers on the machine's cores;
    PyTorch's thread pool in each of them then oversubscribes the cores,
    and frame-sized elementwise passes (the denoise filters, the golden
    renders) run many times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
