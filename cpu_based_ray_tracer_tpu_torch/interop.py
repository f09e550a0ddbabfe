"""Carry a scene and a camera across from numpy arrays.

``scene_from_arrays`` takes the leaves of a JAX-package ``Scene`` as numpy
arrays, nested as the dataclasses are::

    {"triangles": {"v0": ..., "e1": ..., "e2": ..., "normal": ...,
                   "uv0": ..., "uv1": ..., "uv2": ..., "material": ...},
     "spheres": {"center": ..., "radius": ..., "material": ...},
     "materials": {"kind": ..., "albedo": ..., "emission": ..., "ior": ...,
                   "fuzz": ..., "kd": ..., "ks": ..., "spec_exp": ...,
                   "texture": ...},
     "lights": {"position": ..., "radiance": ...},
     "sky_bottom": ..., "sky_top": ...}

and ``camera_from_arrays`` a camera's leaves: ``position``, ``forward``,
``up`` and ``vfov_degrees`` of a ``PerspectiveCamera``, or ``origin``,
``lower_left``, ``horizontal``, ``vertical``, ``u``, ``v`` and
``lens_radius`` of a ``ThinLensCamera``.  Fed the same arrays, both packages compute the same
image.  ``scene_to_arrays`` / ``camera_to_arrays`` go the other way.
``mesh_pack_from_arrays`` and ``coherent_pack_from_arrays`` carry the
fused mesh engine's and the shortlist intersector's packs across;
``record_from_arrays`` / ``record_to_arrays`` a ``BounceRecord`` (the
leaves ``prim``, ``is_triangle``, ``hit`` and ``visible``), so that either
package can replay the other's trace.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cpu_based_ray_tracer_tpu_torch.camera import (PerspectiveCamera,
                                                   ThinLensCamera)
from cpu_based_ray_tracer_tpu_torch.scene import (Materials, PointLights,
                                                  Scene, Spheres, Triangles)

_PARTS = {"triangles": Triangles, "spheres": Spheres,
          "materials": Materials, "lights": PointLights}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        a = a.astype(np.int32)
    else:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def _build(cls, d, device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__} arrays lack {sorted(missing)}")
    return cls(**{n: _tensor(d[n], device) for n in names})


def scene_from_arrays(d: dict, device="cpu") -> Scene:
    """A ``Scene`` on ``device`` from numpy leaves (layout above)."""
    parts = {k: _build(cls, d[k], device) for k, cls in _PARTS.items()}
    return Scene(**parts, sky_bottom=_tensor(d["sky_bottom"], device),
                 sky_top=_tensor(d["sky_top"], device))


def scene_to_arrays(scene: Scene) -> dict:
    out = {k: {f.name: getattr(getattr(scene, k), f.name).cpu().numpy()
               for f in dataclasses.fields(cls)}
           for k, cls in _PARTS.items()}
    out["sky_bottom"] = scene.sky_bottom.cpu().numpy()
    out["sky_top"] = scene.sky_top.cpu().numpy()
    return out


def camera_from_arrays(d: dict, device="cpu"):
    """A ``PerspectiveCamera``, or a ``ThinLensCamera`` where the leaves
    hold ``lens_radius``, on ``device`` from numpy leaves."""
    cls = ThinLensCamera if "lens_radius" in d else PerspectiveCamera
    return _build(cls, d, device)


def camera_to_arrays(camera) -> dict:
    return {f.name: getattr(camera, f.name).cpu().numpy()
            for f in dataclasses.fields(camera)}


def mesh_pack_from_arrays(d: dict, device="cpu"):
    """An ``ops.fused_mesh.MeshPack`` on ``device`` from the fields of a
    JAX-package ``MeshPack``: its arrays as numpy (``smc_tri`` in either
    the JAX (C, CS*16/128, 128) layout or (C, CS, 16)), its ints and
    tuples as they are."""
    from cpu_based_ray_tracer_tpu_torch.ops import fused_mesh
    from cpu_based_ray_tracer_tpu_torch.ops.clusters import MESH_NF

    kw = {f.name: d[f.name] for f in dataclasses.fields(fused_mesh.MeshPack)}
    for name in ("stri", "ssph", "mat", "light", "sky", "smc_tri",
                 "smc_aabb", "smc_box_aabb"):
        kw[name] = torch.as_tensor(np.array(d[name], np.float32),
                                   device=device)
    kw["smc_tri"] = kw["smc_tri"].reshape(kw["smc_aabb"].shape[0], kw["cs"],
                                          MESH_NF)
    kw["gate_mask"] = np.asarray(d["gate_mask"], bool)
    return fused_mesh.MeshPack(**kw)


def coherent_pack_from_arrays(d: dict, device="cpu"):
    """An ``ops.coherent.CoherentPack`` on ``device`` from the fields of a
    JAX-package ``CoherentPack``: ``tri`` in either the JAX (C,
    CS*16/128, 128) layout or (C, CS, 16), ``aabb``, ``cs`` and ``n_tri``."""
    from cpu_based_ray_tracer_tpu_torch.ops import coherent
    from cpu_based_ray_tracer_tpu_torch.ops.clusters import MESH_NF

    aabb = torch.as_tensor(np.array(d["aabb"], np.float32), device=device)
    tri = torch.as_tensor(np.array(d["tri"], np.float32), device=device)
    cs = int(d["cs"])
    return coherent.CoherentPack(
        tri=tri.reshape(aabb.shape[0], cs, MESH_NF), aabb=aabb,
        cs=cs, n_tri=int(d["n_tri"]))


def record_from_arrays(d: dict, device="cpu"):
    """A ``models.monte_carlo.BounceRecord`` on ``device`` from numpy
    leaves of any leading shape: ``prim`` as int32, the flags as bool."""
    from cpu_based_ray_tracer_tpu_torch.models import monte_carlo

    return monte_carlo.BounceRecord(
        prim=torch.as_tensor(np.asarray(d["prim"]).astype(np.int32),
                             device=device),
        **{k: torch.as_tensor(np.asarray(d[k]).astype(bool), device=device)
           for k in ("is_triangle", "hit", "visible")})


def record_to_arrays(rec) -> dict:
    return {f.name: getattr(rec, f.name).cpu().numpy()
            for f in dataclasses.fields(rec)}
