"""Wavefront OBJ reading (port of ``cpu_based_ray_tracer_tpu.utils.objio``,
the part the mesh scenes use; numpy only).

v / vt / f records; faces in the v, v/vt, v//vn and v/vt/vn forms;
polygons fan-triangulated; negative (relative) indices.
"""

from __future__ import annotations

import numpy as np


def parse_obj(text: str):
    """Parse OBJ text -> (vertices (V,3), uvs (T,3,2) or None,
    triangles (T,3,3)) with faces fan-triangulated."""
    verts: list = []
    uvs: list = []
    faces: list = []      # list of [(vi, ti), ...]
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            verts.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            uvs.append([float(x) for x in parts[1:3]])
        elif tag == "f":
            corners = []
            for p in parts[1:]:
                comps = p.split("/")
                vi = int(comps[0])
                ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                corners.append((vi, ti))
            for k in range(1, len(corners) - 1):   # fan triangulation
                faces.append([corners[0], corners[k], corners[k + 1]])
    v = np.asarray(verts, np.float64)
    t_arr = np.asarray(uvs, np.float64) if uvs else None

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    tris = np.empty((len(faces), 3, 3), np.float64)
    tri_uv = np.zeros((len(faces), 3, 2), np.float64)
    has_uv = False
    for fi, face in enumerate(faces):
        for ci, (vi, ti) in enumerate(face):
            tris[fi, ci] = v[resolve(vi, len(v))]
            if ti and t_arr is not None:
                tri_uv[fi, ci] = t_arr[resolve(ti, len(t_arr))]
                has_uv = True
    return v, (tri_uv if has_uv else None), tris


def load_obj(path, scale: float = 1.0, translate=(0.0, 0.0, 0.0)):
    """Load an OBJ file -> (triangles (T,3,3), uv (T,3,2) or None), with the
    reference mesh loader's uniform scale + translate."""
    with open(path) as f:
        _, uv, tris = parse_obj(f.read())
    tris = tris * scale + np.asarray(translate, np.float64)
    return tris, uv
