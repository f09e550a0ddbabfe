"""Wavefront OBJ and MTL IO (port of ``cpu_based_ray_tracer_tpu.utils.objio``;
numpy only).

v / vt / f records; faces in the v, v/vt, v//vn and v/vt/vn forms;
polygons fan-triangulated; negative (relative) indices; ``usemtl`` /
``mtllib`` groups and the ``.mtl`` value subset (newmtl, Ka, Kd, Ks, Ke,
Ns, Ni, d, illum) that the mesh scenes consume.  A native C++ parser with
the same contract is in ``utils.native``.
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


def save_obj(path, triangles: np.ndarray) -> None:
    """Write per-triangle soup (T,3,3) as an OBJ (deduplicated vertices)."""
    tris = np.asarray(triangles, np.float64).reshape(-1, 3)
    verts, inverse = np.unique(tris.round(9), axis=0, return_inverse=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        idx = inverse.reshape(-1, 3) + 1
        for a, b, c in idx:
            f.write(f"f {a} {b} {c}\n")


# --- .mtl subset ---------------------------------------------------------
#
# The vendored loader's LoadMaterials (OBJ_Loader.h:1013-1180) parses newmtl,
# Ka/Kd/Ks, Ns, Ni, d, illum and map_* paths, then assigns each mesh group
# its material by the obj's `usemtl` name (OBJ_Loader.h:696-710).  This
# re-implements the value subset the framework can consume (the reference
# itself overrides mesh materials in code and never samples the maps).

def parse_mtl(text: str) -> dict:
    """Parse MTL text -> {name: {"ka","kd","ks","ke","ns","ni","d","illum"}}.

    Missing keys default like objl::Material's ctor (zeros,
    OBJ_Loader.h:150-160); Ke (emission) is accepted although the vendored
    loader ignores it — our MC stage needs emissive meshes."""
    mats: dict = {}
    cur = None
    for raw in text.splitlines():
        parts = raw.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "newmtl":
            cur = " ".join(parts[1:]) or "none"
            mats[cur] = {"ka": (0.0, 0.0, 0.0), "kd": (0.0, 0.0, 0.0),
                         "ks": (0.0, 0.0, 0.0), "ke": (0.0, 0.0, 0.0),
                         "ns": 0.0, "ni": 0.0, "d": 1.0, "illum": 0}
        elif cur is None:
            continue
        elif tag in ("Ka", "Kd", "Ks", "Ke"):
            mats[cur][tag.lower()] = tuple(float(x) for x in parts[1:4])
        elif tag in ("Ns", "Ni", "d"):
            mats[cur][tag.lower() if tag != "d" else "d"] = float(parts[1])
        elif tag == "illum":
            mats[cur]["illum"] = int(parts[1])
    return mats


def parse_obj_groups(text: str):
    """Like ``parse_obj`` but tracks `usemtl`/`mtllib`: returns
    (vertices, tri_uv or None, tris, tri_mtl (T,) int, mtl_names list,
    mtllibs list).  tri_mtl indexes mtl_names; -1 = no usemtl in effect."""
    verts: list = []
    uvs: list = []
    faces: list = []
    face_mtl: list = []
    names: list = []
    libs: list = []
    cur = -1
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
        elif tag == "mtllib":
            libs.extend(parts[1:])
        elif tag == "usemtl":
            name = " ".join(parts[1:])
            if name not in names:
                names.append(name)
            cur = names.index(name)
        elif tag == "f":
            corners = []
            for p in parts[1:]:
                comps = p.split("/")
                vi = int(comps[0])
                ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                corners.append((vi, ti))
            for k in range(1, len(corners) - 1):
                faces.append([corners[0], corners[k], corners[k + 1]])
                face_mtl.append(cur)
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
    return (v, (tri_uv if has_uv else None), tris,
            np.asarray(face_mtl, np.int64), names, libs)


def load_obj_with_materials(path, scale: float = 1.0,
                            translate=(0.0, 0.0, 0.0)):
    """Load an OBJ plus its `mtllib` files (resolved next to the OBJ, as
    the vendored loader does at OBJ_Loader.h:660-673) -> (tris, uv,
    tri_mtl (T,) int, materials list of dicts aligned with the indices).

    Triangles whose group has no usemtl, or whose name is missing from the
    .mtl, get a default grey Kd=0.5 material (the loader's behavior is to
    leave the Mesh's default-constructed material in place)."""
    import os

    with open(path) as f:
        _, uv, tris, tri_mtl, names, libs = parse_obj_groups(f.read())
    tris = tris * scale + np.asarray(translate, np.float64)
    loaded: dict = {}
    for lib in libs:
        p = os.path.join(os.path.dirname(os.path.abspath(path)), lib)
        if os.path.exists(p):
            with open(p) as f:
                loaded.update(parse_mtl(f.read()))
    default = {"ka": (0.0, 0.0, 0.0), "kd": (0.5, 0.5, 0.5),
               "ks": (0.0, 0.0, 0.0), "ke": (0.0, 0.0, 0.0),
               "ns": 0.0, "ni": 0.0, "d": 1.0, "illum": 0}
    materials = [loaded.get(n, default) for n in names] + [default]
    tri_mtl = np.where(tri_mtl < 0, len(names), tri_mtl)
    return tris, uv, tri_mtl.astype(np.int64), materials
