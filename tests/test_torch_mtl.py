"""The .mtl half of the port's OBJ IO and ``mesh_scene_from_obj``: the five
cases of ``tests/test_mtl.py`` on its inline text, each also equal to the
JAX package's result (parsed dicts, triangle arrays, the scene's arrays via
``interop.scene_to_arrays``)."""

import numpy as np

from cpu_based_ray_tracer_tpu.scenes import meshes as jmeshes
from cpu_based_ray_tracer_tpu.utils import objio as jobjio

from cpu_based_ray_tracer_tpu_torch import interop
from cpu_based_ray_tracer_tpu_torch.scenes import meshes
from cpu_based_ray_tracer_tpu_torch.utils import objio

from torch_ref import scene_arrays

OBJ = """\
mtllib box.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
usemtl red
f 1 2 3 4
usemtl light
f 1 3 4
f -4 -3 -2
"""

MTL = """\
# comment
newmtl red
Ka 0.1 0.1 0.1
Kd 0.63 0.065 0.05
Ks 0.2 0.2 0.2
Ns 10
Ni 1.3
illum 2
newmtl light
Kd 0.78 0.78 0.78
Ke 47.8 38.6 31.1
d 0.5
"""


def _write(tmp_path, mtl=True):
    (tmp_path / "box.obj").write_text(OBJ)
    if mtl:
        (tmp_path / "box.mtl").write_text(MTL)
    return str(tmp_path / "box.obj")


def test_parse_mtl_values():
    m = objio.parse_mtl(MTL)
    assert m == jobjio.parse_mtl(MTL)
    assert set(m) == {"red", "light"}
    assert m["red"]["kd"] == (0.63, 0.065, 0.05)
    assert m["red"]["ns"] == 10.0 and m["red"]["ni"] == 1.3
    assert m["red"]["illum"] == 2
    assert m["red"]["ke"] == (0.0, 0.0, 0.0)
    assert m["light"]["ke"] == (47.8, 38.6, 31.1)
    assert m["light"]["d"] == 0.5


def test_parse_obj_groups_usemtl():
    got = objio.parse_obj_groups(OBJ)
    want = jobjio.parse_obj_groups(OBJ)
    _, _, tris, tri_mtl, names, libs = got
    assert tris.shape == (4, 3, 3)       # the quad fans into 2, 4 in all
    assert names == ["red", "light"] and libs == ["box.mtl"]
    np.testing.assert_array_equal(tri_mtl, [0, 0, 1, 1])
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_load_obj_with_materials(tmp_path):
    path = _write(tmp_path)
    got = objio.load_obj_with_materials(path, scale=2.0, translate=(0, 0, 1))
    tris, _, tri_mtl, mats = got
    assert tris.shape == (4, 3, 3)
    assert tris[:, :, 2].max() == 1.0          # translated
    assert tris[:, :, 0].max() == 2.0          # scaled
    assert mats[tri_mtl[0]]["kd"] == (0.63, 0.065, 0.05)
    assert mats[tri_mtl[2]]["ke"] == (47.8, 38.6, 31.1)
    want = jobjio.load_obj_with_materials(path, scale=2.0,
                                          translate=(0, 0, 1))
    np.testing.assert_array_equal(tris, want[0])
    np.testing.assert_array_equal(tri_mtl, want[2])
    assert mats == want[3] and got[1] is None and want[1] is None


def test_missing_mtl_defaults_grey(tmp_path):
    path = _write(tmp_path, mtl=False)
    _, _, tri_mtl, mats = objio.load_obj_with_materials(path)
    assert all(mats[j]["kd"] == (0.5, 0.5, 0.5) for j in tri_mtl)
    assert mats == jobjio.load_obj_with_materials(path)[3]


def test_mesh_scene_from_obj(tmp_path):
    path = _write(tmp_path)
    scene = meshes.mesh_scene_from_obj(path)
    assert scene.triangles.count == 4
    tm = scene.triangles.material.numpy()
    np.testing.assert_allclose(scene.materials.albedo.numpy()[tm[0]],
                               [0.63, 0.065, 0.05], rtol=1e-6)
    np.testing.assert_allclose(scene.materials.emission.numpy()[tm[2]],
                               [47.8, 38.6, 31.1], rtol=1e-6)
    assert bool(scene.materials.emissive.numpy()[tm[2]])
    got = interop.scene_to_arrays(scene)
    want = scene_arrays(jmeshes.mesh_scene_from_obj(path))
    for part, fields in want.items():
        if isinstance(fields, dict):
            for f, arr in fields.items():
                np.testing.assert_array_equal(got[part][f], arr,
                                              err_msg=f"{part}.{f}")
        else:
            np.testing.assert_array_equal(got[part], fields, err_msg=part)
