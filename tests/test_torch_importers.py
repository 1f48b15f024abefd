"""The port's importers (mitsuba_tpu_torch/mtsimport.py, io/collada.py)
against the JAX package's: an OBJ with its MTL (diffuse, phong, glass and
a bitmap texture) and tests/test_collada.py's COLLADA document (Z-up,
centimetre units, a node hierarchy, lambert and phong effects, a camera
and a point light) become the same scene XML text and the same
.serialized bytes, the COLLADA walk yields the same meshes, materials and
transforms, and the imported scenes render in the port within the cbox
gate of the JAX package's renders (tone-mapped RMSE < 5e-3)."""

import os

import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu import mtsimport as jmtsimport
from mitsuba_tpu.io.collada import Collada as JCollada
from mitsuba_tpu_torch import mtsimport
from mitsuba_tpu_torch.io.collada import Collada
from tests.test_collada import _DAE
from tests.torch_meshes import tm_rmse

torch.set_num_threads(1)

OBJ = """mtllib scene.mtl
o floor
usemtl green
v -2 0 -2
v 2 0 -2
v 2 0 2
v -2 0 2
vn 0 1 0
f 1//1 2//1 3//1
f 1//1 3//1 4//1
o block
usemtl shiny
v -0.5 0 -0.5
v 0.5 0 -0.5
v 0 1 0
vt 0 0
vt 1 0
vt 0.5 1
f 5/1 6/2 7/3
"""
MTL = """newmtl green
Kd 0.1 0.7 0.1
newmtl shiny
Kd 0.4 0.3 0.2
Ks 0.5 0.5 0.5
Ns 30
newmtl glass
d 0.2
Ni 1.5
newmtl floor
Kd 0.5 0.5 0.5
map_Kd checker.png
"""


def _files(out):
    xml = open(os.path.join(out, "scene.xml")).read()
    ser = open(os.path.join(out, "meshes", "geometry.serialized"), "rb").read()
    return xml, ser


def _render_both(xml_path, jxml_path, size=16, spp=4):
    scene, jscene = mt.load_scene(xml_path), mitsuba_tpu.load_scene(jxml_path)
    for s in (scene, jscene):
        s.sensor.record.film.width = s.sensor.record.film.height = size
    img = mt.render(scene, spp=spp, seed=1, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jscene, spp=spp, seed=1))
    return img, ref


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("obj")
    (d / "scene.obj").write_text(OBJ)
    (d / "scene.mtl").write_text(MTL)
    return d


def test_import_obj_equal_and_renders(obj_dir):
    src = str(obj_dir / "scene.obj")
    ours = mtsimport.import_obj(src, str(obj_dir / "port"))
    ref = jmtsimport.import_obj(src, str(obj_dir / "ref"))
    assert _files(obj_dir / "port") == _files(obj_dir / "ref")
    xml = open(ours).read()
    assert 'type="serialized"' in xml and 'type="phong"' in xml and "0.1, 0.7, 0.1" in xml
    img, jimg = _render_both(ours, ref)
    assert np.isfinite(img).all() and img.max() > 0
    assert tm_rmse(img, jimg) < 5e-3


def test_mtl_mapping_equal():
    """The MTL heuristics (diffuse, phong, dielectric by transparency, a
    bitmap from map_Kd) write the reference's XML text."""
    mats = {"glass": {"d": 0.2, "ni": 1.5}, "tex": {"map_kd": "checker.png"},
            "tex_phong": {"ks": [0.5, 0.5, 0.5], "ns": 20.0, "map_kd": "a.png"},
            "plain": {}, "phong": {"kd": [0.2, 0.3, 0.4], "ks": [0.3, 0.3, 0.3], "ns": 8.0}}
    for name, m in mats.items():
        assert mtsimport._mat_xml(name, m) == jmtsimport._mat_xml(name, m)


def test_mtl_parse_equal(obj_dir):
    path = str(obj_dir / "scene.mtl")
    assert mtsimport._parse_mtl(path) == jmtsimport._parse_mtl(path)
    assert mtsimport._parse_mtl(str(obj_dir / "missing.mtl")) == {}


@pytest.fixture(scope="module")
def dae_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("dae")
    (d / "test.dae").write_text(_DAE)
    return d


def test_collada_walk_equal(dae_path):
    ours = list(Collada(str(dae_path / "test.dae")).walk())
    ref = list(JCollada(str(dae_path / "test.dae")).walk())
    assert [i[0] for i in ours] == [i[0] for i in ref] and len(ours) >= 4
    for a, b in zip(ours, ref):
        if a[0] == "geometry":
            for f in ("positions", "indices", "normals", "texcoords"):
                x, y = getattr(a[1], f), getattr(b[1], f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
            assert a[2].keys() == b[2].keys()  # the material
            for k, v in a[2].items():
                assert np.array_equal(np.asarray(v), np.asarray(b[2][k])), k
        np.testing.assert_array_equal(np.asarray(a[-1]), np.asarray(b[-1]))


def test_import_dae_equal_and_renders(dae_path, capsys):
    src = str(dae_path / "test.dae")
    assert mtsimport.main([src, str(dae_path / "port")]) == 0
    assert "wrote" in capsys.readouterr().out
    ref = jmtsimport.import_dae(src, str(dae_path / "ref"))
    assert _files(dae_path / "port") == _files(dae_path / "ref")
    ours = str(dae_path / "port" / "scene.xml")
    assert 'type="point"' in open(ours).read()  # the light came through
    img, jimg = _render_both(ours, ref, size=24, spp=8)
    assert np.isfinite(img).all() and img.max() > 1e-3
    assert tm_rmse(img, jimg) < 5e-3


def test_main_usage(capsys):
    assert mtsimport.main([]) == jmtsimport.main([]) == 1
    assert capsys.readouterr().err.count("usage: python -m mitsuba_tpu") == 2
    with pytest.raises(ValueError, match="unsupported"):
        mtsimport.main(["a.fbx", "out"])
