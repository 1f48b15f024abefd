"""The port's disk, obj, serialized and heightfield shapes and its mesh
readers and writer against the reference, on the files `shape_assets`
writes from a seed:

* load_obj (its groups, negative indices, uv and normals) and the obj
  shape with and without flipTexCoords and faceNormals: equal, bit for
  bit;
* save_serialized: the same bytes as the reference's writer;
  load_serialized of shapeIndex 0 and 1 (and of a version-3 file):
  equal;
* the disk and the heightfield meshes (the heightfield's image strided
  past 2 x 257 columns): equal;
* the shapes gallery's pack: every array equal (checker.png's atlas
  within one float32 place); its render against its golden at its
  GOLDEN_GATES entry (tone-mapped RMSE).
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.io import meshes as jmeshes
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.io import meshes as tmeshes
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    feature_assets,
    shape_assets,
    shapes_gallery_xml,
    tm_rmse,
)

torch.set_num_threads(1)

ASSETS = os.path.join(ROOT, "build", "feature_assets")
FIELDS = ("positions", "indices", "normals", "texcoords", "colors", "face_normals", "name")


@pytest.fixture(scope="module")
def assets():
    return shape_assets(feature_assets(ASSETS))


def _meshes_equal(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        for f in FIELDS:
            x, y = getattr(ma, f), getattr(mb, f)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                assert x is not None and y is not None and x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f


def _shape(xml_body, loader):
    return loader(f'<scene version="0.5.0"><sensor type="perspective"/>{xml_body}</scene>'
                  ).shapes[0].meshes


def test_load_obj_matches_reference(assets):
    path = os.path.join(assets, "gallery.obj")
    out, ref = tmeshes.load_obj(path), jmeshes.load_obj(path)
    _meshes_equal(out, ref)
    assert [m.name for m in out] == ["default", "second"]
    assert out[0].texcoords is not None and out[0].normals is not None


@pytest.mark.parametrize("props", [
    "", '<boolean name="flipTexCoords" value="false"/>',
    '<boolean name="faceNormals" value="true"/>'])
def test_obj_shape_matches_reference(assets, props):
    body = (f'<shape type="obj"><string name="filename" value="'
            f'{os.path.join(assets, "gallery.obj")}"/>{props}<transform name="toWorld">'
            '<scale x="1.5" y="0.5" z="1"/><rotate y="1" angle="30"/></transform></shape>')
    out, ref = _shape(body, load_scene_string), _shape(body, jload_string)
    _meshes_equal(out, ref)
    raw = tmeshes.load_obj(os.path.join(assets, "gallery.obj"))[0].texcoords
    flip = "flipTexCoords" not in props
    np.testing.assert_array_equal(out[0].texcoords[:, 1], 1.0 - raw[:, 1] if flip else raw[:, 1])
    assert (out[0].normals is None) == ("faceNormals" in props)


def test_save_serialized_bytes(tmp_path, assets):
    """Both writers give the same bytes for meshes with and without
    normals, uv, colours and face normals; each reader reads each mesh."""
    meshes = tmeshes.load_serialized(os.path.join(assets, "gallery.serialized"), 0) + \
        tmeshes.load_serialized(os.path.join(assets, "gallery.serialized"), 1)
    ours, theirs = tmp_path / "port.serialized", tmp_path / "ref.serialized"
    tmeshes.save_serialized(str(ours), meshes)
    jmeshes.save_serialized(str(theirs), [jmeshes.MeshData(**{f: getattr(m, f) for f in FIELDS})
                                          for m in meshes])
    assert ours.read_bytes() == theirs.read_bytes()
    for idx in (0, 1):
        _meshes_equal(tmeshes.load_serialized(str(ours), idx),
                      jmeshes.load_serialized(str(theirs), idx))
    with pytest.raises(IndexError):
        tmeshes.load_serialized(str(ours), 2)


def test_load_serialized_version3(tmp_path):
    """A version-3 file (no name, 32-bit offsets) with double precision."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
    blobs = []
    for k in range(2):
        raw = struct.pack("<I", 0x2000) + struct.pack("<QQ", 3, 1)
        raw += (pos + k).astype("<f8").tobytes() + np.array([[0, 1, 2]], "<u4").tobytes()
        blobs.append(struct.pack("<hh", 0x041C, 3) + zlib.compress(raw))
    offs = [0, len(blobs[0])]
    path = tmp_path / "v3.serialized"
    path.write_bytes(b"".join(blobs) + struct.pack("<II", *offs) + struct.pack("<I", 2))
    for idx in (0, 1):
        out = tmeshes.load_serialized(str(path), idx)
        _meshes_equal(out, jmeshes.load_serialized(str(path), idx))
        np.testing.assert_array_equal(out[0].positions, (pos + idx).astype(np.float32))


@pytest.mark.parametrize("body", [
    '<shape type="disk"><transform name="toWorld"><scale value="2"/><rotate x="1" angle="30"/>'
    '</transform></shape>',
    '<shape type="disk"><boolean name="flipNormals" value="true"/></shape>',
    '<shape type="heightfield"/>',
    'HEIGHTFIELD',
])
def test_disk_and_heightfield_meshes(assets, body):
    if body == "HEIGHTFIELD":
        body = (f'<shape type="heightfield"><string name="filename" value="'
                f'{os.path.join(assets, "bumps.pfm")}"/><float name="scale" value="0.3"/>'
                '<transform name="toWorld"><rotate x="1" angle="-90"/></transform></shape>')
    out, ref = _shape(body, load_scene_string), _shape(body, jload_string)
    _meshes_equal(out, ref)
    if "bumps" in body:  # 48 x 600 texels, strided to 48 x 300
        assert len(out[0].positions) == 48 * 300
        assert len(out[0].indices) == 2 * 47 * 299


@pytest.mark.parametrize("flip,face", [(True, False), (False, True)])
def test_gallery_pack_equal(assets, flip, face):
    xml = shapes_gallery_xml(assets, flip_tex=flip, face_normals=face)
    jp, tp = jpack_scene(jload_string(xml)), pack_scene(load_scene_string(xml), "cpu")
    assert tp.meta["use_bvh"] and tp.meta["n_clusters"] > 0
    for k in tp.arrays:
        if k not in jp.arrays:
            continue
        ref, out = np.asarray(jp.arrays[k]), tp.arrays[k].numpy()
        assert out.dtype == ref.dtype and out.shape == ref.shape, k
        if k == "tex_atlas":
            np.testing.assert_allclose(out, ref, rtol=2.4e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(out, ref, err_msg=k)


def test_gallery_golden(assets):
    golden = "torch_shapes_gallery_32_4.npy"
    gold = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(load_scene_string(shapes_gallery_xml(assets)), spp=4, seed=0, device="cpu")
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert tm_rmse(img, gold) < GOLDEN_GATES[golden]
