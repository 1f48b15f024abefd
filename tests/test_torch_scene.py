"""The port's scene loading and packing against the reference: the same
XML gives the same records and, on every array and meta key the ported
slice reads, the same pack (exactly)."""

import os

import numpy as np
import pytest
import torch

from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene as jload
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.scene.builder import (
    SLICE_ARRAYS,
    SLICE_META,
    pack_from_numpy,
    pack_scene,
)
from mitsuba_tpu_torch.scene.xml_loader import load_scene, load_scene_string
from tests.torch_meshes import EMISSIVE_SPHERE_XML, matpreview_const_xml

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox.xml")

# a second slice scene: several emitters, default material, sampling weights
TWO_LIGHTS = """
<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="5"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/><string name="fovAxis" value="y"/>
    <transform name="toWorld"><lookat origin="0,1,-5" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
    <film type="hdrfilm"><integer name="width" value="48"/><integer name="height" value="32"/>
      <rfilter type="gaussian"><float name="stddev" value="0.4"/></rfilter></film>
  </sensor>
  <shape type="rectangle"><transform name="toWorld"><scale value="3"/><rotate x="1" angle="-90"/></transform></shape>
  <shape type="cube"><transform name="toWorld"><scale x="0.5" y="1" z="0.5"/><translate y="1"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.5, 0.05"/></bsdf></shape>
  <shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="90"/><translate y="3"/></transform>
    <emitter type="area"><rgb name="radiance" value="4"/><float name="samplingWeight" value="3"/></emitter></shape>
  <shape type="rectangle"><transform name="toWorld"><scale value="0.3"/><rotate y="1" angle="-90"/><translate x="2" y="1"/></transform>
    <emitter type="area"><spectrum name="radiance" value="1, 2, 3"/></emitter></shape>
</scene>
"""


def _jax_np(jp):
    return {k: np.asarray(v) for k, v in jp.arrays.items()}


@pytest.mark.parametrize("name", ["cbox", "two_lights", "matpreview", "emissive_sphere"])
def test_pack_equals_reference(name):
    if name == "cbox":
        jp = jpack_scene(jload(CBOX))
        tp = pack_scene(load_scene(CBOX), "cpu")
    else:
        xml = {"two_lights": TWO_LIGHTS, "matpreview": matpreview_const_xml(64, 64),
               "emissive_sphere": EMISSIVE_SPHERE_XML}[name]
        jp = jpack_scene(jload_string(xml))
        tp = pack_scene(load_scene_string(xml), "cpu")
    ref = _jax_np(jp)
    for k in SLICE_ARRAYS:
        out = tp.arrays[k].numpy()
        assert out.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out, ref[k], err_msg=k)
    for k in SLICE_META:
        assert tp.meta[k] == jp.meta[k], k


def test_pack_from_numpy_round_trips():
    tp = pack_scene(load_scene(CBOX), "cpu")
    arrays = {k: v.numpy() for k, v in tp.arrays.items()}
    back = pack_from_numpy(arrays, tp.meta, "cpu")
    assert back.meta == tp.meta
    assert set(back.arrays) == set(tp.arrays)
    for k, v in tp.arrays.items():
        assert back.arrays[k].dtype == v.dtype and torch.equal(back.arrays[k], v), k


def test_pack_from_reference_pack():
    """A converted reference pack carries every slice array unchanged."""
    jp = jpack_scene(jload(CBOX))
    tp = pack_from_numpy(_jax_np(jp), jp.meta, "cpu")
    for k in SLICE_ARRAYS:
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]))


def test_loader_records_match_reference():
    j = jload_string(TWO_LIGHTS)
    t = load_scene_string(TWO_LIGHTS)
    assert t.integrator.max_depth == j.integrator.max_depth == 5
    assert t.integrator.rr_depth == j.integrator.rr_depth
    js, ts = j.sensor.record, t.sensor.record
    assert ts.xfov_deg == pytest.approx(js.xfov_deg, rel=1e-12)
    np.testing.assert_array_equal(ts.to_world.m, js.to_world.m)
    assert (ts.film.width, ts.film.height) == (js.film.width, js.film.height)
    assert ts.film.rfilter.stddev == js.film.rfilter.stddev == 0.4
    assert ts.sampler.sample_count == js.sampler.sample_count == 8
    for a, b in zip(t.shapes, j.shapes):
        np.testing.assert_array_equal(a.meshes[0].positions, b.meshes[0].positions)
        np.testing.assert_array_equal(a.meshes[0].indices, b.meshes[0].indices)
        np.testing.assert_array_equal(a.meshes[0].normals, b.meshes[0].normals)


def test_srgb_reflectance_within_one_ulp():
    """<srgb> goes through the sRGB transfer curve on the host; numpy's
    float32 pow may differ from XLA's in the last place."""
    xml = TWO_LIGHTS.replace(
        '<rgb name="reflectance" value="0.2, 0.5, 0.05"/>',
        '<srgb name="reflectance" value="#80c040"/>',
    )
    ref = jload_string(xml).shapes[1].bsdf.cA
    out = load_scene_string(xml).shapes[1].bsdf.cA
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize(
    "snippet",
    [
        '<film type="ldrfilm"/>',
        '<film type="tiledhdrfilm"/>',
        '<film type="mfilm"/>',
    ],
)
def test_unported_features_raise(snippet):
    """The three films the port lacked load now, with the reference's
    record; a film neither package registers still raises by name."""
    import dataclasses

    xml = (
        '<scene version="0.5.0"><sensor type="perspective">'
        f"{snippet}</sensor></scene>"
    )
    ours = load_scene_string(xml).sensor.record.film
    ref = jload_string(xml).sensor.record.film
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_scene_string(xml.replace(snippet, '<film type="holofilm"/>'))


def test_unported_pack_features_raise():
    jp = jpack_scene(jload(CBOX))
    for key, value in (("present_types", (0, 13)),):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            pack_from_numpy(_jax_np(jp), {**jp.meta, key: value}, "cpu")


def test_large_scene_raises(monkeypatch):
    """Above 512 triangles the pack carries a BVH and cluster tables, past
    DENSE_C clusters too (K5/K6, K9/K10).  Past the cluster budget it packs
    no cluster tables, as the reference, and raises nothing: intersect
    walks the BVH."""
    from mitsuba_tpu_torch.accel import clusters, pairs

    cubes = "".join(
        f'<shape type="cube"><transform name="toWorld"><translate x="{3 * i}"/></transform></shape>'
        for i in range(43)  # 43 * 12 = 516 triangles
    )
    scene = load_scene_string(
        f'<scene version="0.5.0"><sensor type="perspective"/>{cubes}</scene>'
    )
    meta = pack_scene(scene, "cpu").meta
    assert meta["use_bvh"] and meta["n_clusters"] > 1
    monkeypatch.setattr(pairs, "DENSE_C", meta["n_clusters"] - 1)
    assert pack_scene(scene, "cpu").meta["n_clusters"] == meta["n_clusters"]
    c, tc = meta["n_clusters"], meta["cluster_tc"]
    monkeypatch.setattr(clusters, "CLUSTER_HBM_MAX", c * tc * 256 - 1)
    meta = pack_scene(scene, "cpu").meta
    assert meta["use_bvh"] and "n_clusters" not in meta


def test_unported_texture_kinds_raise():
    """A reference pack with a texture kind past the reference's seven is
    refused; every kind of the reference passes (the bitmap, kind 1, with
    or without its mip maps, since the texture slice)."""
    jp = jpack_scene(jload_string(matpreview_const_xml(16, 16)))
    arrays = _jax_np(jp)
    assert pack_from_numpy(arrays, jp.meta, "cpu").meta["has_textures"]
    bitmap = {**arrays, "tex_type": np.ones_like(arrays["tex_type"])}
    for meta in (jp.meta, {**jp.meta, "has_mips": True}):
        assert pack_from_numpy(bitmap, meta, "cpu").meta["tex_kinds"] == (1,)
    unknown = {**arrays, "tex_type": np.full_like(arrays["tex_type"], 7)}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pack_from_numpy(unknown, jp.meta, "cpu")
