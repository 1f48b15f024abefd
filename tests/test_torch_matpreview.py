"""The materials slice on the CPU: the port's render of the matpreview
variant (scenes/matpreview.xml under a constant environment with the
independent sampler; tests/torch_meshes.py `matpreview_const_xml`)
against the JAX package's render of the same scene,
tests/golden/torch_matpreview_const_64_16.npy (written by
tests/make_torch_bigmesh_golden.py), at the gate of tests/test_golden.py
(tone-mapped RMSE < 5e-3); and the furnace probes of a sphere in a unit
constant environment, each against its closed form and the JAX
package's render of the same scene:

* white furnace: an albedo-1 diffuse sphere is invisible, L = 1 (mean
  within 0.015 of 1, as tests/test_render.py);
* glass furnaces: a smooth dielectric sphere loses no energy (mean within
  0.015 of 1), a rough one (alpha 0.3) only its microfacet
  single-scattering deficit (mean in (0.85, 1.02], the reference's ~0.97);
  the dielectric's eta enters Russian roulette;
* the "none" mirror (conductor, k = 1e7): L = 1 exactly.

Each furnace image is held to the JAX package's at tone-mapped RMSE
< 5e-3 and its mean within 2e-3 of the reference's."""

import os

import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from tests.torch_meshes import ROOT, matpreview_const_xml

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_matpreview_const_64_16.npy")


def _tonemapped_rmse(img, ref):
    return float(np.sqrt(np.mean((img / (1.0 + img) - ref / (1.0 + ref)) ** 2)))


def test_matpreview_variant_matches_golden():
    golden = np.load(GOLDEN)
    img = mt.render(mt.load_scene_string(matpreview_const_xml(64, 64)), spp=16, seed=0,
                    device="cpu")
    assert img.shape == golden.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    assert _tonemapped_rmse(img, golden) < 5e-3


def test_matpreview_from_reference_pack_is_identical():
    """The variant renders a converted reference pack bit for bit like the
    port's own pack."""
    from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
    from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
    from mitsuba_tpu_torch.scene.builder import pack_from_numpy

    xml = matpreview_const_xml(16, 16)
    jp = jpack_scene(jload_string(xml))
    converted = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    scene = mt.load_scene_string(xml)
    a = mt.render(scene, spp=2, seed=3, device="cpu")
    b = mt.render(scene, spp=2, seed=3, device="cpu", pack=converted)
    np.testing.assert_array_equal(a, b)


def _furnace(bsdf):
    return f"""
<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="-1"/></integrator>
  <sensor type="perspective"><float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0,0,-4" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="64"/></sampler>
    <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="24"/>
      <rfilter type="gaussian"/></film>
  </sensor>
  <shape type="sphere">{bsdf}</shape>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
</scene>"""


FURNACES = {
    "white": ('<bsdf type="diffuse"><rgb name="reflectance" value="1, 1, 1"/></bsdf>',
              (0.985, 1.015)),
    "glass": ('<bsdf type="dielectric"/>', (0.985, 1.015)),
    "rough_glass": ('<bsdf type="roughdielectric"><float name="alpha" value="0.3"/></bsdf>',
                    (0.85, 1.02)),
    "mirror": ('<bsdf type="conductor"><string name="material" value="none"/></bsdf>',
               (1.0 - 1e-6, 1.0 + 1e-6)),
}


@pytest.mark.parametrize("name", sorted(FURNACES))
def test_furnace(name):
    import mitsuba_tpu
    from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string

    bsdf, (lo, hi) = FURNACES[name]
    img = mt.render(mt.load_scene_string(_furnace(bsdf)), seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(_furnace(bsdf)), seed=0), np.float32)
    assert np.isfinite(img).all()
    assert lo <= float(img.mean()) <= hi, float(img.mean())
    assert abs(float(img.mean()) - float(ref.mean())) < 2e-3
    assert _tonemapped_rmse(img, ref) < 5e-3
