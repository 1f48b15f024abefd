"""The port's daylight emitters (mitsuba_tpu_torch/emitter/sky.py and the
`sky`, `sunsky` and `sun` plugins of emitter/plugins.py) against the
reference (mitsuba_tpu/emitter/sky.py, emitter/plugins.py), and the
daylight scenes' renders against the JAX package's goldens.

Tolerances: the solar position, the sun's irradiance, the Hosek
configuration, both baked skies and the plugins' records are equal, and
so are the pack's env tables of a baked sky (the same float64 numpy code
in both packages, the port reading its own copy of hosek_rgb.npz); the
goldens at tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import numpy as np
import pytest

import mitsuba_tpu_torch as mt
from mitsuba_tpu.emitter import sky as jsky
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.emitter import sky as tsky
from mitsuba_tpu_torch.emitter.plugins import DIRECTIONAL, ENVMAP
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import GOLDEN_GATES, ROOT, daylight_xml, sky_sun_xml, tm_rmse

ENV_ARRAYS = ("env_image", "env_to_world", "env_to_local", "env_density", "env_alias_prob",
              "env_alias_idx", "env_alias_fused", "em_rgb", "em_dir", "emitter_pmf",
              "emitter_cdf")
# (year, month, day, hour, latitude, longitude, timezone)
TIMES = [(2010, 7, 10, 15.0, 35.6894, 139.6917, 9.0), (2021, 1, 3, 9.5, -33.9, 18.4, 2.0),
         (2000, 12, 21, 12.0, 64.1, -21.9, 0.0), (1999, 3, 20, 18.25, 0.0, 0.0, 0.0)]
SUN_DIRS = [(0.4, 0.6, -0.5), (-0.5, 0.35, -0.6), (0.1, 0.98, 0.1), (0.3, 0.02, 0.9),
            (0.2, -0.3, 0.9)]


def _unit(d):
    d = np.asarray(d, np.float64)
    return d / np.linalg.norm(d)


@pytest.mark.parametrize("when", TIMES)
def test_sun_direction_from_time(when):
    np.testing.assert_array_equal(tsky.sun_direction_from_time(*when),
                                  jsky.sun_direction_from_time(*when))


@pytest.mark.parametrize("cos_t", [1.0, 0.6, 0.05, 0.0, -0.2])
@pytest.mark.parametrize("turbidity", [2.0, 3.0, 7.5])
def test_sun_irradiance_rgb(cos_t, turbidity):
    np.testing.assert_array_equal(tsky.sun_irradiance_rgb(cos_t, turbidity),
                                  jsky.sun_irradiance_rgb(cos_t, turbidity))


@pytest.mark.parametrize("turbidity,albedo,elevation", [
    (3.0, 0.15, 0.6435), (1.0, 0.0, 0.0), (10.0, 1.0, 1.5707963), (4.7, 0.3, 0.2),
    (2.2, 0.5, -0.1)])
def test_hosek_config(turbidity, albedo, elevation):
    for got, ref in zip(tsky._hosek_config(turbidity, albedo, elevation),
                        jsky._hosek_config(turbidity, albedo, elevation)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("model", ["hosek", "preetham"])
@pytest.mark.parametrize("with_sun", [False, True])
@pytest.mark.parametrize("sun", SUN_DIRS)
def test_sky_images(model, with_sun, sun):
    """Both bakes at 32 x 64, with and without the solar disk, the sun
    high, low, grazing and below the horizon."""
    fn = f"{model}_sky_image"
    kw = dict(resolution=32, sky_scale=1.3, sun_scale=0.7, with_sun=with_sun, ground_albedo=0.2)
    got = getattr(tsky, fn)(3.5, _unit(sun), **kw)
    ref = getattr(jsky, fn)(3.5, _unit(sun), **kw)
    assert got.dtype == np.float32 and got.shape == (32, 64, 3)
    np.testing.assert_array_equal(got, ref)
    assert np.isfinite(got).all()


def _emitter_xml(body):
    return ('<scene version="0.5.0"><sensor type="perspective"/>'
            f'{body}</scene>')


PLUGINS = {
    "sky": '<emitter type="sky"><vector name="sunDirection" x="0.3" y="0.7" z="0.2"/>'
           '<integer name="resolution" value="64"/></emitter>',
    "sky_preetham": '<emitter type="sky"><string name="model" value="preetham"/>'
                    '<float name="turbidity" value="5"/><float name="hour" value="10"/>'
                    '<integer name="resolution" value="64"/></emitter>',
    "sunsky": '<emitter type="sunsky"><vector name="sunDirection" x="0.4" y="0.6" z="-0.5"/>'
              '<float name="scale" value="2"/><rgb name="groundAlbedo" value="0.1, 0.2, 0.3"/>'
              '<integer name="resolution" value="64"/></emitter>',
    "sun": '<emitter type="sun"><float name="turbidity" value="4"/>'
           '<float name="sunScale" value="0.5"/><float name="samplingWeight" value="2"/></emitter>',
    "sun_dir": '<emitter type="sun"><vector name="sunDirection" x="-0.5" y="0.35" z="-0.6"/>'
               '</emitter>',
}


@pytest.mark.parametrize("name", sorted(PLUGINS))
def test_plugin_records(name):
    """The three plugins' records: sky and sunsky an envmap record with
    the baked image, sun a directional one."""
    xml = _emitter_xml(PLUGINS[name])
    got, ref = mt.load_scene_string(xml).emitters[0], jload_string(xml).emitters[0]
    assert got.kind == ref.kind == (DIRECTIONAL if name.startswith("sun_") or name == "sun"
                                    else ENVMAP)
    for k in ("radiance", "irradiance", "direction", "env_image"):
        a, b = getattr(got, k), getattr(ref, k)
        if b is None:
            assert a is None, k
        else:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(got.to_world.m, ref.to_world.m)
    assert (got.scale, got.sampling_weight) == (ref.scale, ref.sampling_weight)


@pytest.mark.parametrize("make", [daylight_xml, sky_sun_xml])
def test_pack_env_tables(make):
    """The pack's environment tables (the baked image, its alias table
    and density) and the emitter rows of a daylight scene."""
    xml = make(16, 16)
    tp, jp = pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))
    for k in ENV_ARRAYS:
        out, ref = tp.arrays[k].numpy(), np.asarray(jp.arrays[k])
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)
    for k in ("has_env", "has_envmap", "env_idx", "env_alias_fused_ok", "emitter_kinds"):
        assert tp.meta[k] == jp.meta[k], k


@pytest.mark.parametrize("golden,make", [("torch_daylight_32_4.npy", daylight_xml),
                                         ("torch_sky_sun_32_4.npy", sky_sun_xml)])
def test_daylight_goldens(golden, make):
    """DAYLIGHT (a sunsky through a thinlens camera, sobol) and the
    Preetham sky with a separate sun, 32x32, 4 spp, seed 0, against the
    JAX package's renders (tests/make_torch_bigmesh_golden.py)."""
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(mt.load_scene_string(make(32, 32)), spp=4, seed=0, device="cpu")
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden], tm_rmse(img, ref)


def test_emitter_plugins_registered():
    """Every emitter plugin of the reference is registered in the port."""
    from mitsuba_tpu.scene import registry as jreg
    from mitsuba_tpu_torch.scene import registry as treg

    assert treg.names("emitter") == jreg.names("emitter")
