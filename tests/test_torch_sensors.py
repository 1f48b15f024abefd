"""The port's sensors (mitsuba_tpu_torch/sensor/plugins.py, the nested
sensor of scene/xml_loader.py) against the reference
(mitsuba_tpu/sensor/plugins.py, scene/xml_loader.py), on inputs made from
seeds with numpy, the meters' constant-environment closures of
tests/test_sensors.py, and the sensor gallery's renders against the JAX
package's goldens.

Tolerances (measured on these inputs):

* SensorRecord.pack and _pack_irr: equal (the same float64 host code,
  rounded to float32 as the reference packs it);
* the field of view, the rdist `kc` parsing and the nested sensor's
  attachment: equal;
* generate_rays, every kind: origins and directions within atol 2e-6
  (measured: at most 1.2e-6 on the irradiancemeter's cosine-weighted
  directions, whose frame (coordinate_system) and concentric disk carry
  the last places of a division and of sin/cos; 1.8e-7 elsewhere, the
  camera matrix product and rsqrt, which XLA and torch round otherwise);
* the meters in a unit constant environment: 1 within rtol 1e-5
  (fluence, radiance) and pi within rtol 1e-3 (irradiance), the
  reference's own tolerances (tests/test_sensors.py:146-194), and the
  reference's render within rtol 1e-6;
* the goldens: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.renderer import render as jrender
from mitsuba_tpu.sensor import plugins as jsen
from mitsuba_tpu.scene.properties import Properties as JProperties
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.scene.properties import Properties
from mitsuba_tpu_torch.sensor import plugins as tsen
from tests.torch_meshes import (
    GOLDEN_GATES,
    METERS,
    ROOT,
    SENSOR_GALLERY,
    meter_xml,
    sensor_xml,
    tm_rmse,
)

torch.set_num_threads(1)

N = 4096
ATOL = 2e-6
# every kind: a gallery camera, or a meter
KINDS = {**{name: sensor_xml(name) for name in SENSOR_GALLERY},
         "telecentric_pinhole": sensor_xml("telecentric").replace(
             '<float name="apertureRadius" value="0.4"/>', ""),
         **{name: meter_xml(body) for name, (body, _) in METERS.items()}}


def _both(xml):
    return mt.load_scene_string(xml), jload_string(xml)


def _cams(name, width=24, height=24):
    ts, js = _both(KINDS[name])
    return (ts.sensor.record.pack(width, height, torch.device("cpu")),
            js.sensor.record.pack(width, height))


@pytest.mark.parametrize("name", sorted(KINDS))
def test_pack_equal(name):
    """Every key of the packed camera, the irradiancemeter's tables
    included."""
    got, ref = _cams(name, 32, 20)
    assert set(got) == set(ref)
    for k, v in ref.items():
        g = got[k]
        if torch.is_tensor(g):
            assert g.dtype == torch.float32, k
            np.testing.assert_array_equal(g.numpy(), np.asarray(v), err_msg=k)
        elif isinstance(v, (str, bool, int, tuple)):
            assert g == v, k
        else:  # a float32 scalar
            assert np.float32(g) == np.asarray(v), k


@pytest.mark.parametrize("name", sorted(KINDS))
def test_generate_rays(name):
    """Origins and directions on seeded film positions and lens samples."""
    got_cam, ref_cam = _cams(name)
    rng = np.random.default_rng(7)
    pos01 = rng.random((N, 2), dtype=np.float32)
    u_lens = rng.random((N, 2), dtype=np.float32)
    o, d = tsen.generate_rays(got_cam, torch.as_tensor(pos01), torch.as_tensor(u_lens))
    o_ref, d_ref = jsen.generate_rays(ref_cam, jnp.asarray(pos01), jnp.asarray(u_lens))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=ATOL)
    # the lens draw moves the rays exactly where the reference reads it
    assert got_cam["use_lens"] == (name in ("thinlens", "telecentric")
                                   or name.startswith("irradiancemeter"))


@pytest.mark.parametrize("props,aspect", [
    ({"fov": 45.0}, 1.5),
    ({"fov": 45.0, "fovAxis": "y"}, 1.5),
    ({"fov": 45.0, "fovAxis": "diagonal"}, 0.75),
    ({"fov": 30.0, "fovAxis": "smaller"}, 1.5),
    ({"fov": 30.0, "fovAxis": "smaller"}, 0.75),
    ({"fov": 30.0, "fovAxis": "larger"}, 0.75),
    ({"focalLength": 35.0}, 1.5),
])
def test_fov_resolution(props, aspect):
    tp, jp = Properties(), JProperties()
    for k, v in props.items():
        tp.set(k, v)
        jp.set(k, v)
    assert tsen._resolve_xfov(tp, aspect) == jsen._resolve_xfov(jp, aspect)


@pytest.mark.parametrize("kc", ["-0.3, 0.05", "0.1", "0.2 -0.01", ""])
def test_rdist_kc(kc):
    """perspective_rdist's `kc`: commas or spaces, missing terms 0."""
    xml = KINDS["rdist"].replace('value="-0.3, 0.05"', f'value="{kc}"')
    ts, js = _both(xml)
    assert ts.sensor.record.kc == js.sensor.record.kc
    assert len(ts.sensor.record.kc) == 2


def test_nested_sensor_attached():
    """A sensor nested in a shape becomes the scene's sensor, with the
    shape as its parent (reference xml_loader.py:326-337)."""
    for name in ("irradiancemeter_sphere", "irradiancemeter_mesh"):
        ts, js = _both(KINDS[name])
        rec = ts.sensor.record
        assert rec.kind == tsen.IRRADIANCEMETER == js.sensor.record.kind
        assert rec.parent_shape is ts.shapes[0]
        assert (rec.film.width, rec.film.height) == (1, 1)
        assert rec.sampler.sample_count == js.sensor.record.sampler.sample_count == 64
        assert rec.ray_weight == js.sensor.record.ray_weight == float(np.pi)


@pytest.mark.parametrize("name", sorted(METERS))
def test_meter_closures(name):
    """In a unit constant environment the meters are zero-variance
    estimators: 1 and pi (tests/test_sensors.py:146-194), as the
    reference renders them."""
    body, exact = METERS[name]
    got = mt.render(mt.load_scene_string(meter_xml(body)), seed=3, device="cpu")
    assert got.shape == (1, 1, 3)
    np.testing.assert_allclose(got, exact, rtol=1e-5 if exact == 1.0 else 1e-3)
    ref = np.asarray(jrender(jload_string(meter_xml(body)), seed=3))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_irradiancemeter_refusals():
    """`toWorld` on an irradiancemeter, and one without a parent shape,
    raise ValueError as the reference's do."""
    film = METERS["fluencemeter"][0].split("</transform>")[1].replace("</sensor>", "")
    with pytest.raises(ValueError, match="toWorld"):
        mt.load_scene_string(meter_xml(
            '<shape type="sphere"><sensor type="irradiancemeter"><transform name="toWorld">'
            f'<translate x="1"/></transform>{film}</sensor></shape>'))
    scene = mt.load_scene_string(meter_xml(f'<sensor type="irradiancemeter">{film}</sensor>'))
    with pytest.raises(ValueError, match="attached to a shape"):
        mt.render(scene, seed=1, device="cpu")


def test_shutter_refused():
    """A sensor whose shutter opens, refused before the motion slice was
    ported, loads; its interval reaches the pack's meta as in the
    reference (which draws a lane's time in [0, 1] whatever the interval:
    ROADMAP C6, tests/test_torch_motion.py)."""
    from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
    from mitsuba_tpu_torch.scene.builder import pack_scene

    xml = KINDS["thinlens"].replace(
        "<sampler", '<float name="shutterOpen" value="0"/><float name="shutterClose" '
        'value="0.5"/><sampler', 1)
    scene = mt.load_scene_string(xml)
    assert (scene.sensor.record.shutter_open, scene.sensor.record.shutter_close) == (0.0, 0.5)
    tp = pack_scene(scene, "cpu")
    jp = jpack_scene(jload_string(xml))
    for k in ("shutter_open", "shutter_close"):
        assert tp.meta[k] == jp.meta[k], k


@pytest.mark.parametrize("name", [n for n in SENSOR_GALLERY if n != "perspective"])
def test_sensor_goldens(name):
    """tests/test_sensors.py's checkerboard under each camera at 24x24, 4
    spp, seed 0, against the JAX package's render
    (tests/make_torch_bigmesh_golden.py)."""
    golden = f"torch_sensor_{name}_24_4.npy"
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(mt.load_scene_string(sensor_xml(name)), spp=4, seed=0, device="cpu")
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden], tm_rmse(img, ref)


def test_sensor_plugins_registered():
    """Every sensor plugin of the reference is registered in the port."""
    from mitsuba_tpu.scene import registry as jreg
    from mitsuba_tpu_torch.scene import registry as treg

    assert treg.names("sensor") == jreg.names("sensor")
