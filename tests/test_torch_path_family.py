"""The rest of the port's path family (mitsuba_tpu_torch/integrator/path.py
ao_trace, field_trace, the `depth` plugin, and the path options
hideEmitters and strictNormals) against the reference
(mitsuba_tpu/integrator/path.py), on scenes/cbox.xml, on the matpreview
variant (tests/torch_meshes.py matpreview_const_xml: analytic spheres,
rough materials, a constant environment) and, for strictNormals, on cbox
with a panel whose vertex normals lean 75 degrees off its faces' normal.

Tolerances:

* ao_trace fed the same rays: the same visibility on all but 1 lane in 200
  (measured: every lane of 4,096); the ao golden: GOLDEN_GATES (lanes that
  flip in the renders, see there);
* every field, rendered: rtol 1e-5, atol 1e-4 of the field's largest
  magnitude (positions and distances of ~1,000 carry an ulp of 6e-5,
  measured 3.5e-7 relative; near a sphere's silhouette the hit's
  quadratic is ill-conditioned, and the variant's normals there move by
  up to 2.2e-5, measured);
* hideEmitters and strictNormals, rendered at 24x24, 4 spp: the
  tone-mapped RMSE under 5e-3, tests/test_golden.py's gate (cbox's paths
  diverge on a last place, ROADMAP C: 1.8e-3 with either option, as
  without; the matpreview variant 1.9e-6), and the option's own effect
  (hidden emitters black, lanes that strictNormals ends) equal in both.
  On the panel, whose leaning normals send bounces back into it at
  grazing angles, paths diverge more (6.9e-3 without the option, 6.6e-3
  with it, measured): there the gate is 1.5 times the scene's own
  agreement without the option;
* path_trace with either option fed the same rays: rtol 1e-4, atol 1e-6
  on 99 % of the lanes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import path as jpath
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    cbox_xml,
    matpreview_const_xml,
    tm_rmse,
    with_integrator,
    with_properties,
    write_ply,
)

torch.set_num_threads(1)

W = 24
# every field name the reference's field_trace reads
FIELD_NAMES = ("position", "relPosition", "distance", "geoNormal", "shNormal", "normal", "uv",
               "albedo", "primIndex", "emission")
SCENES = {
    "cbox": lambda kind: cbox_xml(kind, W, W),
    "matpreview": lambda kind: with_integrator(matpreview_const_xml(W, W), kind),
}


@pytest.fixture(scope="module")
def panel_xml(tmp_path_factory):
    """scenes/cbox.xml with a 4 x 4-vertex panel across the box, facing the
    camera, whose vertex normals lean 75 degrees off its normal toward
    seeded azimuths: between them and its faces' normal lies a wide band
    of directions that strictNormals refuses."""
    r = np.random.default_rng(3)
    gx, gy = np.meshgrid(np.linspace(120, 440, 4), np.linspace(80, 400, 4))
    pos = np.stack([gx.ravel(), gy.ravel(), np.full(16, 300.0)], -1).astype(np.float32)
    phi = r.uniform(0, 2 * np.pi, 16)
    lean = np.deg2rad(75.0)
    nrm = np.stack([np.sin(lean) * np.cos(phi), np.sin(lean) * np.sin(phi),
                    np.full(16, -np.cos(lean))], -1).astype(np.float32)
    idx = [[4 * i + j, 4 * i + j + 1, 4 * i + j + 5] for i in range(3) for j in range(3)]
    idx += [[4 * i + j, 4 * i + j + 5, 4 * i + j + 4] for i in range(3) for j in range(3)]
    path = str(tmp_path_factory.mktemp("panel") / "panel.ply")
    write_ply(path, pos, np.asarray(idx, np.int32), normals=nrm)
    shape = (f'<shape type="ply"><string name="filename" value="{path}"/>'
             '<bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.6, 0.3"/></bsdf></shape>')
    return SCENES["cbox"]("path").replace("</scene>", shape + "</scene>")


def _renders(xml, spp=4):
    out = mt.render(mt.load_scene_string(xml), spp=spp, seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=spp, seed=0))
    assert out.shape == ref.shape and np.isfinite(out).all()
    return out, ref


def _cbox_rays(n, seed):
    """n rays from cbox's camera position: half toward random points of the
    box, half toward its light."""
    r = np.random.default_rng(seed)
    o = np.tile(np.array([[278.0, 273.0, -800.0]], np.float32), (n, 1))
    d = np.concatenate([r.uniform([0, 0, 0], [556, 548, 560], (n - n // 2, 3)),
                        r.uniform([213, 548, 227], [343, 548, 332], (n // 2, 3))]) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("ray_length", [None, "100"])
def test_ao_trace(ray_length):
    """Ambient occlusion of 4,096 cbox rays, with the default length (1e7)
    and with rayLength 100."""
    xml = SCENES["cbox"]("ao")
    if ray_length:
        xml = with_properties(xml, f'<float name="rayLength" value="{ray_length}"/>')
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    tp, jp = pack_scene(ts, "cpu"), jpack_scene(js)
    n = 4096
    o, d = _cbox_rays(n, 1)
    lane = np.arange(n, dtype=np.uint32)
    sidx = np.full(n, 3, np.uint32)
    got = tpath.ao_trace(tp, ts.integrator, torch.tensor(o), torch.tensor(d),
                         torch.tensor(lane.astype(np.int64)), torch.tensor(sidx.astype(np.int64)),
                         None, 5).numpy()
    ref = np.asarray(jpath.ao_trace(jp, js.integrator, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(lane), jnp.asarray(sidx), None, 5))
    assert (got[:, 0] != ref[:, 0]).mean() <= 0.005
    assert (got == got[:, :1]).all() and 0.05 < got.mean() < 0.95
    assert int(tpath.ao_trace.last_ray_count) == 2 * n


def test_ao_meets_golden():
    """cbox under ao at 24x24, 4 spp, through `render` (the batched
    wavefront and the gaussian splat)."""
    name = "torch_cbox_ao_24_4.npy"
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(SCENES["cbox"]("ao")), spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)


def test_field_meets_golden():
    """cbox's uv field at 24x24, 4 spp, through `render`."""
    name = "torch_cbox_field_uv_24_4.npy"
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    xml = with_properties(SCENES["cbox"]("field"), '<string name="field" value="uv"/>')
    out = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("field", FIELD_NAMES)
def test_field(scene, field):
    """Each field, rendered at 24x24, 2 spp."""
    xml = with_properties(SCENES[scene]("field"), f'<string name="field" value="{field}"/>')
    out, ref = _renders(xml, spp=2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4 * max(np.abs(ref).max(), 1e-3))
    if field not in ("emission", "primIndex") or scene == "cbox":
        assert np.abs(ref).max() > 0


def test_depth_is_the_distance_field():
    """The `depth` plugin is `field` on distance."""
    depth = mt.load_scene_string(SCENES["cbox"]("depth")).integrator
    assert (depth.kind, depth.field_name) == ("field", "distance")
    out, ref = _renders(SCENES["cbox"]("depth"), spp=2)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    dist = mt.render(mt.load_scene_string(with_properties(
        SCENES["cbox"]("field"), '<string name="field" value="distance"/>')), spp=2, seed=0,
        device="cpu")
    np.testing.assert_array_equal(out, dist)


def test_unknown_field_raises():
    xml = with_properties(SCENES["cbox"]("field"), '<string name="field" value="curl"/>')
    with pytest.raises(ValueError, match="unknown field"):
        mt.render(mt.load_scene_string(xml), spp=1, device="cpu")


def test_ao_shading_samples_refused():
    """The reference's ao_trace casts one ray a lane and reads no
    shadingSamples: another value is refused by name."""
    xml = with_properties(SCENES["cbox"]("ao"), '<integer name="shadingSamples" value="4"/>')
    with pytest.raises(NotImplementedError, match="shadingSamples"):
        mt.load_scene_string(xml)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_hide_emitters(scene):
    """hideEmitters: the emitters (cbox's light, the variant's environment)
    are black where the camera sees them, and light the scene as before."""
    xml = with_properties(SCENES[scene]("path"), '<boolean name="hideEmitters" value="true"/>')
    out, ref = _renders(xml)
    assert tm_rmse(out, ref) < 5e-3, tm_rmse(out, ref)
    shown = mt.render(mt.load_scene_string(SCENES[scene]("path")), spp=4, seed=0, device="cpu")
    hidden = (shown.max(-1) > 2.0) if scene == "cbox" else (shown.min(-1) > 0.999)
    assert hidden.sum() > 4
    assert (out[hidden].max(-1) < 0.5).all() and (ref[hidden].max(-1) < 0.5).all()


@pytest.mark.parametrize("scene", ["cbox_panel", "matpreview"])
def test_strict_normals(scene, panel_xml):
    """strictNormals on the panel's leaning normals and on the variant."""
    base = panel_xml if scene == "cbox_panel" else SCENES["matpreview"]("path")
    xml = with_properties(base, '<boolean name="strictNormals" value="true"/>')
    out, ref = _renders(xml)
    gate = 5e-3
    if scene == "cbox_panel":
        loose, loose_ref = _renders(base)
        gate = max(gate, 1.5 * tm_rmse(loose, loose_ref))
        # the option ends paths on the panel in both (lane for lane:
        # test_options_lane_for_lane)
        assert tm_rmse(out, loose) > 1e-3 and tm_rmse(ref, loose_ref) > 1e-3
    assert tm_rmse(out, ref) < gate, (tm_rmse(out, ref), gate)


@pytest.mark.parametrize("option", ["hide_emitters", "strict_normals"])
def test_options_lane_for_lane(option, panel_xml):
    """path_trace with each option on 2,048 rays of the cbox with the
    panel, fed the same rays: rtol 1e-4, atol 1e-6 on 99 % of lanes."""
    ts, js = mt.load_scene_string(panel_xml), jload_string(panel_xml)
    setattr(ts.integrator, option, True)
    setattr(js.integrator, option, True)
    tp, jp = pack_scene(ts, "cpu"), jpack_scene(js)
    n = 2048
    o, d = _cbox_rays(n, 2)
    lane = np.arange(n, dtype=np.uint32)
    sidx = np.zeros(n, np.uint32)
    got = tpath.path_trace(tp, ts.integrator, torch.tensor(o), torch.tensor(d),
                           torch.tensor(lane.astype(np.int64)),
                           torch.tensor(sidx.astype(np.int64)), None, 0).numpy()
    ref = np.asarray(jax.jit(lambda *a: jpath.path_trace(jp, js.integrator, *a, None, 0))(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lane), jnp.asarray(sidx)))
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() > 0.99, close.mean()
    loose = tpath.path_trace(tp, dataclasses.replace(ts.integrator, **{option: False}),
                             torch.tensor(o), torch.tensor(d), torch.tensor(lane.astype(np.int64)),
                             torch.tensor(sidx.astype(np.int64)), None, 0).numpy()
    assert (np.abs(loose - got).max(-1) > 1e-3).mean() > 0.02  # the option acts
