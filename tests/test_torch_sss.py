"""The port's subsurface scattering (mitsuba_tpu_torch/scene/subsurface.py,
integrator/sss.py, the builder's subsurface tables and the path loop's
subsurface arm) against the reference (mitsuba_tpu/scene/subsurface.py,
integrator/sss.py), on scenes/dipole.xml (a skimmilk dipole sphere with
irrSamples 32 on a diffuse slab, 1,036 triangles: the pair pipeline).

Tolerances:

* the presets' Fresnel fit and dipole coefficients, and the point sets on
  a sphere and on a mesh: bit for bit (the same float64 host code, the
  same numpy generator);
* the packed tables and meta: equal;
* the irradiance pass: rtol 1e-4, atol 1e-5 at every point (measured
  9.5e-7 abs of E up to 5.9);
* sss_lo on random points: rtol 1e-5, atol 1e-7 (the port sums the
  reference's 128-point steps in its order);
* single_scatter_lo on random surface points: rtol 1e-4, atol 1e-6 on 99 %
  of the lanes (each sample adds three traced rays' last places; a
  connection that grazes the sphere may end on the other side of it);
* the goldens: tests/torch_meshes.py GOLDEN_GATES;
* two renders with one pack: bit for bit, and the pack's sss_E stays 0.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import sss as jsss
from mitsuba_tpu.scene import subsurface as jsub
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.integrator import sss as tsss
from mitsuba_tpu_torch.scene import subsurface as tsub
from mitsuba_tpu_torch.scene.builder import SSS_ARRAYS, SSS_META, pack_scene
from tests.torch_meshes import GOLDEN_GATES, ROOT, dipole_xml, tm_rmse

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dipole():
    xml = dipole_xml(16, 12)
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


@pytest.mark.parametrize("name", sorted(jsub.SSS_PRESETS))
def test_presets_and_coefficients(name):
    """Each preset's Fresnel fit and dipole coefficients, and those of a
    record with g and scale."""
    assert tsub.SSS_PRESETS[name] == jsub.SSS_PRESETS[name]
    sp, sa, eta = tsub.SSS_PRESETS[name]
    for e in (eta, 1.0 / eta):
        assert tsub.fresnel_diffuse_reflectance(e) == jsub.fresnel_diffuse_reflectance(e)
    for g, scale in ((0.0, 1.0), (0.3, 2.5)):
        kw = dict(sigma_s=np.asarray(sp, np.float32), sigma_a=np.asarray(sa, np.float32),
                  g=g, eta=eta, scale=scale)
        got = tsub.SubsurfaceRecord(**kw).dipole_coefficients()
        ref = jsub.SubsurfaceRecord(**kw).dipole_coefficients()
        for a, b in zip(got[:3], ref[:3]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        assert got[3] == ref[3]


SHAPES = {
    "sphere": '<shape type="sphere"><point name="center" x="0.2" y="0.1" z="0"/>'
              '<float name="radius" value="0.8"/>{sss}</shape>',
    # a box whose triangle areas and their sum are exact in float32 (see
    # test_mesh_area_rounding_raises)
    "mesh": '<shape type="cube"><transform name="toWorld"><scale x="0.5" y="0.25" z="1"/>'
            '<translate x="0.5" y="-2" z="1"/></transform>{sss}</shape>',
}


def _sss_scene(shape, sss):
    return (f'<scene version="0.5.0"><sensor type="perspective"/>'
            f'{SHAPES[shape].format(sss=sss)}</scene>')


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cap", [None, 512])
def test_sample_surface_points(shape, cap, monkeypatch):
    """The point set on a sphere and on a mesh, bit for bit; with a cap of
    512 points (MTS_SSS_MAX_POINTS) both report it binding."""
    if cap is not None:
        monkeypatch.setenv("MTS_SSS_MAX_POINTS", str(cap))
    xml = _sss_scene(shape, '<subsurface type="dipole"><string name="material" '
                            'value="ketchup"/><float name="scale" value="4"/></subsurface>')
    ti, ji = mt.load_scene_string(xml).shapes[0], jload_string(xml).shapes[0]
    got = tsub.sample_surface_points(ti.meshes, ti.spheres, ti.subsurface)
    ref = jsub.sample_surface_points(ji.meshes, ji.spheres, ji.subsurface)
    for a, b in zip(got[:2], ref[:2]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got[2:] == ref[2:]
    assert len(got[0]) % 64 == 0 and got[3] == (cap is not None)


def test_mesh_area_rounding_raises():
    """On a mesh whose float32 triangle areas do not sum exactly, the
    reference's point set raises: it draws triangles with probabilities
    area / total in float64 from float32 areas, which numpy's choice finds
    off 1 by more than its 1.5e-8 (ROADMAP C).  The port raises the same
    error there."""
    xml = _sss_scene("mesh", '<subsurface type="dipole"><string name="material" '
                             'value="ketchup"/></subsurface>').replace('y="0.25"', 'y="0.3"')
    ti, ji = mt.load_scene_string(xml).shapes[0], jload_string(xml).shapes[0]
    with pytest.raises(ValueError, match="do not sum to 1"):
        jsub.sample_surface_points(ji.meshes, ji.spheres, ji.subsurface)
    with pytest.raises(ValueError, match="do not sum to 1"):
        tsub.sample_surface_points(ti.meshes, ti.spheres, ti.subsurface)


def test_pack_tables(dipole):
    """dipole.xml's subsurface tables and meta, and its material rows."""
    _, _, tp, jp = dipole
    for k in SSS_ARRAYS + ("mat_type", "mat_cA", "tri_mat", "sph_mat"):
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]), err_msg=k)
    for k in SSS_META:
        assert tp.meta[k] == jp.meta[k], k
    assert tp.meta["sss_irr_samples"] == 32 and tp.sss_p.shape == (640, 3)


def test_material_rows():
    """A subsurface shape gets a row of its own: a copy of a BSDF it shares
    with another shape, and an all-absorbing diffuse where it has none;
    a singlescatter object beside a dipole one."""
    xml = ('<scene version="0.5.0"><sensor type="perspective"/>'
           '<bsdf type="diffuse" id="red"><rgb name="reflectance" value="0.7, 0.1, 0.1"/></bsdf>'
           '<shape type="rectangle"><ref id="red"/></shape>'
           '<shape type="sphere"><ref id="red"/><subsurface type="dipole">'
           '<string name="material" value="marble"/></subsurface></shape>'
           '<shape type="sphere"><point name="center" x="3" y="0" z="0"/>'
           '<subsurface type="singlescatter"><rgb name="sigmaS" value="1, 2, 3"/>'
           '<rgb name="sigmaA" value="0.1, 0.2, 0.3"/><float name="g" value="0.4"/>'
           '<integer name="fastSingleScatterSamples" value="3"/></subsurface></shape>'
           '<shape type="cube"><transform name="toWorld"><translate x="-3"/></transform></shape>'
           '</scene>')
    tp, jp = pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))
    for k in SSS_ARRAYS + ("mat_type", "mat_cA", "tri_mat", "sph_mat"):
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]), err_msg=k)
    for k in SSS_META:
        assert tp.meta[k] == jp.meta[k], k
    mat_sss, cA = tp.mat_sss.numpy(), tp.mat_cA.numpy()
    assert sorted(mat_sss.tolist()) == [-1, -1, 0, 1]
    assert (cA[mat_sss == 1] == 0).all()  # no BSDF: all-absorbing
    np.testing.assert_array_equal(cA[mat_sss == 0], cA[0:1])  # the copy of "red"
    assert tp.meta["sss_has_single"] and tp.meta["sss_has_dipole"]


def test_irradiance():
    """The irradiance pass: direct NEE and the indirect path trace, E at
    all 640 points (8 rays a point)."""
    xml = dipole_xml(16, 12, irr_samples=8)
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    tp, jp = pack_scene(ts, "cpu"), jpack_scene(js)
    got = tsss.compute_sss_irradiance(tp, ts.integrator, 3).numpy()
    ref = np.asarray(jax.jit(lambda pk: jsss.compute_sss_irradiance(pk, js.integrator, 3))(jp))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert (ref > 0).mean() > 0.5


def _random_sphere_points(n, seed, center, radius):
    r = np.random.default_rng(seed)
    nrm = r.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    p = (np.asarray(center) + radius * nrm).astype(np.float32)
    return p, nrm.astype(np.float32), r


def test_sss_lo(dipole):
    """The dense dipole sum on 300 random points about the sphere (sid 0,
    and -1 on a few lanes) with E from the irradiance pass."""
    ts, js, tp, jp = dipole
    e = np.random.default_rng(5).uniform(0, 4, (640, 3)).astype(np.float32)
    tp = type(tp)({**tp.arrays, "sss_E": torch.tensor(e)}, tp.meta)
    jp = type(jp)({**jp.arrays, "sss_E": jnp.asarray(e)}, jp.meta)
    p, _, r = _random_sphere_points(300, 6, (0, 0, 0), 1.0)
    p = (p * r.uniform(0.98, 1.02, (300, 1))).astype(np.float32)
    cos_o = r.uniform(-0.2, 1.0, 300).astype(np.float32)
    sid = np.where(r.uniform(size=300) < 0.1, -1, 0).astype(np.int32)
    got = tsss.sss_lo(tp, torch.tensor(p), torch.tensor(cos_o), torch.tensor(sid)).numpy()
    ref = np.asarray(jsss.sss_lo(jp, jnp.asarray(p), jnp.asarray(cos_o), jnp.asarray(sid)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert (ref > 0).mean() > 0.8


@pytest.mark.parametrize("per_lane_depth", [False, True])
def test_single_scatter_lo(per_lane_depth):
    """single_scatter_lo on 256 random points of the singlescatter sphere,
    seen from random directions: at depth 1 with its 4 internal segments,
    and at a depth per lane with 2 segments of 3 samples."""
    props = ('<integer name="singleScatterDepth" value="2"/>'
             '<integer name="fastSingleScatterSamples" value="3"/>') if per_lane_depth else ""
    xml = dipole_xml(16, 12, "singlescatter", props)
    tp = pack_scene(mt.load_scene_string(xml), "cpu")
    jp = jpack_scene(jload_string(xml))
    n = 256
    p, ng, r = _random_sphere_points(n, 7, (0, 0, 0), 1.0)
    d_in = -ng + 0.8 * r.normal(size=(n, 3))
    d_in = (d_in / np.linalg.norm(d_in, axis=-1, keepdims=True)).astype(np.float32)
    sid = np.where(r.uniform(size=n) < 0.1, -1, 0).astype(np.int32)
    lane = r.integers(0, 1 << 20, n).astype(np.uint32)
    sidx = r.integers(0, 64, n).astype(np.uint32)
    depth = r.integers(0, 4, n).astype(np.int32) if per_lane_depth else 1
    got = tsss.single_scatter_lo(
        tp, torch.tensor(p), torch.tensor(d_in), torch.tensor(ng), torch.tensor(sid),
        torch.tensor(lane.astype(np.int64)), torch.tensor(sidx.astype(np.int64)),
        torch.tensor(depth) if per_lane_depth else depth, 2).numpy()
    ref = np.asarray(jax.jit(
        lambda *a: jsss.single_scatter_lo(jp, *a, jnp.asarray(depth), 2)
    )(jnp.asarray(p), jnp.asarray(d_in), jnp.asarray(ng), jnp.asarray(sid), jnp.asarray(lane),
      jnp.asarray(sidx)))
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() > 0.99, close.mean()
    assert (ref.max(-1) > 0).mean() > 0.3 and (got[sid < 0] == 0).all()


def test_two_renders_one_pack():
    """render fills sss_E in a copy of the pack it is given: two renders
    with one pack give the same image, and the pack keeps its zeros (the
    direct term only, 8 rays a point)."""
    ts = mt.load_scene_string(dipole_xml(
        16, 12, props='<boolean name="irrIndirect" value="false"/>', irr_samples=8))
    tp = pack_scene(ts, "cpu")
    a = mt.render(ts, spp=1, seed=0, device="cpu", pack=tp)
    b = mt.render(ts, spp=1, seed=0, device="cpu", pack=tp)
    np.testing.assert_array_equal(a, b)
    assert (tp.sss_E == 0).all() and a.mean() > 0


@pytest.mark.parametrize("name,kind", [("torch_dipole_32_4.npy", "dipole"),
                                       ("torch_singlescatter_32_4.npy", "singlescatter")])
def test_meets_golden(name, kind):
    """scenes/dipole.xml as it stands (and with singlescatter) at 32x24, 4
    spp, seed 0, through `render`, against the reference's render."""
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(dipole_xml(32, 24, kind)), spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape == (24, 32, 3) and np.isfinite(out).all()
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
