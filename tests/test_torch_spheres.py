"""The port's analytic spheres against the reference: `intersect`,
`occluded` and `fill_interaction` on the matpreview variant (two
triangles and three spheres; the triangles through the plain K1/K2, the
reference's through its XLA brute force), on a scene of spheres alone,
on spheres that tie, and on two scenes with more triangles than spheres
(tests/torch_meshes.py `EMISSIVE_SPHERE_XML`, whose tessellated emitter
takes the BVH path, and `cbox_sphere_xml`), which the port also renders
against the JAX package.

Tolerances: valid, prim, is_sphere, occlusion, material and emitter ids
equal; t at rtol 1e-5; hit points, normals and uv at rtol = atol = 1e-5
(uv on a sphere comes from arccos and arctan2 of the normal); renders at
the gate of tests/test_golden.py, tone-mapped RMSE < 5e-3, with the
means within 2e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.torch_meshes import EMISSIVE_SPHERE_XML, cbox_sphere_xml, matpreview_const_xml

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

SPHERES_ONLY = """
<scene version="0.5.0">
  <sensor type="perspective"/>
  <shape type="sphere"><float name="radius" value="0.5"/>
    <bsdf type="roughconductor"/></shape>
  <shape type="sphere"><point name="center" x="1.2" y="0" z="0"/><float name="radius" value="0.5"/>
    <boolean name="flipNormals" value="true"/></shape>
  <shape type="sphere"><transform name="toWorld"><scale value="0.3"/><translate x="-1" y="0.5"/>
    </transform><bsdf type="dielectric"/></shape>
  <shape type="sphere"><point name="center" x="0" y="2" z="0"/><float name="radius" value="0.2"/></shape>
  <shape type="sphere"><point name="center" x="0" y="2" z="0"/><float name="radius" value="0.2"/>
    <bsdf type="plastic"/></shape>
  <emitter type="constant"/>
</scene>
"""


def _packs(xml):
    return jpack_scene(jload_string(xml)), pack_scene(load_scene_string(xml), "cpu")


def _rays(n, lo, hi, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(scene_xml, size):
    """One ray through each pixel centre of the reference's sensor."""
    from mitsuba_tpu.sensor.plugins import generate_rays

    rec = jload_string(scene_xml).sensor.record
    cam = rec.pack(size, size)
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    pos = np.stack([(xs.ravel() + 0.5) / size, (ys.ravel() + 0.5) / size], -1).astype(np.float32)
    o, d = generate_rays(cam, jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)))
    return np.array(o), np.array(d)


def _check_closest(jp, tp, o, d):
    ref = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d))
    out = tis.intersect(tp, torch.as_tensor(o), torch.as_tensor(d))
    for k in ("valid", "prim", "is_sphere"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)
    hit = np.asarray(ref.valid)
    np.testing.assert_allclose(out.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-5)
    j_its = jis.fill_interaction(jp, jnp.asarray(o), jnp.asarray(d), ref)
    t_its = tis.fill_interaction(tp, torch.as_tensor(o), torch.as_tensor(d), out)
    for k in ("mat", "emit"):
        np.testing.assert_array_equal(getattr(t_its, k).numpy()[hit],
                                      np.asarray(getattr(j_its, k))[hit], err_msg=k)
    for k in ("p", "ng", "ns", "uv"):
        np.testing.assert_allclose(getattr(t_its, k).numpy()[hit],
                                   np.asarray(getattr(j_its, k))[hit], **TOL, err_msg=k)
    return out


def _check_occluded(jp, tp, o, d, t_max):
    ref = np.asarray(jis.occluded(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    out = tis.occluded(tp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    np.testing.assert_array_equal(out.numpy(), ref)
    return out


@pytest.fixture(scope="module")
def matpreview():
    return _packs(matpreview_const_xml(16, 16))


def test_matpreview_camera_rays(matpreview):
    jp, tp = matpreview
    o, d = _camera_rays(matpreview_const_xml(32, 32), 32)
    out = _check_closest(jp, tp, o, d)
    # the view holds the three spheres and the ground
    assert out.is_sphere.any() and (out.valid & ~out.is_sphere).any()
    assert set(out.prim[out.is_sphere].tolist()) == {0, 1, 2}


def test_matpreview_random_rays(matpreview):
    jp, tp = matpreview
    o, d = _rays(4000, [-2.5, 0.01, -1.5], [2.5, 1.5, 1.5], 1)
    out = _check_closest(jp, tp, o, d)
    assert out.is_sphere.float().mean() > 0.2
    t_max = np.random.default_rng(2).uniform(0.05, 3.0, len(o)).astype(np.float32)
    occ = _check_occluded(jp, tp, o, d, t_max)
    assert 0.1 < occ.float().mean() < 0.9


def test_spheres_without_triangles():
    jp, tp = _packs(SPHERES_ONLY)
    assert tp.meta["n_tris"] == 0 and tp.meta["n_spheres"] == 5
    o, d = _rays(4000, [-2, -1, -2], [2, 3, 2], 3)
    out = _check_closest(jp, tp, o, d)
    assert out.valid.any() and bool((out.is_sphere == out.valid).all())
    _check_occluded(jp, tp, o, d, np.full(len(o), 1.0, np.float32))


def test_sphere_ties_keep_the_first():
    """Spheres 3 and 4 coincide: every hit on them reports sphere 3, as
    jnp.argmin keeps the first index."""
    jp, tp = _packs(SPHERES_ONLY)
    o = np.tile(np.array([[0.0, 2.0, -3.0]], np.float32), (64, 1))
    d = np.random.default_rng(4).normal([0, 0, 1], 0.01, (64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out = _check_closest(jp, tp, o, d)
    assert out.valid.all() and bool((out.prim == 3).all())


def test_flipped_sphere_normals_point_inward():
    jp, tp = _packs(SPHERES_ONLY)
    o = np.array([[1.2, 0.0, -3.0], [0.0, 0.0, -3.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    out = _check_closest(jp, tp, o, d)
    its = tis.fill_interaction(tp, torch.as_tensor(o), torch.as_tensor(d), out)
    assert its.ns[0, 2] > 0.99 and its.ns[1, 2] < -0.99


MIXED = {"emissive_sphere": EMISSIVE_SPHERE_XML, "cbox_sphere": cbox_sphere_xml(16, 16)}


@pytest.fixture(scope="module", params=sorted(MIXED))
def mixed(request):
    xml = MIXED[request.param]
    return xml, _packs(xml)


def test_spheres_beside_more_triangles(mixed):
    """Triangle ids past the sphere tables and sphere ids beside them: each
    lane reads only its own kind's tables."""
    xml, (jp, tp) = mixed
    n_sph = tp.meta["n_spheres"]
    assert n_sph == 1 and tp.meta["n_tris"] > 8 * n_sph
    o, d = _camera_rays(xml, 16)
    out = _check_closest(jp, tp, o, d)
    assert out.is_sphere.any()
    assert ((out.valid & ~out.is_sphere) & (out.prim >= n_sph)).any()
    t_max = np.asarray(out.t.clamp(max=1e4)) * 0.999
    o2 = o + 0.5 * np.asarray(out.t.clamp(max=1e4))[:, None] * d
    _check_occluded(jp, tp, o2, -d, t_max * 0.5)


def test_render_beside_more_triangles(mixed):
    import mitsuba_tpu
    import mitsuba_tpu_torch as mt

    xml, _ = mixed
    img = mt.render(mt.load_scene_string(xml), spp=8, seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=8, seed=0), np.float32)
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert abs(float(img.mean()) - float(ref.mean())) <= 2e-3 * float(ref.mean())
    rmse = float(np.sqrt(np.mean((img / (1.0 + img) - ref / (1.0 + ref)) ** 2)))
    assert rmse < 5e-3, rmse
