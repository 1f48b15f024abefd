"""The port's bump and normal maps (mitsuba_tpu_torch/bsdf/plugins.py
`bumpmap` / `normalmap`, scene/builder.py's tri_dpdu / tri_dpdv and
mat_tex_bump / mat_bump_nm, accel/intersect.py's uv partials,
scene/texture_eval.py shading_frame) against the reference
(mitsuba_tpu/bsdf/plugins.py, scene/builder.py, accel/intersect.py,
scene/texture_eval.py), and tests/test_bumpmap.py's scenes rendered by
the port.

Tolerances (measured on these inputs):

* tri_dpdu, tri_dpdv, mat_tex_bump, mat_bump_nm: equal (the same float32
  numpy code);
* fill_interaction's partials on the hits both packages find alike:
  triangles equal (measured 0), the analytic sphere's lat-long partials
  within rtol 1e-4 and atol 1e-5 of their magnitudes (measured: 6.1e-5
  of the magnitude for dp/du, whose length 2 pi r sin(theta) takes the
  hit point's last places near the poles; 2.2e-7 for dp/dv);
* shading_frame fed the reference's own interaction: within atol 5e-5
  (measured: normal maps 1.2e-7; bump maps 3.6e-6, the height's
  differences over eps = 1/1024 in uv, which turn a last-place difference
  of a bilinear fetch into ~1e-4 of the gradient; the frames' last
  places otherwise);
* the flat normal map leaves the render as it is (atol 1e-4, as the
  reference's test); the goldens: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.scene import texture_eval as jtex
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.scene import texture_eval as ttex
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    CBOX_XML,
    GOLDEN_GATES,
    ROOT,
    bitmap_xml,
    bump_xml,
    feature_assets,
    textured_xml,
    tm_rmse,
)

torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return feature_assets(str(tmp_path_factory.mktemp("bump_assets")))


def _packs(xml):
    return pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))


def _scene(name, assets):
    return {"bump": lambda: bump_xml("bump", assets), "tilted": lambda: bump_xml("tilted"),
            "textured": lambda: textured_xml(assets, 32, 32),
            "bitmap": lambda: bitmap_xml(assets)}[name]()


@pytest.mark.parametrize("name", ["bump", "tilted", "textured", "bitmap"])
def test_partials_and_bump_tables_equal(assets, name):
    """tri_dpdu / tri_dpdv (the triangles' uv partials, e1 / e2 where the
    uv are degenerate: TEXTURED's emissive sphere has uv, its pole fans
    do not) and the bump slots, bit for bit."""
    tp, jp = _packs(_scene(name, assets))
    for k in ("tri_dpdu", "tri_dpdv", "mat_tex_bump", "mat_bump_nm"):
        ref = np.asarray(jp.arrays[k])
        assert tp.arrays[k].numpy().dtype == ref.dtype, k
        np.testing.assert_array_equal(tp.arrays[k].numpy(), ref, err_msg=k)
    assert tp.meta["has_bumpmaps"] == (name != "bitmap")
    assert (tp.mat_bump_nm.numpy() > 0).any() == (name in ("tilted", "textured"))


def _rays(seed, origin, target, spread):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray(origin, np.float32), (N, 1))
    d = (np.asarray(target, np.float32) + rng.uniform(-spread, spread, (N, 3))) - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _both_its(tp, jp, o, d):
    jh = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d))
    th = tis.intersect(tp, torch.as_tensor(o), torch.as_tensor(d))
    jits = jis.fill_interaction(jp, jnp.asarray(o), jnp.asarray(d), jh)
    tits = tis.fill_interaction(tp, torch.as_tensor(o), torch.as_tensor(d), th)
    agree = th.prim.numpy() == np.asarray(jh.prim)
    if th.is_sphere is not None:
        agree &= th.is_sphere.numpy() == np.asarray(jh.is_sphere)
    assert agree.mean() > 0.99
    return jits, tits, agree & th.valid.numpy(), th


def test_sphere_and_triangle_partials(assets):
    """The bitmap scene (mip maps: the partials are on): rays toward its
    analytic sphere and the rectangles behind it."""
    tp, jp = _packs(bitmap_xml(assets))
    o, d = _rays(13, (0.0, 0.6, -4.0), (-0.8, 0.7, 1.0), 1.2)
    jits, tits, same, th = _both_its(tp, jp, o, d)
    sph = same & th.is_sphere.numpy()
    tri = same & ~th.is_sphere.numpy()
    assert sph.sum() > N // 5 and tri.sum() > N // 10
    for k in ("dpdu", "dpdv"):
        out, ref = getattr(tits, k).numpy(), np.asarray(getattr(jits, k))
        np.testing.assert_allclose(out[tri], ref[tri], atol=1e-6, rtol=0, err_msg=k)
        scale = np.linalg.norm(ref[sph], axis=-1, keepdims=True)
        np.testing.assert_allclose(out[sph], ref[sph], rtol=1e-4, atol=1e-5 * scale.max(),
                                   err_msg=k)
    # |dp/du| = 2 pi r sin(theta), |dp/dv| = pi r (r = 0.7)
    np.testing.assert_allclose(np.linalg.norm(tits.dpdv.numpy()[sph], axis=-1), np.pi * 0.7,
                               rtol=1e-5)


def test_partials_zero_without_bumps_or_mips():
    """Without bump maps and mip maps the interaction carries zeros, as the
    reference's; an interaction built without them takes None."""
    xml = open(CBOX_XML).read()
    tp = pack_scene(mt.load_scene_string(xml), "cpu")
    o, d = _rays(3, (278.0, 273.0, -800.0), (278.0, 273.0, 0.0), 150.0)
    its = tis.fill_interaction(tp, torch.as_tensor(o), torch.as_tensor(d),
                               tis.intersect(tp, torch.as_tensor(o), torch.as_tensor(d)))
    assert (its.dpdu == 0).all() and (its.dpdv == 0).all()
    assert tis.SurfaceInteraction._field_defaults == {"dpdu": None, "dpdv": None}


def _port_its(jits):
    """The reference's interaction as the port's (the same values)."""
    fields = tis.SurfaceInteraction._fields
    return tis.SurfaceInteraction(**{k: None if getattr(jits, k, None) is None
                                     else torch.as_tensor(np.array(getattr(jits, k)))
                                     for k in fields})


@pytest.mark.parametrize("name,origin,target,spread", [
    ("tilted", (0.0, 0.0, 4.0), (0.0, 0.0, 0.0), 0.9),
    ("bump", (0.0, 0.0, 4.0), (0.0, 0.0, 0.0), 0.9),
    ("textured", (0.0, 1.3, -4.6), (0.0, 1.2, 2.0), 2.0),
])
def test_shading_frame(assets, name, origin, target, spread):
    """The perturbed frame, from the same interaction: normal maps (the
    tilted checkerboard, TEXTURED's normal.pfm on its sphere) and bump
    maps (height.pfm on the bump rectangle and on TEXTURED's back wall)."""
    tp, jp = _packs(_scene(name, assets))
    o, d = _rays(17, origin, target, spread)
    jh = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d))
    jits = jis.fill_interaction(jp, jnp.asarray(o), jnp.asarray(d), jh)
    ref = jtex.shading_frame(jp, jits)
    out = ttex.shading_frame(tp, _port_its(jits))
    valid = np.asarray(jh.valid)
    bumped = (tp.mat_tex_bump.numpy()[np.maximum(np.asarray(jits.mat), 0)] >= 0) & valid
    assert bumped.sum() > N // 5
    for k in ("s", "t", "n"):
        a, b = getattr(out, k).numpy()[valid], np.asarray(getattr(ref, k))[valid]
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0, err_msg=k)
    # the perturbation turned the normals
    tilt = 1.0 - np.sum(out.n.numpy() * np.asarray(jits.ns), -1)
    assert (tilt[bumped] > 1e-4).mean() > 0.5


def _render(xml, spp, seed=0):
    return mt.render(mt.load_scene_string(xml), spp=spp, seed=seed, device="cpu")


def test_flat_normalmap_is_identity():
    """tests/test_bumpmap.py::test_flat_normalmap_is_identity in the port: a
    constant (0.5, 0.5, 1) normal map leaves the render as it is."""
    a = _render(bump_xml("plain"), 16)
    b = _render(bump_xml("flat"), 16)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_tilted_normalmap_changes_shading():
    """tests/test_bumpmap.py::test_tilted_normalmap_changes_shading in the
    port: the tilted map changes the directly lit shading, finitely."""
    a = _render(bump_xml("plain"), 32, seed=2)
    b = _render(bump_xml("tilted"), 32, seed=2)
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() > 1e-3


@pytest.mark.parametrize("golden,kind", [("torch_tex_normalmap_32_4.npy", "tilted"),
                                         ("torch_tex_bumpmap_32_4.npy", "bump")])
def test_bump_goldens(assets, golden, kind):
    img = _render(bump_xml(kind, assets), 4)
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden]
