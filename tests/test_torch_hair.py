"""The port's hairball slice (mitsuba_tpu_torch/scene/hair.py, the
`cylinder` shape, scene/builder.py's segment tables, accel/cyl.py and the
intersector's segment arms) against the reference (mitsuba_tpu/scene/hair.py,
scene/shapes.py, accel/cyl.py, accel/intersect.py), on seeded inputs and on
scenes/hairball.xml (1,200 fibers of scenes/assets/hairball.hair).

Tolerances:

* load_hair (ascii, BINARY_HAIR, the tangent merge, `reduction`),
  tessellate_fibers and fibers_to_segments: bit for bit (the same float64
  numpy code);
* the packs (hairball tessellated and exact, a cylinder analytic and
  tessellated): every array the port packs equal to the reference's,
  dtype included, and the meta the slice reads equal;
* cyl_closest / cyl_any on random rays, the padding rows included: hit
  and occlusion equal; t within rtol 1e-3 (the quadratic's constant term
  cancels |p_perp|^2 against r^2 in float32, which amplifies last-place
  differences of the dots; largest measured 1.7e-4); the hit and the
  segment id equal but on at most 1 lane in 1,000: a silhouette ray, whose
  discriminant lies within float32's rounding of 0 (measured: 1 of 4,000
  random rays, disc / B^2 = 2e-8 in float64, a hit that the reference's
  rounding drops), or a tie of two segments' t; occlusion alike;
* fill_interaction on segment hits: material and emitter equal, uv 0 on
  the segments and within atol 1e-5 on the sphere's triangles (measured
  1.1e-6); normals within atol 2e-2 (measured 5.8e-3: the radial normal at
  a 0.012 radius turns with the hit point's last places);
* the goldens: tests/torch_meshes.py GOLDEN_GATES, and the image's mean
  within 1.5 % of the golden's.
"""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.accel import cyl as jcyl
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.scene import hair as jhair
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import cyl as tcyl
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.scene import hair as thair
from mitsuba_tpu_torch.scene.builder import BVH_ARRAYS, BVH_META, SLICE_ARRAYS, SLICE_META, pack_scene
from tests.torch_meshes import GOLDEN_GATES, ROOT, hairball_xml, tm_rmse

torch.set_num_threads(1)

HAIR = os.path.join(ROOT, "scenes", "assets", "hairball.hair")


def _helix(n=40, turns=3.0, r=0.5, h=2.0):
    t = np.linspace(0, 1, n)
    return np.stack([r * np.cos(2 * np.pi * turns * t), r * np.sin(2 * np.pi * turns * t),
                     h * t], -1)


def _fibers_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def hair_files(tmp_path_factory):
    """An ascii and a BINARY_HAIR file of 30 seeded helices (a comment and
    a straight fiber among them, which the tangent merge collapses)."""
    td = tmp_path_factory.mktemp("hair")
    rng = np.random.default_rng(0)
    fibers = [_helix(int(rng.integers(5, 40)), rng.uniform(0.5, 3), rng.uniform(0.1, 1))
              + rng.uniform(-1, 1, 3) for _ in range(30)]
    fibers.append(np.stack([np.zeros(20), np.zeros(20), np.linspace(0, 1, 20)], -1))
    pa, pb = str(td / "a.hair"), str(td / "b.hair")
    with open(pa, "w") as f:
        f.write("# seeded helices\n")
        for fib in fibers:
            f.writelines(f"{p[0]} {p[1]} {p[2]}\n" for p in fib)
            f.write("\n")
    with open(pb, "wb") as f:
        f.write(b"BINARY_HAIR")
        f.write(struct.pack("<I", sum(len(fib) for fib in fibers)))
        for k, fib in enumerate(fibers):
            if k:
                f.write(struct.pack("<f", np.inf))
            for p in fib:
                f.write(struct.pack("<3f", *p))
    return pa, pb


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
@pytest.mark.parametrize("angle,reduction", [(1.0, 0.0), (0.0, 0.0), (10.0, 0.0), (1.0, 0.4)])
def test_load_hair_bit_equal(hair_files, fmt, angle, reduction):
    path = hair_files[fmt == "binary"]
    out = thair.load_hair(path, angle, reduction, seed=3)
    _fibers_equal(out, jhair.load_hair(path, angle, reduction, seed=3))
    if reduction == 0.0:
        assert len(out) == 31 and len(out[-1]) == (20 if angle == 0.0 else 2)


def test_hairball_asset_tessellation_and_segments_bit_equal():
    """The hairball's fibers, its tubes (4 sides, end caps) and its
    segment table with the miter normals."""
    fibers = thair.load_hair(HAIR)
    _fibers_equal(fibers, jhair.load_hair(HAIR))
    assert len(fibers) == 1200 and sum(len(f) for f in fibers) == 8389
    for sides in (4, 6):
        a, b = thair.tessellate_fibers(fibers, 0.012, sides), jhair.tessellate_fibers(fibers,
                                                                                     0.012, sides)
        for k in ("positions", "indices", "normals", "texcoords"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
            assert getattr(a, k).dtype == getattr(b, k).dtype
    a, b = thair.fibers_to_segments(fibers, 0.012), jhair.fibers_to_segments(fibers, 0.012)
    assert len(a.p0) == 7189
    for k in ("p0", "p1", "n0", "n1", "radius"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


CYLINDER_XML = """
<scene version="0.5.0">
  <sensor type="perspective"><sampler type="independent"/>
    <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="8"/></film>
  </sensor>
  <shape type="cylinder"><point name="p0" x="0" y="0" z="0"/><point name="p1" x="0" y="0" z="1"/>
    <float name="radius" value="0.3"/>{extra}<bsdf type="diffuse"/></shape>
  <shape type="cylinder"><point name="p0" x="1" y="0" z="0"/><point name="p1" x="1" y="1" z="2"/>
    <float name="radius" value="0.2"/><boolean name="flipNormals" value="true"/>
    <transform name="toWorld"><rotate z="1" angle="30"/><scale value="1.5"/></transform>{extra}
    <bsdf type="phong"/></shape>
</scene>"""


def _packs(xml):
    return pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))


def _assert_packs_equal(tp, jp):
    keys = SLICE_ARRAYS + (BVH_ARRAYS if tp.meta["use_bvh"] else ())
    for k in keys:
        ref = np.asarray(jp.arrays[k])
        out = tp.arrays[k].numpy()
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)
    for k in SLICE_META + (BVH_META if tp.meta["use_bvh"] else ()):
        assert tp.meta[k] == jp.meta[k], k


@pytest.mark.parametrize("exact", [True, False])
def test_cylinder_packs_equal(exact):
    """The cylinder shape in both branches: analytic (one segment each,
    under a uniform scale) and tessellated (64 sides)."""
    tp, jp = _packs(CYLINDER_XML.format(extra="" if exact else
                                        '<boolean name="exact" value="false"/>'))
    _assert_packs_equal(tp, jp)
    assert tp.meta["n_cyls"] == (2 if exact else 0)
    assert tp.meta["n_tris"] == (0 if exact else 256)


@pytest.fixture(scope="module")
def hairball_packs():
    """The hairball as it stands and exact, each packed by both packages."""
    return {exact: _packs(hairball_xml(32, 24, exact=exact)) for exact in (False, True)}


@pytest.mark.parametrize("exact", [False, True])
def test_hairball_packs_equal(hairball_packs, exact):
    tp, jp = hairball_packs[exact]
    _assert_packs_equal(tp, jp)
    assert tp.meta["present_types"] == (0, 9)
    if exact:
        assert tp.meta["n_cyls"] == 7189 and tp.cyl_p0.shape[0] == 7296
        assert tp.meta["n_tris"] == 1024
    else:
        assert tp.meta["n_cyls"] == 0 and tp.meta["n_tris"] == 68136
        assert tp.meta["n_clusters"] == 800


def _random_rays(seed, n, lo=-1.3, hi=1.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _same_hits(prim, ref_prim):
    """Lanes whose hit ids agree: all but at most 1 in 1,000 (silhouette
    rays and ties)."""
    same = prim == ref_prim
    assert (~same).sum() <= len(same) // 1000, (~same).sum()
    return same


def test_cyl_closest_and_any(hairball_packs):
    """Every segment of the exact hairball, and its 107 padding rows."""
    tp, jp = hairball_packs[True]
    o, d = _random_rays(0, 3000)
    best = np.random.default_rng(1).choice([1e30, 0.5, 1.5], 3000).astype(np.float32)
    jh, jt, ji = (np.asarray(a) for a in jcyl.cyl_closest(jp, jnp.asarray(o), jnp.asarray(d),
                                                          jnp.asarray(best)))
    th, tt, ti = tcyl.cyl_closest(tp, torch.as_tensor(o), torch.as_tensor(d),
                                  torch.as_tensor(best))
    assert jh.sum() > 300 and (~jh).sum() > 300
    same = _same_hits(ti.numpy(), ji)
    np.testing.assert_array_equal(th.numpy()[same], jh[same])
    np.testing.assert_allclose(tt.numpy()[same], jt[same], rtol=1e-3)
    t_max = np.random.default_rng(2).uniform(0.05, 2.0, 3000).astype(np.float32)
    ja = np.asarray(jcyl.cyl_any(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
    ta = tcyl.cyl_any(tp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    assert 0.05 < ja.mean() < 0.95
    assert (ta.numpy() != ja).sum() <= len(ja) // 1000  # silhouette rays (measured: none)


def test_fill_interaction_on_segments(hairball_packs):
    """Closest hits of random rays (segments and the sphere's triangles)
    and their surface data."""
    tp, jp = hairball_packs[True]
    o, d = _random_rays(3, 4000)
    jhit = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d))
    thit = tis.intersect(tp, torch.as_tensor(o), torch.as_tensor(d))
    same = _same_hits(thit.prim.numpy(), np.asarray(jhit.prim))
    for k in ("valid", "is_cyl"):
        np.testing.assert_array_equal(getattr(thit, k).numpy()[same],
                                      np.asarray(getattr(jhit, k))[same], k)
    assert thit.is_cyl.sum() > 500 and (thit.valid & ~thit.is_cyl).sum() > 50
    jits = jis.fill_interaction(jp, jnp.asarray(o), jnp.asarray(d), jhit)
    tits = tis.fill_interaction(tp, torch.as_tensor(o), torch.as_tensor(d), thit)
    v = thit.valid.numpy() & same
    for k in ("mat", "emit"):
        np.testing.assert_array_equal(getattr(tits, k).numpy()[v], np.asarray(getattr(jits, k))[v],
                                      err_msg=k)
    np.testing.assert_allclose(tits.uv.numpy()[v], np.asarray(jits.uv)[v], atol=1e-5)
    for k in ("ng", "ns"):
        np.testing.assert_allclose(getattr(tits, k).numpy()[v], np.asarray(getattr(jits, k))[v],
                                   atol=2e-2, err_msg=k)
    assert (tits.uv.numpy()[thit.is_cyl.numpy()] == 0).all()


def test_exact_cylinder_analytic_hit():
    """The analytic open cylinder (cylinder.cpp): a side hit at t = axis
    distance - radius with a radial normal; rays past the axial extent or
    down the open mouth miss; from inside, the far wall (port of
    tests/test_hair.py's test)."""
    pack = pack_scene(mt.load_scene_string("""
    <scene version="0.5.0">
      <sensor type="perspective"><sampler type="independent"/>
        <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="8"/>
        </film></sensor>
      <shape type="cylinder"><point name="p0" x="0" y="0" z="0"/><point name="p1" x="0" y="0" z="1"/>
        <float name="radius" value="0.3"/><bsdf type="diffuse"/></shape>
    </scene>"""), "cpu")
    assert pack.meta["n_cyls"] == 1
    o = torch.tensor([[2.0, 0.0, 0.5], [2.0, 0.0, 1.5], [0.0, 0.0, 2.0], [2.0, 0.0, -0.5]])
    d = torch.tensor([[-1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]])
    hit = tis.intersect(pack, o, d)
    assert hit.valid.tolist() == [True, False, False, False]
    assert abs(float(hit.t[0]) - 1.7) < 1e-4
    its = tis.fill_interaction(pack, o, d, hit)
    np.testing.assert_allclose(its.ns[0].numpy(), [1.0, 0.0, 0.0], atol=1e-4)
    h2 = tis.intersect(pack, torch.tensor([[0.0, 0.0, 0.5]]), torch.tensor([[1.0, 0.0, 0.0]]))
    assert bool(h2.valid[0]) and abs(float(h2.t[0]) - 0.3) < 1e-4


def test_hair_exact_miter_joints_no_cracks(tmp_path):
    """A fiber bent 45 degrees has no crack at its miter joint: rays shot
    down across the joint hit (port of tests/test_hair.py's test)."""
    ph = tmp_path / "bend.hair"
    ph.write_text("0 0 0\n1 0 0\n1.7 0.7 0\n")
    pack = pack_scene(mt.load_scene_string(f"""
    <scene version="0.5.0">
      <sensor type="perspective"><sampler type="independent"/>
        <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="8"/>
        </film></sensor>
      <shape type="hair"><string name="filename" value="{ph}"/><float name="radius" value="0.1"/>
        <boolean name="exact" value="true"/><bsdf type="diffuse"/></shape>
    </scene>"""), "cpu")
    assert pack.meta["n_cyls"] == 2
    xs = torch.linspace(0.5, 1.4, 181)
    o = torch.stack([xs, torch.full_like(xs, 2.0), torch.zeros_like(xs)], -1)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(181, 3).contiguous()
    hit = tis.intersect(pack, o, d)
    v = hit.valid.numpy()
    assert v[:90].all() and v.sum() > 0.9 * 181
    t = hit.t.numpy()[v]
    assert np.isfinite(t).all() and (t > 0).all()


def test_hair_exact_matches_tessellated_render(tmp_path):
    """The exact segments and a fine tessellation render alike (port of
    tests/test_hair.py's test, at 24x24 and 8 spp)."""
    ph = tmp_path / "helix.hair"
    ph.write_text("".join(f"{p[0]} {p[1]} {p[2]}\n" for p in _helix(24, 2.0, 0.4, 1.2)))

    def scene(exact, sides=16):
        return mt.load_scene_string(f"""
        <scene version="0.5.0">
          <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
          <sensor type="perspective"><float name="fov" value="40"/>
            <transform name="toWorld"><lookat origin="0,-3,0.6" target="0,0,0.6" up="0,0,1"/>
            </transform>
            <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
            <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="24"/>
              <rfilter type="box"/></film></sensor>
          <shape type="hair"><string name="filename" value="{ph}"/><float name="radius" value="0.08"/>
            <boolean name="exact" value="{str(exact).lower()}"/><integer name="sides" value="{sides}"/>
            <bsdf type="diffuse"><rgb name="reflectance" value="0.7,0.5,0.3"/></bsdf></shape>
          <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
        </scene>""")

    a = mt.render(scene(True), spp=8, seed=2, device="cpu")
    b = mt.render(scene(False), spp=8, seed=2, device="cpu")
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) < 0.05 * max(a.mean(), b.mean())
    assert np.abs(a - b).mean() < 0.08 * max(a.mean(), b.mean()) + 0.02


def test_cylinder_refuses_emitters():
    xml = CYLINDER_XML.format(extra="").replace(
        '<bsdf type="diffuse"/>', '<emitter type="area"><rgb name="radiance" value="1"/></emitter>')
    with pytest.raises(ValueError, match="exact=false"):
        pack_scene(mt.load_scene_string(xml), "cpu")


@pytest.mark.parametrize("golden,exact", [("torch_hairball_32_4.npy", False),
                                          ("torch_hairball_exact_32_4.npy", True)])
def test_hairball_golden(hairball_packs, golden, exact):
    """scenes/hairball.xml at 32x24, 4 spp, against the JAX package's
    render: tessellated (the fallback walk carries most rays) and exact."""
    tp, _ = hairball_packs[exact]
    img = mt.render(mt.load_scene_string(hairball_xml(32, 24, exact=exact)), spp=4, seed=0,
                    device="cpu", pack=tp)
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    assert img.shape == ref.shape == (24, 32, 3)
    assert np.isfinite(img).all()
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden]
    assert abs(img.mean() - ref.mean()) < 0.015 * ref.mean()
