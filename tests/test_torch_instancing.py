"""The port's instancing against the reference on the same seeded inputs:
the loader's shape groups and instances, both routes of the builder
(instances copied into plain rows, and past MTS_INSTANCE_EXPAND_MAX the
two-level accelerator of accel/tlas.py), the traversals and the
interaction of an instanced hit.

Tolerances:

* the loader's groups and instances, and the packs: equal, bit for bit
  (checker.png's atlas within one float32 place, as in
  tests/test_torch_textures.py);
* `inst_closest` / `inst_closest_pairs` against the reference's (its pair
  path run in interpret mode, as tests/test_instancing.py runs it), also
  at K_INST = 1, where most rays overflow into the loop path: prim and
  inst equal, t, u and v within 1e-5; `inst_any` / `inst_any_pairs`:
  equal;
* `fill_interaction` on instanced, sphere and missing lanes under an
  unevenly scaled, bump-mapped template: rtol 1e-5, atol 1e-5;
* renders: each golden at its GOLDEN_GATES entry (tone-mapped RMSE), and
  the port's two routes and two traversals against each other at 1e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.accel import tlas as jtlas
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.accel import tlas as ttlas
from mitsuba_tpu_torch.scene.builder import INSTANCE_ARRAYS, INSTANCE_META, pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    feature_assets,
    instancing_two_group_xml,
    instancing_xml,
    tm_rmse,
)

torch.set_num_threads(1)

ASSETS = os.path.join(ROOT, "build", "feature_assets")
SPHERE = """<shape type="sphere"><point name="center" x="0.3" y="1.7" z="1.2"/>
    <float name="radius" value="0.35"/><bsdf type="diffuse"/></shape>"""
SCENES = {
    "cards": lambda: instancing_xml(),
    "two_group": lambda: instancing_two_group_xml(feature_assets(ASSETS)),
    # a sphere beside the instances: sphere lanes in fill_interaction
    "two_group_sphere": lambda: instancing_two_group_xml(feature_assets(ASSETS)).replace(
        "</scene>", SPHERE + "</scene>"),
    "instances_only": lambda: instancing_xml(floor=False),
    # three cards turned about one place: their boxes overlap
    "overlap": lambda: instancing_xml(instances="".join(
        f'<shape type="instance"><ref id="grp"/><transform name="toWorld"><rotate y="1" '
        f'angle="{20 + 30 * i}"/><translate x="{0.1 * i}"/></transform></shape>'
        for i in range(3))),
}


@pytest.fixture
def tlas_route(monkeypatch):
    monkeypatch.setenv("MTS_INSTANCE_EXPAND_MAX", "0")


class _Packs(dict):
    def __missing__(self, key):
        name, route = key
        saved = os.environ.get("MTS_INSTANCE_EXPAND_MAX")
        if route == "tlas":
            os.environ["MTS_INSTANCE_EXPAND_MAX"] = "0"
        try:
            xml = SCENES[name]()
            self[key] = (jpack_scene(jload_string(xml)), pack_scene(load_scene_string(xml), "cpu"))
        finally:
            if saved is None:
                os.environ.pop("MTS_INSTANCE_EXPAND_MAX", None)
            else:
                os.environ["MTS_INSTANCE_EXPAND_MAX"] = saved
        return self[key]


@pytest.fixture(scope="module")
def packs():
    return _Packs()


def _equal_arrays(jp, tp, keys):
    for k in keys:
        ref = np.asarray(jp.arrays[k])
        out = tp.arrays[k].cpu()
        out = (out.float() if out.dtype == torch.bfloat16 else out).numpy()
        if ref.dtype.name == "bfloat16":
            ref = ref.astype(np.float32)
        assert out.dtype == ref.dtype and out.shape == ref.shape, k
        if k == "tex_atlas":  # checker.png: numpy's and XLA's sRGB pow
            np.testing.assert_allclose(out, ref, rtol=2.4e-7, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(out, ref, err_msg=k)


# ---- the loader and the packs ----------------------------------------------

def test_loader_groups_and_instances():
    """One group key per shape group, its shapes attached once (with their
    BSDFs), each instance's transform."""
    xml = instancing_two_group_xml(feature_assets(ASSETS))
    t, j = load_scene_string(xml), jload_string(xml)
    assert len(t.instances) == len(j.instances) == 4
    assert len(t.shape_groups) == len(j.shape_groups) == 2
    assert len(t.shapes) == len(j.shapes) == 2  # the floor and the light
    keys_t = list(t.shape_groups)
    keys_j = list(j.shape_groups)
    for (kt, xt), (kj, xj) in zip(t.instances, j.instances):
        assert keys_t.index(kt) == keys_j.index(kj)
        np.testing.assert_array_equal(xt.m, xj.m)
    for kt, kj in zip(keys_t, keys_j):
        for a, b in zip(t.shape_groups[kt], j.shape_groups[kj]):
            assert (a.bsdf is None) == (b.bsdf is None)
            assert a.bsdf.type == b.bsdf.type
            for ma, mb in zip(a.meshes, b.meshes):
                for f in ("positions", "indices", "normals", "texcoords"):
                    np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f), err_msg=f)


def test_instance_without_group_raises():
    xml = instancing_xml(instances='<shape type="instance"/>')
    for load in (load_scene_string, jload_string):
        with pytest.raises(ValueError, match="requires a shapegroup"):
            load(xml)


@pytest.mark.parametrize("name", ["cards", "two_group"])
def test_expanded_pack_equal(packs, name):
    """Below MTS_INSTANCE_EXPAND_MAX every instance is plain rows: every
    array the port packs equals the reference's, and the meta."""
    jp, tp = packs[name, "expand"]
    assert not tp.meta["has_instances"] and tp.meta["n_instances"] == 0
    _equal_arrays(jp, tp, [k for k in tp.arrays if k in jp.arrays])
    for k, v in tp.meta.items():
        if k in jp.meta:
            assert v == jp.meta[k], k


@pytest.mark.parametrize("name", ["cards", "two_group", "instances_only"])
def test_tlas_pack_equal(packs, name):
    """Past MTS_INSTANCE_EXPAND_MAX: the template rows after every other
    row, the splice, the instance tables, every group's cluster tables
    ig{g}_*, inst_groups, inst_pairs_ok and n_instances, and every other
    array and meta key the port packs."""
    jp, tp = packs[name, "tlas"]
    m = tp.meta
    assert m["has_instances"] and m["inst_pairs_ok"]
    assert m["n_instances"] == {"cards": 3, "two_group": 4, "instances_only": 3}[name]
    groups = [k for k in jp.arrays if k.startswith("ig") and not k.endswith(
        ("cl_mt", "cl_primf", "cl_sph"))]  # the reference's TPU-only tables
    assert len(groups) == 9 * len(m["inst_groups"])
    _equal_arrays(jp, tp, list(INSTANCE_ARRAYS) + groups)
    _equal_arrays(jp, tp, [k for k in tp.arrays if k in jp.arrays])
    for k in INSTANCE_META + ("n_static_tris", "n_tris", "scene_center", "scene_radius"):
        assert m[k] == jp.meta[k], k
    # the templates are stored once, past the static prefix
    n_tmpl = sum(c for _, c, _ in m["inst_groups"])
    assert m["n_tris"] - m["n_static_tris"] == n_tmpl
    assert m["n_static_tris"] == (0 if name == "instances_only" else 4)


def test_group_restrictions(tlas_route):
    """A group with an emitter cannot go through the accelerator."""
    xml = instancing_xml(groups="""<shape type="shapegroup" id="grp"><shape type="rectangle">
      <emitter type="area"><rgb name="radiance" value="1,1,1"/></emitter></shape></shape>""")
    with pytest.raises(ValueError, match="instanced shapegroup"):
        jpack_scene(jload_string(xml))
    with pytest.raises(ValueError, match="instanced shapegroup"):
        pack_scene(load_scene_string(xml), "cpu")


# ---- traversal ------------------------------------------------------------

def _rays(n, seed):
    """tests/test_instancing.py's rays toward the instances, half of them
    cut short at a seeded t_max."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 1.5, -4.0], np.float32) + 0.2 * rng.standard_normal((n, 3)).astype(
        np.float32)
    tgt = np.stack([rng.uniform(-1.8, 1.8, n), rng.uniform(0.0, 1.0, n),
                    rng.uniform(-0.6, 0.8, n)], -1).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=n) < 0.5, 1e30, rng.uniform(3.0, 6.0, n)).astype(np.float32)
    return o, d, t_max


def _sweep_rays(n=64):
    """Level rays across the first instance's card and the second's box
    (the cards' boxes are flat): each meets two instance boxes, and so
    overflows K_INST = 1."""
    ys = np.linspace(0.1, 0.8, n).astype(np.float32)
    o = np.stack([np.full(n, -3.0), ys, np.full(n, -0.9)], -1).astype(np.float32)
    d = np.tile(np.array([[6.0, 0.0, 2.4]], np.float32) / np.hypot(6.0, 2.4), (n, 1))
    return o, d.astype(np.float32), np.full(n, 1e30, np.float32)


def _init(r, t_max):
    return (t_max, np.full(r, -1, np.int32), np.zeros(r, np.float32), np.zeros(r, np.float32),
            np.full(r, -1, np.int32))


@pytest.mark.parametrize("name,k_inst,interpret", [
    ("cards", 4, True), ("cards", 1, False), ("two_group", 4, False), ("two_group", 1, False),
    ("overlap", 4, False), ("overlap", 1, False)])
def test_traversals_match_reference(packs, monkeypatch, name, k_inst, interpret):
    """The port's loop and pair paths against the reference's loop path
    and, where `interpret`, its pair path too (interpreted Pallas: slow)."""
    jp, tp = packs[name, "tlas"]
    monkeypatch.setattr(jtlas, "K_INST", k_inst)
    monkeypatch.setattr(ttlas, "K_INST", k_inst)
    o, d, tm = (np.concatenate(x) for x in zip(_rays(192, 3), _sweep_rays()))
    init = _init(len(o), tm)
    ref = [np.asarray(x) for x in jtlas.inst_closest(jp, o, d, *(jnp.asarray(x) for x in init))]
    if interpret:
        ref_p = jtlas.inst_closest_pairs(jp, o, d, *(jnp.asarray(x) for x in init),
                                         interpret=True)
        for a, b in zip(ref_p, ref):
            np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5)
    ttlas.inst_closest_pairs.overflow_rays = 0
    for fn in (ttlas.inst_closest, ttlas.inst_closest_pairs):
        out = fn(tp, torch.from_numpy(o), torch.from_numpy(d),
                 *(torch.from_numpy(x.copy()) for x in init))
        t, prim, u, v, inst = (x.numpy() for x in out)
        rt, rprim, ru, rv, rinst = ref
        np.testing.assert_array_equal(prim, rprim)
        np.testing.assert_array_equal(inst, rinst)
        for a, b, n in ((t, rt, "t"), (u, ru, "u"), (v, rv, "v")):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=n)
    assert (rprim >= 0).sum() > 40 and (rinst >= 0).sum() > 40
    # K_INST = 1: the sweep's rays overflow into the loop path
    assert (ttlas.inst_closest_pairs.overflow_rays >= 32) == (k_inst == 1)
    occ = np.asarray(jtlas.inst_any(jp, o, d, jnp.asarray(tm)))
    if interpret:
        np.testing.assert_array_equal(
            np.asarray(jtlas.inst_any_pairs(jp, o, d, jnp.asarray(tm), interpret=True)), occ)
    assert 0.1 < occ.mean() < 0.9
    for fn in (ttlas.inst_any, ttlas.inst_any_pairs):
        np.testing.assert_array_equal(fn(tp, torch.from_numpy(o), torch.from_numpy(d),
                                         torch.from_numpy(tm)).numpy(), occ)


def test_inst_lists_match_reference(packs):
    """The K_INST nearest instance boxes by entry, ties to the lower id
    (every box holding a ray's origin enters at 0), and the overflow."""
    jp, tp = packs["overlap", "tlas"]
    o, d, tm = _rays(256, 5)
    o[:64] = [0.2, 0.45, 0.0]  # inside all three boxes
    ids, ov = jtlas._inst_lists(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), 2)
    t_ids, t_ov = ttlas._inst_lists(tp, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(tm), 2)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(t_ov.numpy(), np.asarray(ov))
    assert np.asarray(ov)[:64].all() and (np.asarray(ids)[:64] == [0, 1]).all()


def _jhit(h):
    z = np.zeros(h.t.shape[0], bool)
    return jis.Hit(valid=jnp.asarray(h.valid.numpy()), t=jnp.asarray(h.t.numpy()),
                   prim=jnp.asarray(h.prim.numpy()),
                   is_sphere=jnp.asarray(z if h.is_sphere is None else h.is_sphere.numpy()),
                   u=jnp.asarray(h.u.numpy()), v=jnp.asarray(h.v.numpy()),
                   inst=jnp.asarray(h.inst.numpy()), is_cyl=jnp.asarray(z))


def test_fill_interaction_instanced(packs):
    """Normals through inst_nrm and partials through inst_fwd under the
    unevenly scaled, bump-mapped template, beside sphere lanes and misses
    (inst -1), from the same hits."""
    jp, tp = packs["two_group_sphere", "tlas"]
    o, d, _ = _rays(384, 8)
    rng = np.random.default_rng(9)
    o_s = np.array([0.3, 1.7, -3.0], np.float32) + 0.1 * rng.standard_normal((64, 3))
    d_s = np.array([0.0, 0.0, 1.0]) + 0.05 * rng.standard_normal((64, 3))
    d_s /= np.linalg.norm(d_s, axis=-1, keepdims=True)
    o = np.concatenate([o, o_s, o[:64]]).astype(np.float32)
    d = np.concatenate([d, d_s, -d[:64]]).astype(np.float32)  # the last 64 look away
    hit = tis.intersect(tp, torch.from_numpy(o), torch.from_numpy(d))
    inst = hit.inst.numpy()
    assert (inst >= 0).sum() > 50 and hit.is_sphere.sum() > 20 and (~hit.valid).sum() > 40
    assert (inst[hit.is_sphere.numpy()] == -1).all()
    assert tp.meta["has_bumpmaps"]
    out = tis.fill_interaction(tp, torch.from_numpy(o), torch.from_numpy(d), hit)
    ref = jis.fill_interaction(jp, jnp.asarray(o), jnp.asarray(d), _jhit(hit))
    ok = hit.valid.numpy()
    for f in ("p", "ng", "ns", "uv", "dpdu", "dpdv", "mat", "emit"):
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-5, err_msg=f)
    # the unevenly scaled instance (ids run group by group: the cards'
    # two, then the textured card's) stretches its template's partials
    sel = inst == 3
    assert sel.sum() > 5
    assert np.abs(np.linalg.norm(out.dpdu.numpy()[sel], axis=-1)
                  - np.linalg.norm(tp.tri_dpdu[hit.prim[torch.from_numpy(sel)].long()].numpy(),
                                   axis=-1)).max() > 1e-3


def test_instances_only_scene(packs):
    """No static triangles: occluded is intersect's hit, through the
    instances."""
    jp, tp = packs["instances_only", "tlas"]
    o, d, tm = _rays(512, 11)
    hit = tis.intersect(tp, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    ref = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(hit.inst.numpy(), np.asarray(ref.inst))
    assert hit.valid.sum() > 100
    occ = tis.occluded(tp, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        jis.occluded(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))))
    np.testing.assert_array_equal(occ.numpy(), hit.valid.numpy())


# ---- renders --------------------------------------------------------------

GOLDENS = {
    "expand": ("torch_instancing_32_4.npy", instancing_xml, {}),
    "tlas": ("torch_instancing_tlas_32_4.npy", instancing_xml,
             {"MTS_INSTANCE_EXPAND_MAX": "0"}),
    "tlas_loop": ("torch_instancing_tlas_32_4.npy", instancing_xml,
                  {"MTS_INSTANCE_EXPAND_MAX": "0", "MTS_TLAS_PAIRS": "0"}),
    "two_group": ("torch_instancing_two_group_32_4.npy",
                  lambda: instancing_two_group_xml(feature_assets(ASSETS)),
                  {"MTS_INSTANCE_EXPAND_MAX": "0"}),
}


@pytest.fixture(scope="module")
def renders():
    out = {}
    for name, (_, xml, env) in GOLDENS.items():
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out[name] = mt.render(load_scene_string(xml()), spp=4, seed=0, device="cpu")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
    return out


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden(renders, name):
    golden = GOLDENS[name][0]
    gold = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = renders[name]
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert tm_rmse(img, gold) < GOLDEN_GATES[golden]


def test_routes_agree(renders):
    """The same instances copied into rows, through the pair path and
    through the loop path: one image."""
    assert tm_rmse(renders["tlas"], renders["expand"]) < 1e-6
    assert tm_rmse(renders["tlas_loop"], renders["tlas"]) < 1e-6
