"""The port's motion slice against the reference on the same seeded numpy
inputs: animated (<animation>) and deformable shapes, the shutter time,
the motion integrator and the manifold walk at a time.

Tolerances:

* the packs (MOTION, MOTION_BIG's 516-triangle version, the moving cards
  of tests/test_motion.py and tests/test_deformable.py, the glass slab):
  every array and meta key equal, bit for bit;
* the intersection functions on 4,096 seeded rays and times: prim and
  the any-hit flags equal; on the hits t, u, v within rtol 1e-5 (atol
  1e-5 for u and v, which cross 0, and 1e-6 of the scene's radius for t:
  _hits_equal says why); _anim_ray and _deform_frames within rtol 1e-6;
* shutter_time and _motion_advance: bit for bit;
* renders: each golden at its GOLDEN_GATES entry (tone-mapped RMSE; for
  the motion vectors the largest difference in pixels, and at most
  MOTION_VECTOR_SHARE of the pixels off by more than 1e-4);
* the moving cards' blur against the analytic shutter coverage, with the
  reference tests' thresholds (tests/test_motion.py:64-91).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.integrator import path as jpath
from mitsuba_tpu.renderer import render as jrender
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.accel.pallas_kernels import live_columns
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.scene.builder import (
    BVH_ARRAYS,
    BVH_META,
    MOTION_ARRAYS,
    MOTION_META,
    SLICE_ARRAYS,
    SLICE_META,
    pack_scene,
)
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.torch_meshes import (
    CBOX_XML,
    GOLDEN_GATES,
    MOTION_VECTOR_SHARE,
    ROOT,
    card_coverage,
    glass_slab_motion_xml,
    motion_big_xml,
    motion_vectors_xml,
    motion_xml,
    moving_card_xml,
    tm_rmse,
)

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:(animated shape|deformable)")

N = 4096
SCENES = {
    "motion": lambda: motion_xml(16, 16, 4),
    "motion_big": lambda: motion_big_xml(None, 16, 16, 4),
    "card": lambda: moving_card_xml("animated", spp=4, width=16, height=16),
    "deform2": lambda: moving_card_xml("deformable", 2, spp=4, width=16, height=16),
    "deform3": lambda: moving_card_xml("deformable", 3, spp=4, width=16, height=16),
    "slab": lambda: glass_slab_motion_xml("ttd", width=16, height=16),
}


class _Packs(dict):
    def __missing__(self, name):
        xml = SCENES[name]()
        self[name] = (jpack_scene(jload_string(xml)), pack_scene(load_scene_string(xml), "cpu"))
        return self[name]


@pytest.fixture(scope="module")
def packs():
    return _Packs()


def _rays(pack_t, seed, spread=1.0):
    """N seeded rays from points around the scene's centre, and times."""
    g = np.random.default_rng(seed)
    c = np.asarray(pack_t.meta["scene_center"], np.float32)
    r = pack_t.meta["scene_radius"]
    o = (c + g.uniform(-0.6, 0.6, (N, 3)) * r * spread).astype(np.float32)
    d = g.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = g.uniform(0.0, 1.0, N).astype(np.float32)
    return o, d, t


def _card_rays(seed):
    """N rays toward the moving card's sweep (z = 0) from the camera's
    side, and times."""
    g = np.random.default_rng(seed)
    o = np.stack([g.uniform(-1, 1, N), g.uniform(-0.8, 0.8, N), np.full(N, -3.0)], -1)
    tgt = np.stack([g.uniform(-1.1, 1.1, N), g.uniform(-0.8, 0.8, N), np.zeros(N)], -1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), g.uniform(0, 1, N).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _hits_equal(out, ref, scale):
    """prim equal; on the hits t, u, v within rtol 1e-5, t also within
    1e-6 of the scene's radius `scale` and u, v within 1e-5 (a hit 1.7
    units off a cbox wall whose corners lie ~500 units out moves by 5e-5
    between Moller-Trumbore forms, and the pair pipeline's u of a static
    row of MOTION_BIG by 7.7e-6 from the reference's XLA walk's; a miss's
    t is the query's t_max in the reference, 3e38 after the port's pair
    pipeline, as in tests/test_torch_pairs.py)."""
    t_o, prim_o, u_o, v_o = (x.numpy() for x in out)
    t_r, prim_r, u_r, v_r = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(prim_o, prim_r)
    hit = prim_r >= 0
    np.testing.assert_allclose(t_o[hit], t_r[hit], rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(u_o[hit], u_r[hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v_o[hit], v_r[hit], rtol=1e-5, atol=1e-5)


# ---- packs ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SCENES))
def test_packs_equal_reference(packs, name):
    """Every array and meta key of the port's pack equals the reference's:
    the partition into static, animated and deformable rows, anim_m1,
    deform_tri9_{r}, the shutter meta and the camera of the motion
    integrator among them."""
    jp, tp = packs[name]
    bvh = tp.meta["use_bvh"]
    deform = tuple(k for k in jp.arrays if k.startswith("deform_tri9_"))
    for k in SLICE_ARRAYS + MOTION_ARRAYS + deform + (BVH_ARRAYS if bvh else ()):
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]), err_msg=k)
    for k in SLICE_META + MOTION_META + (BVH_META if bvh else ()):
        assert tp.meta[k] == jp.meta[k], k
    assert set(deform) == {k for k in tp.arrays if k.startswith("deform_tri9_")}


def test_partition(packs):
    """MOTION: 24 static rows, the short block's 12 animated rows, the
    deformable card's 2 rows with its three keyframes."""
    _, tp = packs["motion"]
    assert tp.meta["n_tris"] == 38 and tp.meta["n_static_tris"] == 24
    assert tp.meta["anim_ranges"] == ((24, 12),)
    assert tp.meta["deform_ranges"] == ((36, 2, (0.0, 0.5, 1.0)),)
    assert tp.arrays["deform_tri9_0"].shape == (3, 2, 9)
    np.testing.assert_allclose(tp.anim_m1[0].numpy(), [1, 0, 0, 0, 1, 0, 0, 0, 1, 166.8, 0, 0],
                               atol=1e-4)
    assert tp.meta["shutter_open"] == 0.0 and tp.meta["shutter_close"] == 1.0


@pytest.mark.parametrize("name", ["motion", "motion_big"])
def test_static_accelerators_cover_the_prefix(packs, name):
    """tri_s and tri_t hold exactly the static prefix's columns, the BVH
    and its clusters only static rows, and the clusters' dummy slot is row
    n_tris (padding past every moving row), as in the reference pack."""
    jp, tp = packs[name]
    n_static, n_tris = tp.meta["n_static_tris"], tp.meta["n_tris"]
    assert n_static < n_tris
    assert live_columns(tp.tri_s).tolist() == list(range(n_static))
    np.testing.assert_array_equal(tp.tri_t.numpy(), np.asarray(jp.tri_t))
    if name == "motion_big":
        assert tp.meta["use_bvh"] and n_static == 516
        prims = set(tp.cl_pad2prim.numpy().tolist())
        assert n_tris in prims and max(prims - {n_tris}) < n_static
        np.testing.assert_array_equal(tp.cl_pad2prim.numpy(), np.asarray(jp.cl_pad2prim))
        assert tp.tri_v0[n_tris, 0].item() == np.float32(1e30)  # the dummy row is far away
    else:
        assert not tp.meta["use_bvh"]


# ---- intersection -----------------------------------------------------------

def test_anim_ray(packs):
    """The closed-form inverse of I + t (M1 - I) against the reference,
    for MOTION's translation and for a seeded affine M1 (rotation, scale)."""
    _, tp = packs["motion"]
    o, d, t = _rays(tp, 0)
    g = np.random.default_rng(1)
    affine = np.concatenate([(np.eye(3) + 0.3 * g.normal(size=(3, 3))).reshape(-1),
                             g.normal(size=3) * 50]).astype(np.float32)
    for m1 in (tp.anim_m1[0].numpy(), affine):
        ref = jis._anim_ray(jnp.asarray(o), jnp.asarray(d), jnp.asarray(m1), jnp.asarray(t))
        out = tis._anim_ray(_t(o), _t(d), _t(m1), _t(t))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("name,k", [("deform2", 2), ("deform3", 3), ("motion", 3)])
def test_deform_frames(packs, name, k):
    """Each lane's lerped rows of its own keyframe segment (k = 2: no
    select), including times on the keyframes and past [0, 1]."""
    jp, tp = packs[name]
    first, count, times = tp.meta["deform_ranges"][0]
    assert len(times) == k
    t = np.concatenate([np.asarray(times, np.float32), [-0.2, 1.3],
                        np.random.default_rng(2).uniform(0, 1, N - k - 2)]).astype(np.float32)
    fetch_j, pad_j = jis._deform_frames(jp, 0, count, times, jnp.asarray(t))
    fetch_t, pad_t = tis._deform_frames(tp, 0, count, times, _t(t))
    out = fetch_t(slice(0, pad_t))[:, :count].numpy()
    ref = np.asarray(fetch_j(slice(0, pad_j)))[:, :count]
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("name", ["motion", "card", "deform3"])
def test_moving_arms(packs, name):
    """_anim_closest / _deform_closest and _anim_any / _deform_any on
    their own, from the same running best hit."""
    jp, tp = packs[name]
    o, d, t = _card_rays(3) if name != "motion" else _rays(tp, 3)
    best = (np.full(N, 1e30, np.float32), np.full(N, -1, np.int32), np.zeros(N, np.float32),
            np.zeros(N, np.float32))
    tm = np.full(N, 1e30, np.float32)
    for kind in ("anim", "deform"):
        if not tp.meta[f"{kind}_ranges"]:
            continue
        jc, ja = getattr(jis, f"_{kind}_closest"), getattr(jis, f"_{kind}_any")
        tc, ta = getattr(tis, f"_{kind}_closest"), getattr(tis, f"_{kind}_any")
        ref = jc(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), *map(jnp.asarray, best))
        out = tc(tp, _t(o), _t(d), _t(t), *map(_t, best))
        _hits_equal(out, ref, tp.meta["scene_radius"])
        assert (out[1] >= 0).sum() > 50  # the arm hits
        np.testing.assert_array_equal(
            ta(tp, _t(o), _t(d), _t(t), _t(tm)).numpy(),
            np.asarray(ja(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t), jnp.asarray(tm))))


@pytest.mark.parametrize("name", ["motion", "motion_big", "card", "deform2", "deform3"])
@pytest.mark.parametrize("timed", [True, False], ids=["time", "midpoint"])
def test_intersect_occluded(packs, name, timed):
    """intersect and occluded with per-lane times and with None (the
    shutter midpoint): the static rows (K1 or the pair pipeline), then the
    animated and deformable arms; the moving cards have no static rows,
    so occluded is intersect's hit."""
    jp, tp = packs[name]
    o, d, t = _card_rays(4) if name in ("card", "deform2", "deform3") else _rays(tp, 4)
    jt, tt = (jnp.asarray(t), _t(t)) if timed else (None, None)
    ref = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d), time=jt)
    out = tis.intersect(tp, _t(o), _t(d), time=tt)
    _hits_equal((out.t, out.prim, out.u, out.v), (ref.t, ref.prim, ref.u, ref.v),
                tp.meta["scene_radius"])
    moving = out.prim.numpy() >= tp.meta["n_static_tris"]
    assert moving.sum() > 20
    tm = np.random.default_rng(5).uniform(0.1, 1.0, N).astype(np.float32) * tp.meta["scene_radius"]
    np.testing.assert_array_equal(
        tis.occluded(tp, _t(o), _t(d), _t(tm), time=tt).numpy(),
        np.asarray(jis.occluded(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), time=jt)))
    if not timed:  # None is the midpoint 0.5, not 0
        half = tis.intersect(tp, _t(o), _t(d), time=torch.full((N,), 0.5))
        np.testing.assert_array_equal(half.prim.numpy(), out.prim.numpy())


# ---- integrator functions ---------------------------------------------------

def test_shutter_time(packs):
    """Bit for bit the reference's draw; None without moving shapes."""
    jp, tp = packs["motion"]
    lane = np.arange(N, dtype=np.int64)
    sidx = np.random.default_rng(6).integers(0, 1 << 20, N)
    for seed in (0, 7):
        ref = jpath.shutter_time(jp, jnp.asarray(lane, jnp.uint32), jnp.asarray(sidx, jnp.uint32),
                                 seed)
        out = tpath.shutter_time(tp, _t(lane), _t(sidx), seed)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    static = pack_scene(mt.load_scene(CBOX_XML), "cpu")
    assert tpath.shutter_time(static, _t(lane), _t(sidx)) is None


@pytest.mark.parametrize("t_target", [0.0, 0.3, 0.5, 0.75, 1.0])
def test_motion_advance(packs, t_target):
    """Hit points moved to the target time through the animated and the
    deformable rows: bit for bit the reference's."""
    jp, tp = packs["motion"]
    o, d, t = _rays(tp, 8)
    hit = tis.intersect(tp, _t(o), _t(d), time=torch.zeros(N))
    its = tis.fill_interaction(tp, _t(o), _t(d), hit)
    tri = its.valid
    args = (its.prim, its.p, hit.u, hit.v, tri)
    out = tpath._motion_advance(tp, *args, t_target)
    ref = jpath._motion_advance(jp, *(jnp.asarray(a.numpy()) for a in args), t_target)
    assert (out != its.p).any(dim=-1).sum() > 20 or t_target == 0.0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---- renders ----------------------------------------------------------------

GOLDENS = {
    "torch_motion_32_4.npy": lambda: motion_xml(32, 32, 4),
    "torch_deform_card3_32_4.npy": lambda: moving_card_xml("deformable", 3, spp=4, width=32,
                                                           height=32),
    "torch_motion_big_32_4.npy": lambda: motion_big_xml(None, 32, 32, 4),
}


@pytest.mark.parametrize("golden", list(GOLDENS))
def test_goldens(golden):
    """The JAX package's render (tests/make_torch_bigmesh_golden.py), seed
    0, 4 spp."""
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(mt.load_scene_string(GOLDENS[golden]()), spp=4, seed=0, device="cpu")
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden], tm_rmse(img, ref)


@pytest.mark.parametrize("golden,xml", [
    ("torch_motion_vectors_d_32_1.npy", lambda: motion_vectors_xml("d")),
    ("torch_motion_vectors_ttd_32_1.npy", lambda: glass_slab_motion_xml("ttd")),
])
def test_motion_vector_goldens(golden, xml):
    """The motion integrator's (dx, dy, 0) in pixels: config "d" on MOTION
    (the short block and the card move), "ttd" through the glass slab (the
    chain re-solved at the target time), within the gate's pixels of the
    reference's, and all but MOTION_VECTOR_SHARE of them within 1e-4."""
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(mt.load_scene_string(xml()), spp=1, seed=0, device="cpu")
    assert np.abs(ref[..., 0]).max() > 2.0  # something moves by pixels
    diff = np.abs(img - ref).max(-1)
    assert diff.max() < GOLDEN_GATES[golden], diff.max()
    assert (diff > 1e-4).mean() <= MOTION_VECTOR_SHARE


@pytest.mark.parametrize("kind,frames", [("animated", 2), ("deformable", 2), ("deformable", 3)])
def test_blur_matches_analytic(kind, frames):
    """The reference tests' coverage check on the port's render: each
    pixel's brightness is the share of the shutter the moving card covers
    it (64 x 64, 256 spp; tests/test_motion.py:64-91,
    tests/test_deformable.py:66-152)."""
    img = mt.render(mt.load_scene_string(moving_card_xml(kind, frames, spp=256)), spp=256,
                    seed=0, device="cpu")
    h, w = img.shape[:2]
    row = img[h // 2].mean(axis=-1)
    expect = card_coverage(np.abs(1.0 - 2.0 * (np.arange(w) + 0.5) / w))
    sel = expect > 0.02
    assert np.abs(row - expect)[sel].max() < 0.12
    assert abs(row.sum() - expect.sum()) / expect.sum() < 0.03


def test_render_matches_reference():
    """The slice as a whole: MOTION through `render` at 24 x 24, 4 spp
    against the JAX package's render (cbox's own last-place divergence:
    8 of 576 pixels move by more than 1e-3 at this size)."""
    xml = motion_xml(24, 24, 4)
    ref = jrender(jload_string(xml), spp=4, seed=0)
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    assert tm_rmse(img, ref) < 6e-3, tm_rmse(img, ref)
    assert (np.abs(img - ref).max(-1) > 1e-3).mean() < 0.03


# ---- ROADMAP C6: faults of the reference that the port keeps ----------------

def _three_key_card(times, mid_x):
    return moving_card_xml("animated", spp=4, width=16, height=16).replace(
        '<transform time="1">',
        f'<transform time="{times[1]}"><scale x="0.25" y="0.6" z="1"/><rotate y="1" angle="180"/>'
        f'<translate x="{mid_x}"/></transform><transform time="{times[2]}">').replace(
        '<transform time="0">', f'<transform time="{times[0]}">')


def test_c6_keyframe_times_ignored():
    """C6, first part: both packages interpolate from the first keyframe
    to the last with the draw as the fraction; a middle keyframe (here
    far off the line) and the keyframes' times change nothing."""
    base = moving_card_xml("animated", spp=4, width=16, height=16)
    odd = _three_key_card((0.0, 0.2, 5.0), 3.0)
    for pack_fn, load in ((jpack_scene, jload_string),
                          (lambda s: pack_scene(s, "cpu"), load_scene_string)):
        a, b = pack_fn(load(base)), pack_fn(load(odd))
        np.testing.assert_array_equal(np.asarray(a.arrays["anim_m1"]),
                                      np.asarray(b.arrays["anim_m1"]))
    ref = jrender(jload_string(odd), spp=4, seed=0)
    img = mt.render(mt.load_scene_string(odd), spp=4, seed=0, device="cpu")
    np.testing.assert_array_equal(img, mt.render(mt.load_scene_string(base), spp=4, seed=0,
                                                 device="cpu"))
    np.testing.assert_allclose(img, ref, atol=1e-6)


def test_c6_shutter_interval_ignored():
    """C6, second part: a shutter that never opens (open = close = 0.5)
    blurs as one open over [0, 1] in both packages; the interval reaches
    the meta only."""
    base = moving_card_xml("animated", spp=4, width=16, height=16)
    shut = base.replace('<float name="shutterOpen" value="0"/><float name="shutterClose" value="1"/>',
                        '<float name="shutterOpen" value="0.5"/>'
                        '<float name="shutterClose" value="0.5"/>')
    tp = pack_scene(load_scene_string(shut), "cpu")
    assert tp.meta["shutter_open"] == tp.meta["shutter_close"] == 0.5
    img = mt.render(mt.load_scene_string(shut), spp=4, seed=0, device="cpu")
    np.testing.assert_array_equal(img, mt.render(mt.load_scene_string(base), spp=4, seed=0,
                                                 device="cpu"))
    np.testing.assert_allclose(img, jrender(jload_string(shut), spp=4, seed=0), atol=1e-6)
    row = img[8].mean(-1)
    assert ((row > 0.05) & (row < 0.95)).any()  # partly covered pixels: blur


def test_c6_midpoint_without_a_time():
    """C6, third part: an integrator that draws no time (volpath here, in
    a scene with a medium) meets the moving card at the shutter midpoint:
    its render equals the render of the card frozen at x = 0, in both
    packages."""
    fog = ('<shape type="sphere"><point name="center" x="0" y="0" z="-2"/>'
           '<float name="radius" value="0.3"/><bsdf type="null"/>'
           '<medium name="interior" type="homogeneous"><rgb name="sigmaS" value="0.2"/>'
           '<rgb name="sigmaA" value="0.1"/></medium></shape></scene>')
    moving = moving_card_xml("animated", spp=4, width=16, height=16)
    frozen = moving_card_xml("deformable", 2, spp=4, width=16, height=16).replace(
        'x="-0.75"', 'x="0"').replace('x="0.75"', 'x="0"')
    lit = '<emitter type="constant"><rgb name="radiance" value="1"/></emitter>' + fog
    imgs = []
    for xml in (moving, frozen):
        # a diffuse card under a constant light: NEE samples no emitter
        # on the card, which the reference samples at keyframe 0
        xml = xml.replace('<emitter type="area"><rgb name="radiance" value="1, 1, 1"/></emitter>',
                          '<bsdf type="diffuse"/>')
        xml = xml.replace('type="path"', 'type="volpath"').replace("</scene>", lit)
        ref = jrender(jload_string(xml), spp=4, seed=0)
        img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
        np.testing.assert_allclose(img, ref, atol=1e-5)
        imgs.append(img)
    assert imgs[0].max() > 0.2
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-5)
