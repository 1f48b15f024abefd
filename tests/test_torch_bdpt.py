"""The port's bidirectional path tracer against the reference
(mitsuba_tpu/integrator/bdpt.py) on seeded numpy inputs: `_to_area`,
`_remap0`, `_mis_weight` at several (s, t), the light vertex of every
kind in BDPT_KINDS, a few walk steps on cbox, one chunk of
scenes/glass_caustics.xml at 16x16, maxDepth 4 (with the counter RNG and
with an explicit primary-sample tensor U), chunks under constant,
envmap, directional and five-kind lights and on cbox with
exclude_direct, a render under a spot light,
the edge budget and the envelope; and the 16-edge enumeration on glass as
it stands, and the media scene, against goldens the reference rendered
(tests/make_torch_bigmesh_golden.py).

Function-level tolerance: rtol 1e-5, atol 1e-6; integer and boolean
outputs equal.  The envmap's light vertex takes rtol 1e-3, atol 1e-5: its
sampled directions and pdfs differ between XLA and PyTorch in the last
places (ROADMAP C, "The envmap's functions").  A chunk's and a walk's per-lane results
take rtol 3e-4: a lane sums up to a dozen strategies along paths
refracted through the glass sphere, where the last-place differences of
sqrt, rsqrt and the trigonometric functions add up (measured: at most
1.2e-4 relative, on 3 of 3,072 values).  Renders against the reference
live: tone-mapped RMSE < 5e-3, the gate of tests/test_golden.py; against
the goldens: tests/torch_meshes.py GOLDEN_GATES (2e-6 glass, 1e-7 spot and
media), a few times above the port's readings.

The reference traces the glass scene through its XLA BVH walk here; the
port through its pair pipeline.  On this scene the two agree (no coplanar
faces): the port meets either at tone-mapped RMSE 3.4e-7 (16x16, 4 spp,
maxDepth 4)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import bdpt as jb
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene as jload
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu.sensor.plugins import generate_rays as jgen
from mitsuba_tpu_torch.emitter.plugins import AREA, CONSTANT, ENVMAP
from mitsuba_tpu_torch.integrator import bdpt as tb
from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    CBOX_XML,
    GOLDEN_GATES,
    ROOT,
    bdpt_media_xml,
    delta_mix_xml,
    glass_xml,
    two_wall_xml,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_ENV = dict(rtol=1e-3, atol=1e-5)
TOL_LANE = dict(rtol=3e-4, atol=1e-6)
GOLDEN = os.path.join(ROOT, "tests", "golden")
SKY = os.path.join(ROOT, "scenes", "assets", "sky.exr")
N = 2048


def _close(out, ref, tol=TOL, **kw):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol, **kw)


def _tm_rmse(a, b):
    return float(np.sqrt(np.mean((a / (1 + a) - b / (1 + b)) ** 2)))


def _packs(xml):
    js, ts = jload_string(xml), mt.load_scene_string(xml)
    return js, jpack_scene(js), ts, pack_scene(ts, "cpu")


def _lanes(n, seed=0):
    r = np.random.default_rng(seed)
    lane = r.integers(0, 1 << 20, n).astype(np.uint32)
    sidx = r.integers(0, 64, n).astype(np.uint32)
    return (jnp.asarray(lane), jnp.asarray(sidx),
            torch.as_tensor(lane.astype(np.int64)), torch.as_tensor(sidx.astype(np.int64)))


# ---- helpers ----

def test_to_area_and_remap0():
    r = np.random.default_rng(0)
    pdf = r.uniform(0, 5, N).astype(np.float32)
    pdf[::7] = 0.0
    p_from, p_to = (r.normal(size=(N, 3)).astype(np.float32) for _ in range(2))
    p_to[::11] = p_from[::11]  # coincident points: the clamped d2
    ns = r.normal(size=(N, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    med = r.uniform(size=N) < 0.3
    for medium in (None, med):
        ref = jb._to_area(*map(jnp.asarray, (pdf, p_from, p_to, ns)),
                          medium_to=None if medium is None else jnp.asarray(medium))
        out = tb._to_area(*map(torch.as_tensor, (pdf, p_from, p_to, ns)),
                          medium_to=None if medium is None else torch.as_tensor(medium))
        _close(out, ref)
    _close(tb._remap0(torch.as_tensor(pdf)), jb._remap0(jnp.asarray(pdf)))


def _random_vertices(r, n_verts, light):
    verts = []
    for k in range(n_verts):
        v = {
            "pdf_fwd": r.uniform(0, 3, N).astype(np.float32) * (r.uniform(size=N) > 0.1),
            "pdf_rev": r.uniform(0, 3, N).astype(np.float32) * (r.uniform(size=N) > 0.1),
            "delta": r.uniform(size=N) < 0.2,
        }
        if light and k == 0:
            v["hittable"] = r.uniform(size=N) < 0.7
        verts.append(v)
    return verts


def _as(verts, conv):
    return [{k: conv(v) for k, v in vert.items()} for vert in verts]


@pytest.mark.parametrize("s,t", [(0, 2), (0, 5), (1, 2), (1, 4), (2, 2), (3, 3), (2, 5),
                                 (4, 1), (1, 1), (5, 2)])
def test_mis_weight(s, t):
    """The ratio walk with junction overrides on random pdfs (zeros and
    delta flags included) at several strategies."""
    r = np.random.default_rng(100 * s + t)
    cam = _random_vertices(r, max(t - 1, 1), light=False)
    light = _random_vertices(r, max(s, 1), light=True)
    over = {}
    if t >= 2:
        over[("c", t - 2)] = r.uniform(0, 2, N).astype(np.float32)
    if t >= 3:
        over[("c", t - 3)] = r.uniform(0, 2, N).astype(np.float32)
    if s >= 1:
        over[("l", s - 1)] = r.uniform(0, 2, N).astype(np.float32)
    if s >= 2:
        over[("l", s - 2)] = r.uniform(0, 2, N).astype(np.float32)
    false = np.zeros(N, bool)
    ref = jb._mis_weight(s, t, _as(cam, jnp.asarray), _as(light, jnp.asarray),
                         {k: jnp.asarray(v) for k, v in over.items()}, jnp.asarray(false))
    out = tb._mis_weight(s, t, _as(cam, torch.as_tensor), _as(light, torch.as_tensor),
                         {k: torch.as_tensor(v) for k, v in over.items()},
                         torch.as_tensor(false))
    _close(out, ref)
    assert (out.numpy() < 1).any() or (s + t <= 2)


def test_edge_budget(monkeypatch, capsys):
    """bdpt_max_edges: maxDepth, capped with the reference's warning; the
    default for an unbounded maxDepth; and primary_dims."""
    for depth in (4, 16, 24, -1):
        integ = IntegratorRecord(kind="bdpt", max_depth=depth)
        assert tb.bdpt_max_edges(integ) == jb.bdpt_max_edges(integ)
    capsys.readouterr()
    tb.bdpt_max_edges(IntegratorRecord(kind="bdpt", max_depth=24))
    assert "[bdpt] maxDepth 24 capped to 16 edges (MTS_BDPT_MAX_EDGES)" in capsys.readouterr().out
    monkeypatch.setenv("MTS_BDPT_MAX_EDGES", "6")
    monkeypatch.setenv("MTS_BDPT_DEFAULT_EDGES", "5")
    for depth in (4, 8, -1):
        integ = IntegratorRecord(kind="bdpt", max_depth=depth)
        assert tb.bdpt_max_edges(integ) == jb.bdpt_max_edges(integ)
    for edges in (1, 4, 16):
        for media in (False, True):
            assert tb.primary_dims(edges, media) == jb.primary_dims(edges, media)


# ---- the light vertex, each kind ----

_AREA_LIGHT = """<shape type="rectangle"><transform name="toWorld"><scale value="0.5"/>
  <rotate x="1" angle="90"/><translate y="2.5"/></transform>
  <emitter type="area"><rgb name="radiance" value="5, 4, 3"/></emitter></shape>"""
LIGHT_SCENES = {
    "area": two_wall_xml(_AREA_LIGHT, "bdpt"),
    "point": two_wall_xml("point", "bdpt"),
    "spot": two_wall_xml("spot", "bdpt"),
    "directional": two_wall_xml("directional", "bdpt"),
    "collimated": two_wall_xml("collimated", "bdpt"),
    "constant": two_wall_xml('<emitter type="constant"><rgb name="radiance" value="0.6, 0.7, 0.9"/>'
                             "</emitter>", "bdpt"),
    "envmap": two_wall_xml(f'<emitter type="envmap"><string name="filename" value="{SKY}"/>'
                           "</emitter>", "bdpt"),
    "mix": delta_mix_xml("bdpt"),
}


@pytest.mark.parametrize("name", list(LIGHT_SCENES))
def test_sample_light_vertex(name):
    """Light vertex 0 and the first emission ray of every kind in
    BDPT_KINDS, and of a scene whose emitter pick reaches five kinds."""
    _, jp, _, tp = _packs(LIGHT_SCENES[name])
    assert tb.supports_bdpt(tp) and jb.supports_bdpt(jp)
    jl, js, tl, ts = _lanes(N, 1)
    seed = 7
    ref = jb._sample_light_vertex(jp, jl, js, seed)
    out = tb._sample_light_vertex(tp, tl, ts, seed)
    tol = TOL_ENV if name == "envmap" else TOL
    v_ref, v_out = ref[0], out[0]
    for k in ("emit", "kind", "delta", "hittable", "is_inf", "is_medium", "med"):
        np.testing.assert_array_equal(v_out[k].numpy(), np.asarray(v_ref[k]), err_msg=k)
    for k in ("p", "ns", "beta", "pdf_fwd"):
        _close(v_out[k], v_ref[k], tol, err_msg=k)
    for i, k in ((1, "o1"), (2, "d1"), (3, "beta1"), (4, "pdf_w1"), (6, "planar0")):
        _close(out[i], ref[i], tol, err_msg=k)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[5]))  # delta1
    kinds = set(np.unique(v_out["kind"].numpy()).tolist())
    if name == "mix":
        assert kinds == {AREA, 1, 2, 3, 4}
    assert (v_out["beta"].numpy().max(-1) > 0).all()
    assert v_out["is_inf"].numpy().all() == (kinds <= {CONSTANT, ENVMAP})


def test_explicit_light_samples():
    """u01 in place of the counter RNG (the chain samplers' path)."""
    _, jp, _, tp = _packs(LIGHT_SCENES["mix"])
    r = np.random.default_rng(3)
    u, u2 = r.uniform(size=(N, 4)).astype(np.float32), r.uniform(size=(N, 4)).astype(np.float32)
    jl, js, tl, ts = _lanes(N, 2)
    ref = jb._sample_light_vertex(jp, jl, js, 0, u01=(jnp.asarray(u), jnp.asarray(u2)))
    out = tb._sample_light_vertex(tp, tl, ts, 0, u01=(torch.as_tensor(u), torch.as_tensor(u2)))
    for k in ("p", "beta", "pdf_fwd"):
        _close(out[0][k], ref[0][k], err_msg=k)
    _close(out[2], ref[2])


# ---- the walk ----

def test_walk_steps_on_cbox():
    """Three steps of the camera walk on cbox from its camera rays."""
    jsc = jload(CBOX_XML)
    tsc = mt.load_scene(CBOX_XML)
    jp, tp = jpack_scene(jsc), pack_scene(tsc, "cpu")
    r = np.random.default_rng(4)
    pos = r.uniform(0.02, 0.98, (N, 2)).astype(np.float32)
    o, d = jgen(jsc.sensor.record.pack(64, 64), jnp.asarray(pos), jnp.zeros((N, 2)))
    o, d = np.array(o), np.array(d)
    jl, js, tl, ts = _lanes(N, 5)
    pdf0 = r.uniform(0.5, 2, N).astype(np.float32)
    false = np.zeros(N, bool)
    ref = jb._walk(jp, jnp.asarray(o), jnp.asarray(d), jnp.ones((N, 3)), jnp.asarray(pdf0),
                   jl, js, 3, 3, jp.present_types, jnp.asarray(false))
    out = tb._walk(tp, torch.as_tensor(o), torch.as_tensor(d), torch.ones(N, 3),
                   torch.as_tensor(pdf0), tl, ts, 3, 3, tp.meta["present_types"],
                   torch.as_tensor(false))
    assert len(out) == len(ref) == 3
    for k_step, (vo, vr) in enumerate(zip(out, ref)):
        for k in ("valid", "delta", "emit", "is_medium", "_hit_valid"):
            np.testing.assert_array_equal(vo[k].numpy(), np.asarray(vr[k]),
                                          err_msg=f"{k} step {k_step}")
        # cbox's coordinates reach 560, where a float32 ulp is 6.1e-5
        _close(vo["p"], vr["p"], dict(rtol=1e-5, atol=2e-4), err_msg=f"p step {k_step}")
        for k in ("ns", "ng", "wi", "beta", "_pdf_w_in"):
            _close(vo[k], vr[k], TOL_LANE, err_msg=f"{k} step {k_step}")
        # an area pdf divides by the squared length of the segment, whose
        # ends carry those ulps: held where both segments at the vertex
        # are longer than 1 (the box is 550 wide)
        p = vr["p"]
        prev = o if k_step == 0 else ref[k_step - 1]["p"]
        nxt = ref[k_step + 1]["p"] if k_step + 1 < len(ref) else p + 10.0
        far = np.minimum(np.linalg.norm(np.asarray(p - prev), axis=-1),
                         np.linalg.norm(np.asarray(nxt - p), axis=-1)) > 1.0
        assert far.mean() > 0.5
        for k in ("pdf_fwd", "pdf_rev"):
            np.testing.assert_allclose(vo[k].numpy()[far], np.asarray(vr[k])[far], **TOL_LANE,
                                       err_msg=f"{k} step {k_step}")
        assert vo["valid"].numpy().mean() > 0.5
    _close(out[0]["_rev_w_to_origin"], ref[0]["_rev_w_to_origin"])


# ---- a glass chunk ----

@pytest.fixture(scope="module")
def glass4():
    """One chunk of glass at 16x16, 4 spp, maxDepth 4: its lanes as
    render_bdpt lays them out; the reference run eagerly (one chunk)."""
    js, jp, ts, tp = _packs(glass_xml(16, 16, max_depth=4))
    lane = np.tile(np.arange(256), 4).astype(np.uint32)
    sidx = np.repeat(np.arange(4), 256).astype(np.uint32)
    args = (jnp.asarray(lane), jnp.asarray(sidx),
            torch.as_tensor(lane.astype(np.int64)), torch.as_tensor(sidx.astype(np.int64)))
    fns = (jb.make_bdpt_chunk(jp, js.integrator, js.sensor.record, 16, 16, 0),
           tb.make_bdpt_chunk(tp, ts.integrator, ts.sensor.record, 16, 16, 0))
    return jp, tp, fns, args


def _check_chunk(ref, out, min_lit=0.2, diverged=0):
    """A chunk's estimates and light-image splats against the reference's,
    lane by lane at TOL_LANE, but for at most `diverged` lanes of each."""
    (L_ref, spl_ref), (L_out, spl_out) = ref, out

    def off(a, b):
        return int((~np.isclose(a, np.asarray(b), **TOL_LANE)).any(axis=-1).sum())

    assert off(L_out.numpy(), L_ref) <= diverged
    assert len(spl_out) == len(spl_ref)
    for (p_r, v_r, ok_r), (p_o, v_o, ok_o) in zip(spl_ref, spl_out):
        ok = np.asarray(ok_r) & ok_o.numpy()
        assert int((np.asarray(ok_r) != ok_o.numpy()).sum()) <= diverged
        assert off(v_o.numpy(), v_r) <= diverged
        np.testing.assert_allclose(p_o.numpy()[ok], np.asarray(p_r)[ok], rtol=1e-5, atol=1e-4)
    assert (L_out.numpy().max(-1) > 0).mean() > min_lit


def test_glass_chunk_counter_rng(glass4):
    _, _, (jf, tf), (jl, js, tl, ts) = glass4
    out = tf(tl, ts)
    _check_chunk(jf(jl, js), out)
    assert int(tf.stats["rays"]) > 0
    assert any(ok.any() for _, _, ok in out[1])


def test_glass_chunk_explicit_u(glass4):
    """chunk_fn(U=...): every decision from the primary-sample tensor."""
    jp, _, (jf, tf), (jl, js, tl, ts) = glass4
    dims = jb.primary_dims(4, jp.meta.get("has_media", False))
    assert tb.primary_dims(4) == dims
    U = np.random.default_rng(6).uniform(0, 1, (jl.shape[0], dims)).astype(np.float32)
    _check_chunk(jf(jl, js, U=jnp.asarray(U)), tf(tl, ts, U=torch.as_tensor(U)))


def test_cbox_chunk_exclude_direct():
    """exclude_direct (the strategies of at most 2 edges dropped, as the
    chain samplers' separateDirect mode asks) on cbox at maxDepth 4: the
    estimates and the light image of a 16x16, 2-spp chunk."""
    from tests.torch_meshes import with_integrator

    with open(CBOX_XML) as f:
        xml = with_integrator(f.read(), "bdpt", max_depth=4)
    js, jp, ts, tp = _packs(xml)
    lane = np.tile(np.arange(256), 2).astype(np.uint32)
    sidx = np.repeat(np.arange(2), 256).astype(np.uint32)
    ref = jb.make_bdpt_chunk(jp, js.integrator, js.sensor.record, 16, 16, 4,
                             exclude_direct=True)(jnp.asarray(lane), jnp.asarray(sidx))
    out = tb.make_bdpt_chunk(tp, ts.integrator, ts.sensor.record, 16, 16, 4, exclude_direct=True)(
        torch.as_tensor(lane.astype(np.int64)), torch.as_tensor(sidx.astype(np.int64)))
    assert len(out[1]) == len(ref[1]) == 2  # the light image's s = 3, 4
    # cbox's paths diverge on a few lanes (ROADMAP C, "cbox 7.8e-4 / 8.6e-4,
    # not 0": last places of log, cos and rsqrt; measured: 1 lane of 512)
    _check_chunk(ref, out, diverged=3)


@pytest.mark.parametrize("name", ["constant", "envmap", "directional", "mix"])
def test_light_kinds_chunk(name):
    """A chunk on the two-wall scene under each kind of light whose
    strategies the glass scene does not reach: the s = 0 environment
    escape, the planar disk density of directional and infinite lights,
    and the emitter pick over five kinds (16x16, 2 spp, maxDepth 3)."""
    from tests.torch_meshes import with_integrator

    xml = with_integrator(LIGHT_SCENES[name], "bdpt", max_depth=3)
    xml = xml.replace('name="width" value="24"', 'name="width" value="16"').replace(
        'name="height" value="24"', 'name="height" value="16"')
    js, jp, ts, tp = _packs(xml)
    lane = np.tile(np.arange(256), 2).astype(np.uint32)
    sidx = np.repeat(np.arange(2), 256).astype(np.uint32)
    ref = jb.make_bdpt_chunk(jp, js.integrator, js.sensor.record, 16, 16, 2)(
        jnp.asarray(lane), jnp.asarray(sidx))
    out = tb.make_bdpt_chunk(tp, ts.integrator, ts.sensor.record, 16, 16, 2)(
        torch.as_tensor(lane.astype(np.int64)), torch.as_tensor(sidx.astype(np.int64)))
    # the envmap's sampled directions differ in the last places (ROADMAP C)
    _check_chunk(ref, out, min_lit=0.3, diverged=3 if name == "envmap" else 0)


# ---- renders ----

def test_render_spot_matches_reference():
    """render_bdpt against the reference's on the two-wall scene under a
    spot light (delta lights reach bdpt through the s = 1 re-sampling),
    16x16, 4 spp, maxDepth 4."""
    xml = two_wall_xml("spot", "bdpt", max_depth=4, spp=4, width=16, height=16)
    ref = np.asarray(jb.render_bdpt(jload_string(xml), spp=4, seed=3))
    out = mt.render(mt.load_scene_string(xml), spp=4, seed=3, device="cpu")
    assert out.shape == ref.shape == (16, 16, 3)
    assert _tm_rmse(out, ref) < 5e-3, _tm_rmse(out, ref)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_glass_16_edges_meets_golden(capsys):
    """scenes/glass_caustics.xml as it stands (maxDepth 24 capped to 16
    edges) at 16x16, 4 spp, against the reference's render through its
    pair pipeline (tests/golden/torch_glass_bdpt_16_4.npy).  Its paths
    past 5 edges reach the light through the sphere's delta vertices, by
    the s = 0 and s = 1 strategies: with s = 1 dropped past 5 edges the
    render moves by 9.1e-3.  Connections and light-image splats past 5
    edges do not move it; test_media_meets_golden holds those."""
    golden = np.load(os.path.join(GOLDEN, "torch_glass_bdpt_16_4.npy"))
    scene = mt.load_scene_string(glass_xml(16, 16))
    out = mt.render(scene, spp=4, seed=0, device="cpu")
    assert "capped to 16 edges" in capsys.readouterr().out
    gate = GOLDEN_GATES["torch_glass_bdpt_16_4.npy"]
    assert _tm_rmse(out, golden) < gate, _tm_rmse(out, golden)
    assert np.isfinite(out).all() and out.mean() > 0.1


def test_media_meets_golden():
    """tests/test_bdpt.py's media scene (medium vertices, attenuated
    connections through a null boundary) at maxDepth 6, 24x24, 16 spp."""
    golden = np.load(os.path.join(GOLDEN, "torch_media_bdpt_24_16.npy"))
    out = mt.render(mt.load_scene_string(bdpt_media_xml("bdpt", max_depth=6, spp=16)), seed=0,
                    device="cpu")
    assert _tm_rmse(out, golden) < GOLDEN_GATES["torch_media_bdpt_24_16.npy"], _tm_rmse(out, golden)


def test_spot_meets_golden():
    """tests/test_bdpt.py's two-wall scene under a spot light (the s = 1
    re-sampling of a delta light) at maxDepth 8, 24x24, 16 spp."""
    golden = np.load(os.path.join(GOLDEN, "torch_spot_bdpt_24_16.npy"))
    out = mt.render(mt.load_scene_string(two_wall_xml("spot", "bdpt", max_depth=8, spp=16)),
                    seed=0, device="cpu")
    assert _tm_rmse(out, golden) < GOLDEN_GATES["torch_spot_bdpt_24_16.npy"], _tm_rmse(out, golden)


def test_outside_envelope_falls_back_to_path(capsys):
    """A scene without emitters renders with the path backend, as the
    reference does."""
    xml = two_wall_xml("", "bdpt", max_depth=3, spp=2, width=8, height=8)
    _, jp, ts, tp = _packs(xml)
    assert not tb.supports_bdpt(tp) and not jb.supports_bdpt(jp)
    out = mt.render(ts, spp=2, seed=0, device="cpu")
    assert "unidirectional path backend" in capsys.readouterr().out
    assert ts.integrator.kind == "bdpt" and out.shape == (8, 8, 3) and out.max() == 0.0
