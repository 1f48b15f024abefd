"""The port's volumetric path tracer against the reference: the `null`
BSDF, the media on either side of a hit, the attenuated shadow ray, the
event loop, and scenes/smoke.xml rendered whole.

The JAX package traces BVH scenes on its TPU through its pair pipeline
(K3/K4, K7 on overflow) and off it with an XLA BVH walk; the two break
exact-t ties differently, and scenes/smoke.xml's cube stands on its floor
(coplanar faces).  The port's kernels follow the pair pipeline, so the
reference runs here through `reference_pair_traversal` (its Pallas
kernels in interpret mode).

Tolerances:

* the null BSDF's sample (wo, weight, pdf, delta, eta), eval and pdf:
  equal;
* med_in / med_ex: equal on every hit (-1 on a miss in the port);
* `_attenuated_visibility` on the smoke's shadow rays: rtol 1e-5;
* volpath on a medium-free scene (cbox): the port's `path` image,
  exactly (reference tests/test_volpath.py:128);
* scenes/smoke.xml at 24 x 24, 4 spp (one pass of the batched
  wavefront) against the reference's render pass: tone-mapped RMSE <
  5e-3 and the mean within 2e-3 relative (measured 4e-8 and 7e-8), the
  same count of rays traced.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.bsdf import eval as jbsdf
from mitsuba_tpu.integrator import volpath as jvp
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.bsdf import eval as tbsdf
from mitsuba_tpu_torch.bsdf.plugins import DIFFUSE, NULL_BSDF
from mitsuba_tpu_torch.core import lanes, rng
from mitsuba_tpu_torch.emitter import eval as tem
from mitsuba_tpu_torch.integrator import volpath as tvp
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.sensor.plugins import generate_rays
from tests.make_torch_bigmesh_golden import reference_pair_traversal
from tests.test_torch_media import homogeneous_xml
from tests.torch_meshes import CBOX_XML, smoke_xml

torch.set_num_threads(1)

W = 24


def _tonemapped_rmse(img, ref):
    return float(np.sqrt(np.mean((img / (1 + img) - ref / (1 + ref)) ** 2)))


@pytest.fixture(scope="module")
def smoke():
    xml = smoke_xml(W, W)
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


def _camera(ts, sample=0):
    """One ray per pixel of the scene's film, jittered as the renderer's
    batched branch jitters sample `sample`; with (lane, sidx)."""
    rec = ts.sensor.record
    w, h = rec.film.width, rec.film.height
    lane = torch.arange(w * h)
    sidx = torch.full((w * h,), sample, dtype=torch.int64)
    jit = rec.sampler.pixel_sample(lane, sidx, rec.sampler.sample_count)
    pos = torch.stack([((lane % w).float() + jit[:, 0]) / w,
                       ((lane // w).float() + jit[:, 1]) / h], -1)
    o, d = generate_rays(rec.pack(w, h, "cpu"), pos, torch.zeros_like(pos))
    return o, d, lane, sidx


def _j(*xs):
    return [jnp.asarray(x.numpy().astype(np.uint32) if x.dtype == torch.int64 else x.numpy())
            for x in xs]


def test_null_bsdf():
    n = 4096
    g = np.random.default_rng(0)
    wi = g.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = -wi[::-1].copy()
    u2, ul = g.uniform(size=(n, 2)).astype(np.float32), g.uniform(size=n).astype(np.float32)
    kinds = np.where(np.arange(n) % 2 == 0, NULL_BSDF, DIFFUSE).astype(np.int32)
    sp = {"type": kinds, "cA": np.full((n, 3), 0.5, np.float32),
          "twosided": np.zeros(n, np.float32)}
    tsp = {k: torch.as_tensor(v) for k, v in sp.items()}
    jsp = {k: jnp.asarray(v) for k, v in sp.items()}
    present = (DIFFUSE, NULL_BSDF)
    out = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), torch.as_tensor(u2), torch.as_tensor(ul),
                            present)
    ref = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), jnp.asarray(u2), jnp.asarray(ul), present)
    null = kinds == NULL_BSDF
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy()[null], np.asarray(b)[null])
    np.testing.assert_array_equal(out.wo.numpy()[null], -wi[null])
    assert out.delta.numpy()[null].all()
    for fn in ("bsdf_eval", "bsdf_pdf"):
        a = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), present).numpy()
        b = np.asarray(getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), present))
        np.testing.assert_array_equal(a, b)
        assert not a[null].any()
    assert NULL_BSDF in tbsdf.DELTA_TYPES and set(tbsdf.DELTA_TYPES) <= set(jbsdf.DELTA_TYPES)


@pytest.mark.parametrize("scene", ["smoke", "spheres"])
def test_interaction_media(smoke, scene):
    """med_in / med_ex of triangle hits (the smoke's cube) and of analytic
    sphere hits."""
    if scene == "smoke":
        ts, js, tp, jp = smoke
    else:
        xml = homogeneous_xml()
        ts, js = mt.load_scene_string(xml), jload_string(xml)
        tp, jp = pack_scene(ts, "cpu"), jpack_scene(js)
    o, d, _, _ = _camera(ts)
    hit = tis.intersect(tp, o, d)
    its = tis.fill_interaction(tp, o, d, hit)
    jo, jd = _j(o, d)
    with reference_pair_traversal():
        jits = jax.jit(lambda o, d: jis.fill_interaction(jp, o, d, jis.intersect(jp, o, d)))(jo, jd)
    valid = its.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jits.valid))
    for k in ("med_in", "med_ex"):
        np.testing.assert_array_equal(getattr(its, k).numpy()[valid],
                                      np.asarray(getattr(jits, k))[valid])
        assert (getattr(its, k).numpy()[~valid] == -1).all()
    assert (its.med_in.numpy()[valid] >= 0).any()


def test_attenuated_visibility(smoke):
    """The first NEE's shadow rays from the camera rays' hits, through the
    null cube and the smoke (finite t_max per segment)."""
    ts, js, tp, jp = smoke
    o, d, lane, sidx = _camera(ts)
    its = tis.fill_interaction(tp, o, d, tis.intersect(tp, o, d))
    u = rng.rand4(lane, sidx, tvp._SLOT_NEE, 0)
    ds = tem.sample_direct(tp, its.p, u[..., :3])
    med = torch.where(its.valid, its.med_ex, -1)
    tr, crossed = tvp._attenuated_visibility(tp, its.p, ds.d, ds.dist, med, lane, sidx, 0, 0)
    tr = tr.numpy()
    with reference_pair_traversal():
        ref = np.asarray(jax.jit(lambda *a: jvp._attenuated_visibility(jp, *a, 0, 0))(
            *_j(its.p, ds.d, ds.dist, med, lane, sidx)))
    np.testing.assert_allclose(tr, ref, rtol=1e-5, atol=1e-7)
    assert ((tr[:, 0] > 0) & (tr[:, 0] < 0.95)).any()  # attenuated by the smoke
    assert int(crossed) > 0  # through the null cube


def test_event_loop_exit_checks(smoke, monkeypatch):
    """The event loop gives the same output with its exit checked every
    event and every 8 (the tracking loop inside too)."""
    ts, _, tp, _ = smoke
    o, d, lane, sidx = _camera(ts, sample=2)
    outs = []
    for every in (1, 8):
        monkeypatch.setattr(lanes, "EXIT_CHECK_EVERY", every)
        outs.append(tvp.volpath_trace(tp, ts.integrator, o, d, lane, sidx,
                                      ts.sensor.record.sampler, 0))
    assert torch.equal(*outs)


def test_volpath_without_media_is_path():
    scene = mt.load_scene(CBOX_XML)
    scene.sensor.record.film.width = scene.sensor.record.film.height = 16
    scene.integrator.kind = "volpath"
    a = mt.render(scene, spp=4, seed=3, device="cpu")
    scene.integrator = copy.copy(scene.integrator)
    scene.integrator.kind = "path"
    b = mt.render(scene, spp=4, seed=3, device="cpu")
    assert np.array_equal(a, b) and a.mean() > 0


@pytest.fixture(scope="module")
def smoke_ref(smoke):
    """The reference's render pass of the whole frame at 4 spp (the
    batched wavefront): (image, rays traced)."""
    from mitsuba_tpu.film.film import develop as jdevelop
    from mitsuba_tpu.film.film import new_film as jnew_film
    from mitsuba_tpu.renderer import make_render_pass as jmake_render_pass

    _, js, _, jp = smoke
    rec = js.sensor.record
    with reference_pair_traversal():
        rp = jax.jit(jmake_render_pass(jp, js.integrator, rec, rec.film, rec.sampler, 4,
                                       with_stats=True))
        film, rays = rp(jnew_film(W, W), jnp.uint32(0), jnp.uint32(0))
    return np.asarray(jdevelop(film)), int(rays)


def test_smoke_matches_reference(smoke_ref):
    """scenes/smoke.xml through the port's entry point (one pass of the
    batched wavefront): the image and the rays traced."""
    img = mt.render(mt.load_scene_string(smoke_xml(W, W)), spp=4, seed=0, device="cpu")
    rays = int(tvp.volpath_trace.last_ray_count)
    assert int(tvp.volpath_trace.last_medium_events) > 0
    assert int(tvp.volpath_trace.last_null_crossings) > 0
    ref, ref_rays = smoke_ref
    assert img.shape == ref.shape == (W, W, 3) and np.isfinite(img).all()
    assert _tonemapped_rmse(img, ref) < 5e-3
    assert abs(img.mean() - ref.mean()) < 2e-3 * ref.mean()
    assert rays == ref_rays
