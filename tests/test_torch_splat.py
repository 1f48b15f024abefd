"""The port's reconstruction filters and splatting film branch against the
reference on seeded numpy inputs, and the batched wavefront they serve.

Tolerances:

* the filter plugins' records and `filter_importance_sample` (box, tent,
  gaussian): equal, and rtol 1e-6;
* `filter_eval_1d` (all six filters): rtol 1e-6, atol 1e-7;
* `splat_grid` on seeded [S, H, W] jitter and values: rtol 1e-5 (float
  sums over the samples in another order), atol 1e-6;
* scenes/cbox.xml under the mitchell filter (the batched wavefront,
  `path_trace`, `splat_grid`) at 32 x 32, 4 spp, against the JAX
  package's render: tone-mapped RMSE < 5e-3 (tests/test_golden.py's
  gate) and the mean within 2e-3 relative; at 64 x 64, 16 spp against
  tests/golden/torch_cbox_mitchell_64_16.npy at the same gate.  One of
  4,096 lanes ends on another triangle edge than in the reference (the
  edge rays of ROADMAP C), which a mitchell footprint spreads: RMSE
  measured 1.4e-3 and 6.3e-4;
* `path_trace` per lane against the reference's on the Cornell box's
  camera rays: rtol 1e-4 on all but at most 1 lane in 1,000, equal ray
  counts.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.film import film as jfilm
from mitsuba_tpu.film import plugins as jfp
from mitsuba_tpu.integrator import path as jpath
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.film import film as tfilm
from mitsuba_tpu_torch.film import plugins as tfp
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.renderer import uses_regen
from mitsuba_tpu_torch.scene.builder import ScenePack, pack_scene
from mitsuba_tpu_torch.sensor.plugins import generate_rays
from tests.torch_meshes import ROOT, cbox_mitchell_xml

torch.set_num_threads(1)

FILTERS = {
    "box": "", "tent": "", "gaussian": '<float name="stddev" value="0.4"/>',
    "mitchell": '<float name="B" value="0.2"/><float name="C" value="0.4"/>',
    "catmullrom": "", "lanczos": '<integer name="lobes" value="2"/>',
}


def _rfilter_xml(name):
    return (f'<scene version="0.5.0"><sensor type="perspective"><film type="hdrfilm">'
            f'<integer name="width" value="8"/><integer name="height" value="8"/>'
            f'<rfilter type="{name}">{FILTERS[name]}</rfilter></film></sensor></scene>')


def _records(name):
    xml = _rfilter_xml(name)
    return (mt.load_scene_string(xml).sensor.record.film.rfilter,
            jload_string(xml).sensor.record.film.rfilter)


def _tonemapped_rmse(img, ref):
    return float(np.sqrt(np.mean((img / (1 + img) - ref / (1 + ref)) ** 2)))


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_records_and_eval(name):
    t, j = _records(name)
    for f in ("kind", "radius", "stddev", "b", "c", "lobes"):
        assert getattr(t, f) == getattr(j, f), f
    x = np.random.default_rng(1).uniform(-4.5, 4.5, 10000).astype(np.float32)
    x[:5] = [0.0, 0.5, -1.0, 2.0, t.radius]
    np.testing.assert_allclose(
        tfilm.filter_eval_1d(t, torch.as_tensor(x)).numpy(),
        np.asarray(jfilm.filter_eval_1d(j, jnp.asarray(x))), rtol=1e-6, atol=1e-7,
    )
    assert tfp.supports_fis(t) == jfp.supports_fis(j)


@pytest.mark.parametrize("name", ["box", "tent", "gaussian"])
def test_filter_importance_sample(name):
    t, j = _records(name)
    u2 = np.random.default_rng(2).uniform(size=(10000, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tfp.filter_importance_sample(t, torch.as_tensor(u2)).numpy(),
        np.asarray(jfp.filter_importance_sample(j, jnp.asarray(u2))), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("name", list(FILTERS))
def test_splat_grid(name):
    t, j = _records(name)
    g = np.random.default_rng(3)
    s, h, w = 4, 13, 17
    jitter = g.uniform(size=(s, h, w, 2)).astype(np.float32)
    value = g.uniform(0, 3, (s, h, w, 3)).astype(np.float32)
    value[0, 0, 0] = [np.nan, np.inf, -np.inf]  # counted as 0 on both sides
    film = g.uniform(0, 1, (h, w, 4)).astype(np.float32)
    out = tfilm.splat_grid(torch.as_tensor(film), torch.as_tensor(jitter),
                           torch.as_tensor(value), t)
    ref = jfilm.splat_grid(jnp.asarray(film), jnp.asarray(jitter), jnp.asarray(value), j)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert np.isfinite(out.numpy()).all()


def test_branch_choice():
    """The regenerating wavefront for filters with importance sampling
    and no media; the batched one (splat) otherwise."""
    no_media, media = (ScenePack({}, {"has_media": m}) for m in (False, True))
    for name, regen in (("box", True), ("tent", True), ("gaussian", True),
                        ("mitchell", False), ("catmullrom", False), ("lanczos", False)):
        film = mt.load_scene_string(_rfilter_xml(name)).sensor.record.film
        assert uses_regen(no_media, film) == regen, name
        assert not uses_regen(media, film)


@pytest.fixture(scope="module")
def mitchell_ref():
    xml = cbox_mitchell_xml(32, 32)
    return xml, np.asarray(mitsuba_tpu.render(jload_string(xml), spp=4, seed=0))


def test_cbox_mitchell_matches_reference(mitchell_ref):
    xml, ref = mitchell_ref
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    assert img.shape == ref.shape == (32, 32, 3)
    assert _tonemapped_rmse(img, ref) < 5e-3
    assert abs(img.mean() - ref.mean()) < 2e-3 * ref.mean()


def test_cbox_mitchell_matches_golden():
    golden = np.load(os.path.join(ROOT, "tests", "golden", "torch_cbox_mitchell_64_16.npy"))
    img = mt.render(mt.load_scene_string(cbox_mitchell_xml(64, 64)), spp=16, seed=0,
                    device="cpu")
    assert np.isfinite(img).all()
    assert _tonemapped_rmse(img, golden) < 5e-3


def test_path_trace_matches_reference():
    xml = cbox_mitchell_xml(32, 32)
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    tp, jp = pack_scene(ts, "cpu"), jpack_scene(js)
    rec = ts.sensor.record
    n = 32 * 32
    lane = torch.arange(n).repeat(2)
    sidx = torch.arange(2).repeat_interleave(n)
    jit = rec.sampler.pixel_sample(lane, sidx, rec.sampler.sample_count)
    pos = torch.stack([((lane % 32).float() + jit[:, 0]) / 32,
                       ((lane // 32).float() + jit[:, 1]) / 32], -1)
    o, d = generate_rays(rec.pack(32, 32, "cpu"), pos, torch.zeros_like(pos))
    out = tpath.path_trace(tp, ts.integrator, o, d, lane, sidx, rec.sampler, 0).numpy()
    ref = np.asarray(jpath.path_trace(
        jp, js.integrator, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(lane.numpy().astype(np.uint32)), jnp.asarray(sidx.numpy().astype(np.uint32)),
        js.sensor.record.sampler, 0))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.999, f"{(~close).sum()} lanes differ"
    assert int(tpath.path_trace.last_ray_count) == int(jpath.path_trace.last_ray_count)
    assert out.mean() > 0.05
