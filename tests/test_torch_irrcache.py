"""The port's irradiance cache (mitsuba_tpu_torch/integrator/irrcache.py)
against the reference (mitsuba_tpu/integrator/irrcache.py): the
Ward-Heckbert gradients and the Ward-weighted interpolation on seeded
random records, the overture's records on scenes/cbox.xml, the render
trace fed the reference's records (cbox, and the matpreview variant,
whose rough and specular hits fall back to the path trace), the trace
without a cache, and a whole render against the reference's golden.

Tolerances:

* the gradients: rtol 1e-5, atol 1e-6 (float32 sums over 128 cells);
* the interpolation: rtol 1e-4, atol 1e-6 (float32 sums over 300 records
  in 128-record steps; the extrapolation's matrix products accumulate in
  another order);
* the overture's 36 records: positions atol 1e-3 (a camera ray's last
  place moves a hit by ~6e-5), normals and validity equal; irradiance,
  radius and gradients rtol 1e-3, atol 1e-5 on 90 % of the records.  A
  gather ray starts 1e-4 off its record's surface, and where a last place
  lets it meet that surface again in one package only, its hit distance
  drops from hundreds to ~1e-4: the radius, a harmonic mean of those
  distances, and the gradients, which divide by them, move by half
  (1 of 36 records, measured);
* the render trace fed the reference's records: rtol 1e-4, atol 1e-6 on
  90 % of the lanes and rtol 3e-2 on 99 %.  The hit points carry a
  camera ray's last place (1.2e-4 at ~500 units), and on cbox one record,
  whose radius such a self-hit shrank to 0.0126, turns that into up to a
  1.2 % change of its Ward weight (measured: 33 of 576 lanes past 1e-4;
  fed the same hit points the blends agree to 1.6e-5);
* without a cache, the nested path trace bit for bit;
* the golden: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import irrcache as jic
from mitsuba_tpu.integrator.plugins import IntegratorRecord as JRecord
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu.sensor.plugins import generate_rays as jgenerate_rays
from mitsuba_tpu_torch.integrator import irrcache as tic
from mitsuba_tpu_torch.integrator import path as tpath
from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    GOLDEN_GATES,
    NESTED_PATH,
    ROOT,
    cbox_meta_xml,
    matpreview_const_xml,
    tm_rmse,
    with_integrator,
)

torch.set_num_threads(1)

W = 24
SCENES = {"cbox": lambda: cbox_meta_xml("irrcache", NESTED_PATH),
          "matpreview": lambda: with_integrator(matpreview_const_xml(W, W), "irrcache")}


def _frames(r, m):
    n = r.normal(size=(m, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1 = np.cross(n, r.normal(size=(m, 3)))
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (t1, np.cross(n, t1), n)]


def test_hemisphere_gradients():
    """Irradiance and both gradients of 40 records of random radiance and
    hit distances."""
    r = np.random.default_rng(11)
    m = 40
    li = r.gamma(0.6, 0.5, (m, tic.GRID_M, tic.GRID_N, 3)).astype(np.float32)
    rdist = r.uniform(1e-5, 50.0, (m, tic.GRID_M, tic.GRID_N)).astype(np.float32)
    t1, t2, n = _frames(r, m)
    got = tic._hemisphere_gradients(*map(torch.tensor, (li, rdist, t1, t2, n)))
    ref = jic._hemisphere_gradients(*map(jnp.asarray, (li, rdist, t1, t2, n)))
    for a, b, k in zip(got, ref, ("e", "grad_t", "grad_r")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("gradients", [False, True])
def test_interp(gradients):
    """The blend of 300 random records (3 steps, the last padded, 10 % of
    them invalid) at 500 random points and normals."""
    r = np.random.default_rng(12)
    m, n_q = 300, 500
    pos = r.uniform(-1, 1, (m, 3)).astype(np.float32)
    _, _, nrm = _frames(r, m)
    e = r.uniform(0, 2, (m, 3)).astype(np.float32)
    rad = r.uniform(0.05, 1.0, m).astype(np.float32)
    valid = r.uniform(size=m) > 0.1
    p = r.uniform(-1, 1, (n_q, 3)).astype(np.float32)
    n = nrm[r.integers(0, m, n_q)] + 0.3 * r.normal(size=(n_q, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    gt = gr = None
    if gradients:
        gt = r.normal(0, 0.5, (m, 3, 3)).astype(np.float32)
        gr = r.normal(0, 0.5, (m, 3, 3)).astype(np.float32)
    tin = [torch.tensor(a) if a is not None else None for a in (pos, nrm, e, rad, valid, p, n, gt, gr)]
    jin = [jnp.asarray(a) if a is not None else None for a in (pos, nrm, e, rad, valid, p, n, gt, gr)]
    got, ref = tic._interp(*tin), jic._interp(*jin)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    assert (ref[1] > 0).mean() > 0.9


def _subgrid_rays(js, w=W, h=W):
    cam = js.sensor.record.pack(w, h)
    xs = (jnp.arange(w // tic.STRIDE) * tic.STRIDE + 0.5) / w
    ys = (jnp.arange(h // tic.STRIDE) * tic.STRIDE + 0.5) / h
    gx, gy = jnp.meshgrid(xs, ys)
    pos01 = jnp.stack([gx.ravel(), gy.ravel()], axis=-1)
    o, d = jgenerate_rays(cam, pos01, jnp.zeros_like(pos01))
    return np.asarray(o), np.asarray(d)


@pytest.fixture(scope="module")
def cbox():
    xml = SCENES["cbox"]()
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


def test_overture(cbox):
    """The 36 records of cbox's 6 x 6 subgrid, 128 gather rays each."""
    _, _, tp, jp = cbox
    o, d = _subgrid_rays(jload_string(SCENES["cbox"]()))
    got, n_rays = tic._overture(tp, IntegratorRecord(kind="path"),
                                (torch.tensor(o), torch.tensor(d)), 0)
    ref = jax.jit(lambda pk, oo, dd: jic._overture(pk, JRecord(kind="path"), (oo, dd), 0))(
        jp, jnp.asarray(o), jnp.asarray(d))
    got = [a.numpy() for a in got]
    ref = [np.asarray(a) for a in ref]
    np.testing.assert_allclose(got[0], ref[0], atol=1e-3)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6)
    np.testing.assert_array_equal(got[4], ref[4])
    m = len(ref[0])
    close = np.ones(m, bool)
    for a, b in zip(got[2:4] + got[5:], ref[2:4] + ref[5:]):
        close &= np.isclose(a, b, rtol=1e-3, atol=1e-5).reshape(m, -1).all(-1)
    assert close.mean() >= 0.9, close.mean()
    assert ref[4].all() and (ref[2] > 0).all() and int(n_rays) > m * tic.GATHER_K


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_trace_with_reference_records(scene):
    """One pass of camera rays at 24x24 through irrcache_trace, both fed
    the reference's records."""
    xml = SCENES[scene]()
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    tp, jp = pack_scene(ts, "cpu"), jpack_scene(js)
    o, d = _subgrid_rays(js)
    cache = jax.jit(lambda pk, oo, dd: jic._overture(pk, JRecord(kind="path"), (oo, dd), 0))(
        jp, jnp.asarray(o), jnp.asarray(d))
    n = W * W
    r = np.random.default_rng(13)
    cam = js.sensor.record.pack(W, W)
    px = np.arange(n)
    pos01 = np.stack([(px % W + r.uniform(size=n)) / W, (px // W + r.uniform(size=n)) / W], -1)
    o, d = jgenerate_rays(cam, jnp.asarray(pos01, jnp.float32), jnp.zeros((n, 2), jnp.float32))
    lane, sidx = np.arange(n, dtype=np.uint32), np.full(n, 1, np.uint32)
    ref = np.asarray(jax.jit(lambda pk, *a: jic.irrcache_trace(
        pk, js.integrator, *a, None, 0, cache))(jp, o, d, jnp.asarray(lane), jnp.asarray(sidx)))
    got = tic.irrcache_trace(
        tp, ts.integrator, torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
        torch.tensor(lane.astype(np.int64)), torch.tensor(sidx.astype(np.int64)), None, 0,
        tuple(torch.tensor(np.asarray(a)) for a in cache)).numpy()
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() > 0.9, close.mean()
    near = np.isclose(got, ref, rtol=3e-2, atol=1e-6).all(-1)
    assert near.mean() > 0.99, near.mean()
    assert ref.mean() > 0.05


def test_trace_without_cache_is_the_path_trace(cbox):
    """Without records the trace is the nested path tracer's."""
    ts, _, tp, _ = cbox
    o, d = _subgrid_rays(jload_string(SCENES["cbox"]()))
    o, d = torch.tensor(o), torch.tensor(d)
    lane = torch.arange(o.shape[0])
    sidx = torch.zeros_like(lane)
    got = tic.irrcache_trace(tp, ts.integrator, o, d, lane, sidx, None, 0)
    ref = tpath.path_trace(tp, ts.integrator.sub_integrator, o, d, lane, sidx, None, 0)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_meets_golden():
    """cbox under irrcache over `path` at maxDepth 4, 24x24, 4 spp, seed 0,
    through `render`, against the reference's render."""
    name = "torch_cbox_irrcache_24_4.npy"
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(SCENES["cbox"]()), spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape and np.isfinite(out).all()
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
    st = tic.render_irrcache.last_stats
    assert st["records"] == 36 and st["overture_rays"] > 36 * tic.GATHER_K
