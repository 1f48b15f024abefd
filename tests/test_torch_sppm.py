"""The port's stochastic progressive photon mapper (mitsuba_tpu_torch/
integrator/sppm.py) against the reference (mitsuba_tpu/integrator/sppm.py)
on the same scenes and seeds: the eye pass and the photon pass of
scenes/cbox.xml at 24x24 (maxDepth 5, 2^14 photons), the shuffled cell
sort on seeded numpy photons, `ppm` against `sppm`, whole renders
against the reference's goldens, and the port's sppm against its own
path tracer as tests/test_sppm.py holds the reference's.

The photon counts are passed explicitly: tests/test_photonmapper.py
writes MTS_SPPM_PHOTONS into the environment when it is imported.

Tolerances:

* the eye pass: the visible points' validity and materials equal; their
  normals, directions, uv and throughputs within rtol 1e-5, atol 1e-5,
  their positions atol 1e-3 (2e-6 of cbox's 560 units: o + t d cancels
  on the walls at 0); L within rtol 1e-4, atol 1e-5 on 99 % of the
  pixels, and its mean within 1 %: a shadow ray that grazes an edge may
  be blocked in one package and not in the other (2 pixels of 576 at
  iteration 3, measured);
* the photon pass fed the reference's visible points and radii: photon
  paths that a last-place difference sends elsewhere move a few
  windows, so M and tau agree to 2 % in their sums and on 95 % of the
  visible points exactly up to rtol 1e-4; the overflow within 2 %;
* the cell sort: equal, bit for bit (order and sorted cells);
* ppm: equal to sppm, bit for bit;
* the goldens: tests/torch_meshes.py GOLDEN_GATES;
* against the port's path tracer: the means within 8 % per channel and
  the relative RMS error under 0.45 (tests/test_sppm.py's bounds).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.integrator import sppm as jsppm
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.integrator import sppm as tsppm
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import GOLDEN_GATES, ROOT, cbox_xml, glass_xml, tm_rmse, with_integrator

torch.set_num_threads(1)

W = 24
N_PHOTONS = 1 << 14
VP_FIELDS = ("valid", "p", "ns", "wi", "beta", "mat", "uv")


@pytest.fixture(scope="module")
def cbox():
    xml = cbox_xml("sppm", W, W, max_depth=5)
    ts, js = mt.load_scene_string(xml), jload_string(xml)
    return ts, js, pack_scene(ts, "cpu"), jpack_scene(js)


def _passes(cbox, seed=3):
    ts, js, tp, jp = cbox
    tsen, jsen = ts.sensor.record, js.sensor.record
    t = tsppm.make_sppm_passes(tp, ts.integrator, tsen, W, W, seed, torch.device("cpu"))
    j = jsppm.make_sppm_passes(jp, js.integrator, jsen, W, W, seed)
    return t, j


@pytest.fixture(scope="module")
def eye_passes(cbox):
    (t_eye, _, t_ext), (j_eye, _, j_ext) = _passes(cbox)
    assert t_ext == j_ext
    lane = np.arange(W * W)
    out = {}
    for it in (0, 3):
        ref = j_eye(jnp.asarray(lane, jnp.uint32), jnp.uint32(it))
        got = t_eye(torch.as_tensor(lane), it)
        out[it] = got, ref
    return out


@pytest.mark.parametrize("it", [0, 3])
def test_eye_pass(eye_passes, it):
    """L and each field of the visible points."""
    (L, vps), (L_ref, vps_ref) = eye_passes[it]
    valid = np.asarray(vps_ref[0])
    np.testing.assert_array_equal(vps[0].numpy(), valid)
    assert valid.mean() > 0.9
    for k, a, b in zip(VP_FIELDS[1:], vps[1:], vps_ref[1:]):
        a, b = a.numpy()[valid], np.asarray(b)[valid]
        if k == "mat":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:  # a hit's coordinates carry the cancellation of o + t d
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3 if k == "p" else 1e-5,
                                       err_msg=k)
    L, L_ref = L.numpy(), np.asarray(L_ref)
    close = np.isclose(L, L_ref, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() > 0.99, close.mean()
    np.testing.assert_allclose(L.mean(), L_ref.mean(), rtol=0.01)
    assert L.mean() > 0


@pytest.mark.parametrize("it", [0, 3])
def test_photon_pass(cbox, eye_passes, it):
    """M, tau and the overflow of the photon pass, each package fed the
    reference's visible points and the same radii."""
    (_, t_ph, ext), (_, j_ph, _) = _passes(cbox)
    _, (_, vps_ref) = eye_passes[it]
    r0 = ext / W * 2.0
    r2 = np.full(W * W, r0 * r0 * (0.6 if it else 1.0), np.float32)
    lane = np.arange(N_PHOTONS)
    M_ref, tau_ref, ov_ref = j_ph(jnp.asarray(lane, jnp.uint32), jnp.uint32(it), vps_ref,
                                  jnp.asarray(r2))
    vps = tuple(torch.as_tensor(np.asarray(v)) for v in vps_ref)
    M, tau, ov = t_ph(torch.as_tensor(lane), it, vps, torch.as_tensor(r2))
    M_ref, tau_ref = np.asarray(M_ref), np.asarray(tau_ref)
    M, tau = M.numpy(), tau.numpy()
    assert M_ref.sum() > 100
    np.testing.assert_allclose(M.sum(), M_ref.sum(), rtol=0.02)
    np.testing.assert_allclose(tau.sum(0), tau_ref.sum(0), rtol=0.02)
    np.testing.assert_allclose(float(ov), float(ov_ref), rtol=0.02)
    same = np.isclose(M, M_ref, rtol=1e-4, atol=1e-6) & np.isclose(
        tau, tau_ref, rtol=1e-4, atol=1e-6).all(-1)
    assert same.mean() > 0.95, same.mean()


@pytest.mark.parametrize("word,offset,n_cells", [(0, 0, 64), (1, 17, 64), (0, 0, 4096)])
def test_cell_sort(word, offset, n_cells):
    """The shuffled stable sort by cell, bit for bit: the reference's lines
    (sppm.py:296-317 for word 0; photonmapper.py:223-246's shuffle, slot
    index + 17 and word 1) on every (depth, photon) slot, dead ones under
    the sentinel cell, against cell_order on the live photons."""
    r = np.random.default_rng(word + n_cells)
    n = 20000
    dims = np.array([4, 4, 4]) if n_cells == 64 else np.array([16, 16, 16])
    lo = np.zeros(3, np.float32)
    inv_cell = np.float32(1.0) / np.float32(0.25)
    p = r.uniform(-0.1, dims * 0.25 + 0.1, (n, 3)).astype(np.float32)
    p[::7] = np.round(p[::7] * 4) / 4  # on cell faces
    ok = r.uniform(size=n) < 0.6
    q = jsppm._grid_cell(jnp.asarray(p), jnp.asarray(lo), jnp.float32(inv_cell),
                         jnp.asarray(dims, jnp.int32))
    cid = jnp.where(jnp.asarray(ok), jsppm._cell_id(q, dims), n_cells)
    shuffle = jnp.argsort(jrng.pcg4d(jnp.stack(
        [jnp.arange(n, dtype=jnp.uint32) + offset] * 4, -1))[:, word])
    cid = cid[shuffle]
    order_ref = np.asarray(shuffle[jnp.argsort(cid, stable=True)])
    cid_ref = np.asarray(jnp.sort(cid, stable=True))

    g = np.nonzero(ok)[0]
    dims_t = torch.as_tensor(dims)
    cid_t = tsppm._cell_id(tsppm._grid_cell(torch.as_tensor(p[g]), torch.as_tensor(lo),
                                            float(inv_cell), dims_t), dims_t)
    order, cid_s = tsppm.cell_order(cid_t, torch.as_tensor(g), word=word, offset=offset)
    live = int(ok.sum())
    np.testing.assert_array_equal(g[order.numpy()], order_ref[:live])
    np.testing.assert_array_equal(cid_s.numpy(), cid_ref[:live])
    assert (cid_ref[live:] == n_cells).all()
    assert len(np.unique(cid_ref[:live])) > n_cells // 2


def test_ppm_is_sppm(monkeypatch):
    """`ppm` runs the sppm code (the reference's render does the same)."""
    monkeypatch.setenv("MTS_SPPM_PHOTONS", "4096")
    imgs = [mt.render(mt.load_scene_string(cbox_xml(kind, 16, 16, max_depth=4)), spp=2, seed=1,
                      device="cpu")
            for kind in ("ppm", "sppm")]
    np.testing.assert_array_equal(*imgs)
    assert imgs[0].mean() > 0


@pytest.mark.parametrize("name,photons", [("torch_cbox_sppm_24_4.npy", N_PHOTONS),
                                          ("torch_glass_sppm_16_4.npy", 1 << 12)])
def test_meets_golden(name, photons, monkeypatch):
    """scenes/cbox.xml (maxDepth 16) at 24x24 with 2^14 photons an
    iteration and scenes/glass_caustics.xml (maxDepth 24) at 16x16 with
    2^12 under sppm, 4 iterations, seed 0, through `render` (with
    MTS_SPPM_PHOTONS as the goldens were made), against the reference's
    renders (tests/make_torch_bigmesh_golden.py)."""
    monkeypatch.setenv("MTS_SPPM_PHOTONS", str(photons))
    xml = cbox_xml("sppm", 24, 24) if "cbox" in name else with_integrator(glass_xml(16, 16),
                                                                          "sppm")
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
    assert tsppm.render_sppm.last_stats["photons"] > 100


def test_sppm_matches_path():
    """The port's sppm against the port's path tracer on cbox at 24x24
    (tests/test_sppm.py's check of the reference)."""
    xml = cbox_xml("path", W, W, max_depth=5)
    ts = mt.load_scene_string(xml)
    ts.integrator.rr_depth = 100
    ref = mt.render(ts, spp=384, seed=0, device="cpu")
    sc = mt.load_scene_string(cbox_xml("sppm", W, W, max_depth=5))
    img = tsppm.render_sppm(sc, spp=10, seed=2, photons_per_pass=N_PHOTONS, device="cpu")
    ratio = img.mean(axis=(0, 1)) / ref.mean(axis=(0, 1))
    assert np.all(np.abs(ratio - 1.0) < 0.08), ratio
    lum = ref.mean(axis=-1)
    mask = lum < 5.0 * np.median(lum)
    d = (img - ref)[mask]
    rel = float(np.sqrt((d * d).mean()) / ref[mask].mean())
    assert rel < 0.45, rel
