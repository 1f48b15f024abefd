"""The port's specular manifold walks and the manifold perturbation
(mitsuba_tpu_torch/integrator/{manifold,mut_manifold}.py) against the
reference (mitsuba_tpu/integrator/{manifold,mut_manifold}.py) on seeded
numpy inputs: `chain_trace` and `manifold_walk` on tests/test_manifold.py's
scenes (two refractions through a glass sphere, one reflection off a
mirror sphere); `trace_path_info`, `classify`, `solve_chain` and
`propose_manifold` on scenes/glass_caustics.xml (48x48, maxDepth 6, as
tests/test_manifold_mlt.py); and mlt with the manifold perturbation on
glass against the reference's golden.

The walks take finite differences in float32 (eps 1e-4), which magnify
last-place differences in the traced chain ends, and a Newton iteration
amplifies them further.  So the ok masks are compared by count (at most
2 % of the lanes, at least 1, may differ; measured: none), and the
solved directions, residuals and corrections only on the lanes both sides
call ok: directions and written-back primary samples within 1e-5
(measured 1.5e-6), the residual err within 5e-4 absolute (measured
1.4e-4, on lanes that did not converge), the Jacobian determinant and the
acceptance correction at rtol 6e-2 with a median under 5e-3 (measured:
at most 3.0e-2 and 2.2e-2, medians 1e-3).  The records of trace_path_info:
integer and boolean fields equal, the geometry within 5e-4 (measured
1.9e-4 at the third vertex past the sphere).  The walk on
tests/test_manifold.py's scenes: directions and errors within 1e-4 on the
lanes that converge.  The golden: tests/torch_meshes.py GOLDEN_GATES."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.integrator import manifold as jmf
from mitsuba_tpu.integrator import mut_manifold as jmm
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.integrator import manifold as tmf
from mitsuba_tpu_torch.integrator import mut_manifold as tmm
from mitsuba_tpu_torch.integrator.pssmlt import dims_for
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import GOLDEN_GATES, ROOT, glass_manifold_xml, glass_xml, tm_rmse

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "tests", "golden")

# tests/test_manifold.py's scenes: a unit sphere of the given BSDF with a
# diffuse receiver wall at z = wall_z under a constant environment
SPHERE_XML = """
<scene version="0.5.0">
  <integrator type="path"/>
  <sensor type="perspective">
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="8"/>
      <rfilter type="box"/></film>
  </sensor>
  <shape type="sphere"><float name="radius" value="1"/>{bsdf}</shape>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="{scale}"/><translate z="{wall_z}"/></transform>
    <bsdf type="diffuse"/>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""


def _packs(xml):
    js, ts = jload_string(xml), mt.load_scene_string(xml)
    return js, jpack_scene(js), ts, pack_scene(ts, "cpu")



def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both_ok(ok_o, ok_r, n):
    ok_o, ok_r = _np(ok_o), _np(ok_r)
    assert int((ok_o != ok_r).sum()) <= max(1, n // 50), (ok_o.sum(), ok_r.sum())
    return ok_o & ok_r


@pytest.mark.parametrize("chain", ["refract2", "reflect"])
def test_manifold_walk(chain):
    """The chain's end before and after a Newton walk to a moved target
    (tests/test_manifold.py's inputs)."""
    if chain == "refract2":
        xml = SPHERE_XML.format(bsdf='<bsdf type="dielectric"><float name="intIOR" '
                                     'value="1.5"/></bsdf>', scale=6, wall_z=4)
        n, seed, spread, aim, sig, n_t = 64, 3, 0.2, None, (tmf.REFRACT,) * 2, (0, 0, -1)
    else:
        xml = SPHERE_XML.format(bsdf='<bsdf type="conductor"/>', scale=8, wall_z=-4)
        n, seed, spread, aim, sig, n_t = 32, 5, 0.5, 0.2, (tmf.REFLECT,), (0, 0, 1)
    _, jpk, _, tpk = _packs(xml)
    r = np.random.default_rng(seed)
    p0 = np.zeros((n, 3), np.float32)
    p0[:, 0] = r.uniform(-spread, spread, n)
    p0[:, 1] = r.uniform(-spread, spread, n)
    p0[:, 2] = -3.0
    if aim is None:
        d0 = -p0.copy()
        d0[:, 2] += 1.0
    else:
        d0 = np.stack([-p0[:, 0] * aim, -p0[:, 1] * aim, np.ones(n, np.float32)], -1)
    d0 = (d0 / np.linalg.norm(d0, axis=-1, keepdims=True)).astype(np.float32)

    end_r = jax.jit(lambda p, d: jmf.chain_trace(jpk, p, d, sig))(jnp.asarray(p0),
                                                                  jnp.asarray(d0))
    end_o = tmf.chain_trace(tpk, torch.as_tensor(p0), torch.as_tensor(d0), sig)
    np.testing.assert_array_equal(_np(end_o[2]), _np(end_r[2]))
    assert _np(end_r[2]).mean() > 0.9
    for a, b in zip(end_o[:2], end_r[:2]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)

    delta = r.uniform(-0.3 if chain == "refract2" else -0.2, 0.3 if chain == "refract2" else 0.2,
                      (n, 2)).astype(np.float32)
    pt = _np(end_r[0]).copy()
    pt[:, :2] += delta
    nt = np.broadcast_to(np.array(n_t, np.float32), (n, 3)).copy()
    d_r, err_r, ok_r = jax.jit(lambda *a: jmf.manifold_walk(jpk, a[0], a[1], sig, *a[2:]))(
        *map(jnp.asarray, (p0, d0, pt, nt)))
    d_o, err_o, ok_o = tmf.manifold_walk(tpk, torch.as_tensor(p0), torch.as_tensor(d0), sig,
                                         torch.as_tensor(pt), torch.as_tensor(nt))
    both = _both_ok(ok_o, ok_r, n)
    conv = both & (_np(err_r) < 1e-3)
    assert conv.mean() > 0.7
    np.testing.assert_allclose(_np(d_o)[conv], _np(d_r)[conv], atol=1e-4)
    np.testing.assert_allclose(_np(err_o)[conv], _np(err_r)[conv], atol=1e-4)


# ---- the manifold perturbation on glass ----

POOL = 16384  # seeded rows, of which those the port classifies eligible
N_OTHER = 192  # and this many others are kept


@pytest.fixture(scope="module")
def caustic():
    """scenes/glass_caustics.xml at 48x48, maxDepth 6: primary samples
    seeded as the reference's test seeds them (rand4 at index 7000), the
    rows of a pool of 16,384 whose paths the port classifies D - S..S - B
    (~0.3 %) and N_OTHER more; (..., U, their lane ids, seed_mlt)."""
    js, jpk, ts, tpk = _packs(glass_xml(48, 48, max_depth=6))
    D = dims_for(6)
    seed_mlt = trng.stream_seed(0, trng.STREAM_MLT)
    words = jnp.arange(POOL * D, dtype=jnp.uint32)
    U = np.asarray(jrng.rand4(words // D, words % D, jnp.uint32(7000), seed_mlt)[:, 0])
    U = U.reshape(POOL, D)
    info = tmm.trace_path_info(tpk, ts.integrator, ts.sensor.record.pack(48, 48, "cpu"), 48, 48,
                               torch.tensor(U), 6)
    elig = tmm.classify(info)["elig"].numpy()
    keep = np.sort(np.concatenate([np.nonzero(elig)[0], np.nonzero(~elig)[0][:N_OTHER]]))
    return js, jpk, ts, tpk, U[keep], keep, seed_mlt


def _cams(js, ts):
    return js.sensor.record.pack(48, 48), ts.sensor.record.pack(48, 48, "cpu")


def test_trace_path_info_and_classify(caustic):
    js, jpk, ts, tpk, U, _, _ = caustic
    n = U.shape[0]
    cam_j, cam_t = _cams(js, ts)
    info_r = jax.jit(lambda u: jmm.trace_path_info(jpk, js.integrator, cam_j, 48, 48, u, 6))(
        jnp.asarray(U))
    info_o = tmm.trace_path_info(tpk, ts.integrator, cam_t, 48, 48, torch.tensor(U), 6)
    for k in ("valid", "delta", "refract", "type", "mat"):
        mism = (_np(info_o[k]) != _np(info_r[k])).any(axis=1)
        assert mism.sum() <= 2, (k, mism.sum())
    same = ~(_np(info_o["valid"]) != _np(info_r["valid"])).any(axis=1)
    live = _np(info_r["valid"]) & same[:, None]
    for k in ("p", "ns", "ng", "d_out"):
        np.testing.assert_allclose(_np(info_o[k])[live], _np(info_r[k])[live], rtol=1e-4,
                                   atol=5e-4)
    c_r, c_o = jmm.classify(info_r), tmm.classify(info_o)
    elig = _both_ok(c_o["elig"], c_r["elig"], n)
    assert elig.sum() > 30, elig.sum()
    for k in ("klen", "sig"):
        np.testing.assert_array_equal(_np(c_o[k])[elig], _np(c_r[k])[elig])
    for k in ("p0", "d0_out", "s1_p", "b_p", "b_n"):
        np.testing.assert_allclose(_np(c_o[k])[elig], _np(c_r[k])[elig], rtol=1e-4, atol=1e-4)


def test_solve_chain(caustic):
    """The Newton solve from the classified first vertices, aimed at the
    second vertex, back onto each lane's B."""
    js, jpk, ts, tpk, U, _, _ = caustic
    cam_j, _ = _cams(js, ts)
    info = jax.jit(lambda u: jmm.trace_path_info(jpk, js.integrator, cam_j, 48, 48, u, 6))(
        jnp.asarray(U))
    c = {k: _np(v) for k, v in jmm.classify(info).items()}
    e = c["elig"]
    args = [c[k][e] for k in ("p0", "ng0", "d0_out", "sig", "klen")] + [4] + [
        c[k][e] for k in ("b_p", "b_n")]
    ref = jax.jit(lambda *a: jmm.solve_chain(jpk, *a[:5], 4, *a[5:]))(
        *map(jnp.asarray, args[:5] + args[6:]))
    out = tmm.solve_chain(tpk, *[torch.as_tensor(a) for a in args[:5]], 4,
                          *[torch.as_tensor(a) for a in args[6:]])
    both = _both_ok(out[3], ref[3], int(e.sum()))
    assert both.mean() > 0.5
    np.testing.assert_allclose(_np(out[0])[both], _np(ref[0])[both], atol=1e-5)
    np.testing.assert_allclose(_np(out[1])[both], _np(ref[1])[both], atol=5e-4)
    _rel_close(_np(out[2])[both], _np(ref[2])[both])


def _rel_close(out, ref):
    rel = np.abs(out - ref) / np.abs(ref)
    assert rel.max() < 6e-2 and np.median(rel) < 5e-3, (rel.max(), np.median(rel))


def test_propose_manifold(caustic):
    """The whole proposal at step 3: the ok masks by count, and on the
    lanes both call ok the proposals (the solved direction written back
    through the inverse cosine warp) and the acceptance corrections;
    rejected lanes keep their row."""
    js, jpk, ts, tpk, U, lanes, seed_mlt = caustic
    cam_j, cam_t = _cams(js, ts)
    lanes_j = jnp.asarray(lanes.astype(np.uint32))
    U_r, corr_r, ok_r = jax.jit(lambda u: jmm.propose_manifold(
        jpk, js.integrator, cam_j, 48, 48, u, jnp.uint32(3), seed_mlt, lanes_j))(jnp.asarray(U))
    U_o, corr_o, ok_o = tmm.propose_manifold(tpk, ts.integrator, cam_t, 48, 48,
                                             torch.tensor(U), 3, seed_mlt,
                                             torch.as_tensor(lanes))
    both = _both_ok(ok_o, ok_r, U.shape[0])
    assert both.sum() > 10, both.sum()
    np.testing.assert_array_equal(_np(U_o)[~_np(ok_o)], U[~_np(ok_o)])
    np.testing.assert_allclose(_np(U_o)[both], _np(U_r)[both], atol=1e-5)
    _rel_close(_np(corr_o)[both], _np(corr_r)[both])
    assert (_np(corr_o)[~_np(ok_o)] == 0).all()


def test_glass_mlt_manifold_meets_golden():
    """mlt with the manifold perturbation (steps 3 and 7 of 8) on glass at
    16x16, maxDepth 6, 8 mutations per pixel, 256 chains."""
    name = "torch_glass_mlt_manifold_16_8.npy"
    golden = np.load(os.path.join(GOLDEN, name))
    out = mt.render(mt.load_scene_string(glass_manifold_xml()), spp=8, seed=0, device="cpu")
    assert out.shape == golden.shape == (16, 16, 3)
    assert np.isfinite(out).all() and out.mean() > 0.1
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
