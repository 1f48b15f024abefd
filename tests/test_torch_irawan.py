"""The port's irawan cloth (mitsuba_tpu_torch/bsdf/irawan_host.py: the
parser, presets, tables and normalization; bsdf/irawan.py: the lane
functions in torch; bsdf/eval.py's irawan arms; scene/texture_eval.py's
yarn lookup; core/rng.py STREAM_WEAVE) against the reference
(mitsuba_tpu/bsdf/irawan.py, bsdf/eval.py, scene/texture_eval.py), on
inputs made from seeds with numpy, and tests/test_irawan.py's cloth
rendered by the port.

Tolerances (measured on these inputs):

* parse_weave, PRESETS, pack_tables, tables_have_noise and
  compute_normalization: equal (the same numpy code, the normalization's
  Monte Carlo at seed 7 included);
* lane_params with and without the noise: the yarn ids and flags equal,
  the floats within rtol 1e-5, atol 1e-6 (measured: equal without the
  noise, 1.2e-7 with it; its perlin lattice draws come from the same
  counter hash);
* irawan_f, bsdf_eval and bsdf_pdf: rtol 5e-4, atol 1e-6 as in
  tests/test_torch_bsdfs.py (measured: irawan_f within 2e-6, the
  staple integrand's arccos and the spine radius's float32 powers);
* bsdf_sample: wo within atol 2e-6, weight and pdf within rtol 5e-4, and
  weight * pdf = f within rtol 1e-4 (the cosine sampling identity);
* the cloth golden: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.bsdf import eval as jbsdf
from mitsuba_tpu.bsdf import irawan as jiw
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.scene import texture_eval as jtex
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.properties import Properties as JProperties
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.bsdf import eval as tbsdf
from mitsuba_tpu_torch.bsdf import irawan as tiw
from mitsuba_tpu_torch.bsdf import irawan_host as hiw
from mitsuba_tpu_torch.bsdf.plugins import IRAWAN
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.scene import texture_eval as ttex
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.properties import Properties
from tests.torch_meshes import GOLDEN_GATES, ROOT, cloth_xml, tm_rmse

torch.set_num_threads(1)

N = 8192
PARAM_TEXT = """
/* a comment */ weave {
  name = "test", tileWidth = 2, tileHeight = 1,
  alpha = 0.1, beta = 2 /* inline */, ss = 0.2, hWidth = 0.5,
  warpArea = 0.6, weftArea = 0.4, fineness = 3, period = 2.5,
  dWarpUmaxOverDWarp = 12, dWeftUmaxOverDWeft = 8,
  pattern { 1, 2 },
  yarn { type = warp, psi = 25, umax = $crimp, kappa = -0.4, width = 1, length = 2,
         centerU = 0.25, centerV = 0.5, kd = $warp_kd, ks = { 1, 1, 1 } },
  yarn { type = weft, psi = 0, umax = 30, kappa = 0.7, width = 1, length = 2,
         centerU = 0.75, centerV = 0.5, kd = { 0.3, 0.1, 0.1 }, ks = { 0.5, 0.6, 0.7 } }
}
"""


def _props(cls):
    props = cls("bsdf", "irawan")
    props.set("warp_kd", np.asarray([0.1, 0.2, 0.3], np.float32))
    props.set("crimp", 30.0)
    return props


def _weaves():
    """(port pattern, reference pattern) of the plain preset and of the
    parameterized two-yarn text (a staple and a filament yarn, noise)."""
    return [(hiw.parse_weave(hiw.PRESETS["plain"]), jiw.parse_weave(jiw.PRESETS["plain"])),
            (hiw.parse_weave(PARAM_TEXT, _props(Properties)),
             jiw.parse_weave(PARAM_TEXT, _props(JProperties)))]


def test_presets_and_parser_equal():
    assert hiw.PRESETS == jiw.PRESETS
    for a, b in _weaves():
        for k in ("name", "alpha", "beta", "ss", "hWidth", "warpArea", "weftArea", "tileWidth",
                  "tileHeight", "dWarpUmaxOverDWarp", "dWeftUmaxOverDWeft", "fineness", "period",
                  "pattern"):
            assert getattr(a, k) == getattr(b, k), k
        for ya, yb in zip(a.yarns, b.yarns, strict=True):
            for k in ("type", "psi", "umax", "kappa", "width", "length", "centerU", "centerV"):
                assert getattr(ya, k) == getattr(yb, k), k
            np.testing.assert_array_equal(ya.kd, yb.kd)
            np.testing.assert_array_equal(ya.ks, yb.ks)
    with pytest.raises(ValueError, match="pattern index"):
        hiw.parse_weave(PARAM_TEXT.replace("pattern { 1, 2 }", "pattern { 1, 5 }"),
                        _props(Properties))


@pytest.mark.parametrize("repeat", [1.0, 4.0, 8.0])
def test_tables_and_normalization_equal(repeat):
    for a, b in _weaves():
        na = hiw.compute_normalization(a, repeat, repeat)
        nb = jiw.compute_normalization(b, repeat, repeat)
        assert na == nb and na > 0
        ta, tb = hiw.pack_tables([(a, repeat, repeat, na)]), jiw.pack_tables([(b, repeat, repeat, nb)])
        assert ta.keys() == tb.keys() and hiw.tables_have_noise(ta) == jiw.tables_have_noise(tb)
        for k in ta:
            assert ta[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _tables(noise, repeat=4.0):
    """Two weave entries (the plain preset and the two-yarn text), as
    (numpy tables, torch tables)."""
    entries = []
    for a, _ in _weaves():
        if not noise:
            a.period = a.fineness = 0.0
        entries.append((a, repeat, repeat, hiw.compute_normalization(a, repeat, repeat)))
    t = hiw.pack_tables(entries)
    assert hiw.tables_have_noise(t) == noise
    return t, {k: torch.as_tensor(v) for k, v in t.items()}


def _lane_inputs(seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 2, N).astype(np.int32)
    uv = rng.uniform(-1.0, 2.0, (N, 2)).astype(np.float32)
    return row, uv


def _lanes_both(noise, seed):
    t, tt = _tables(noise)
    row, uv = _lane_inputs(seed)
    jseed = jrng.stream_seed(0, jrng.STREAM_WEAVE)
    ref = jiw.lane_params(jnp, {k: jnp.asarray(v) for k, v in t.items()}, jnp.asarray(row),
                          jnp.asarray(uv), lambda i, j: jrng.rand1(i, j, 0, jseed), noise)
    tseed = trng.stream_seed(0, trng.STREAM_WEAVE)
    out = tiw.lane_params(tt, torch.as_tensor(row), torch.as_tensor(uv),
                          lambda i, j: trng.rand1(i, j, 0, tseed), noise)
    return out, ref


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_lane_params(noise):
    assert trng.STREAM_WEAVE == jrng.STREAM_WEAVE == 7
    out, ref = _lanes_both(noise, 1)
    assert out.keys() == ref.keys()
    for k in out:
        a, b = out[k].numpy(), np.asarray(ref[k])
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=k)
    if noise:
        assert (out["intensity"].numpy() != 1.0).any()
        assert np.unique(out["umax"].numpy()).size > 4


def _dirs(seed, below=0.2):
    d = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    d[: int(N * below), 2] *= -1.0
    return d


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_irawan_f(noise):
    out, ref = _lanes_both(noise, 2)
    wi, wo = _dirs(3), _dirs(4)[::-1].copy()
    f_ref = np.asarray(jiw.irawan_f(jnp, ref, jnp.asarray(wi), jnp.asarray(wo)))
    f_out = tiw.irawan_f(out, torch.as_tensor(wi), torch.as_tensor(wo)).numpy()
    np.testing.assert_allclose(f_out, f_ref, rtol=5e-4, atol=1e-6)
    # the specular lobe is live on some lanes: more than the diffuse floor
    floor = out["kd"].numpy() / np.pi * np.maximum(wo[:, 2:3], 0.0)
    assert (f_out > floor * 1.5 + 1e-6).any()


def _sp_pair(seed):
    out, ref = _lanes_both(False, seed)
    jsp = {"type": jnp.full((N,), IRAWAN, jnp.int32), "twosided": jnp.zeros(N), "iw": ref}
    tsp = {"type": torch.full((N,), IRAWAN, dtype=torch.int32), "twosided": torch.zeros(N),
           "iw": out}
    return jsp, tsp


def test_bsdf_functions():
    """eval, pdf and sample of irawan lanes through bsdf/eval.py."""
    jsp, tsp = _sp_pair(5)
    wi, wo = _dirs(6), _dirs(7)[::-1].copy()
    present = (IRAWAN,)
    for fn in ("bsdf_eval", "bsdf_pdf"):
        ref = np.asarray(getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), present))
        out = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), present).numpy()
        np.testing.assert_allclose(out, ref, rtol=5e-4, atol=1e-6, err_msg=fn)
    u = np.random.default_rng(8).random((N, 3)).astype(np.float32)
    ref = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), jnp.asarray(u[:, :2]), jnp.asarray(u[:, 2]),
                            present)
    out = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), torch.as_tensor(u[:, :2]),
                            torch.as_tensor(u[:, 2]), present)
    np.testing.assert_allclose(out.wo.numpy(), np.asarray(ref.wo), atol=2e-6, rtol=0)
    for k in ("weight", "pdf"):
        np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=5e-4, atol=1e-6, err_msg=k)
    assert not out.delta.numpy().any()
    # the sample arm's weight is f / pdf
    f = tbsdf.bsdf_eval(tsp, torch.as_tensor(wi), out.wo, present).numpy()
    np.testing.assert_allclose(out.weight.numpy() * out.pdf.numpy()[:, None], f, rtol=1e-4,
                               atol=1e-6)
    assert (out.weight.numpy() > 0).any()


def test_shading_params_yarn_lookup():
    """shading_params looks up each irawan lane's yarn by its material row
    and uv (iw_noise off for the plain preset); irawan beside a mixture is
    refused, as in the reference."""
    xml = cloth_xml()
    tp, jp = pack_scene(mt.load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))
    assert tp.meta["has_irawan"] and tp.meta["iw_noise"] is False
    for k in [k for k in jp.arrays if k.startswith("iw_")] + ["mat_iw"]:
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]), err_msg=k)
    rng = np.random.default_rng(9)
    mat = np.zeros(N, np.int32)
    uv = rng.random((N, 2)).astype(np.float32)
    ref = jtex.shading_params(jp, jnp.asarray(mat), jnp.asarray(uv))["iw"]
    out = ttex.shading_params(tp, torch.as_tensor(mat), torch.as_tensor(uv))["iw"]
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    mixed = xml.replace('<bsdf type="twosided">', '<bsdf type="mixturebsdf">'
                        '<string name="weights" value="0.5 0.5"/><bsdf type="diffuse"/>')
    with pytest.raises(ValueError, match="irawan cannot be a mixture"):
        pack_scene(mt.load_scene_string(mixed), "cpu")


def test_render_cloth_golden():
    """tests/test_irawan.py::test_render_cloth's scene at 4 spp against the
    JAX package's render; finite, not black, and the same twice."""
    scene = mt.load_scene_string(cloth_xml())
    img = mt.render(scene, spp=4, seed=0, device="cpu")
    ref = np.load(os.path.join(ROOT, "tests", "golden", "torch_irawan_cloth_24_4.npy"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert tm_rmse(img, ref) < GOLDEN_GATES["torch_irawan_cloth_24_4.npy"]
    assert img[6:18, 6:18].mean() > 0.1
    np.testing.assert_array_equal(img, mt.render(scene, spp=4, seed=0, device="cpu"))
