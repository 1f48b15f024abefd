"""The envmap emitter of the port against the JAX package.

* Alias table and density (core/distribution.py): `build_alias` and
  `Distribution2D.from_weights` equal the reference's exactly, on
  scenes/assets/sky.exr's weights and on hypothesis-drawn weight vectors
  (all-zero and single-entry ones included); the compiled table is the
  one the pack holds, and the pure-Python fallback equals the
  reference's own fallback.
* The pack's env arrays (scene/builder.py `_env_table`) equal the
  reference pack's exactly on scenes/matpreview.xml and on a rotated,
  scaled envmap (`env_to_local`, an inverse in float64, to 1 ulp).
* The emitter functions (emitter/eval.py) on 4,096 seeded directions and
  uniforms, with a rotated toWorld and scale 2.5: the sampled lat-long
  coordinates, and so the sampled pixel ids, are bit-equal (fused and
  unfused alias rows); the rest agree at tolerances set from the
  measured differences (XLA's and PyTorch's atan2/acos/sin and 3x3
  matmul differ in the last places): lat-long uv atol 1e-5 (measured
  2.45e-6), eval_env rtol 5e-4 (8.6e-5), the direction pdf rtol 3e-3
  (5.0e-4, where sin(theta) is small), sampled directions atol 1e-6
  (1.8e-7), sampled pdfs rtol 1e-6 (1.8e-7), sample_direct's value rtol
  1e-4 (2.0e-5); distances and kinds exact.
* Renders: scenes/matpreview.xml as it stands at 64x64, 16 spp, seed 0
  against the reference's own golden tests/golden/matpreview_64_16.npy
  (made with sobol, the envmap and VNDF) at tests/test_golden.py's gate
  (tone-mapped RMSE < 5e-3); a converted reference pack renders bit for
  bit as the port's own; an envmap read from an LDR grey PNG against the
  JAX package's render at the same gate.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, example, given, settings
from hypothesis import strategies as st

import mitsuba_tpu
from mitsuba_tpu.core import distribution as jdist
from mitsuba_tpu.core.spectrum import luminance as jluminance
from mitsuba_tpu.emitter import eval as jem
from mitsuba_tpu.io.png import write_png as jwrite_png
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene as jload
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.core import distribution as tdist
from mitsuba_tpu_torch.emitter import eval as tem
from mitsuba_tpu_torch.emitter.plugins import DIRECTIONAL, ENVMAP
from mitsuba_tpu_torch.io.exr import read_exr
from mitsuba_tpu_torch.scene.builder import pack_from_numpy, pack_scene
from tests.torch_meshes import MATPREVIEW_XML, ROOT

torch.set_num_threads(1)

SKY = os.path.join(ROOT, "scenes", "assets", "sky.exr")
GOLDEN = os.path.join(ROOT, "tests", "golden", "matpreview_64_16.npy")
ENV_ARRAYS = ("env_image", "env_to_world", "env_density", "env_alias_prob", "env_alias_idx",
              "env_alias_fused")
N = 4096


def _env_xml(filename, size=8, extra=""):
    """A diffuse ground under an envmap rotated about y and x and scaled
    by 2.5, seen at size x size."""
    return f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective"><float name="fov" value="60"/>
    <transform name="toWorld"><lookat origin="0,1.5,-4" target="0,0.5,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="hdrfilm"><integer name="width" value="{size}"/><integer name="height" value="{size}"/>
      <rfilter type="gaussian"/></film></sensor>
  <shape type="rectangle"><transform name="toWorld"><scale value="3"/><rotate x="1" angle="-90"/></transform></shape>
  <shape type="sphere"><float name="radius" value="0.5"/><point name="center" x="0" y="0.5" z="0"/>
    <bsdf type="roughconductor"><float name="alpha" value="0.2"/></bsdf></shape>
  <emitter type="envmap"><string name="filename" value="{filename}"/><float name="scale" value="2.5"/>
    <transform name="toWorld"><rotate y="1" angle="37"/><rotate x="1" angle="20"/></transform>{extra}
  </emitter>
</scene>"""


def _tonemapped_rmse(img, ref):
    return float(np.sqrt(np.mean((img / (1.0 + img) - ref / (1.0 + ref)) ** 2)))


def _sky_weights():
    """The reference builder's env weights of sky.exr (luminance x
    sin(theta) + 1e-12, builder.py:1303-1309), from the reference's reader
    and luminance."""
    from mitsuba_tpu.io.exr import read_exr as jread_exr

    img = jread_exr(SKY)[0]
    h = img.shape[0]
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
    return np.asarray(jluminance(jnp.asarray(img))) * sin_t[:, None] + 1e-12


# ---- alias table and density ----

def test_alias_on_sky_equals_reference():
    w = _sky_weights()
    prob, alias = tdist.build_alias(w)
    ref_prob, ref_alias = jdist.build_alias(w)
    assert prob.dtype == np.float32 and alias.dtype == np.int32
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(alias, ref_alias)


def test_alias_library_is_built():
    """The render path builds the table with the compiled copy of the
    reference's source (g++ is present wherever the tests run)."""
    assert tdist.alias_library() is not None


_weights = st.lists(
    st.one_of(st.just(0.0), st.floats(0.0, 1e6, allow_nan=False, allow_subnormal=False)),
    min_size=1, max_size=300,
)


@settings(max_examples=150, deadline=None)
@given(_weights)
@example([0.0])
@example([0.0] * 17)
@example([3.5])
@example([1.0] * 64)
def test_alias_equals_reference(weights):
    w = np.asarray(weights, np.float64)
    prob, alias = tdist.build_alias(w)
    ref_prob, ref_alias = jdist.build_alias(w)
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(alias, ref_alias)


@settings(max_examples=40, deadline=None)
@given(_weights)
@example([0.0] * 5)
@example([2.0])
def test_alias_fallback_equals_reference_fallback(weights):
    """Without a C++ compiler both packages take their pure-Python Vose."""
    import mitsuba_tpu.native as jnative

    w = np.asarray(weights, np.float64)
    # C10: where n / sum overflows, the reference's fallback leaves its NaN
    # bins unwritten (np.empty's memory), which cannot be compared;
    # test_c10_fallback_writes_every_bin covers those weights
    s = w.sum()
    assume(s == 0 or np.isfinite(w.size / s))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdist, "alias_library", lambda: None)
        mp.setattr(jnative, "alias_builder", lambda: None)
        prob, alias = tdist.build_alias(w)
        ref_prob, ref_alias = jdist.build_alias(w)
    np.testing.assert_array_equal(prob, ref_prob)
    np.testing.assert_array_equal(alias, ref_alias)


C10_WEIGHTS = (
    [0.0, 2.2250738585072014e-308, 0.0, 0.0],
    [0.0, 0.0, 2.2250738585072014e-308, 0.0, 0.0, 0.0, 2.2250738585072014e-308, 0.0],
)


@pytest.mark.parametrize("weights", C10_WEIGHTS, ids=("n4", "n8"))
def test_c10_fallback_writes_every_bin(weights):
    """C10: n / sum overflows to inf, so the zero bins' p is NaN.  The
    port's fallback puts them with the full bins, as both compiled
    builders do, and writes every bin; the reference's fallback puts
    them in neither list and leaves np.empty's memory there, shown here
    with a sentinel fill."""
    import mitsuba_tpu.native as jnative

    w = np.asarray(weights, np.float64)
    assert not np.isfinite(w.size / w.sum())
    nan_bins = np.flatnonzero(w == 0.0)
    compiled = tdist.build_alias(w)
    ref_compiled = jdist.build_alias(w)
    sentinel = -7.0
    real_empty = np.empty

    def filled(shape, dtype=float, *a, **k):
        return np.full(shape, sentinel, dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdist, "alias_library", lambda: None)
        mp.setattr(jnative, "alias_builder", lambda: None)
        mp.setattr(np, "empty", filled)
        fallback = tdist.build_alias(w)
        ref_fallback = jdist.build_alias(w)
    assert np.empty is real_empty
    for got in (fallback, ref_compiled):
        np.testing.assert_array_equal(got[0], compiled[0])
        np.testing.assert_array_equal(got[1], compiled[1])
    assert (fallback[0] != sentinel).all()
    np.testing.assert_array_equal(ref_fallback[0][nan_bins], sentinel)
    assert (ref_fallback[0][w > 0] == 1.0).all()


def _check_2d(w):
    out = tdist.Distribution2D.from_weights(w)
    ref = jdist.Distribution2D.from_weights(w)
    for k in ("marginal_cdf", "conditional_cdf", "density"):
        a, b = getattr(out, k), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_distribution2d_on_sky_equals_reference():
    _check_2d(_sky_weights())


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 12), st.integers(1, 12), st.integers(0, 2**31 - 1), st.booleans())
def test_distribution2d_equals_reference(h, w, seed, zero_rows):
    r = np.random.default_rng(seed)
    wts = r.exponential(size=(h, w)) * (r.random((h, w)) < 0.7)
    if zero_rows:
        wts[r.random(h) < 0.5] = 0.0
    _check_2d(wts)


def test_distribution2d_all_zero():
    _check_2d(np.zeros((3, 4)))


def test_sample_2d_and_pdf_equal_reference():
    w = _sky_weights()[::8, ::8]  # 32 x 64
    ref = jdist.Distribution2D.from_weights(w)
    out = tdist.Distribution2D.from_weights(w)
    u2 = np.random.default_rng(1).random((N, 2)).astype(np.float32)
    tabs = [torch.as_tensor(t) for t in (out.marginal_cdf, out.conditional_cdf, out.density)]
    xy, pdf = tdist.sample_2d(*tabs, torch.as_tensor(u2))
    ref_xy, ref_pdf = ref.sample(jnp.asarray(u2))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(ref_xy))
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(ref_pdf))
    np.testing.assert_array_equal(tdist.pdf_2d(tabs[2], xy).numpy(),
                                  np.asarray(ref.pdf(ref_xy)))


# ---- the pack's env arrays ----

def _packs(xml):
    return jpack_scene(jload_string(xml)), pack_scene(mt.load_scene_string(xml), "cpu")


@pytest.mark.parametrize("name", ["matpreview", "rotated"])
def test_pack_env_arrays_equal_reference(name):
    if name == "matpreview":
        jp, tp = jpack_scene(jload(MATPREVIEW_XML)), pack_scene(mt.load_scene(MATPREVIEW_XML), "cpu")
        assert tp.env_image.shape == (256, 512, 3)
    else:
        jp, tp = _packs(_env_xml(SKY))
    for k in ENV_ARRAYS:
        out, ref = tp.arrays[k].numpy(), np.asarray(jp.arrays[k])
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)
    ulps = np.abs(tp.env_to_local.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jp.env_to_local).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    for k in ("has_env", "has_envmap", "env_idx", "env_alias_fused_ok", "emitter_kinds"):
        assert tp.meta[k] == jp.meta[k], k
    np.testing.assert_array_equal(tp.em_rgb.numpy(), np.asarray(jp.em_rgb))


# ---- the emitter functions ----

@pytest.fixture(scope="module")
def rotated():
    jp, tp = _packs(_env_xml(SKY))
    r = np.random.default_rng(0)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = r.random((N, 3)).astype(np.float32)
    p = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    return jp, tp, d, u, p


def test_env_uv_from_dir(rotated):
    jp, tp, d, _, _ = rotated
    out = tem._env_uv_from_dir(tp, torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(out, np.asarray(jem._env_uv_from_dir(jp, jnp.asarray(d))),
                               rtol=0, atol=1e-5)


def test_eval_env(rotated):
    jp, tp, d, _, _ = rotated
    out = tem.eval_env(tp, torch.as_tensor(d)).numpy()
    ref = np.asarray(jem.eval_env(jp, jnp.asarray(d)))
    assert out.shape == (N, 3) and (ref > 0).all()
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=0)


@pytest.mark.parametrize("fn", ["_env_pdf_dir", "pdf_direct_env"])
def test_env_pdf(rotated, fn):
    jp, tp, d, _, _ = rotated
    out = getattr(tem, fn)(tp, torch.as_tensor(d)).numpy()
    np.testing.assert_allclose(out, np.asarray(getattr(jem, fn)(jp, jnp.asarray(d))),
                               rtol=3e-3, atol=0)


def _captured_uv(monkeypatch, mod):
    """Record the lat-long uv each _env_dir_from_uv call receives."""
    seen, inner = [], mod._env_dir_from_uv

    def spy(pack, uv):
        seen.append(np.asarray(uv))
        return inner(pack, uv)

    monkeypatch.setattr(mod, "_env_dir_from_uv", spy)
    return seen


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_sample_env_dir(rotated, monkeypatch, fused):
    jp, tp, _, u, _ = rotated
    jp = type(jp)(jp.arrays, {**jp.meta, "env_alias_fused_ok": fused})
    tp = type(tp)(tp.arrays, {**tp.meta, "env_alias_fused_ok": fused})
    t_uv, j_uv = _captured_uv(monkeypatch, tem), _captured_uv(monkeypatch, jem)
    d, pdf = tem._sample_env_dir(tp, torch.as_tensor(u[:, 1:]))
    ref_d, ref_pdf = jem._sample_env_dir(jp, jnp.asarray(u[:, 1:]))
    np.testing.assert_array_equal(t_uv[0], j_uv[0])  # the sampled texel and its offsets
    h, w = tp.env_density.shape
    pix = np.floor(t_uv[0] * [w, h]).astype(np.int64)
    assert len(np.unique(pix[:, 1] * w + pix[:, 0])) > 1000  # many texels drawn
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(ref_pdf), rtol=1e-6, atol=0)


def test_sample_direct_envmap(rotated):
    jp, tp, _, u, p = rotated
    out = tem.sample_direct(tp, torch.as_tensor(p), torch.as_tensor(u))
    ref = jem.sample_direct(jp, jnp.asarray(p), jnp.asarray(u))
    np.testing.assert_array_equal(out.kind.numpy(), np.asarray(ref.kind))
    assert (out.kind.numpy() == 6).all()
    np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))
    np.testing.assert_allclose(out.d.numpy(), np.asarray(ref.d), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.pdf.numpy(), np.asarray(ref.pdf), rtol=1e-6, atol=0)
    np.testing.assert_allclose(out.value.numpy(), np.asarray(ref.value), rtol=1e-4, atol=0)


def test_envmap_reads_the_exr_once_scaled(rotated):
    """env_image is the file's RGB times the scale."""
    _, tp, _, _, _ = rotated
    np.testing.assert_array_equal(tp.env_image.numpy(), read_exr(SKY)[0] * np.float32(2.5))


def test_unported_emitters_raise():
    """The daylight plugins (sky, sunsky, sun), once refused by name, load
    and pack: sky and sunsky as an envmap, sun as a directional emitter."""
    for kind, kinds in (("sky", (ENVMAP,)), ("sunsky", (ENVMAP,)), ("sun", (DIRECTIONAL,))):
        xml = (f'<scene version="0.5.0"><sensor type="perspective"/><emitter type="{kind}">'
               '<integer name="resolution" value="32"/></emitter></scene>')
        tp = pack_scene(mt.load_scene_string(xml), "cpu")
        assert tp.meta["emitter_kinds"] == kinds, kind
        assert tp.meta["has_envmap"] == (kind != "sun"), kind


# ---- renders ----

def test_matpreview_matches_reference_golden():
    """scenes/matpreview.xml as it stands: envmap, sobol, VNDF."""
    scene = mt.load_scene(MATPREVIEW_XML)
    scene.sensor.record.film.width = scene.sensor.record.film.height = 64
    assert scene.sensor.record.sampler.kind == 3  # sobol
    golden = np.load(GOLDEN)
    img = mt.render(scene, spp=16, seed=0, device="cpu")
    assert img.shape == golden.shape and img.dtype == np.float32
    assert np.isfinite(img).all()
    assert _tonemapped_rmse(img, golden) < 5e-3


def test_matpreview_from_reference_pack_is_identical():
    jscene = jload(MATPREVIEW_XML)
    jp = jpack_scene(jscene)
    converted = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    scene = mt.load_scene(MATPREVIEW_XML)
    scene.sensor.record.film.width = scene.sensor.record.film.height = 16
    a = mt.render(scene, spp=2, seed=0, device="cpu")
    b = mt.render(scene, spp=2, seed=0, device="cpu", pack=converted)
    np.testing.assert_array_equal(a, b)


def test_ldr_png_envmap_matches_jax_render(tmp_path):
    """A grey 8-bit PNG: de-gamma'd (sRGB) and repeated to RGB."""
    yy, xx = np.mgrid[0:32, 0:64]
    grey = (40 + 200 * (yy < 14) * (0.5 + 0.5 * np.sin(xx / 5.0))).astype(np.uint8)[..., None]
    path = str(tmp_path / "env.png")
    jwrite_png(path, grey)
    xml = _env_xml(path, size=16)
    img = mt.render(mt.load_scene_string(xml), spp=8, seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=8, seed=0), np.float32)
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert _tonemapped_rmse(img, ref) < 5e-3
