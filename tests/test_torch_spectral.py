"""The port's spectral mode (mitsuba_tpu_torch/core/spectral.py, the
colour helpers of core/spectrum.py, the tabulated and blackbody spectra of
scene/xml_loader.py, scene/builder.py apply_spectral_pack and render's
`spectral_bins`) against the reference (mitsuba_tpu/core/spectral.py,
core/spectrum.py, scene/xml_loader.py, scene/builder.py, renderer.py), on
inputs made from seeds with numpy, and scenes/dispersion.xml's renders
against the JAX package's goldens.

Tolerances:

* the bin tables (make_bins), cauchy_eta, upsample_rgb, upsample_illum,
  spd_to_bins, blackbody_rgb, interpolated_spectrum_to_rgb and the parsed
  spectra: equal (the same numpy code);
* apply_spectral_pack: every leaf it rewrites equal to the reference's,
  every other tensor the caller's own, the caller's pack unchanged, and
  the port's material table equal to the one it builds from the
  reference's rewritten leaves;
* the 3-bin render of cbox against the port's RGB render within 1e-4,
  the reference's own gate (tests/test_spectral.py:94-102);
* bdpt (its own orchestration) in 6 bins on cbox against the JAX
  package's render: tone-mapped RMSE below 1e-6 (measured 2.7e-8);
* the goldens: tests/torch_meshes.py GOLDEN_GATES.
"""

import os

import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import spectral as jspec
from mitsuba_tpu.core import spectrum as jspectrum
from mitsuba_tpu.scene import builder as jbuilder
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import spectral as tspec
from mitsuba_tpu_torch.core import spectrum as tspectrum
from mitsuba_tpu_torch.scene import builder as tbuilder
from tests.torch_meshes import (
    CBOX_XML,
    GOLDEN_GATES,
    ROOT,
    cbox_xml,
    dispersion_xml,
    feature_assets,
    textured_xml,
    tm_rmse,
)

torch.set_num_threads(1)

BINS = [3, 6, 9, 12, 24]
REWRITTEN = tbuilder._SPECTRAL_LEAVES + tbuilder._EMISSION_LEAVES + ("tex_atlas", "mat_eta")


def _rgb(seed, n=500):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    rgb[:8] = [[0, 0, 0], [1, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0],
               [0.25, 0.25, 0.25], [0.2, 0.9, 0.2]]
    return rgb


@pytest.mark.parametrize("n", BINS)
def test_make_bins_equal(n):
    got, ref = tspec.make_bins(n), jspec.make_bins(n)
    assert (got.n, got.identity, got.n_groups) == (ref.n, ref.identity, ref.n_groups)
    for k in ("edges", "centers", "to_xyz", "basis", "d65"):
        a, b = getattr(got, k), getattr(ref, k)
        if b is None:
            assert a is None, k
        else:
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    for g in range(ref.n_groups):
        (m_got, lam_got), (m_ref, lam_ref) = got.group(g), ref.group(g)
        np.testing.assert_array_equal(m_got, m_ref)
        assert lam_got == lam_ref


def test_invalid_bin_counts():
    for n in (0, 7, -3):
        with pytest.raises(ValueError, match="multiple of 3"):
            tspec.make_bins(n)


@pytest.mark.parametrize("n", BINS)
def test_upsample_equal(n):
    bins_t, bins_j = tspec.make_bins(n), jspec.make_bins(n)
    rgb = _rgb(n)
    for fn in ("upsample_rgb", "upsample_illum"):
        got, ref = getattr(tspec, fn)(rgb, bins_t), getattr(jspec, fn)(rgb, bins_j)
        assert got.dtype == ref.dtype, fn
        np.testing.assert_array_equal(got, ref, err_msg=fn)
    lam = np.array([380.0, 450.0, 520.0, 610.0, 700.0, 780.0])
    val = np.array([0.1, 0.8, 0.3, 0.9, 0.5, 0.2])
    np.testing.assert_array_equal(tspec.spd_to_bins(lam, val, bins_t),
                                  jspec.spd_to_bins(lam, val, bins_j))


def test_cauchy_eta_equal():
    rng = np.random.default_rng(1)
    eta = rng.uniform(1.3, 2.4, 64).astype(np.float32)
    disp = rng.uniform(0.0, 0.02, 64).astype(np.float32)
    for lam in (380.0, 438.3, 587.6, 595.0, 751.7):
        got = tspec.cauchy_eta(eta, disp, lam)
        ref = jspec.cauchy_eta(eta, disp, lam)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("temperature", [1000.0, 2700.0, 5500.0, 6504.0, 12000.0])
def test_blackbody_equal(temperature):
    got, ref = tspectrum.blackbody_rgb(temperature), jspectrum.blackbody_rgb(temperature)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_interpolated_spectrum_equal():
    rng = np.random.default_rng(2)
    for n in (2, 5, 40):
        lam = np.sort(rng.uniform(350.0, 800.0, n))
        val = rng.uniform(0.0, 3.0, n)
        np.testing.assert_array_equal(tspectrum.interpolated_spectrum_to_rgb(lam, val),
                                      jspectrum.interpolated_spectrum_to_rgb(lam, val))


def test_xyz_matrices():
    np.testing.assert_array_equal(tspectrum._RGB_TO_XYZ, jspectrum._RGB_TO_XYZ)
    np.testing.assert_array_equal(tspectrum._XYZ_TO_RGB, jspectrum._XYZ_TO_RGB)
    rgb = torch.as_tensor(_rgb(3))
    back = tspectrum.xyz_to_rgb(tspectrum.rgb_to_xyz(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), rtol=1e-5, atol=1e-5)


def _spectrum_scene(value_xml):
    return ('<scene version="0.5.0"><sensor type="perspective"/>'
            '<shape type="rectangle"><bsdf type="diffuse">'
            f'{value_xml}</bsdf></shape>'
            '<shape type="sphere"><emitter type="area">'
            '<blackbody name="radiance" temperature="4500" scale="3.5"/></emitter></shape>'
            '</scene>')


@pytest.mark.parametrize("value_xml", [
    '<spectrum name="reflectance" value="400:0.1, 500:0.5, 600:0.8, 700:0.3"/>',
    '<spectrum name="reflectance" value="450:0.7 650:0.2"/>',
    '<spectrum name="reflectance" value="0.35"/>',
    '<spectrum name="reflectance" value="0.1, 0.2, 0.3"/>',
    '<spectrum name="reflectance" value="{spd}"/>',
])
def test_parsed_spectra(value_xml, tmp_path):
    """<spectrum> as lambda:value pairs, a uniform value, three values,
    and a .spd file found on the search paths (here the scene's
    directory); <blackbody> with its scale."""
    spd = tmp_path / "refl.spd"
    spd.write_text("# wavelength value\n380 0.05\n480 0.6\n\n580 0.4\n680 0.9\n780 0.1\n")
    xml = _spectrum_scene(value_xml.format(spd=spd.name))
    got = mt.load_scene_string(xml, base_dir=str(tmp_path))
    ref = jload_string(xml, base_dir=str(tmp_path))
    for a, b in ((got.shapes[0].bsdf.cA, ref.shapes[0].bsdf.cA),
                 (got.shapes[1].emitter.radiance, ref.shapes[1].emitter.radiance)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_unknown_spectrum_raises():
    with pytest.raises(ValueError, match="cannot parse spectrum"):
        mt.load_scene_string(_spectrum_scene('<spectrum name="reflectance" value="no.spd"/>'))


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """(port pack, reference pack) of cbox, dispersion.xml and TEXTURED
    (bump maps, whose atlas texels the rewrite restores)."""
    assets = feature_assets(str(tmp_path_factory.mktemp("spec_assets")))
    out = {}
    for name, xml in (("cbox", cbox_xml("path", 16, 16)), ("dispersion", dispersion_xml(16, 16)),
                      ("textured", textured_xml(assets, 16, 16))):
        out[name] = (tbuilder.pack_scene(mt.load_scene_string(xml), "cpu"),
                     jbuilder.pack_scene(jload_string(xml)))
    return out


@pytest.mark.parametrize("name", ["cbox", "dispersion", "textured"])
@pytest.mark.parametrize("n", [3, 9])
def test_apply_spectral_pack(packs, name, n):
    tp, jp = packs[name]
    before = {k: v.clone() for k, v in tp.arrays.items()}
    bins_t, bins_j = tspec.make_bins(n), jspec.make_bins(n)
    for g in range(bins_t.n_groups):
        got = tbuilder.apply_spectral_pack(tp, bins_t, g)
        ref = jbuilder.apply_spectral_pack(jp, bins_j, g)
        assert got.meta is tp.meta and ref.meta is jp.meta
        assert set(got.arrays) == set(tp.arrays)
        for k, v in got.arrays.items():
            if k in REWRITTEN and k in ref.arrays:
                r = np.asarray(ref.arrays[k])
                assert v.dtype == torch.float32 and r.dtype == np.float32, k
                np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
            elif k not in ("mat_params", "mat_iparams"):
                # the sampling tables (env_density, the alias table, the
                # emitter pmf and cdf) and every other tensor: the caller's
                assert v is tp.arrays[k], k
        via_ref = tbuilder.pack_from_numpy({k: np.asarray(v) for k, v in ref.arrays.items()},
                                           ref.meta, "cpu")
        for k in ("mat_params", "mat_iparams"):
            np.testing.assert_array_equal(got.arrays[k].numpy(), via_ref.arrays[k].numpy(),
                                          err_msg=k)
    for k, v in tp.arrays.items():
        assert torch.equal(v, before[k]), k


def test_dispersion_moves_the_glass_eta(packs):
    """9 bins move the glass's eta (1.5168, Cauchy B 0.0042) to the hero
    wavelength of each group, 438.3, 595.0 and 751.7 nm, and leave the
    floor's row alone."""
    tp, _ = packs["dispersion"]
    glass = int(np.nonzero(tp.mat_disp.numpy())[0][0])
    bins = tspec.make_bins(9)
    etas = [float(tbuilder.apply_spectral_pack(tp, bins, g).mat_eta[glass]) for g in range(3)]
    assert etas[0] > float(tp.mat_eta[glass]) > etas[1] > etas[2]
    np.testing.assert_allclose(etas, [1.52608, 1.51608, 1.51165], atol=2e-5)
    np.testing.assert_allclose(float(tp.mat_disp[glass]), 0.0042)


def test_three_bins_are_rgb():
    """3-bin mode runs the whole spectral branch and reproduces the RGB
    render (tests/test_spectral.py:94-102, cbox at 32x32, 16 spp, seed
    2)."""
    scene = mt.load_scene(CBOX_XML)
    scene.sensor.record.film.width = scene.sensor.record.film.height = 32
    ref = mt.render(scene, spp=16, seed=2, device="cpu")
    img = mt.render(scene, spp=16, seed=2, device="cpu", spectral_bins=3)
    assert np.abs(img - ref).max() < 1e-4


def test_environment_setting(monkeypatch):
    """MTS_SPECTRAL_BINS selects spectral mode as the argument does."""
    scene = mt.load_scene_string(dispersion_xml(8, 8))
    by_arg = mt.render(scene, spp=2, seed=0, device="cpu", spectral_bins=6)
    monkeypatch.setenv("MTS_SPECTRAL_BINS", "6")
    np.testing.assert_array_equal(mt.render(scene, spp=2, seed=0, device="cpu"), by_arg)
    monkeypatch.setenv("MTS_SPECTRAL_BINS", "0")
    assert not np.array_equal(mt.render(scene, spp=2, seed=0, device="cpu"), by_arg)


def test_bdpt_spectral_matches_reference():
    """bdpt, an integrator with its own orchestration, renders each bin
    group: cbox at 16x16, maxDepth 3, 2 spp, 6 bins, against the JAX
    package's render."""
    from mitsuba_tpu.renderer import render as jrender

    xml = cbox_xml("bdpt", 16, 16, max_depth=3)
    ref = np.asarray(jrender(jload_string(xml), spp=2, seed=0, spectral_bins=6))
    img = mt.render(mt.load_scene_string(xml), spp=2, seed=0, device="cpu", spectral_bins=6)
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < 1e-6, tm_rmse(img, ref)


@pytest.mark.parametrize("golden,bins", [("torch_dispersion_32_4.npy", None),
                                         ("torch_dispersion_spectral9_32_4.npy", 9)])
def test_dispersion_goldens(golden, bins):
    """scenes/dispersion.xml at 32x32, 4 spp, seed 0, in RGB mode and with
    9 bins, against the JAX package's renders
    (tests/make_torch_bigmesh_golden.py)."""
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(mt.load_scene_string(dispersion_xml(32, 32)), spp=4, seed=0, device="cpu",
                    spectral_bins=bins)
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden], tm_rmse(img, ref)


def test_env_spectral_multichannel_matches_reference(monkeypatch):
    """ROADMAP C5, a fault of the reference that the port keeps: under
    MTS_SPECTRAL_BINS a multichannel integrator's nested renders read the
    setting again and rewrite the already rewritten pack of their bin
    group, so the image differs from the render with `spectral_bins`.
    The port renders what the reference renders (cbox under multichannel
    over path, 8x8, 1 spp, 6 bins)."""
    from mitsuba_tpu.renderer import render as jrender
    from tests.torch_meshes import NESTED_PATH, cbox_meta_xml

    xml = cbox_meta_xml("multichannel", NESTED_PATH, 8, 8)
    by_arg = mt.render(mt.load_scene_string(xml), spp=1, seed=0, device="cpu", spectral_bins=6)
    monkeypatch.setenv("MTS_SPECTRAL_BINS", "6")
    ref = np.asarray(jrender(jload_string(xml), spp=1, seed=0))
    img = mt.render(mt.load_scene_string(xml), spp=1, seed=0, device="cpu")
    assert tm_rmse(img, ref) < 1e-6, tm_rmse(img, ref)
    assert tm_rmse(img, by_arg) > 1e-3
