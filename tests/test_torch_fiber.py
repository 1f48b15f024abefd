"""The port's remaining media against the reference on the same seeded
numpy inputs: the fiber phases kkay and microflake on an orientation
volume, and the volumes hgridvolume and volcache.

Tolerances:

* the packs of FIBER (kkay and microflake; the density through
  gridvolume, hgridvolume and volcache): every medium array and meta key
  equal, bit for bit; the host tables (_kkay_normalization,
  _flake_tables) bit for bit;
* _orient_at, _kkay_eval, _microflake_eval and phase_eval / phase_pdf /
  phase_sample with a position on 4,096 seeded lanes: valid flags equal,
  values within rtol 1e-5 (atol 1e-6); microflake's sampled direction,
  pdf and weight within rtol 1e-4 (atol 1e-5), and 1e-3 where the first
  uniform lies within 0.02 of 0 or 1: torch.erfinv and XLA's erfinv
  differ in their last places, and erfinv is steep there;
* renders: each golden at its GOLDEN_GATES entry (tone-mapped RMSE);
* the port's fiber sampling against its pdf: the chi-square test of
  tests/chi2.py at significance 1e-3, as tests/test_fiber_phase.py runs
  the reference's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.medium import eval as jme
from mitsuba_tpu.medium import plugins as jmp
from mitsuba_tpu.renderer import render as jrender
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.medium import eval as tme
from mitsuba_tpu_torch.medium import plugins as tmp
from mitsuba_tpu_torch.scene.builder import MEDIA_ARRAYS, MEDIA_META, pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.chi2 import chi2_test
from tests.make_torch_bigmesh_golden import reference_pair_traversal
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    fiber_assets,
    fiber_slab_xml,
    fiber_xml,
    tm_rmse,
    write_vol,
)

torch.set_num_threads(1)
N = 4096
PHASES = ("kkay", "microflake")
DENSITIES = ("grid", "hgrid", "volcache")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return fiber_assets(str(tmp_path_factory.mktemp("fiber")))


class _Packs(dict):
    def __init__(self, assets):
        super().__init__()
        self.assets = assets

    def __missing__(self, key):
        xml = fiber_xml(*key[:1], self.assets, key[1], 16, 16)
        self[key] = (jpack_scene(jload_string(xml)), pack_scene(load_scene_string(xml), "cpu"))
        return self[key]


@pytest.fixture(scope="module")
def packs(assets):
    return _Packs(assets)


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


# ---- packs and host tables --------------------------------------------------

@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("phase", PHASES)
def test_packs_equal_reference(packs, phase, density):
    """The medium tables, the fiber phases' and the orientation corners
    among them, equal the reference's; the density read through
    hgridvolume or volcache packs as through the gridvolume itself."""
    jp, tp = packs[(phase, density)]
    for k in MEDIA_ARRAYS:
        np.testing.assert_array_equal(_tnp(tp.arrays[k]), _np(jp.arrays[k]), err_msg=k)
    for k in MEDIA_META:
        assert tp.meta[k] == jp.meta[k], k
    assert tp.meta["phase_kinds"] == ({"kkay": tmp.KKAY, "microflake": tmp.MICROFLAKE}[phase],)
    assert tp.het_obase.tolist() == [0] and tp.het_odims.tolist() == [[48, 48, 48]]
    _, grid = packs[(phase, "grid")]
    for k in ("het_corners", "het_super", "het_w2g", "het_dims"):
        np.testing.assert_array_equal(_tnp(tp.arrays[k]), _tnp(grid.arrays[k]), err_msg=k)


def test_hgrid_flattens_to_the_grid(assets):
    """The 2 x 2 x 2 blocks of 24^3 flatten into smoke.vol's 48^3 grid
    and box, in both packages."""
    from mitsuba_tpu_torch.scene.properties import Properties

    vol = tmp.load_vol(os.path.join(ROOT, "scenes", "assets", "smoke.vol"))
    props = Properties(plugin_name="volume:hgridvolume", search_paths=[assets])
    props.set("filename", "smoke.hgrid")
    props.set("prefix", "smoke_")
    props.set("postfix", ".vol")
    rec = tmp.HGridVolume(props).record
    np.testing.assert_array_equal(rec.grid, vol.grid[..., 0])
    np.testing.assert_array_equal(rec.aabb_min, vol.aabb_min)
    np.testing.assert_array_equal(rec.aabb_max, vol.aabb_max)


@pytest.mark.parametrize("exponent", [1.0, 4.0, 6.0, 30.5])
def test_kkay_normalization(exponent):
    assert tmp._kkay_normalization(exponent) == jmp._kkay_normalization(exponent)


@pytest.mark.parametrize("stddev", [0.01, 0.1, 0.25, 1.0])
def test_flake_tables(stddev):
    norm, sigt = tmp._flake_tables(stddev)
    ref_norm, ref_sigt = jmp._flake_tables(stddev)
    assert norm == ref_norm
    np.testing.assert_array_equal(sigt, ref_sigt)


# ---- phase functions --------------------------------------------------------

def _lanes(seed):
    """Seeded lanes: medium 0, or -1 on a tenth; positions in the smoke's
    box (a tenth outside it); unit directions."""
    g = np.random.default_rng(seed)
    med = np.where(g.uniform(size=N) < 0.1, -1, 0).astype(np.int32)
    p = g.uniform([-0.55, -0.05, -0.55], [0.55, 1.05, 0.55], (N, 3)).astype(np.float32)

    def dirs():
        d = g.normal(size=(N, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)

    return med, p, dirs(), dirs(), g.uniform(size=(N, 2)).astype(np.float32)


@pytest.mark.parametrize("phase", PHASES)
def test_orient_at(packs, phase):
    """The trilinear, renormalized orientation at each position."""
    jp, tp = packs[(phase, "grid")]
    med, p, *_ = _lanes(1)
    ax_r, ok_r = jme._orient_at(jp, jnp.asarray(med), jnp.asarray(p))
    ax, ok = tme._orient_at(tp, _t(med), _t(p))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_r))
    assert ok.float().mean() > 0.5
    _close(ax[ok], np.asarray(ax_r)[ok.numpy()])


@pytest.mark.parametrize("phase", PHASES)
def test_fiber_evals(packs, phase):
    """_kkay_eval and _microflake_eval on the same axes and directions."""
    jp, tp = packs[(phase, "grid")]
    med, p, wi, wo, _ = _lanes(2)
    ax, ok = jme._orient_at(jp, jnp.asarray(med), jnp.asarray(p))
    m = np.maximum(med, 0)
    fn = {"kkay": "_kkay_eval", "microflake": "_microflake_eval"}[phase]
    ref = getattr(jme, fn)(jp, jnp.asarray(m), ax, ok, jnp.asarray(wi), jnp.asarray(wo))
    out = getattr(tme, fn)(tp, _t(m), _t(ax), _t(ok), _t(wi), _t(wo))
    _close(out, ref)
    assert (out > 0).float().mean() > 0.3


@pytest.mark.parametrize("phase", PHASES)
def test_phase_eval_pdf_sample(packs, phase):
    """phase_eval, phase_pdf and phase_sample with the event's position."""
    jp, tp = packs[(phase, "grid")]
    med, p, d_in, d_out, u2 = _lanes(3)
    jargs = (jp, jnp.asarray(med), jnp.asarray(d_in))
    targs = (tp, _t(med), _t(d_in))
    _close(tme.phase_eval(*targs, _t(d_out), p=_t(p)),
           jme.phase_eval(*jargs, jnp.asarray(d_out), p=jnp.asarray(p)))
    _close(tme.phase_pdf(*targs, _t(d_out), p=_t(p)),
           jme.phase_pdf(*jargs, jnp.asarray(d_out), p=jnp.asarray(p)))
    out = tme.phase_sample(*targs, _t(u2), p=_t(p))
    ref = jme.phase_sample(*jargs, jnp.asarray(u2), p=jnp.asarray(p))
    if phase == "kkay":
        for a, b in zip(out, ref):
            _close(a, b)
    else:
        # erfinv is steep near +-1: where the first uniform lies within
        # 0.02 of 0 or 1 a last-place difference of its argument moves the
        # flake's cosine, and the pdf D(c) / (2 |wi . m|) with it, by up to
        # 2.1e-4 relative (2 of 4,096 lanes, measured)
        steep = torch.from_numpy((u2[:, 0] < 0.02) | (u2[:, 0] > 0.98))
        for a, b in zip(out, ref):
            b = _t(b)
            _close(a[~steep], b[~steep], rtol=1e-4, atol=1e-5)
            _close(a[steep], b[steep], rtol=1e-3, atol=1e-5)
    # without a position the fiber phases evaluate as the reference does
    _close(tme.phase_eval(*targs, _t(d_out)), jme.phase_eval(*jargs, jnp.asarray(d_out)))


def _chi2_pack(tmp_path, phase):
    """tests/test_fiber_phase.py's scene: a unit density and a constant
    orientation +z over [-2, 2]^3 in a null sphere."""
    dens, orient = str(tmp_path / "dens.vol"), str(tmp_path / "orient.vol")
    write_vol(dens, np.ones((4, 4, 4), np.float32), (-2, -2, -2), (2, 2, 2))
    write_vol(orient, np.tile(np.asarray([0.0, 0.0, 1.0], np.float32), (4, 4, 4, 1)),
              (-2, -2, -2), (2, 2, 2))
    from tests.torch_meshes import FIBER_PHASES

    xml = f"""<scene version="0.5.0"><integrator type="volpath"/>
      <sensor type="perspective"><film type="hdrfilm"><integer name="width" value="8"/>
        <integer name="height" value="8"/></film></sensor>
      <shape type="sphere"><bsdf type="null"/><medium name="interior" type="heterogeneous">
        <volume name="density" type="gridvolume"><string name="filename" value="{dens}"/></volume>
        <volume name="orientation" type="gridvolume"><string name="filename" value="{orient}"/>
        </volume>{FIBER_PHASES[phase]}</medium></shape>
      <emitter type="constant"/></scene>"""
    return pack_scene(load_scene_string(xml), "cpu")


@pytest.mark.parametrize("phase", PHASES)
def test_fiber_sampling_chi2(tmp_path, phase):
    """The port's draw against its own pdf (tests/test_fiber_phase.py's
    test of the reference, 400,000 draws)."""
    pack = _chi2_pack(tmp_path, phase)
    d_in = np.asarray([0.4, 0.2, 0.894], np.float32)
    d_in /= np.linalg.norm(d_in)

    def lanes(n):
        return (torch.zeros(n, dtype=torch.int32), _t(d_in).expand(n, 3),
                torch.zeros(n, 3))

    def sample_fn(u2):
        med, din, p = lanes(u2.shape[0])
        d_out, pdf, _ = tme.phase_sample(pack, med, din, _t(u2), p=p)
        return torch.where((pdf > 0)[..., None], d_out, 0.0).numpy()

    def pdf_fn(d):
        med, din, p = lanes(d.shape[0])
        return tme.phase_pdf(pack, med, din, _t(d), p=p).numpy()

    passed, _, msg = chi2_test(sample_fn, pdf_fn, n_samples=400_000, pdf_sub=32)
    assert passed, msg


def test_microflake_weight_is_eval_over_pdf(tmp_path):
    """The microflake draw's weight is eval / pdf (tests/test_fiber_phase.py
    test_fiber_weight_consistency)."""
    pack = _chi2_pack(tmp_path, "microflake")
    lane = torch.arange(N, dtype=torch.int64)
    u2 = rng.rand4(lane, torch.full_like(lane, 3), 5, 11)[..., :2]
    med = torch.zeros(N, dtype=torch.int32)
    din = torch.tensor([0.4, 0.2, 0.894]).expand(N, 3)
    din = din / torch.linalg.vector_norm(din, dim=-1, keepdim=True)
    p = torch.zeros(N, 3)
    d_out, pdf, w = tme.phase_sample(pack, med, din, u2, p=p)
    f = tme.phase_eval(pack, med, din, d_out, p=p)
    ok = pdf > 1e-6
    np.testing.assert_allclose((f[ok] / pdf[ok]).numpy(), w[ok].numpy(), rtol=2e-3, atol=1e-4)


# ---- renders ----------------------------------------------------------------

GOLDENS = {
    "torch_fiber_kkay_24_4.npy": (lambda d: fiber_xml("kkay", d, "grid", 24, 24), {}),
    "torch_fiber_microflake_24_4.npy": (lambda d: fiber_xml("microflake", d, "grid", 24, 24), {}),
    "torch_fiber_slab_bdpt_16_4.npy": (lambda d: fiber_slab_xml("bdpt", d), {}),
    "torch_fiber_slab_photonmapper_16_4.npy": (lambda d: fiber_slab_xml("photonmapper", d),
                                               {"MTS_SPPM_PHOTONS": "4096"}),
}


@pytest.mark.parametrize("golden", list(GOLDENS))
def test_goldens(assets, golden, monkeypatch):
    """The JAX package's render (tests/make_torch_bigmesh_golden.py), seed
    0, 4 spp: FIBER under volpath, the fiber slab under bdpt and the photon
    mapper."""
    make, env = GOLDENS[golden]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))
    img = mt.render(mt.load_scene_string(make(assets)), spp=4, seed=0, device="cpu")
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < GOLDEN_GATES[golden], tm_rmse(img, ref)


@pytest.mark.parametrize("density", ["hgrid", "volcache"])
def test_density_sources_render_alike(assets, density):
    """FIBER renders bit for bit alike with its density read through
    hgridvolume or volcache as through the gridvolume."""
    imgs = [mt.render(mt.load_scene_string(fiber_xml("kkay", assets, dn, 12, 12)), spp=2,
                      seed=0, device="cpu") for dn in ("grid", density)]
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_spectral_matches_reference(assets):
    """FIBER kkay in spectral mode, 6 bins at 8 x 8, 2 spp, against the JAX
    package (its pair pipeline; med_ph_ks and med_ph_kd are spectral
    leaves)."""
    xml = fiber_xml("kkay", assets, "grid", 8, 8)
    with reference_pair_traversal():
        ref = np.asarray(jrender(jload_string(xml), spp=2, seed=0, spectral_bins=6))
    img = mt.render(mt.load_scene_string(xml), spp=2, seed=0, device="cpu", spectral_bins=6)
    assert img.shape == ref.shape
    assert tm_rmse(img, ref) < 1e-5, tm_rmse(img, ref)


def test_render_matches_reference(assets):
    """The slice as a whole: FIBER kkay through `render` at 24 x 24, 4 spp
    against the JAX package's render (its pair pipeline)."""
    xml = fiber_xml("kkay", assets, "grid", 24, 24)
    with reference_pair_traversal():
        ref = np.asarray(jrender(jload_string(xml), spp=4, seed=0))
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    assert tm_rmse(img, ref) < GOLDEN_GATES["torch_fiber_kkay_24_4.npy"], tm_rmse(img, ref)
