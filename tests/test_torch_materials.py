"""The port's materials against the reference on seeded numpy inputs:
Fresnel and refraction helpers, the index-of-refraction tables, the
rough-transmittance fit, the BSDF plugins' records, each BSDF type's
eval / pdf / sample, and the checkerboard texture.

Tolerances (measured on 20,000 lanes per type):

* the IOR lookups, the rtrans fit and the plugins' records: equal, bit
  for bit (numpy on both sides);
* the Fresnel / refraction helpers: rtol = atol = 1e-6;
* bsdf_eval and bsdf_pdf: rtol = 5e-4, atol = 1e-6 (exact for the
  smooth and diffuse types; largest measured difference 1.2e-4 relative,
  in roughdielectric, whose half vector of a refraction divides by
  wi.h + eta wo.h);
* bsdf_sample of diffuse, conductor, dielectric and plastic: rtol = atol
  = 1e-4 on wo, weight and pdf (the cosine warp differs in the last
  places; largest measured difference 6.3e-5 relative); of the
  microfacet types, whose direction comes from a sampled normal (see
  tests/test_torch_microfacet.py): wo within atol = 2e-4, and weight and
  pdf within rtol = 1e-3 on 99.9 % of lanes and rtol = 5e-2 on all of
  them (a pdf near a singular configuration amplifies the normal's last
  places; largest measured difference 2.2e-2 relative on 2 of 20,000
  lanes);
* delta and eta: equal;
* eval_texture: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdf import eval as jbsdf
from mitsuba_tpu.bsdf import ior as jior
from mitsuba_tpu.bsdf import rtrans as jrt
from mitsuba_tpu.core import math as jmm
from mitsuba_tpu.scene import texture_eval as jtex
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.bsdf import eval as tbsdf
from mitsuba_tpu_torch.bsdf import ior as tior
from mitsuba_tpu_torch.bsdf import rtrans as trt
from mitsuba_tpu_torch.bsdf.plugins import (
    CONDUCTOR,
    DIELECTRIC,
    DIFFUSE,
    PLASTIC,
    ROUGHCONDUCTOR,
    ROUGHDIELECTRIC,
    ROUGHPLASTIC,
)
from mitsuba_tpu_torch.core import math as tmm
from mitsuba_tpu_torch.scene import texture_eval as ttex
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string

torch.set_num_threads(1)

N = 20000
PRESENT = (DIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, DIELECTRIC, ROUGHDIELECTRIC, PLASTIC,
           ROUGHPLASTIC)
SAMPLED_NORMAL = (ROUGHCONDUCTOR, ROUGHDIELECTRIC, ROUGHPLASTIC)


def _dirs(seed, below=0.25):
    d = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    d[: int(N * below), 2] *= -1.0
    return d


def test_fresnel_and_refraction():
    r = np.random.default_rng(0)
    c = r.uniform(-1, 1, N).astype(np.float32)
    c[:4] = [0.0, 1.0, -1.0, 1e-7]
    eta = r.choice([1.5046, 1.33, 0.7, 2.419], N).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    for out, ref in zip(tmm.fresnel_dielectric(torch.as_tensor(c), torch.as_tensor(eta)),
                        jmm.fresnel_dielectric(jnp.asarray(c), jnp.asarray(eta))):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    ek = r.uniform(0.1, 3, (N, 3)).astype(np.float32)
    k = r.uniform(0, 5, (N, 3)).astype(np.float32)
    k[:8] = 1e7  # the "none" mirror
    np.testing.assert_allclose(
        tmm.fresnel_conductor(torch.as_tensor(c), torch.as_tensor(ek), torch.as_tensor(k)).numpy(),
        np.asarray(jmm.fresnel_conductor(jnp.asarray(c), jnp.asarray(ek), jnp.asarray(k))), **tol)
    wi = _dirs(1)
    for out, ref in zip(tmm.refract_local(torch.as_tensor(wi), torch.as_tensor(eta)),
                        jmm.refract_local(jnp.asarray(wi), jnp.asarray(eta))):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    np.testing.assert_array_equal(tmm.reflect_local(torch.as_tensor(wi)).numpy(),
                                  np.asarray(jmm.reflect_local(jnp.asarray(wi))))
    for fn in ("sin_theta", "tan_theta", "tan_theta2", "sin_phi_cos_phi"):
        out, ref = getattr(tmm, fn)(torch.as_tensor(wi)), getattr(jmm, fn)(jnp.asarray(wi))
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol, err_msg=fn)
    e = np.linspace(0.5, 2.5, 41).astype(np.float32)
    np.testing.assert_allclose(tmm.fresnel_diffuse_reflectance(torch.as_tensor(e)).numpy(),
                               np.asarray(jmm.fresnel_diffuse_reflectance(jnp.asarray(e))), **tol)


@pytest.mark.parametrize("name", ["Cu", "Au", "Ag", "Al", "none", "TiO2-e_palik"])
def test_conductor_ior_equal(name):
    for a, b in zip(tior.lookup_conductor(name), jior.lookup_conductor(name)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_dielectric_ior_equal():
    for name in list(jior.DIELECTRIC_IOR) + [1.7, "1.25"]:
        assert tior.lookup_dielectric(name) == jior.lookup_dielectric(name)
    with pytest.raises(KeyError):
        tior.lookup_conductor("unobtainium")


def test_port_reads_its_own_conductor_table():
    """The port's table lies in the port and is a byte copy of the JAX
    package's."""
    import os

    port = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "mitsuba_tpu_torch", "data", "conductor_ior_rgb.npz")
    assert os.path.normpath(tior.CONDUCTOR_TABLE) == os.path.normpath(port)
    ref = os.path.join(os.path.dirname(jior.__file__), "..", "data", "conductor_ior_rgb.npz")
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("dist,alpha,eta", [(0, 0.12, 1.49), (1, 0.25, 1.49),
                                            (0, 0.25, 1 / 1.49), (2, 0.3, 1.5046)])
def test_rtrans_fit_bit_equal(dist, alpha, eta):
    for a, b in zip(trt.fit_rtrans_poly(dist, alpha, eta), jrt.fit_rtrans_poly(dist, alpha, eta)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _sp(seed, typ):
    """Per-lane parameters of one material type, as shading_params gives
    them (one rtrans fit for every lane)."""
    r = np.random.default_rng(seed)
    c, _ = jrt.fit_rtrans_poly(0, 0.12, 1.49)
    return {
        "type": np.full(N, typ, np.int32),
        "cA": r.uniform(0, 1, (N, 3)).astype(np.float32),
        "cB": r.uniform(0.2, 1, (N, 3)).astype(np.float32),
        "cC": r.uniform(0.2, 3, (N, 3)).astype(np.float32),
        "cD": r.uniform(0, 5, (N, 3)).astype(np.float32),
        "alpha_u": r.uniform(0.02, 0.6, N).astype(np.float32),
        "alpha_v": r.uniform(0.02, 0.6, N).astype(np.float32),
        "eta": r.choice([1.49, 1.5046, 0.7, 1.33], N).astype(np.float32),
        "exponent": np.full(N, 30.0, np.float32),
        "dist": r.integers(0, 3, N).astype(np.int32),
        "nonlinear": r.choice([0.0, 1.0], N).astype(np.float32),
        "twosided": r.choice([0.0, 1.0], N).astype(np.float32),
        "fdr_int": r.uniform(0.3, 0.7, N).astype(np.float32),
        "spec_w": r.uniform(0.2, 0.8, N).astype(np.float32),
        "rt": np.tile(c, (N, 1)),
        "rt_fdr": r.uniform(0.3, 0.7, N).astype(np.float32),
    }


def _sp_pair(typ):
    sp = _sp(typ, typ)
    jsp = {k: jnp.asarray(v) for k, v in sp.items()}
    tsp = {k: torch.as_tensor(v) for k, v in sp.items()}
    jsp["mf_dists"] = tsp["mf_dists"] = (0, 1, 2)
    return jsp, tsp


@pytest.mark.parametrize("typ", PRESENT)
@pytest.mark.parametrize("fn", ["bsdf_eval", "bsdf_pdf"])
def test_bsdf_eval_pdf(typ, fn):
    jsp, tsp = _sp_pair(typ)
    wi, wo = _dirs(2), _dirs(3)
    ref = np.asarray(getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), PRESENT))
    out = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), PRESENT).numpy()
    np.testing.assert_allclose(out, ref, rtol=5e-4, atol=1e-6)
    if typ in (DIFFUSE, ROUGHCONDUCTOR, PLASTIC, ROUGHPLASTIC, ROUGHDIELECTRIC):
        assert (ref > 0).any()  # the lobe is live on these inputs


def _close_most(out, ref, name):
    rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-6)
    assert np.quantile(rel, 0.999) < 1e-3, (name, np.quantile(rel, 0.999))
    assert rel.max() < 5e-2, (name, rel.max())


@pytest.mark.parametrize("typ", PRESENT)
def test_bsdf_sample(typ):
    jsp, tsp = _sp_pair(typ)
    wi = _dirs(4)
    u = np.random.default_rng(5).uniform(0, 1, (N, 3)).astype(np.float32)
    ref = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), jnp.asarray(u[:, :2]), jnp.asarray(u[:, 2]),
                            PRESENT)
    out = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), torch.as_tensor(u[:, :2]),
                            torch.as_tensor(u[:, 2]), PRESENT)
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))
    np.testing.assert_array_equal(out.eta.numpy(), np.asarray(ref.eta))
    if typ in SAMPLED_NORMAL:
        np.testing.assert_allclose(out.wo.numpy(), np.asarray(ref.wo), rtol=0, atol=2e-4)
        _close_most(out.weight.numpy(), np.asarray(ref.weight), "weight")
        _close_most(out.pdf.numpy(), np.asarray(ref.pdf), "pdf")
    else:
        for k in ("wo", "weight", "pdf"):
            np.testing.assert_allclose(getattr(out, k).numpy(), np.asarray(getattr(ref, k)),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    assert np.isfinite(out.weight.numpy()).all() and (out.weight.numpy() > 0).any()
    if typ in (CONDUCTOR, DIELECTRIC):
        assert out.delta.all()
    if typ in (DIELECTRIC, ROUGHDIELECTRIC):
        assert (out.eta.numpy() != 1.0).any()  # refractions change eta


def test_bsdf_unported_types_raise():
    """A type number the functions do not evaluate is refused: 13, the
    mixture's, which no row holds (a mixture's row holds its first leaf's
    type; irawan, 17, is evaluated since the texture slice); and the
    loader refuses a plugin it does not hold, by name."""
    _, tsp = _sp_pair(DIFFUSE)
    for present in ((0, 13), (13,)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tbsdf.bsdf_sample(tsp, torch.zeros(N, 3), torch.zeros(N, 2), torch.zeros(N), present)
    assert 17 in tbsdf.PORTED
    with pytest.raises(NotImplementedError, match="bsdf 'velvet' not yet ported"):
        load_scene_string("""<scene version="0.5.0"><sensor type="perspective"/>
            <shape type="rectangle"><bsdf type="velvet"><bsdf type="diffuse"/></bsdf></shape>
            </scene>""")


BSDF_XML = """
<scene version="0.5.0">
  <sensor type="perspective"/>
  <shape type="rectangle"><bsdf type="conductor"><string name="material" value="Au"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="conductor"><spectrum name="eta" value="0.2, 0.9, 1.1"/>
    <spectrum name="k" value="3.9, 2.4, 2.2"/><float name="extEta" value="1.33"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="roughconductor"><string name="material" value="none"/>
    <float name="alphaU" value="0.05"/><float name="alphaV" value="0.3"/>
    <string name="distribution" value="ggx"/><rgb name="specularReflectance" value="0.9, 0.8, 0.7"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="dielectric"><string name="intIOR" value="water"/>
    <float name="extIOR" value="1.0"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="roughdielectric"><float name="alpha" value="0.2"/>
    <string name="distribution" value="phong"/><rgb name="specularTransmittance" value="0.9"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="plastic"><rgb name="diffuseReflectance" value="0.1, 0.5, 0.2"/>
    <boolean name="nonlinear" value="true"/></bsdf></shape>
  <shape type="rectangle"><bsdf type="roughplastic"><float name="alpha" value="0.3"/>
    <float name="intIOR" value="1.6"/>
    <texture name="diffuseReflectance" type="checkerboard"><float name="uscale" value="4"/>
      <float name="uoffset" value="-0.3"/></texture></bsdf></shape>
  <shape type="rectangle"><bsdf type="diffuse">
    <texture name="reflectance" type="checkerboard"><rgb name="color0" value="0.9, 0.1, 0.1"/>
      <float name="vscale" value="3"/></texture></bsdf></shape>
</scene>
"""

MATERIAL_ARRAYS = ("mat_type", "mat_cA", "mat_cB", "mat_cC", "mat_cD", "mat_alpha_u",
                   "mat_alpha_v", "mat_eta", "mat_exponent", "mat_dist", "mat_nonlinear",
                   "mat_twosided", "mat_fdr_int", "mat_spec_w", "mat_texA", "mat_rt",
                   "mat_rt_fdr", "tex_type", "tex_c0", "tex_c1", "tex_scale", "tex_uv")


@pytest.fixture(scope="module")
def material_packs():
    return jpack_scene(jload_string(BSDF_XML)), pack_scene(load_scene_string(BSDF_XML), "cpu")


def test_plugin_records_pack_equal(material_packs):
    """Every registered BSDF type, textured reflectances included, packs
    into the reference's material and texture tables."""
    jp, tp = material_packs
    for k in MATERIAL_ARRAYS:
        ref = np.asarray(jp.arrays[k])
        out = tp.arrays[k].numpy()
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)
    for k in ("present_types", "mf_dists", "has_textures"):
        assert tp.meta[k] == jp.meta[k], k


def test_checkerboard_eval_texture(material_packs):
    """Both checkerboards (and no texture, -1) at uv over several tiles,
    negative ones included: floor-mod parity as the reference's int32 %."""
    jp, tp = material_packs
    r = np.random.default_rng(6)
    uv = r.uniform(-3, 3, (N, 2)).astype(np.float32)
    uv[:6] = [[0, 0], [0.25, 0], [-0.25, 0], [-0.25, -0.25], [0.5, 0.5], [-1e-8, 0]]
    tid = r.integers(-1, 2, N).astype(np.int32)
    default = r.uniform(0, 1, (N, 3)).astype(np.float32)
    ref = np.asarray(jtex.eval_texture(jp, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(default)))
    out = ttex.eval_texture(tp, torch.as_tensor(tid), torch.as_tensor(uv),
                            torch.as_tensor(default)).numpy()
    np.testing.assert_array_equal(out, ref)
    c0, c1 = tp.tex_c0[0].numpy(), tp.tex_c1[0].numpy()
    lanes = (tid == 0) & (np.abs(uv[:, 0] * 4 - 0.3) < 50)
    assert ((out[lanes] == c0).all(-1) | (out[lanes] == c1).all(-1)).all()
    assert (out[lanes] == c0).all(-1).any() and (out[lanes] == c1).all(-1).any()


def test_shading_params_match_reference(material_packs):
    jp, tp = material_packs
    r = np.random.default_rng(7)
    mat = r.integers(-1, 8, N).astype(np.int32)
    uv = r.uniform(-2, 2, (N, 2)).astype(np.float32)
    jsp = jtex.shading_params(jp, jnp.asarray(mat), jnp.asarray(uv))
    tsp = ttex.shading_params(tp, torch.as_tensor(mat), torch.as_tensor(uv))
    # the port gathers what the scene's types read: every key of the
    # reference but Phong's exponent, which no type of this scene reads
    assert set(tsp) == set(jsp) - {"exponent"}
    assert tsp["mf_dists"] == jsp["mf_dists"] == (0, 1, 2)
    for k, v in tsp.items():
        if k != "mf_dists":
            np.testing.assert_array_equal(v.numpy(), np.asarray(jsp[k]), err_msg=k)


@pytest.mark.parametrize("typ", PRESENT)
def test_shading_params_carry_what_each_type_reads(material_packs, typ):
    """A scene of one material type gathers only the parameters that type
    reads (with type and twosided), and its eval, pdf and sample run on
    them alone and match the reference's on every parameter."""
    from mitsuba_tpu_torch.scene.builder import pack_from_numpy

    jp, tp = material_packs
    meta = {**tp.meta, "present_types": (typ,)}
    one = pack_from_numpy({k: v.numpy() for k, v in tp.arrays.items()}, meta, "cpu")
    mat = np.random.default_rng(8).integers(0, 8, N).astype(np.int32)
    jsp = jtex.shading_params(jp, jnp.asarray(mat), jnp.zeros((N, 2)))
    tsp = ttex.shading_params(one, torch.as_tensor(mat), torch.zeros(N, 2))
    # the scene is textured: cA is gathered as the texture's default
    assert set(tsp) == {"type", "twosided", "mf_dists", "cA", *ttex.TYPE_KEYS[typ]}
    wi, wo = _dirs(10), _dirs(11)
    u = np.random.default_rng(12).uniform(0, 1, (N, 3)).astype(np.float32)
    for fn in ("bsdf_eval", "bsdf_pdf"):
        ref = np.asarray(getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), (typ,)))
        out = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), (typ,))
        np.testing.assert_allclose(out.numpy(), ref, rtol=5e-4, atol=1e-6, err_msg=fn)
    ref = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), jnp.asarray(u[:, :2]), jnp.asarray(u[:, 2]),
                            (typ,))
    out = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), torch.as_tensor(u[:, :2]),
                            torch.as_tensor(u[:, 2]), (typ,))
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))
    np.testing.assert_array_equal(out.eta.numpy(), np.asarray(ref.eta))
    np.testing.assert_allclose(out.wo.numpy(), np.asarray(ref.wo), rtol=0, atol=2e-4)
