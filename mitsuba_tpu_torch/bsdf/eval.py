"""BSDF sample / eval / pdf over lanes (port of mitsuba_tpu/bsdf/eval.py
for the types `diffuse`, `conductor`, `roughconductor`, `dielectric`,
`roughdielectric`, `plastic`, `roughplastic` and `null`).

Every type present in the scene is evaluated on all lanes and selected
by the lane's type, as in the reference.  Conventions as there: `wi`,
`wo` in the local shading frame (+z = shading normal), both pointing
away from the surface; `bsdf_eval` returns f(wi, wo) * |cos theta_o|
(0 for Dirac lobes); `bsdf_sample` returns the weight f * |cos| / pdf
with the lobe-selection probability folded in.  `present` is the static
tuple of material types in the scene; other types, mixtures and coatings
raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.bsdf import microfacet as mf
from mitsuba_tpu_torch.bsdf.plugins import (
    CONDUCTOR,
    DIELECTRIC,
    DIFFUSE,
    NULL_BSDF,
    PLASTIC,
    ROUGHCONDUCTOR,
    ROUGHDIELECTRIC,
    ROUGHPLASTIC,
)
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import warp

INV_PI = 1.0 / math.pi
# the material types evaluated here
PORTED = frozenset((DIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, DIELECTRIC, ROUGHDIELECTRIC, PLASTIC,
                    ROUGHPLASTIC, NULL_BSDF))
# the ported types whose every lobe is a Dirac delta
DELTA_TYPES = (CONDUCTOR, DIELECTRIC, NULL_BSDF)


class BSDFSample(NamedTuple):
    wo: torch.Tensor  # [..., 3] local frame
    weight: torch.Tensor  # [..., 3] f*cos/pdf
    pdf: torch.Tensor  # [...] solid-angle pdf (the lobe probability for Dirac lobes)
    delta: torch.Tensor  # [...] bool, sampled a Dirac lobe
    eta: torch.Tensor  # [...] relative IOR change (1 if none)


def _check(sp, present):
    if "mix" in sp:
        raise NotImplementedError("mixture/coating BSDFs not yet ported")
    other = sorted(set(present) - PORTED)
    if other:
        raise NotImplementedError(f"bsdf types {other} not yet ported")


def _mask3(mask, rgb):
    return torch.where(mask[..., None], rgb, 0.0)


# ---------------------------------------------------------------------------
# per-type eval (f * cos_o) and pdf
# ---------------------------------------------------------------------------

def _diffuse_eval(sp, wi, wo):
    mask = (mm.cos_theta(wi) > 0) & (mm.cos_theta(wo) > 0)
    return _mask3(
        mask, sp["cA"] * (INV_PI * torch.clamp(mm.cos_theta(wo), min=0.0))[..., None]
    )


def _diffuse_pdf(sp, wi, wo):
    mask = (mm.cos_theta(wi) > 0) & (mm.cos_theta(wo) > 0)
    return torch.where(mask, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _roughconductor_eval(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    h = mm.normalize(wi + wo)
    d = mf.microfacet_D(sp["dist"], sp["alpha_u"], sp["alpha_v"], h)
    g = mf.smith_g(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, wo, h)
    f = mm.fresnel_conductor(mm.dot(wi, h), sp["cC"], sp["cD"])
    val = (d * g / torch.clamp(4.0 * ci, min=1e-8))[..., None] * f * sp["cB"]
    return _mask3(mask & (d > 0), val)


def _roughconductor_pdf(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    h = mm.normalize(wi + wo)
    pm = mf.pdf_m(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, h)
    jac = 1.0 / torch.clamp(4.0 * torch.abs(mm.dot(wo, h)), min=1e-8)
    return torch.where(mask, pm * jac, 0.0)


def _plastic_probs(sp, cos_i):
    fi, _, _ = mm.fresnel_dielectric(cos_i, sp["eta"])
    sw = sp["spec_w"]
    prob = (fi * sw) / torch.clamp(fi * sw + (1.0 - fi) * (1.0 - sw), min=1e-8)
    return fi, prob


def _plastic_diffuse_factor(sp, fi, fo):
    """Internal scattering correction (plastic.cpp eval)."""
    diff = sp["cA"]
    fdr = sp["fdr_int"][..., None]
    denom = torch.where(sp["nonlinear"][..., None] > 0.5, 1.0 - diff * fdr, 1.0 - fdr)
    inv_eta2 = 1.0 / (sp["eta"] * sp["eta"])
    return diff / torch.clamp(denom, min=1e-4) * ((1.0 - fi) * (1.0 - fo) * inv_eta2)[..., None]


def _plastic_eval(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    fi, _, _ = mm.fresnel_dielectric(ci, sp["eta"])
    fo, _, _ = mm.fresnel_dielectric(co, sp["eta"])
    val = _plastic_diffuse_factor(sp, fi, fo) * (INV_PI * torch.clamp(co, min=0.0))[..., None]
    return _mask3(mask, val)


def _plastic_pdf(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    _, prob = _plastic_probs(sp, ci)
    return torch.where(mask, (1.0 - prob) * warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _rt_eval(sp, cos_i):
    """Rough transmittance: the cubic in cos_i fitted at pack time
    (bsdf/rtrans.py; reference rtrans.h:44-186)."""
    c = sp["rt"]
    x = torch.clamp(cos_i, 0.0, 1.0)
    t = ((c[..., 0] * x + c[..., 1]) * x + c[..., 2]) * x + c[..., 3]
    return torch.clamp(t, 0.0, 1.0)


def _roughplastic_probs(sp, cos_i):
    """Lobe-selection probability from the rough specular reflectance
    1 - T12 (roughplastic.cpp sample, probSpecular)."""
    si = 1.0 - _rt_eval(sp, cos_i)
    sw = sp["spec_w"]
    prob = (si * sw) / torch.clamp(si * sw + (1.0 - si) * (1.0 - sw), min=1e-8)
    return si, prob


def _roughplastic_eval(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    h = mm.normalize(wi + wo)
    d = mf.microfacet_D(sp["dist"], sp["alpha_u"], sp["alpha_v"], h)
    g = mf.smith_g(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, wo, h)
    fh, _, _ = mm.fresnel_dielectric(mm.dot(wi, h), sp["eta"])
    spec = sp["cB"] * (fh * d * g / torch.clamp(4.0 * ci, min=1e-8))[..., None]
    # diffuse through the rough interface: the T12 T21 rough
    # transmittances and the internal diffuse reflectance of the fits
    t12 = _rt_eval(sp, ci)
    t21 = _rt_eval(sp, co)
    diffc = sp["cA"]
    fdr = sp["rt_fdr"][..., None]
    denom = torch.where(sp["nonlinear"][..., None] > 0.5, 1.0 - diffc * fdr, 1.0 - fdr)
    inv_eta2 = 1.0 / (sp["eta"] * sp["eta"])
    diff = diffc / torch.clamp(denom, min=1e-4) * (
        INV_PI * torch.clamp(co, min=0.0) * t12 * t21 * inv_eta2
    )[..., None]
    return _mask3(mask, spec + diff)


def _roughplastic_pdf(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    h = mm.normalize(wi + wo)
    _, prob = _roughplastic_probs(sp, ci)
    pm = mf.pdf_m(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, h)
    spec_pdf = pm / torch.clamp(4.0 * torch.abs(mm.dot(wo, h)), min=1e-8)
    diff_pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(mask, prob * spec_pdf + (1.0 - prob) * diff_pdf, 0.0)


def _roughdielectric_half(sp, wi, wo):
    """(reflect, eta, h): the half vector of a reflection or of a
    refraction (Walter et al. 2007), +z oriented."""
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    reflect = ci * co > 0
    eta = torch.where(ci > 0, sp["eta"], 1.0 / sp["eta"])
    h_r = mm.normalize(wi + wo) * mm.sign(ci)[..., None]
    h_t = -mm.normalize(wi + wo * eta[..., None])
    h_t = h_t * mm.sign(mm.cos_theta(h_t))[..., None]
    return reflect, eta, torch.where(reflect[..., None], h_r, h_t)


def _roughdielectric_eval(sp, wi, wo):
    """Walter et al. 2007 rough dielectric, radiance transport
    (roughdielectric.cpp eval)."""
    ci = mm.cos_theta(wi)
    reflect, eta, h = _roughdielectric_half(sp, wi, wo)
    d = mf.microfacet_D(sp["dist"], sp["alpha_u"], sp["alpha_v"], h)
    g = mf.smith_g(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, wo, h)
    f, _, _ = mm.fresnel_dielectric(mm.dot(wi, h), sp["eta"])
    val_r = f * d * g / torch.clamp(4.0 * torch.abs(ci), min=1e-8)
    # Walter's eq. 21 carries eta^2 and radiance transport 1/eta^2: they
    # cancel
    wih = mm.dot(wi, h)
    woh = mm.dot(wo, h)
    sqrt_denom = wih + eta * woh
    val_t = (
        torch.abs(wih * woh) * (1.0 - f) * d * g
        / torch.clamp(torch.abs(ci) * sqrt_denom * sqrt_denom, min=1e-8)
    )
    rgb = torch.where(
        reflect[..., None], sp["cB"] * val_r[..., None], sp["cC"] * val_t[..., None]
    )
    return _mask3(d > 0, rgb)


def _roughdielectric_pdf(sp, wi, wo):
    reflect, eta, h = _roughdielectric_half(sp, wi, wo)
    pm = mf.pdf_m(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, h)
    f, _, _ = mm.fresnel_dielectric(mm.dot(wi, h), sp["eta"])
    wih, woh = mm.dot(wi, h), mm.dot(wo, h)
    # a reflection needs wi, wo on one side of h, a refraction on both
    # sides; otherwise no microfacet maps wi to wo
    valid = torch.where(reflect, wih * woh > 0, wih * woh < 0)
    jac_r = 1.0 / torch.clamp(4.0 * torch.abs(woh), min=1e-8)
    sqrt_denom = wih + eta * woh
    jac_t = eta * eta * torch.abs(woh) / torch.clamp(sqrt_denom * sqrt_denom, min=1e-8)
    pdf = torch.where(reflect, pm * f * jac_r, pm * (1.0 - f) * jac_t)
    return torch.where(valid, pdf, 0.0)


_EVAL_FNS = {
    DIFFUSE: _diffuse_eval,
    ROUGHCONDUCTOR: _roughconductor_eval,
    ROUGHDIELECTRIC: _roughdielectric_eval,
    PLASTIC: _plastic_eval,
    ROUGHPLASTIC: _roughplastic_eval,
}

_PDF_FNS = {
    DIFFUSE: _diffuse_pdf,
    ROUGHCONDUCTOR: _roughconductor_pdf,
    ROUGHDIELECTRIC: _roughdielectric_pdf,
    PLASTIC: _plastic_pdf,
    ROUGHPLASTIC: _roughplastic_pdf,
}


def _flip_twosided(sp, wi, *rest):
    """Two-sided materials: mirror the frame when hit from the back
    (reference src/bsdfs/twosided.cpp)."""
    flip = (sp["twosided"] > 0.5) & (mm.cos_theta(wi) < 0)
    fz = torch.where(flip, -1.0, 1.0)[..., None]
    flip_vec = torch.cat([torch.ones_like(fz), torch.ones_like(fz), fz], dim=-1)
    return flip_vec, [wi * flip_vec] + [w * flip_vec for w in rest]


def bsdf_eval(sp, wi, wo, present):
    """f(wi, wo) * |cos_o| for the per-lane material (smooth lobes only:
    Dirac lobes give 0)."""
    _check(sp, present)
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    out = 0.0
    for t in present:
        fn = _EVAL_FNS.get(t)
        if fn is not None:
            out = torch.where((sp["type"] == t)[..., None], fn(sp, wi, wo), out)
    return out if torch.is_tensor(out) else torch.zeros(wi.shape, device=wi.device)


def bsdf_pdf(sp, wi, wo, present):
    """Solid-angle density of bsdf_sample producing wo (0 for Dirac
    lobes)."""
    _check(sp, present)
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    out = 0.0
    for t in present:
        fn = _PDF_FNS.get(t)
        if fn is not None:
            out = torch.where(sp["type"] == t, fn(sp, wi, wo), out)
    return out if torch.is_tensor(out) else torch.zeros(wi.shape[:-1], device=wi.device)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _weight(f, pdf, ok):
    return torch.where(ok[..., None], f / torch.clamp(pdf, min=1e-10)[..., None], 0.0)


def bsdf_sample(sp, wi, u2, ulobe, present):
    """Sample an outgoing direction for every lane; lanes whose sample
    failed get weight 0."""
    _check(sp, present)
    flip_vec, (wi,) = _flip_twosided(sp, wi)
    # a lane of no arm keeps these: direction and weight 0, pdf 0, no
    # Dirac lobe, eta 1 (the first arm's selects fill them in)
    wo, weight, pdf, delta, eta_s = 0.0, 0.0, 0.0, False, 1.0

    def put(mask, wo_t, w_t, pdf_t, delta_t, eta_t):
        nonlocal wo, weight, pdf, delta, eta_s
        wo = torch.where(mask[..., None], wo_t, wo)
        weight = torch.where(mask[..., None], w_t, weight)
        pdf = torch.where(mask, pdf_t, pdf)
        delta = torch.where(mask, delta_t, delta)
        eta_s = torch.where(mask, eta_t, eta_s)

    ci = mm.cos_theta(wi)
    m_cache = []

    def sampled_m():
        """The microfacet normal of every lane, drawn once: the rough
        types sample it from the same per-lane parameters and numbers
        (XLA's common-subexpression pass merges the reference's draws)."""
        if not m_cache:
            m_cache.append(mf.sample_m(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, u2,
                                       sp.get("mf_dists")))
        return m_cache[0]

    def microfacet_reflect():
        m = sampled_m()
        return 2.0 * mm.dot(wi, m, keepdim=True) * m - wi

    for t in present:
        tm = sp["type"] == t
        if t == DIFFUSE:
            wo_t = warp.square_to_cosine_hemisphere(u2)
            put(tm, wo_t, _mask3(ci > 0, sp["cA"]),
                warp.square_to_cosine_hemisphere_pdf(wo_t), False, 1.0)
        elif t == CONDUCTOR:
            f = mm.fresnel_conductor(ci, sp["cC"], sp["cD"])
            w_t = _mask3(ci > 0, sp["cB"] * f)
            put(tm, mm.reflect_local(wi), _mask3(tm, w_t), 1.0, True, 1.0)
        elif t == ROUGHCONDUCTOR:
            wo_t = microfacet_reflect()
            pdf_t = _roughconductor_pdf(sp, wi, wo_t)
            f = _roughconductor_eval(sp, wi, wo_t)
            ok = (pdf_t > 1e-10) & (mm.cos_theta(wo_t) > 0) & (ci > 0)
            put(tm, wo_t, _weight(f, pdf_t, ok), pdf_t, False, 1.0)
        elif t == DIELECTRIC:
            F, _, eta_rel = mm.fresnel_dielectric(ci, sp["eta"])
            refl = ulobe <= F
            wo_refr, _, _ = mm.refract_local(wi, sp["eta"])
            wo_t = torch.where(refl[..., None], mm.reflect_local(wi), wo_refr)
            inv_eta2 = 1.0 / (eta_rel * eta_rel)
            w_t = torch.where(refl[..., None], sp["cB"], sp["cC"] * inv_eta2[..., None])
            put(tm, wo_t, w_t, torch.where(refl, F, 1.0 - F), True,
                torch.where(refl, 1.0, eta_rel))
        elif t == ROUGHDIELECTRIC:
            # m keeps +z (the outside), so the signed dot(wi, m) tells
            # entering from exiting, as cos_theta does for the smooth case
            m = sampled_m()
            wih = mm.dot(wi, m)
            F, _, eta_rel = mm.fresnel_dielectric(wih, sp["eta"])
            refl = ulobe <= F
            wo_refl = 2.0 * wih[..., None] * m - wi
            # refraction about m: wo = -wi/eta + (|c|/eta - cos_t) m_s
            inv_eta = 1.0 / eta_rel
            c = torch.abs(wih)
            ct_t = mm.safe_sqrt(1.0 - (1.0 - c * c) * inv_eta * inv_eta)
            m_signed = m * mm.sign(wih)[..., None]
            wo_refr = -wi * inv_eta[..., None] + (inv_eta * c - ct_t)[..., None] * m_signed
            wo_t = mm.normalize(torch.where(refl[..., None], wo_refl, wo_refr))
            pdf_t = _roughdielectric_pdf(sp, wi, wo_t)
            f = _roughdielectric_eval(sp, wi, wo_t)
            co = mm.cos_theta(wo_t)
            side_ok = torch.where(refl, co * ci > 0, co * ci < 0)
            put(tm, wo_t, _weight(f, pdf_t, (pdf_t > 1e-10) & side_ok), pdf_t, False,
                torch.where(refl, 1.0, eta_rel))
        elif t == PLASTIC:
            fi, prob = _plastic_probs(sp, ci)
            spec_sel = ulobe <= prob
            wo_t = torch.where(spec_sel[..., None], mm.reflect_local(wi),
                               warp.square_to_cosine_hemisphere(u2))
            # the diffuse branch's weight: f cos / pdf with the combined pdf
            pdf_diff = (1.0 - prob) * warp.square_to_cosine_hemisphere_pdf(wo_t)
            w_diff = _plastic_eval(sp, wi, wo_t) / torch.clamp(pdf_diff, min=1e-8)[..., None]
            w_spec = sp["cB"] * (fi / torch.clamp(prob, min=1e-8))[..., None]
            w_t = torch.where(spec_sel[..., None], w_spec, w_diff)
            put(tm, wo_t, _mask3(ci > 0, w_t), torch.where(spec_sel, prob, pdf_diff),
                spec_sel, 1.0)
        elif t == ROUGHPLASTIC:
            _, prob = _roughplastic_probs(sp, ci)
            spec_sel = ulobe <= prob
            wo_t = torch.where(spec_sel[..., None], microfacet_reflect(),
                               warp.square_to_cosine_hemisphere(u2))
            pdf_t = _roughplastic_pdf(sp, wi, wo_t)
            f = _roughplastic_eval(sp, wi, wo_t)
            ok = (pdf_t > 1e-10) & (mm.cos_theta(wo_t) > 0) & (ci > 0)
            put(tm, wo_t, _weight(f, pdf_t, ok), pdf_t, False, 1.0)
        elif t == NULL_BSDF:
            # straight through: eval and pdf are 0, the sample has weight 1
            put(tm, -wi, torch.ones_like(wi), 1.0, True, 1.0)

    # un-flip wo for two-sided lanes
    return BSDFSample(wo * flip_vec, weight, pdf, delta, eta_s)
