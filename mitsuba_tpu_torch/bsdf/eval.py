"""BSDF sample / eval / pdf over lanes (port of mitsuba_tpu/bsdf/eval.py:
every material type of the reference).

Every type present in the scene is evaluated on all lanes and selected
by the lane's type, as in the reference.  Conventions as there: `wi`,
`wo` in the local shading frame (+z = shading normal), both pointing
away from the surface; `bsdf_eval` returns f(wi, wo) * |cos theta_o|
(0 for Dirac lobes); `bsdf_sample` returns the weight f * |cos| / pdf
with the lobe-selection probability folded in.  `present` is the static
tuple of material types in the scene.  `irawan` lanes read their yarn
parameters from sp["iw"] (scene/texture_eval.py shading_params,
bsdf/irawan.py).

Mixtures and layers: a lane whose row heads a mixture chain or a coating
carries its next component's parameters in sp["mix"] ({"spB", "wa",
"wb"}, scene/texture_eval.py shading_params).  Mixtures blend the
components' eval and pdf and sample one component by weight, absorbing
the deficit of weights that sum below one (reference mixturebsdf.cpp);
`coating` and `roughcoating` rows evaluate the layered models over their
spB child.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.bsdf import irawan as iw
from mitsuba_tpu_torch.bsdf import microfacet as mf
from mitsuba_tpu_torch.bsdf.plugins import (
    COATING,
    CONDUCTOR,
    DIELECTRIC,
    DIFFTRANS,
    DIFFUSE,
    HK,
    IRAWAN,
    NULL_BSDF,
    PHONG_BSDF,
    PLASTIC,
    ROUGHCOATING,
    ROUGHCONDUCTOR,
    ROUGHDIELECTRIC,
    ROUGHDIFFUSE,
    ROUGHPLASTIC,
    THINDIELECTRIC,
    WARD,
)
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import warp

INV_PI = 1.0 / math.pi
# the material types evaluated here
PORTED = frozenset((DIFFUSE, ROUGHDIFFUSE, CONDUCTOR, ROUGHCONDUCTOR, DIELECTRIC, THINDIELECTRIC,
                    ROUGHDIELECTRIC, PLASTIC, ROUGHPLASTIC, PHONG_BSDF, WARD, DIFFTRANS,
                    NULL_BSDF, COATING, HK, ROUGHCOATING, IRAWAN))
# the types whose every lobe is a Dirac delta
DELTA_TYPES = (CONDUCTOR, DIELECTRIC, THINDIELECTRIC, NULL_BSDF)


class BSDFSample(NamedTuple):
    wo: torch.Tensor  # [..., 3] local frame
    weight: torch.Tensor  # [..., 3] f*cos/pdf
    pdf: torch.Tensor  # [...] solid-angle pdf (the lobe probability for Dirac lobes)
    delta: torch.Tensor  # [...] bool, sampled a Dirac lobe
    eta: torch.Tensor  # [...] relative IOR change (1 if none)


def _check(present):
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


def _roughdiffuse_eval(sp, wi, wo):
    """Oren-Nayar (the fast approximation), sigma = alpha / sqrt(2)
    (roughdiffuse.cpp:128-175)."""
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    sigma = sp["alpha_u"] * (1.0 / math.sqrt(2.0))
    s2 = sigma * sigma
    si, so = mm.sin_theta(wi), mm.sin_theta(wo)
    spi, cpi = mm.sin_phi_cos_phi(wi)
    spo, cpo = mm.sin_phi_cos_phi(wo)
    cos_phi_diff = torch.where((si > 1e-4) & (so > 1e-4), cpi * cpo + spi * spo, 0.0)
    a = 1.0 - 0.5 * s2 / (s2 + 0.33)
    b = 0.45 * s2 / (s2 + 0.09)
    sin_alpha = torch.where(ci > co, so, si)
    tan_beta = torch.where(ci > co, si / torch.clamp(ci, min=1e-6), so / torch.clamp(co, min=1e-6))
    val = INV_PI * torch.clamp(co, min=0.0) * (
        a + b * torch.clamp(cos_phi_diff, min=0.0) * sin_alpha * tan_beta)
    return _mask3(mask, sp["cA"] * val[..., None])


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


def _phong_eval(sp, wi, wo):
    """The modified Phong model (phong.cpp eval)."""
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    cos_a = torch.clamp(mm.dot(mm.reflect_local(wi), wo), min=0.0)
    e = sp["exponent"]
    spec = sp["cB"] * ((e + 2.0) * (0.5 * INV_PI) * torch.pow(cos_a, e) * co)[..., None]
    diff = sp["cA"] * (INV_PI * co)[..., None]
    return _mask3(mask, spec + diff)


def _phong_pdf(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    cos_a = torch.clamp(mm.dot(mm.reflect_local(wi), wo), min=0.0)
    e = sp["exponent"]
    spec_pdf = (e + 1.0) * (0.5 * INV_PI) * torch.pow(cos_a, e)
    sw = sp["spec_w"]
    return torch.where(
        mask, sw * spec_pdf + (1.0 - sw) * warp.square_to_cosine_hemisphere_pdf(wo), 0.0
    )


def _ward_eval(sp, wi, wo):
    """The balanced Ward-Duer variant (ward.cpp)."""
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    h = wi + wo
    au, av = mf.clamp_alpha(sp["alpha_u"]), mf.clamp_alpha(sp["alpha_v"])
    hz2 = torch.clamp(h[..., 2] * h[..., 2], min=1e-12)
    exp_arg = -((h[..., 0] / au) ** 2 + (h[..., 1] / av) ** 2) / hz2
    spec_val = torch.exp(exp_arg) / (
        4.0 * math.pi * au * av * torch.sqrt(torch.clamp(ci * co, min=1e-8))
    )
    spec = sp["cB"] * (spec_val * co)[..., None]
    diff = sp["cA"] * (INV_PI * co)[..., None]
    return _mask3(mask, spec + diff)


def _ward_pdf(sp, wi, wo):
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    mask = (ci > 0) & (co > 0)
    h = mm.normalize(wi + wo)
    au, av = mf.clamp_alpha(sp["alpha_u"]), mf.clamp_alpha(sp["alpha_v"])
    ct = torch.clamp(mm.cos_theta(h), min=1e-6)
    t2 = mm.tan_theta2(h)
    sphi, cphi = mm.sin_phi_cos_phi(h)
    exp_arg = -t2 * ((cphi / au) ** 2 + (sphi / av) ** 2)
    ph = torch.exp(exp_arg) / (math.pi * au * av * ct * ct * ct)
    spec_pdf = ph / torch.clamp(4.0 * torch.abs(mm.dot(wo, h)), min=1e-8)
    sw = sp["spec_w"]
    return torch.where(
        mask, sw * spec_pdf + (1.0 - sw) * warp.square_to_cosine_hemisphere_pdf(wo), 0.0
    )


def _difftrans_eval(sp, wi, wo):
    mask = mm.cos_theta(wi) * mm.cos_theta(wo) < 0
    return _mask3(mask, sp["cA"] * (INV_PI * torch.abs(mm.cos_theta(wo)))[..., None])


def _difftrans_pdf(sp, wi, wo):
    mask = mm.cos_theta(wi) * mm.cos_theta(wo) < 0
    return torch.where(mask, torch.abs(mm.cos_theta(wo)) * INV_PI, 0.0)


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


# ---------------------------------------------------------------------------
# Hanrahan-Krueger thin slab (hk.cpp): cB = sigmaS, cC = sigmaA,
# alpha_u = the HG g, alpha_v = the slab's thickness
# ---------------------------------------------------------------------------

def _hk_phase(g, wi, wo):
    """HG phase in the slab's convention: forward scattering has
    dot(wi, wo) = -1 (both point away from the scattering point)."""
    temp = 1.0 + g * g + 2.0 * g * mm.dot(wi, wo)
    return 0.25 * INV_PI * (1.0 - g * g) / torch.clamp(
        temp * torch.sqrt(torch.clamp(temp, min=1e-12)), min=1e-12)


def _hk_common(sp):
    sig_s = sp["cB"]
    sig_t = sig_s + sp["cC"]
    tau = sig_t * sp["alpha_v"][..., None]
    albedo = torch.where(sig_t > 0, sig_s / torch.clamp(sig_t, min=1e-12), 0.0)
    return tau, albedo


def _hk_prob_spec(sp, wi):
    tau, _ = _hk_common(sp)
    aci = torch.clamp(torch.abs(mm.cos_theta(wi)), min=1e-6)
    return torch.exp(-tau / aci[..., None]).mean(dim=-1)


def _hk_eval(sp, wi, wo):
    """The single-scattering slab terms (hk.cpp eval); the delta
    transmission straight through lives in the sample arm."""
    tau, albedo = _hk_common(sp)
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    aci = torch.clamp(torch.abs(ci), min=1e-6)
    aco = torch.clamp(torch.abs(co), min=1e-6)
    phase = _hk_phase(sp["alpha_u"], wi, wo)
    # reflection: Hanrahan and Krueger 93, single scattering
    refl = albedo * (phase * aci / (aci + aco))[..., None] * (
        1.0 - torch.exp((-1.0 / aci - 1.0 / aco)[..., None] * tau))
    # transmission
    near = torch.abs(aci - aco) < 1e-4
    t_same = albedo * (phase / aco)[..., None] * tau * torch.exp(-tau / aco[..., None])
    t_diff = albedo * (phase * aci / (aci - aco))[..., None] * (
        torch.exp(-tau / aci[..., None]) - torch.exp(-tau / aco[..., None]))
    trans = torch.where(near[..., None], t_same, t_diff)
    dp = ci * co
    out = torch.where((dp > 0)[..., None], refl, torch.where((dp < 0)[..., None], trans, 0.0))
    return out * aco[..., None]


def _hk_pdf(sp, wi, wo):
    """Phase-function sampling density x (1 - P[delta transmission])
    (hk.cpp pdf)."""
    return _hk_phase(sp["alpha_u"], wi, wo) * (1.0 - _hk_prob_spec(sp, wi))


# ---------------------------------------------------------------------------
# Irawan-Marschner woven cloth (irawan.cpp); the yarn lookup is sp["iw"]
# ---------------------------------------------------------------------------

def _irawan_eval(sp, wi, wo):
    if "iw" not in sp:  # a mixture's or coating's component: not supported
        return torch.zeros(wi.shape[:-1] + (3,), device=wi.device)
    return iw.irawan_f(sp["iw"], wi, wo)


def _irawan_pdf(sp, wi, wo):
    """Cosine-hemisphere density, front side only (irawan.cpp pdf:321-334)."""
    front = (mm.cos_theta(wi) > 0) & (mm.cos_theta(wo) > 0)
    return torch.where(front, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


_EVAL_FNS = {
    HK: _hk_eval,
    DIFFUSE: _diffuse_eval,
    ROUGHDIFFUSE: _roughdiffuse_eval,
    ROUGHCONDUCTOR: _roughconductor_eval,
    ROUGHDIELECTRIC: _roughdielectric_eval,
    PLASTIC: _plastic_eval,
    ROUGHPLASTIC: _roughplastic_eval,
    PHONG_BSDF: _phong_eval,
    WARD: _ward_eval,
    DIFFTRANS: _difftrans_eval,
    IRAWAN: _irawan_eval,
}

_PDF_FNS = {
    HK: _hk_pdf,
    DIFFUSE: _diffuse_pdf,
    ROUGHDIFFUSE: _diffuse_pdf,
    ROUGHCONDUCTOR: _roughconductor_pdf,
    ROUGHDIELECTRIC: _roughdielectric_pdf,
    PLASTIC: _plastic_pdf,
    ROUGHPLASTIC: _roughplastic_pdf,
    PHONG_BSDF: _phong_pdf,
    WARD: _ward_pdf,
    DIFFTRANS: _difftrans_pdf,
    IRAWAN: _irawan_pdf,
}


def _flip_twosided(sp, wi, *rest):
    """Two-sided materials: mirror the frame when hit from the back
    (reference src/bsdfs/twosided.cpp)."""
    flip = (sp["twosided"] > 0.5) & (mm.cos_theta(wi) < 0)
    fz = torch.where(flip, -1.0, 1.0)[..., None]
    flip_vec = torch.cat([torch.ones_like(fz), torch.ones_like(fz), fz], dim=-1)
    return flip_vec, [wi * flip_vec] + [w * flip_vec for w in rest]


def _eval_single(sp, wi, wo, present):
    """f * |cos_o| of the lane's own row (Dirac lobes and the layer types
    give 0)."""
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    out = 0.0
    for t in present:
        fn = _EVAL_FNS.get(t)
        if fn is not None:
            out = torch.where((sp["type"] == t)[..., None], fn(sp, wi, wo), out)
    return out if torch.is_tensor(out) else torch.zeros(wi.shape, device=wi.device)


def _pdf_single(sp, wi, wo, present):
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    out = 0.0
    for t in present:
        fn = _PDF_FNS.get(t)
        if fn is not None:
            out = torch.where(sp["type"] == t, fn(sp, wi, wo), out)
    return out if torch.is_tensor(out) else torch.zeros(wi.shape[:-1], device=wi.device)


# ---------------------------------------------------------------------------
# a smooth dielectric coating over a nested BSDF (coating.cpp); the nested
# BSDF's parameters are spB (sp["mix"]["spB"])
# ---------------------------------------------------------------------------

def _coating_refract_in(wi, eta):
    """Snell-refract into the layer on the same side (coating.cpp
    refractIn: the tangential parts scale by 1/eta)."""
    cos_i = mm.cos_theta(wi)
    sin2_t = (1.0 / (eta * eta)) * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return torch.cat([wi[..., :2] * (1.0 / eta)[..., None], (mm.sign(cos_i) * cos_t)[..., None]],
                     dim=-1)


def _coating_refract_out(wo_r, eta):
    """Layer -> outside: (wo, total internal reflection)."""
    cos_i = mm.cos_theta(wo_r)
    sin2_t = (eta * eta) * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wo = torch.cat([wo_r[..., :2] * eta[..., None], (mm.sign(cos_i) * cos_t)[..., None]], dim=-1)
    return mm.normalize(wo), sin2_t >= 1.0


def _coating_probs(sp, cos_i):
    f_i, _, _ = mm.fresnel_dielectric(torch.abs(cos_i), sp["eta"])
    sw = sp["spec_w"]
    prob = (f_i * sw) / torch.clamp(f_i * sw + (1.0 - f_i) * (1.0 - sw), min=1e-8)
    return f_i, prob


def _absorb(sp, wi_r, wo_r):
    """(Beer absorption through the layer, sigmaA x thickness in cD, and
    |cos| of wo_r clamped at 1e-4)."""
    ct_ir = torch.clamp(torch.abs(mm.cos_theta(wi_r)), min=1e-4)
    ct_or = torch.clamp(torch.abs(mm.cos_theta(wo_r)), min=1e-4)
    return torch.exp(-sp["cD"] * (1.0 / ct_ir + 1.0 / ct_or)[..., None]), ct_or


def _coating_eval_nf(sp, spB, wi, wo, present):
    """The coated eval in the (already two-sided-flipped) local frame."""
    eta = sp["eta"]
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    f_i, _, _ = mm.fresnel_dielectric(torch.abs(ci), eta)
    f_o, _, _ = mm.fresnel_dielectric(torch.abs(co), eta)
    wi_r = _coating_refract_in(wi, eta)
    wo_r = _coating_refract_in(wo, eta)
    val = _eval_single(spB, wi_r, wo_r, present) * ((1.0 - f_i) * (1.0 - f_o))[..., None]
    absorb, ct_or = _absorb(sp, wi_r, wo_r)
    # the solid-angle compression (coating.cpp eval)
    return val * absorb * ((1.0 / (eta * eta)) * torch.abs(co) / ct_or)[..., None]


def _coating_pdf_nf(sp, spB, wi, wo, present):
    eta = sp["eta"]
    co = mm.cos_theta(wo)
    _, prob = _coating_probs(sp, mm.cos_theta(wi))
    wo_r = _coating_refract_in(wo, eta)
    p_n = _pdf_single(spB, _coating_refract_in(wi, eta), wo_r, present)
    ct_or = torch.clamp(torch.abs(mm.cos_theta(wo_r)), min=1e-4)
    return (1.0 - prob) * p_n * ((1.0 / (eta * eta)) * torch.abs(co) / ct_or)


def _coating_eval(sp, spB, wi, wo, present):
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    return _coating_eval_nf(sp, spB, wi, wo, present)


def _coating_pdf(sp, spB, wi, wo, present):
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    return _coating_pdf_nf(sp, spB, wi, wo, present)


def _child_lobe(ulobe, prob):
    """The lobe number left for the nested BSDF after the layer's choice."""
    return torch.clamp((ulobe - prob) / torch.clamp(1.0 - prob, min=1e-8), 0.0, mm.ONE_MINUS_EPS)


def _coating_sample(sp, spB, wi, u2, ulobe, present):
    """coating.cpp sample: a Fresnel-weighted choice between the delta
    reflection and the refracted nested sample, rejected on total
    internal reflection on the way out."""
    flip_vec, (wi,) = _flip_twosided(sp, wi)
    eta = sp["eta"]
    f_i, prob = _coating_probs(sp, mm.cos_theta(wi))
    spec_sel = ulobe <= prob
    w_spec = sp["cB"] * (f_i / torch.clamp(prob, min=1e-8))[..., None]
    wi_r = _coating_refract_in(wi, eta)
    bs_n = bsdf_sample(spB, wi_r, u2, _child_lobe(ulobe, prob), present)
    wo_out, tir = _coating_refract_out(bs_n.wo, eta)
    child_ok = (bs_n.weight.amax(dim=-1) > 0) & ~tir
    # smooth child lobes: the full coated f / pdf
    p_c = _coating_pdf_nf(sp, spB, wi, wo_out, present)
    w_smooth = _weight(_coating_eval_nf(sp, spB, wi, wo_out, present), p_c,
                       child_ok & (p_c > 1e-10))
    # a delta child (a coated mirror): the child's weight with the
    # boundary and absorption factors (the selection probability cancels)
    f_o, _, _ = mm.fresnel_dielectric(torch.abs(mm.cos_theta(wo_out)), eta)
    absorb, _ = _absorb(sp, wi_r, bs_n.wo)
    w_delta = bs_n.weight * ((1.0 - f_i) * (1.0 - f_o))[..., None] * absorb / torch.clamp(
        1.0 - prob, min=1e-8)[..., None]
    w_delta = _mask3(child_ok, w_delta)
    wo = torch.where(spec_sel[..., None], mm.reflect_local(wi), wo_out)
    weight = torch.where(spec_sel[..., None], w_spec,
                         torch.where(bs_n.delta[..., None], w_delta, w_smooth))
    pdf = torch.where(spec_sel, prob, torch.where(bs_n.delta, (1.0 - prob) * bs_n.pdf, p_c))
    # the relative IOR follows the nested lobe (a coated dielectric)
    return BSDFSample(wo * flip_vec, weight, pdf, spec_sel | bs_n.delta,
                      torch.where(spec_sel, 1.0, bs_n.eta))


# ---------------------------------------------------------------------------
# a rough dielectric coating (roughcoating.cpp): a glossy D F G reflection
# off the boundary, and the nested BSDF through smooth-refracted
# directions weighted by the fitted rough transmittance
# ---------------------------------------------------------------------------

def _rcoating_probs(sp, cos_i):
    """The selection probability 1 - T12, reallocated by the specular
    sampling weight (roughcoating.cpp sample, probSpecular)."""
    si = 1.0 - _rt_eval(sp, torch.abs(cos_i))
    sw = sp["spec_w"]
    prob = (si * sw) / torch.clamp(si * sw + (1.0 - si) * (1.0 - sw), min=1e-8)
    return si, prob


def _rcoating_half(wi, wo):
    """(same side, the half vector on wo's side)."""
    same = mm.cos_theta(wi) * mm.cos_theta(wo) > 0
    return same, mm.normalize(wi + wo) * mm.sign(mm.cos_theta(wo))[..., None]


def _rcoating_spec_eval(sp, wi, wo):
    """The microfacet reflection off the rough boundary."""
    same, h = _rcoating_half(wi, wo)
    d = mf.microfacet_D(sp["dist"], sp["alpha_u"], sp["alpha_v"], h)
    g = mf.smith_g(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, wo, h)
    fh, _, _ = mm.fresnel_dielectric(torch.abs(mm.dot(wi, h)), sp["eta"])
    val = sp["cB"] * (fh * d * g / torch.clamp(4.0 * torch.abs(mm.cos_theta(wi)), min=1e-8))[
        ..., None]
    return _mask3(same, val)


def _rcoating_nested_factor(sp, wi_r, wo_r, ci, co):
    """T12 T21, the boundary's transmittances, with the absorption; and
    |cos| of wo_r (roughcoating.cpp:294-315)."""
    t = (_rt_eval(sp, torch.abs(ci)) * _rt_eval(sp, torch.abs(co)))[..., None]
    absorb, ct_or = _absorb(sp, wi_r, wo_r)
    return t * absorb, ct_or


def _rcoating_eval_nf(sp, spB, wi, wo, present):
    eta = sp["eta"]
    ci, co = mm.cos_theta(wi), mm.cos_theta(wo)
    wi_r = _coating_refract_in(wi, eta)
    wo_r = _coating_refract_in(wo, eta)
    fac, ct_or = _rcoating_nested_factor(sp, wi_r, wo_r, ci, co)
    nested = _eval_single(spB, wi_r, wo_r, present) * fac * (
        (1.0 / (eta * eta)) * torch.abs(co) / ct_or)[..., None]
    return _rcoating_spec_eval(sp, wi, wo) + nested


def _rcoating_pdf_nf(sp, spB, wi, wo, present):
    eta = sp["eta"]
    co = mm.cos_theta(wo)
    _, prob = _rcoating_probs(sp, mm.cos_theta(wi))
    same, h = _rcoating_half(wi, wo)
    pm = mf.pdf_m(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, h)
    spec_pdf = torch.where(same, pm / torch.clamp(4.0 * torch.abs(mm.dot(wo, h)), min=1e-8), 0.0)
    wo_r = _coating_refract_in(wo, eta)
    p_n = _pdf_single(spB, _coating_refract_in(wi, eta), wo_r, present)
    ct_or = torch.clamp(torch.abs(mm.cos_theta(wo_r)), min=1e-4)
    return prob * spec_pdf + (1.0 - prob) * p_n * ((1.0 / (eta * eta)) * torch.abs(co) / ct_or)


def _rcoating_eval(sp, spB, wi, wo, present):
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    return _rcoating_eval_nf(sp, spB, wi, wo, present)


def _rcoating_pdf(sp, spB, wi, wo, present):
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    return _rcoating_pdf_nf(sp, spB, wi, wo, present)


def _rcoating_sample(sp, spB, wi, u2, ulobe, present):
    """roughcoating.cpp sample."""
    flip_vec, (wi,) = _flip_twosided(sp, wi)
    eta = sp["eta"]
    ci = mm.cos_theta(wi)
    _, prob = _rcoating_probs(sp, ci)
    spec_sel = ulobe <= prob
    # the glossy boundary reflection about a sampled microfacet normal
    m = mf.sample_m(sp["dist"], sp["alpha_u"], sp["alpha_v"], wi, u2, sp.get("mf_dists"))
    wo_spec = mm.normalize(2.0 * mm.dot(wi, m)[..., None] * m - wi)
    wi_r = _coating_refract_in(wi, eta)
    bs_n = bsdf_sample(spB, wi_r, u2, _child_lobe(ulobe, prob), present)
    wo_nest, tir = _coating_refract_out(bs_n.wo, eta)
    child_ok = (bs_n.weight.amax(dim=-1) > 0) & ~tir
    wo = torch.where(spec_sel[..., None], wo_spec, wo_nest)
    # smooth lobes (either): the full layered f / pdf
    p_c = _rcoating_pdf_nf(sp, spB, wi, wo, present)
    w_smooth = _weight(_rcoating_eval_nf(sp, spB, wi, wo, present), p_c,
                       (spec_sel | child_ok) & (p_c > 1e-10))
    # a delta child (a rough-coated mirror): the child's weight with the
    # boundary and absorption factors
    fac, _ = _rcoating_nested_factor(sp, wi_r, bs_n.wo, ci, mm.cos_theta(wo))
    w_delta = _mask3(child_ok, bs_n.weight * fac / torch.clamp(1.0 - prob, min=1e-8)[..., None])
    use_delta = ~spec_sel & bs_n.delta
    return BSDFSample(wo * flip_vec, torch.where(use_delta[..., None], w_delta, w_smooth),
                      torch.where(use_delta, (1.0 - prob) * bs_n.pdf, p_c), use_delta,
                      torch.where(spec_sel, 1.0, bs_n.eta))


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

def _eval(sp, wi, wo, present):
    if "mix" not in sp:
        return _eval_single(sp, wi, wo, present)
    mix = sp["mix"]
    # spB may itself head a chain (N-ary mixtures)
    out = (mix["wa"][..., None] * _eval_single(sp, wi, wo, present)
           + mix["wb"][..., None] * _eval(mix["spB"], wi, wo, present))
    if COATING in present:
        out = torch.where((sp["type"] == COATING)[..., None],
                          _coating_eval(sp, mix["spB"], wi, wo, present), out)
    if ROUGHCOATING in present:
        out = torch.where((sp["type"] == ROUGHCOATING)[..., None],
                          _rcoating_eval(sp, mix["spB"], wi, wo, present), out)
    return out


def _pdf(sp, wi, wo, present):
    if "mix" not in sp:
        return _pdf_single(sp, wi, wo, present)
    mix = sp["mix"]
    out = (mix["wa"] * _pdf_single(sp, wi, wo, present)
           + mix["wb"] * _pdf(mix["spB"], wi, wo, present))
    if COATING in present:
        out = torch.where(sp["type"] == COATING, _coating_pdf(sp, mix["spB"], wi, wo, present),
                          out)
    if ROUGHCOATING in present:
        out = torch.where(sp["type"] == ROUGHCOATING,
                          _rcoating_pdf(sp, mix["spB"], wi, wo, present), out)
    return out


def bsdf_eval(sp, wi, wo, present):
    """f(wi, wo) * |cos_o| for the per-lane material (smooth lobes only:
    Dirac lobes give 0).  Mixtures blend their components (mixturebsdf.cpp
    eval); coating rows evaluate the layered model over their spB child."""
    _check(present)
    return _eval(sp, wi, wo, present)


def bsdf_pdf(sp, wi, wo, present):
    """Solid-angle density of bsdf_sample producing wo (0 for Dirac
    lobes); for a mixture wa pdfA + wb pdfB, the absorption included."""
    _check(present)
    return _pdf(sp, wi, wo, present)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _weight(f, pdf, ok):
    return torch.where(ok[..., None], f / torch.clamp(pdf, min=1e-10)[..., None], 0.0)


def _select(mask, a, b):
    """BSDFSample a where mask holds, else b."""
    m3 = mask[..., None]
    return BSDFSample(torch.where(m3, a.wo, b.wo), torch.where(m3, a.weight, b.weight),
                      torch.where(mask, a.pdf, b.pdf), torch.where(mask, a.delta, b.delta),
                      torch.where(mask, a.eta, b.eta))


def _mix_sample(sp, wi, u2, ulobe, present):
    """Pick a component by weight (absorbing the deficit when the weights
    sum below one, mixturebsdf.cpp) and re-weight smooth lobes by the
    blended eval / pdf; coating rows take the layered sample."""
    mix = sp["mix"]
    wa, wb, spB = mix["wa"], mix["wb"], mix["spB"]
    sel_b = ulobe < wb
    absorb = ulobe >= (wa + wb)
    # the lobe number rescaled for the chosen component
    ul = torch.where(sel_b, ulobe / torch.clamp(wb, min=1e-8),
                     (ulobe - wb) / torch.clamp(wa, min=1e-8))
    ul = torch.clamp(ul, 0.0, mm.ONE_MINUS_EPS)
    sp_sel = {
        k: torch.where(sel_b[..., None] if sp[k].dim() > sel_b.dim() else sel_b, spB[k], sp[k])
        for k in spB if k not in ("mix", "mf_dists")
    }
    if "mf_dists" in sp:
        # the scene's static tuple, never part of a per-lane select
        sp_sel["mf_dists"] = sp["mf_dists"]
    if "mix" in spB:
        # an N-ary chain: lanes that picked B go on down B's chain; lanes
        # that picked A see the weights (1, 0), a leaf
        sub = spB["mix"]
        sp_sel["mix"] = {"spB": sub["spB"], "wa": torch.where(sel_b, sub["wa"], 1.0),
                         "wb": torch.where(sel_b, sub["wb"], 0.0)}
    if "iw" in sp:
        sp_sel["iw"] = sp["iw"]
    bs = _sample(sp_sel, wi, u2, ul, present)
    # smooth lobes take the blended f / pdf (delta lobes keep the child's
    # weight: the selection probability cancels); a draw the child rejects
    # stays rejected, or the claimed density would undercount
    child_ok = bs.weight.amax(dim=-1) > 0
    p_mix = _pdf(sp, wi, bs.wo, present)
    w_smooth = _weight(_eval(sp, wi, bs.wo, present), p_mix, child_ok & (p_mix > 1e-10))
    weight = torch.where(bs.delta[..., None], bs.weight, w_smooth)
    bs = BSDFSample(bs.wo, _mask3(~absorb, weight), torch.where(bs.delta, bs.pdf, p_mix),
                    bs.delta, bs.eta)
    if COATING in present:
        bs = _select(sp["type"] == COATING, _coating_sample(sp, spB, wi, u2, ulobe, present), bs)
    if ROUGHCOATING in present:
        bs = _select(sp["type"] == ROUGHCOATING,
                     _rcoating_sample(sp, spB, wi, u2, ulobe, present), bs)
    return bs


def bsdf_sample(sp, wi, u2, ulobe, present):
    """Sample an outgoing direction for every lane; lanes whose sample
    failed get weight 0."""
    _check(present)
    return _sample(sp, wi, u2, ulobe, present)


def _sample(sp, wi, u2, ulobe, present):
    if "mix" in sp:
        return _mix_sample(sp, wi, u2, ulobe, present)
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

    def glossy(tm, wo_spec, eval_fn, pdf_fn):
        """A glossy lobe beside a cosine-sampled diffuse one (phong, ward):
        the lobe chosen by spec_w, weighted by the full f / pdf."""
        wo_t = torch.where((ulobe <= sp["spec_w"])[..., None], wo_spec,
                           warp.square_to_cosine_hemisphere(u2))
        pdf_t = pdf_fn(sp, wi, wo_t)
        ok = (pdf_t > 1e-10) & (mm.cos_theta(wo_t) > 0) & (ci > 0)
        put(tm, wo_t, _weight(eval_fn(sp, wi, wo_t), pdf_t, ok), pdf_t, False, 1.0)

    for t in present:
        tm = sp["type"] == t
        if t == DIFFUSE:
            wo_t = warp.square_to_cosine_hemisphere(u2)
            put(tm, wo_t, _mask3(ci > 0, sp["cA"]),
                warp.square_to_cosine_hemisphere_pdf(wo_t), False, 1.0)
        elif t == ROUGHDIFFUSE:
            wo_t = warp.square_to_cosine_hemisphere(u2)
            pdf_t = warp.square_to_cosine_hemisphere_pdf(wo_t)
            put(tm, wo_t, _roughdiffuse_eval(sp, wi, wo_t) / torch.clamp(pdf_t, min=1e-8)[
                ..., None], pdf_t, False, 1.0)
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
        elif t == HK:
            # the slab: delta transmission straight through with the mean
            # channel attenuation as its probability, else HG scattering
            # around the continuing direction -wi (hk.cpp sample)
            p_spec = _hk_prob_spec(sp, wi)
            tau, _ = _hk_common(sp)
            choose_spec = ulobe < p_spec
            att = torch.exp(-tau / torch.clamp(torch.abs(ci), min=1e-6)[..., None])
            w_spec = att / torch.clamp(p_spec, min=1e-8)[..., None]
            wo_hg = mm.Frame.from_normal(-wi).to_world(warp.square_to_phase_hg(u2, sp["alpha_u"]))
            pdf_hg = _hk_pdf(sp, wi, wo_hg)
            w_hg = _weight(_hk_eval(sp, wi, wo_hg), pdf_hg, pdf_hg > 1e-10)
            put(tm, torch.where(choose_spec[..., None], -wi, wo_hg),
                torch.where(choose_spec[..., None], w_spec, w_hg),
                torch.where(choose_spec, p_spec, pdf_hg), choose_spec, 1.0)
        elif t == DIELECTRIC:
            F, _, eta_rel = mm.fresnel_dielectric(ci, sp["eta"])
            refl = ulobe <= F
            wo_refr, _, _ = mm.refract_local(wi, sp["eta"])
            wo_t = torch.where(refl[..., None], mm.reflect_local(wi), wo_refr)
            inv_eta2 = 1.0 / (eta_rel * eta_rel)
            w_t = torch.where(refl[..., None], sp["cB"], sp["cC"] * inv_eta2[..., None])
            put(tm, wo_t, w_t, torch.where(refl, F, 1.0 - F), True,
                torch.where(refl, 1.0, eta_rel))
        elif t == THINDIELECTRIC:
            F, _, _ = mm.fresnel_dielectric(torch.abs(ci), sp["eta"])
            # with the internal reflections: R' = 2F / (1 + F)
            r = torch.where(F < 1.0, 2.0 * F / (1.0 + F), 1.0)
            refl = ulobe <= r
            put(tm, torch.where(refl[..., None], mm.reflect_local(wi), -wi),
                torch.where(refl[..., None], sp["cB"], sp["cC"]),
                torch.where(refl, r, 1.0 - r), True, 1.0)
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
        elif t == PHONG_BSDF:
            # the lobe about the mirror direction (phong.cpp sample)
            e = sp["exponent"]
            cos_a = torch.pow(torch.clamp(u2[..., 0], 0.0, mm.ONE_MINUS_EPS), 1.0 / (e + 1.0))
            sin_a = mm.safe_sqrt(1.0 - cos_a * cos_a)
            phi = 2.0 * math.pi * u2[..., 1]
            lobe = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a], dim=-1)
            glossy(tm, mm.Frame.from_normal(mm.reflect_local(wi)).to_world(lobe), _phong_eval,
                   _phong_pdf)
        elif t == WARD:
            # the half vector of the anisotropic Ward lobe (ward.cpp sample)
            au = mf.clamp_alpha(sp["alpha_u"])
            av = mf.clamp_alpha(sp["alpha_v"])
            phi_h = torch.atan2(av * torch.sin(2.0 * math.pi * u2[..., 1]),
                                au * torch.cos(2.0 * math.pi * u2[..., 1]))
            cp, sph = torch.cos(phi_h), torch.sin(phi_h)
            t2 = -torch.log(torch.clamp(1.0 - u2[..., 0], min=1e-20)) / torch.clamp(
                (cp / au) ** 2 + (sph / av) ** 2, min=1e-8)
            ct_h = 1.0 / torch.sqrt(1.0 + t2)
            st_h = mm.safe_sqrt(1.0 - ct_h * ct_h)
            h = torch.stack([st_h * cp, st_h * sph, ct_h], dim=-1)
            glossy(tm, 2.0 * mm.dot(wi, h, keepdim=True) * h - wi, _ward_eval, _ward_pdf)
        elif t == DIFFTRANS:
            wo_t = warp.square_to_cosine_hemisphere(u2)
            flip_z = torch.stack([torch.ones_like(ci), torch.ones_like(ci), -mm.sign(ci)], dim=-1)
            wo_t = wo_t * flip_z
            put(tm, wo_t, sp["cA"], torch.abs(mm.cos_theta(wo_t)) * INV_PI, False, 1.0)
        elif t == IRAWAN:
            # cosine sampling, weight f / pdf (the reference has no better
            # sampler either, irawan.cpp sample:336-371)
            wo_t = warp.square_to_cosine_hemisphere(u2)
            pdf_t = warp.square_to_cosine_hemisphere_pdf(wo_t)
            ok = (pdf_t > 1e-8) & (ci > 0)
            put(tm, wo_t, torch.where(ok[..., None], _irawan_eval(sp, wi, wo_t)
                                      / torch.clamp(pdf_t, min=1e-8)[..., None], 0.0),
                pdf_t, False, 1.0)
        elif t == NULL_BSDF:
            # straight through: eval and pdf are 0, the sample has weight 1
            put(tm, -wi, torch.ones_like(wi), 1.0, True, 1.0)

    # un-flip wo for two-sided lanes
    return BSDFSample(wo * flip_vec, weight, pdf, delta, eta_s)
