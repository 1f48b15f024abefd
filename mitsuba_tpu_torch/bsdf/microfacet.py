"""Microfacet distributions: Beckmann, GGX, Phong (port of
mitsuba_tpu/bsdf/microfacet.py; reference src/bsdfs/microfacet.h).

D, Smith G1 and G, classic D*cos sampling (`sample_m_all`) and the
reference's default visible-normal sampling (`sample_m_visible`):
Heitz 2018 for GGX, the Heitz-d'Eon stretch with a safeguarded Newton
inversion of the visible-slope CDF for Beckmann, classic sampling for
Phong.  Anisotropy is supported in D, G and sampling.  Directions are in
the local shading frame (+z = n).  MTS_VNDF=0 selects classic sampling,
MTS_BECK_NEWTON_ITERS the Newton steps, both read at import as in the
reference.
"""

from __future__ import annotations

import math
import os

import torch

from mitsuba_tpu_torch.core import math as mm

BECKMANN = 0
GGX = 1
PHONG = 2

_MIN_ALPHA = 1e-4


def clamp_alpha(a):
    return torch.clamp(a, min=_MIN_ALPHA)


def microfacet_D(dist, alpha_u, alpha_v, m):
    """D(m) of all three families, selected per lane by `dist`."""
    au = clamp_alpha(alpha_u)
    av = clamp_alpha(alpha_v)
    ct = mm.cos_theta(m)
    ct2 = ct * ct
    valid = ct > 0.0
    ct2s = torch.clamp(ct2, min=1e-12)
    # slope-space squared components: (mx/ct/au)^2 + (my/ct/av)^2
    sx = m[..., 0] / au
    sy = m[..., 1] / av
    exponent_arg = (sx * sx + sy * sy) / ct2s

    beckmann = torch.exp(-exponent_arg) / (math.pi * au * av * ct2s * ct2s)

    root = ct2 + sx * sx + sy * sy
    ggx = 1.0 / (math.pi * au * av * torch.clamp(root * root, min=1e-12))

    # Phong with the exponent of the isotropic alpha
    a_iso = torch.sqrt(au * av)
    exp_phong = 2.0 / (a_iso * a_iso) - 2.0
    phong = (
        (exp_phong + 2.0)
        * (0.5 / math.pi)
        * torch.pow(torch.clamp(ct, min=1e-12), exp_phong)
    )

    d = torch.where(dist == BECKMANN, beckmann, torch.where(dist == GGX, ggx, phong))
    return torch.where(valid, d, 0.0)


def smith_g1(dist, alpha_u, alpha_v, v, m):
    """Smith masking-shadowing for one direction (microfacet.h smithG1)."""
    au = clamp_alpha(alpha_u)
    av = clamp_alpha(alpha_v)
    ct = mm.cos_theta(v)
    # v must lie on the same side as m
    backside = mm.dot(v, m) * ct <= 0.0
    tan_theta = torch.abs(mm.tan_theta(v))
    perp = tan_theta == 0.0

    # projected roughness along v's azimuth
    st2 = mm.sin_theta2(v)
    inv_sin2 = torch.where(st2 > 1e-12, 1.0 / torch.clamp(st2, min=1e-12), 0.0)
    cos2_phi = v[..., 0] * v[..., 0] * inv_sin2
    sin2_phi = v[..., 1] * v[..., 1] * inv_sin2
    alpha = torch.sqrt(cos2_phi * au * au + sin2_phi * av * av)
    alpha = torch.where(st2 > 1e-12, alpha, torch.sqrt(au * av))

    a = 1.0 / torch.clamp(alpha * tan_theta, min=1e-12)
    # Beckmann rational approximation (microfacet.h:436)
    a2 = a * a
    beck = torch.where(
        a < 1.6, (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2), 1.0
    )
    at2 = (alpha * tan_theta) ** 2
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + at2))
    # Phong uses the Beckmann G at its equivalent alpha, as the reference
    g = torch.where(dist == GGX, ggx, beck)
    g = torch.where(perp, 1.0, g)
    return torch.where(backside, 0.0, g)


def smith_g(dist, alpha_u, alpha_v, wi, wo, m):
    return smith_g1(dist, alpha_u, alpha_v, wi, m) * smith_g1(dist, alpha_u, alpha_v, wo, m)


def sample_m_all(dist, alpha_u, alpha_v, u2):
    """m ~ D(m) cos(theta_m) (classic, not visible normals), anisotropic
    for Beckmann/GGX (microfacet.h sampleAll's quadrant-corrected
    azimuth); Phong at the isotropic-equivalent alpha, as its D."""
    au = clamp_alpha(alpha_u)
    av = clamp_alpha(alpha_v)
    u0 = torch.clamp(u2[..., 0], 0.0, mm.ONE_MINUS_EPS)
    u1 = u2[..., 1]

    # anisotropic azimuth: atan(av/au tan(pi + 2 pi u1)) + pi floor(2 u1 + 0.5)
    phi_a = torch.arctan(
        av / au * torch.tan(math.pi + 2.0 * math.pi * u1)
    ) + math.pi * torch.floor(2.0 * u1 + 0.5)
    iso = torch.abs(au - av) < 1e-7
    phi = torch.where(iso, 2.0 * math.pi * u1, phi_a)
    cp, sp = torch.cos(phi), torch.sin(phi)
    inv_a2 = (cp * cp) / (au * au) + (sp * sp) / (av * av)
    a2 = 1.0 / torch.clamp(inv_a2, min=1e-12)

    # Beckmann: tan^2 = -a(phi)^2 ln(1-u)
    t2_beck = -a2 * torch.log(torch.clamp(1.0 - u0, min=1e-20))
    # GGX: tan^2 = a(phi)^2 u/(1-u)
    t2_ggx = a2 * u0 / torch.clamp(1.0 - u0, min=1e-12)
    # Phong: cos = (1-u)^(1/(e+2)) with the isotropic exponent
    a_iso = torch.sqrt(au * av)
    e_ph = 2.0 / (a_iso * a_iso) - 2.0
    ct_ph = torch.pow(torch.clamp(1.0 - u0, min=1e-20), 1.0 / (e_ph + 2.0))
    t2_ph = torch.clamp(1.0 - ct_ph * ct_ph, min=0.0) / torch.clamp(ct_ph * ct_ph, min=1e-12)

    tan2 = torch.where(dist == BECKMANN, t2_beck, torch.where(dist == GGX, t2_ggx, t2_ph))
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = mm.safe_sqrt(1.0 - ct * ct)
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def pdf_m_all(dist, alpha_u, alpha_v, m):
    """pdf of sample_m_all over the solid angle of m: D(m) cos(theta_m)."""
    return microfacet_D(dist, alpha_u, alpha_v, m) * torch.clamp(mm.cos_theta(m), min=0.0)


# ---------------------------------------------------------------------------
# Visible-normal (VNDF) sampling, the reference's default
# (microfacet.h:237-261, :421-459, :573-717): GGX by Heitz 2018,
# Beckmann by the Heitz & d'Eon 2014 stretch with the slope CDF inverted
# by safeguarded Newton (after W. Jakob 2014), Phong by classic sampling
# (microfacet.h:141-143 disables sampleVisible for it).
# ---------------------------------------------------------------------------

USE_VNDF = os.environ.get("MTS_VNDF", "1") != "0"

_INV_SQRT_PI = 0.5641895835477563


def _ggx_visible(alpha_u, alpha_v, wi, u2):
    """Heitz 2018 hemisphere method; wi must have cos_theta > 0."""
    au = clamp_alpha(alpha_u)
    av = clamp_alpha(alpha_v)
    # to the hemisphere configuration (stretched tangent plane)
    vh = mm.normalize(torch.stack([au * wi[..., 0], av * wi[..., 1], wi[..., 2]], dim=-1))
    # orthonormal basis around vh (t1 in the tangent plane)
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    safe = lensq > 1e-20
    t1 = torch.stack(
        [
            torch.where(safe, -vh[..., 1] * inv_len, 1.0),
            torch.where(safe, vh[..., 0] * inv_len, 0.0),
            torch.zeros_like(inv_len),
        ],
        dim=-1,
    )
    t2 = mm.cross(vh, t1)
    # a disk point, warped onto the visible half
    r = torch.sqrt(torch.clamp(u2[..., 0], 0.0, mm.ONE_MINUS_EPS))
    phi = 2.0 * math.pi * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * mm.safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + mm.safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh
    )
    # back to the ellipsoid configuration
    return mm.normalize(
        torch.stack(
            [au * nh[..., 0], av * nh[..., 1], torch.clamp(nh[..., 2], min=1e-6)], dim=-1
        )
    )


# safeguarded-Newton steps of the Beckmann visible-slope CDF inversion
# (the reference's default, 8)
_BECK_ITERS = int(os.environ.get("MTS_BECK_NEWTON_ITERS", 8))


def _beckmann_visible_slope_x(cos_theta_i, u0, iters=None):
    """Invert the azimuth-0 visible-slope CDF of the unit Beckmann
    distribution,
      F(x) = ct (1 + erf(x)) / 2 + st exp(-x^2) / (2 sqrt(pi)),  x <= cot(ti),
      F'(x) = (ct - st x) exp(-x^2) / sqrt(pi),
    for F(x) = u F(cot) by safeguarded Newton in the slope domain; the
    reference's fori_loop is a loop over the static step count."""
    if iters is None:
        iters = _BECK_ITERS
    erf = torch.special.erf
    ct = torch.clamp(cos_theta_i, 1e-6, 1.0)
    st = mm.safe_sqrt(1.0 - ct * ct)
    cot_t = torch.clamp(ct / torch.clamp(st, min=1e-8), max=1e6)
    u0 = torch.clamp(u0, 1e-6, 1.0 - 1e-6)

    def F(x):
        return 0.5 * ct * (1.0 + erf(x)) + (0.5 * _INV_SQRT_PI) * st * torch.exp(-x * x)

    # erf saturates in float32 near |x| ~ 4: cap the bracket there
    hi = torch.clamp(cot_t, max=4.2)
    target = u0 * F(cot_t)

    # initial guess: invert the near-linear erf-domain fit once
    c = erf(cot_t)
    theta_i = torch.arccos(ct)
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * torch.pow(1.0 - u0, fit)
    x = torch.erfinv(torch.clamp(b, -0.9999, 0.9999))

    lo = torch.full_like(x, -4.2)
    for _ in range(iters):
        x = torch.where((x >= lo) & (x <= hi), x, 0.5 * (lo + hi))
        value = F(x) - target
        lo = torch.where(value <= 0.0, x, lo)
        hi = torch.where(value > 0.0, x, hi)
        deriv = torch.clamp((ct - st * x) * torch.exp(-x * x) * _INV_SQRT_PI, min=1e-12)
        x = x - value / deriv
    x = torch.where((x >= lo) & (x <= hi), x, 0.5 * (lo + hi))
    return torch.minimum(x, cot_t)


def _beckmann_visible(alpha_u, alpha_v, wi, u2):
    """Stretch method: unit-roughness visible slopes at the stretched
    incidence, rotated by its azimuth, unstretched."""
    au = clamp_alpha(alpha_u)
    av = clamp_alpha(alpha_v)
    wi_s = mm.normalize(torch.stack([au * wi[..., 0], av * wi[..., 1], wi[..., 2]], dim=-1))
    ct = torch.clamp(wi_s[..., 2], 1e-6, 1.0)
    # azimuth of the stretched direction (any at normal incidence)
    inv_st = 1.0 / torch.clamp(mm.safe_sqrt(wi_s[..., 0] ** 2 + wi_s[..., 1] ** 2), min=1e-12)
    cp = torch.where(inv_st < 1e11, wi_s[..., 0] * inv_st, 1.0)
    sp = torch.where(inv_st < 1e11, wi_s[..., 1] * inv_st, 0.0)

    sx = _beckmann_visible_slope_x(ct, u2[..., 0])
    u1 = torch.clamp(u2[..., 1], 1e-6, 1.0 - 1e-6)
    sy = torch.erfinv(2.0 * u1 - 1.0)
    # rotate back by the incident azimuth, unstretch
    rx = (cp * sx - sp * sy) * au
    ry = (sp * sx + cp * sy) * av
    return mm.normalize(torch.stack([-rx, -ry, torch.ones_like(rx)], dim=-1))


def sample_m_visible(dist, alpha_u, alpha_v, wi, u2, dists=None):
    """m from the visible-normal distribution
    D_wi(m) = G1(wi, m) |wi.m| D(m) / |cos_theta_i|; wi may lie in either
    hemisphere (flipped internally), m has +z orientation; Phong lanes
    fall back to classic sampling.  dists: the STATIC tuple of
    distributions in the scene (the pack's mf_dists): absent samplers are
    not run."""
    if dists is not None and len(dists) == 0:
        dists = (BECKMANN, GGX, PHONG)
    need = set(dists) if dists is not None else {BECKMANN, GGX, PHONG}
    wi_f = wi * mm.sign(mm.cos_theta(wi))[..., None]
    if need == {GGX}:
        return _ggx_visible(alpha_u, alpha_v, wi_f, u2)
    if need == {BECKMANN}:
        return _beckmann_visible(alpha_u, alpha_v, wi_f, u2)
    if need == {PHONG}:
        return sample_m_all(dist, alpha_u, alpha_v, u2)
    zero = torch.zeros_like(wi)
    zero[..., 2] = 1.0
    m_ggx = _ggx_visible(alpha_u, alpha_v, wi_f, u2) if GGX in need else zero
    m_beck = _beckmann_visible(alpha_u, alpha_v, wi_f, u2) if BECKMANN in need else zero
    m_all = sample_m_all(dist, alpha_u, alpha_v, u2) if PHONG in need else zero
    return torch.where(
        (dist == GGX)[..., None], m_ggx, torch.where((dist == BECKMANN)[..., None], m_beck, m_all)
    )


def pdf_m_visible(dist, alpha_u, alpha_v, wi, m):
    """pdf of sample_m_visible over the solid angle of m
    (microfacet.h:461-486)."""
    ci = torch.abs(mm.cos_theta(wi))
    wi_f = wi * mm.sign(mm.cos_theta(wi))[..., None]
    g1 = smith_g1(dist, alpha_u, alpha_v, wi_f, m)
    d = microfacet_D(dist, alpha_u, alpha_v, m)
    pdf_vis = g1 * torch.abs(mm.dot(wi_f, m)) * d / torch.clamp(ci, min=1e-8)
    pdf_vis = torch.where(ci < 1e-8, 0.0, pdf_vis)
    return torch.where(dist == PHONG, pdf_m_all(dist, alpha_u, alpha_v, m), pdf_vis)


def sample_m(dist, alpha_u, alpha_v, wi, u2, dists=None):
    """Default microfacet-normal sampler: visible normals unless
    MTS_VNDF=0."""
    if USE_VNDF:
        return sample_m_visible(dist, alpha_u, alpha_v, wi, u2, dists)
    return sample_m_all(dist, alpha_u, alpha_v, u2)


def pdf_m(dist, alpha_u, alpha_v, wi, m):
    """pdf of sample_m over the solid angle of m."""
    if USE_VNDF:
        return pdf_m_visible(dist, alpha_u, alpha_v, wi, m)
    return pdf_m_all(dist, alpha_u, alpha_v, m)


def project_roughness_to_alpha(roughness):
    """Identity, as in the reference: its plugins expose the
    Beckmann-equivalent alpha directly."""
    return roughness
