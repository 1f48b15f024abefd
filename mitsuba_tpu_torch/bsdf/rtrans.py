"""Rough dielectric transmittance tables (port of
mitsuba_tpu/bsdf/rtrans.py; numpy in float64 with the same seeded draws,
so the fitted coefficients are the reference's bit for bit).

Rebuild of the reference's RoughTransmittance precomputation
(reference: include/mitsuba/render/rtrans.h:44-186 — the reference
ships 25 MB of precomputed `data/microfacet/*.dat` spline tables; here
the tables are Monte-Carlo precomputed at scene-pack time for exactly
the (distribution, alpha, eta) tuples the scene uses, then fitted with
a cubic in cos(theta) so the device-side evaluation is four fused
coefficients instead of a per-lane spline table gather).

T(cos_i; alpha, eta) = total energy transmitted through a rough
dielectric microfacet interface = int BTDF(wi -> wo) |cos_o| dwo,
estimated by importance-sampling the visible-normal-ish distribution
D(m) cos(m) (Walter et al. 2007 weights).
"""

from __future__ import annotations

import numpy as np

BECKMANN, GGX, PHONG = 0, 1, 2


def _sample_m(dist, alpha, u1, u2):
    phi = 2 * np.pi * u2
    if dist == GGX:
        t2 = alpha * alpha * u1 / np.maximum(1.0 - u1, 1e-12)
    elif dist == PHONG:
        e = 2.0 / (alpha * alpha) - 2.0
        ct = np.power(u1, 1.0 / (e + 2.0))
        t2 = np.maximum(1.0 - ct * ct, 0.0) / np.maximum(ct * ct, 1e-12)
    else:  # BECKMANN
        t2 = -alpha * alpha * np.log(np.maximum(1.0 - u1, 1e-12))
    ct = 1.0 / np.sqrt(1.0 + t2)
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)


def _smith_g1(dist, alpha, v, m):
    cos_v = np.abs(v[..., 2])
    tan_v = np.sqrt(np.maximum(1.0 - cos_v**2, 0.0)) / np.maximum(
        cos_v, 1e-12
    )
    ok = np.sum(v * m, -1) * v[..., 2] > 0
    if dist == GGX:
        g = 2.0 / (1.0 + np.sqrt(1.0 + (alpha * tan_v) ** 2))
    else:
        a = 1.0 / np.maximum(alpha * tan_v, 1e-12)
        g = np.where(
            a < 1.6,
            (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a),
            1.0,
        )
    return np.where(ok, g, 0.0)


def _fresnel(cos_i, eta):
    """Dielectric Fresnel reflectance for cos_i > 0 entering eta."""
    cos_i = np.clip(cos_i, 0.0, 1.0)
    sin_t2 = (1.0 / eta) ** 2 * (1.0 - cos_i**2)
    tir = sin_t2 >= 1.0
    cos_t = np.sqrt(np.maximum(1.0 - sin_t2, 0.0))
    rs = (cos_i - eta * cos_t) / np.maximum(cos_i + eta * cos_t, 1e-12)
    rp = (eta * cos_i - cos_t) / np.maximum(eta * cos_i + cos_t, 1e-12)
    return np.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))


def rough_transmittance(dist, alpha, eta, cos_i, n_samples=8192, seed=7):
    """MC estimate of T(cos_i) for each entry of cos_i [N]."""
    rng = np.random.default_rng(seed)
    cos_i = np.asarray(cos_i, np.float64)
    n = len(cos_i)
    u1 = rng.uniform(size=(n, n_samples))
    u2 = rng.uniform(size=(n, n_samples))
    m = _sample_m(dist, alpha, u1, u2)  # [N, S, 3]
    si = np.sqrt(np.maximum(1.0 - cos_i**2, 0.0))
    wi = np.stack([si, np.zeros_like(si), cos_i], -1)[:, None, :]
    wih = np.sum(wi * m, -1)
    F = _fresnel(np.abs(wih), eta)
    # refracted direction about m (Walter eq. 40); eta = int/ext ratio
    inv_eta = 1.0 / eta
    c = np.abs(wih)
    ct_t2 = 1.0 - (1.0 - c * c) * inv_eta * inv_eta
    valid = (ct_t2 > 0) & (wih > 0)
    ct_t = np.sqrt(np.maximum(ct_t2, 0.0))
    m_s = m * np.sign(wih)[..., None]
    wo = -wi * inv_eta + (inv_eta * c - ct_t)[..., None] * m_s
    wo /= np.maximum(np.linalg.norm(wo, axis=-1, keepdims=True), 1e-12)
    # Walter importance weight for m ~ D(m)cos(m):
    #   w = |wi.m| G(wi, wo, m) / (cos_i cos_m)
    g = _smith_g1(dist, alpha, wi * np.ones_like(m), m) * _smith_g1(
        dist, alpha, wo, m
    )
    w = (
        np.abs(wih) * g
        / np.maximum(cos_i[:, None] * np.abs(m[..., 2]), 1e-12)
    )
    t = np.where(valid, (1.0 - F) * w, 0.0)
    return np.clip(t.mean(axis=1), 0.0, 1.0)


def fit_rtrans_poly(dist, alpha, eta, n_cos=24):
    """Cubic fit of T(cos_i) on [0, 1] + the cosine-weighted average
    (the reference's evalDiffuse, rtrans.h:128).

    Returns (coeffs[4] highest-first for np.polyval, t_diffuse)."""
    cos_i = np.linspace(0.05, 1.0, n_cos)
    t = rough_transmittance(dist, alpha, eta, cos_i)
    coeffs = np.polyfit(cos_i, t, 3)
    # diffuse (cosine-weighted) transmittance: 2 int T(c) c dc
    t_diff = float(2.0 * np.trapezoid(t * cos_i, cos_i))
    return coeffs.astype(np.float32), t_diff
