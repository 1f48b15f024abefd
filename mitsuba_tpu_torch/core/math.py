"""Vector math on trailing-dimension tensors (port of
mitsuba_tpu/core/math.py, the subset the path tracer and the ported
BSDFs use).  A "vector" is a tensor whose last axis has size 3."""

from __future__ import annotations

import torch

ONE_MINUS_EPS = 0.99999994  # largest float32 < 1


def dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-30))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def sign(x):
    """Sign that never returns 0 (1 for x >= 0)."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def coordinate_system(n):
    """Orthonormal (s, t) around unit normal n (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = sign(nz)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t1, t2


class Frame:
    """Shading frame (s, t, n), each [..., 3]; local z = normal."""

    def __init__(self, s, t, n):
        self.s, self.t, self.n = s, t, n

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v):
        return torch.stack(
            [dot(v, self.s), dot(v, self.t), dot(v, self.n)], dim=-1
        )

    def to_world(self, v):
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )


def cos_theta(w):
    return w[..., 2]


def cos_theta2(w):
    return w[..., 2] * w[..., 2]


def sin_theta2(w):
    return torch.clamp(1.0 - w[..., 2] * w[..., 2], min=0.0)


def sin_theta(w):
    return torch.sqrt(sin_theta2(w))


def tan_theta(w):
    return sin_theta(w) / torch.where(w[..., 2] == 0.0, 1e-20, w[..., 2])


def tan_theta2(w):
    c2 = cos_theta2(w)
    return torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-20)


def sin_phi_cos_phi(w):
    st = sin_theta(w)
    inv = torch.where(st == 0.0, 0.0, 1.0 / torch.clamp(st, min=1e-20))
    cp = torch.clamp(w[..., 0] * inv, -1.0, 1.0)
    sp = torch.clamp(w[..., 1] * inv, -1.0, 1.0)
    # degenerate (normal incidence): phi = 0
    cp = torch.where(st == 0.0, 1.0, cp)
    sp = torch.where(st == 0.0, 0.0, sp)
    return sp, cp


# --- reflection / refraction / Fresnel (reference src/libcore/util.cpp) ----

def reflect_local(wi):
    """Mirror reflection in the local frame (around +z)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def refract_local(wi, eta):
    """Refract in the local frame; eta = int_ior / ext_ior.  Returns (wo,
    total internal reflection mask, eta_rel), eta_rel being the relative
    index crossed (eta entering, 1/eta exiting)."""
    ci = cos_theta(wi)
    eta_rel = torch.where(ci > 0.0, eta, 1.0 / eta)
    inv_eta = 1.0 / eta_rel
    sin2_t = sin_theta2(wi) * inv_eta * inv_eta
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - sin2_t) * -sign(ci)
    wo = torch.stack([-wi[..., 0] * inv_eta, -wi[..., 1] * inv_eta, ct], dim=-1)
    return wo, tir, eta_rel


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel reflectance, either side by the sign
    of cos_theta_i (fresnelDielectricExt).  Returns (F, signed
    cos_theta_t, eta_rel); F = 1 under total internal reflection."""
    eta_rel = torch.where(cos_theta_i > 0.0, eta, 1.0 / eta)
    ci = torch.abs(cos_theta_i)
    sin2_t = (1.0 - ci * ci) / (eta_rel * eta_rel)
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - sin2_t)
    rs = (ci - eta_rel * ct) / torch.clamp(ci + eta_rel * ct, min=1e-20)
    rp = (eta_rel * ci - ct) / torch.clamp(eta_rel * ci + ct, min=1e-20)
    F = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    cos_theta_t = torch.where(tir, 0.0, -sign(cos_theta_i) * ct)
    return F, cos_theta_t, eta_rel


def fresnel_conductor(cos_theta_i, eta, k):
    """Exact unpolarized conductor Fresnel (fresnelConductorExact);
    cos_theta_i [...], eta and k [..., C] -> [..., C]."""
    ci = torch.abs(cos_theta_i)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta):
    """Average Fresnel reflectance for internal scattering (the fitted
    polynomials of fresnelDiffuseReflectance: Egan & Hilgeman 1973 below
    eta = 1, d'Eon & Irving 2011 above)."""
    eta = torch.as_tensor(eta)
    lt1 = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / eta
    ie = 1.0 / eta
    gt1 = (0.919317 - 3.4793 * ie + 6.75335 * ie**2 - 7.80989 * ie**3
           + 4.98554 * ie**4 - 1.36881 * ie**5)
    return torch.where(eta < 1.0, lt1, gt1)
