"""Square-to-X sampling warps (port of mitsuba_tpu/core/warp.py, the
warps on the path and volumetric path tracers' main paths)."""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(s):
    z = 1.0 - 2.0 * s[..., 1]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * s[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_disk_concentric(s):
    """Shirley-Chiu concentric disk mapping."""
    r1 = 2.0 * s[..., 0] - 1.0
    r2 = 2.0 * s[..., 1] - 1.0
    use_r1 = torch.abs(r1) > torch.abs(r2)
    r = torch.where(use_r1, r1, r2)
    safe_den = torch.where(r == 0.0, 1.0, r)
    phi = torch.where(
        use_r1,
        (math.pi / 4.0) * (r2 / safe_den),
        (math.pi / 2.0) - (math.pi / 4.0) * (r1 / safe_den),
    )
    phi = torch.where(r == 0.0, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_cosine_hemisphere(s):
    p = square_to_uniform_disk_concentric(s)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    z = torch.clamp(z, min=1e-10)  # avoid exactly grazing directions
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp(d[..., 2], min=0.0) * INV_PI


def square_to_uniform_triangle(s):
    """Barycentric warp (a = 1 - sqrt(u1), b = u2 sqrt(u1))."""
    t = safe_sqrt(s[..., 0])
    return torch.stack([1.0 - t, t * s[..., 1]], dim=-1)


def square_to_std_normal(s):
    """Box-Muller transform to a 2D standard normal."""
    r = torch.sqrt(
        -2.0 * torch.log(torch.clamp(1.0 - s[..., 0], min=1e-38))
    )
    phi = 2.0 * math.pi * s[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_tent(s):
    """1D tent over [-1, 1] applied per component."""
    return torch.where(
        s < 0.5,
        torch.sqrt(2.0 * s) - 1.0,
        1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * s, min=0.0)),
    )


def square_to_phase_hg(s, g):
    """Henyey-Greenstein phase direction around +z (forward = +z);
    reference src/phase/hg.cpp sample().  g: float or tensor."""
    g = torch.as_tensor(g, dtype=s.dtype, device=s.device)
    iso = torch.abs(g) < 1e-4
    den = 1.0 - g + 2.0 * g * s[..., 0]
    sqr = (1.0 - g * g) / torch.where(torch.abs(den) < 1e-10, 1e-10, den)
    cos_theta_hg = (1.0 + g * g - sqr * sqr) / torch.where(iso, 1.0, 2.0 * g)
    cos_theta = torch.where(iso, 1.0 - 2.0 * s[..., 0], cos_theta_hg)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * math.pi * s[..., 1]
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def square_to_phase_hg_pdf(cos_theta, g):
    g = torch.as_tensor(g, dtype=cos_theta.dtype, device=cos_theta.device)
    tmp = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.clamp(tmp * safe_sqrt(tmp), min=1e-20)
