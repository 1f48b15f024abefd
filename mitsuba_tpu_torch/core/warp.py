"""Square-to-X sampling warps (port of mitsuba_tpu/core/warp.py, the
warps on the path tracer's main path)."""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi


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
