"""Square-to-X sampling warps (port of mitsuba_tpu/core/warp.py, the
warps of the path, volumetric path, bidirectional and particle tracers,
and the concentric inverse the manifold perturbation writes back with)."""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(s):
    z = 1.0 - 2.0 * s[..., 1]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * s[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_cone(s, cos_cutoff):
    """Uniform direction in a cone around +z with cos(angle) >= cos_cutoff
    (a tensor broadcasting against s[..., 0])."""
    z = 1.0 - s[..., 0] * (1.0 - cos_cutoff)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * s[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_cone_pdf(cos_cutoff):
    return INV_TWOPI / (1.0 - cos_cutoff)


def square_to_uniform_disk(s):
    r = torch.sqrt(s[..., 0])
    phi = 2.0 * math.pi * s[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


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


def uniform_disk_concentric_to_square(p):
    """Inverse of the Shirley-Chiu concentric mapping: disk point [..., 2]
    -> uniform square sample [..., 2] (the manifold perturbation writes a
    solved direction back into primary-sample space with it)."""
    x, y = p[..., 0], p[..., 1]
    rr = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)  # (-pi, pi]
    q = math.pi / 4.0
    abs_t = torch.abs(theta)
    # wedge 1: |theta| <= pi/4 (r1 = +r); wedge 2: pi/4 < theta < 3pi/4
    # (r2 = +r); wedge 3: |theta| >= 3pi/4 (r1 = -r); wedge 4: the rest
    # (r2 = -r)
    r1_a, r2_a = rr, rr * theta / q
    r2_b, r1_b = rr, (math.pi / 2.0 - theta) * rr / q
    phi_c = theta - torch.sign(theta) * math.pi
    r1_c, r2_c = -rr, -rr * phi_c / q
    phi_d = theta + math.pi
    r2_d, r1_d = -rr, (math.pi / 2.0 - phi_d) * (-rr) / q

    in1 = abs_t <= q
    in2 = (theta > q) & (theta < 3.0 * q)
    in3 = abs_t >= 3.0 * q
    r1 = torch.where(in1, r1_a, torch.where(in2, r1_b, torch.where(in3, r1_c, r1_d)))
    r2 = torch.where(in1, r2_a, torch.where(in2, r2_b, torch.where(in3, r2_c, r2_d)))
    u = torch.stack([(r1 + 1.0) * 0.5, (r2 + 1.0) * 0.5], dim=-1)
    return torch.clamp(u, 0.0, 1.0 - 1e-7)


def cosine_hemisphere_to_square(d):
    """Inverse of square_to_cosine_hemisphere for d with d_z >= 0."""
    return uniform_disk_concentric_to_square(d[..., 0:2])


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
