"""Specular manifold walks (port of mitsuba_tpu/integrator/manifold.py;
Jakob & Marschner 2012, reference include/mitsuba/bidir/manifold.h:35,
src/libbidir/manifold.cpp): given a path segment start -> k specular
vertices -> endpoint, find the start direction whose deterministic
specular chain lands on a moved endpoint.

As in the reference port, the unknown is the 2D start direction and the
whole chain is re-traced per Newton iteration (a few batched `intersect`
calls); the 2x2 Jacobian comes from two forward-difference traces.  Every
walk runs a fixed number of iterations over all lanes; failures flag out.
The chain signature (reflect or refract per bounce) is static.  A walk
may run at a shutter `time` (the motion integrator re-solves a chain at
its target time); without one, animated and deformable shapes sit at the
shutter midpoint.
"""

from __future__ import annotations

import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.integrator.path import _offset_ray

REFLECT = 0
REFRACT = 1


def _refract_world(d, n, eta_rel):
    """Deterministic refraction of unit d through normal n with relative
    IOR eta_rel (int/ext); returns (d_out, tir_mask)."""
    cos_i = -mm.dot(d, n)
    entering = cos_i > 0
    n_or = torch.where(entering[..., None], n, -n)
    ci = torch.abs(cos_i)
    eta = torch.where(entering, 1.0 / eta_rel, eta_rel)
    sin2_t = eta * eta * (1.0 - ci * ci)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    d_out = eta[..., None] * d + (eta * ci - cos_t)[..., None] * n_or
    return mm.normalize(d_out), tir


def _norm2(e):
    """Length of [..., 2] vectors."""
    return torch.sqrt(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1])


def chain_trace(pack, o, d, signature, time=None):
    """Trace the start ray (o, d) deterministically through `signature`
    (a static tuple of REFLECT / REFRACT) specular bounces, then one more
    segment to the receiving surface, at the shutter `time` ([R] or None).
    Returns (p_end [R, 3], n_end [R, 3], ok [R])."""
    ok = torch.ones(o.shape[:1], dtype=torch.bool, device=o.device)
    for s in signature:
        its = fill_interaction(pack, o, d, intersect(pack, o, d, time=time))
        ok = ok & its.valid
        n = its.ns
        if s == REFLECT:
            d = mm.normalize(d - 2.0 * mm.dot(d, n)[..., None] * n)
        else:
            eta_rel = take_rows(pack.mat_eta, torch.clamp(its.mat, min=0))
            d, tir = _refract_world(d, n, eta_rel)
            ok = ok & ~tir
        o = _offset_ray(its.p, its.ng, d)
    its = fill_interaction(pack, o, d, intersect(pack, o, d, time=time))
    return its.p, its.ns, ok & its.valid


def newton_step(res, x, eps):
    """One damped Newton step on the 2D residual res(x) -> (e [R, 2], ok),
    with the Jacobian from forward differences and one backtracking
    halving (manifold.cpp's step-size control, simplified; reference
    manifold.py:107-128 and mut_manifold.py:272-291)."""
    e0, ok0 = res(x)
    ex, okx = res(x + torch.tensor([eps, 0.0], dtype=torch.float32, device=x.device))
    ey, oky = res(x + torch.tensor([0.0, eps], dtype=torch.float32, device=x.device))
    j00 = (ex[..., 0] - e0[..., 0]) / eps
    j10 = (ex[..., 1] - e0[..., 1]) / eps
    j01 = (ey[..., 0] - e0[..., 0]) / eps
    j11 = (ey[..., 1] - e0[..., 1]) / eps
    det = j00 * j11 - j01 * j10
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    dx0 = -(j11 * e0[..., 0] - j01 * e0[..., 1]) * inv_det
    dx1 = -(-j10 * e0[..., 0] + j00 * e0[..., 1]) * inv_det
    dx = torch.stack([dx0, dx1], dim=-1)
    ok = (ok0 & okx & oky)[..., None]
    x1 = x + torch.where(ok, dx, 0.0)
    e1, ok1 = res(x1)
    worse = ~ok1 | (_norm2(e1) > _norm2(e0))
    return torch.where(worse[..., None], x + torch.where(ok, 0.5 * dx, 0.0), x1)


def manifold_walk(pack, p_start, d0, signature, p_target, n_target, iters=16, fd_eps=1e-4,
                  time=None):
    """Newton walk: adjust the start direction until the specular chain's
    endpoint lands on p_target (measured in the target's tangent plane).
    Returns (d_solved [R, 3], err [R] the final tangent-plane distance,
    ok [R])."""
    fr_t = mm.Frame.from_normal(n_target)
    fr_d = mm.Frame.from_normal(d0)

    def residual(x):
        d = mm.normalize(d0 + x[..., 0:1] * fr_d.s + x[..., 1:2] * fr_d.t)
        p_end, _, ok = chain_trace(pack, p_start, d, signature, time=time)
        dp = p_end - p_target
        return torch.stack([mm.dot(dp, fr_t.s), mm.dot(dp, fr_t.t)], dim=-1), ok

    x = torch.zeros(p_start.shape[0], 2, dtype=torch.float32, device=p_start.device)
    for _ in range(iters):
        x = newton_step(residual, x, fd_eps)
    e, ok = residual(x)
    d_sol = mm.normalize(x[..., 0:1] * fr_d.s + x[..., 1:2] * fr_d.t + d0)
    return d_sol, _norm2(e), ok
