"""The manifold perturbation for MLT (port of
mitsuba_tpu/integrator/mut_manifold.py; Jakob & Marschner 2012, reference
include/mitsuba/bidir/mut_manifold.h:36, src/libbidir/mut_manifold.cpp).

The move targets paths camera - D - S..S - B - ..., where D is a
cosine-sampled (diffuse) vertex, S..S a chain of 1..KMAX delta vertices
(smooth conductor or dielectric) and B the first non-delta vertex after
the chain.  It perturbs the image-plane position (moving D across its
surface) and re-solves the delta chain with a batched Newton walk
(integrator/manifold.py, with per-lane reflect/refract signatures) so that
the chain still lands on B.  The solved direction at D is written back
into the chain's primary samples through the inverse cosine-hemisphere
warp, so the chain state stays a row of U.

Acceptance: the target transforms by the cosine pdf at D and the chain's
generalized geometric factor |det d(B offset)/d(direction)| (both
Jacobians by forward differences), so

    a = min(1, I'/I * (pdf'_cos / pdf_cos) * (|det J| / |det J'|)).

A proposal whose re-trace changes the structure (a lobe flips, the chain
escapes, the endpoint leaves B) is rejected.
"""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect
from mitsuba_tpu_torch.bsdf.eval import bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import CONDUCTOR, DIELECTRIC, DIFFUSE, ROUGHDIFFUSE
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import rng, warp
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.integrator.manifold import REFRACT, _norm2, _refract_world, newton_step
from mitsuba_tpu_torch.integrator.path import _offset_ray
from mitsuba_tpu_torch.integrator.pssmlt import _HEAD, _PER_DEPTH
from mitsuba_tpu_torch.scene.texture_eval import mip_footprint, shading_frame, shading_params
from mitsuba_tpu_torch.sensor.plugins import generate_rays

# the longest delta chain the mutation solves (caustic configurations are
# 1-4 bounces)
KMAX = 4


def trace_path_info(pack, integ, cam, w, h, U, dmax):
    """Re-trace the first `dmax` vertices of every chain's path with
    path_from_primary's decisions (the same dims of U, the same roulette)
    and record each vertex's geometry and lobe.  Returns a dict of
    [N, dmax(, 3)] tensors."""
    n = U.shape[0]
    dev = U.device
    present = pack.meta["present_types"]
    rr_depth = max(integ.rr_depth, 1)
    o, d = generate_rays(cam, U[:, 0:2], U[:, 2:4])

    thr = torch.ones(n, 3, dtype=torch.float32, device=dev)
    eta = torch.ones(n, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    rec = {k: [] for k in ("valid", "delta", "refract", "type", "p", "ns", "ng", "d_out",
                           "cos_o", "mat")}
    for depth in range(dmax):
        its = fill_interaction(pack, o, d, intersect(pack, o, d))
        found = its.valid & active
        frame = shading_frame(pack, its)
        wi_l = frame.to_local(its.wi_world)
        sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)
        base = _HEAD + _PER_DEPTH * depth
        u_b = U[:, base + 3:base + 6]
        bs = bsdf_sample(sp, wi_l, u_b[:, 0:2], u_b[:, 2], present)
        d_world = frame.to_world(bs.wo)
        rec["valid"].append(found)
        rec["delta"].append(bs.delta & found)
        rec["refract"].append((bs.wo[..., 2] * wi_l[..., 2]) < 0)
        rec["type"].append(_chain_type(sp))
        rec["p"].append(its.p)
        rec["ns"].append(frame.n)
        rec["ng"].append(its.ng)
        rec["d_out"].append(d_world)
        rec["cos_o"].append(bs.wo[..., 2])
        rec["mat"].append(its.mat)

        thr = thr * torch.where(found[..., None], bs.weight, 1.0)
        eta = eta * torch.where(found, bs.eta, 1.0)
        o_new = _offset_ray(its.p, its.ng, d_world)
        thr_max = thr.amax(dim=-1)
        active = found & (thr_max > 0)
        q = torch.clamp(thr_max * eta * eta, max=0.95)
        do_rr = depth + 1 >= rr_depth
        keep = U[:, base + 6] < q if do_rr else torch.ones_like(active)
        if do_rr:
            thr = torch.where(keep[..., None], thr / torch.clamp(q, min=1e-6)[..., None], thr)
        active = active & keep
        o = torch.where(active[..., None], o_new, o)
        d = torch.where(active[..., None], d_world, d)
    return {k: torch.stack(v, dim=1) for k, v in rec.items()}


def _chain_type(sp):
    """The lane's material type, -1 on mixture lanes, which sample a
    component by chance: the deterministic solve and inversion do not
    apply there (reference mut_manifold.py:107-110)."""
    if "mix" in sp:
        return torch.where(sp["mix"]["wb"] > 0, -1, sp["type"])
    return sp["type"]


def _at(x, idx):
    """x[lane, idx[lane]] of an [N, dmax(, 3)] record."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def classify(info, kmax=KMAX):
    """Find the D - S..S - B pattern per lane.  Returns a dict: elig [N],
    klen [N], sig [N, kmax] (REFLECT / REFRACT), the first vertex's p, ns,
    ng, outgoing direction and cosine, s1_p, b_p, b_n."""
    valid, delta, typ = info["valid"], info["delta"], info["type"]
    chain_t = (typ == CONDUCTOR) | (typ == DIELECTRIC)
    run = torch.ones(valid.shape[0], dtype=torch.bool, device=valid.device)
    klen = torch.zeros(valid.shape[0], dtype=torch.int32, device=valid.device)
    for i in range(1, kmax + 1):
        run = run & delta[:, i] & chain_t[:, i] & valid[:, i]
        klen = klen + run.to(torch.int32)
    b_idx = torch.clamp(1 + klen, max=valid.shape[1] - 1).to(torch.int64)

    cos0 = info["cos_o"][:, 0]
    elig = (valid[:, 0] & ((typ[:, 0] == DIFFUSE) | (typ[:, 0] == ROUGHDIFFUSE))
            & ~delta[:, 0] & (klen >= 1) & _at(valid, b_idx) & ~_at(delta, b_idx)
            & (cos0 > 1e-4))
    return dict(
        elig=elig,
        klen=klen,
        sig=info["refract"][:, 1:kmax + 1].to(torch.int32),
        p0=info["p"][:, 0],
        ns0=info["ns"][:, 0],
        ng0=info["ng"][:, 0],
        d0_out=info["d_out"][:, 0],
        cos0=cos0,
        s1_p=info["p"][:, 1],
        b_p=_at(info["p"], b_idx),
        b_n=_at(info["ns"], b_idx),
    )


def _chain_end(pack, p0, ng0, d, sig, klen, kmax):
    """Trace the delta chain deterministically from (p0, d) through each
    lane's signature, then one more segment to the receiver.  Returns
    (p_end, ok)."""
    o = _offset_ray(p0, ng0, d)
    ok = torch.ones(p0.shape[:1], dtype=torch.bool, device=p0.device)
    for i in range(kmax):
        live = i < klen
        its = fill_interaction(pack, o, d, intersect(pack, o, d))
        nsh = shading_frame(pack, its).n
        refl = mm.normalize(d - 2.0 * mm.dot(d, nsh)[..., None] * nsh)
        eta_rel = take_rows(pack.mat_eta, torch.clamp(its.mat, min=0))
        refr, tir = _refract_world(d, nsh, eta_rel)
        want_refr = sig[:, i] == REFRACT
        d_new = torch.where(want_refr[..., None], refr, refl)
        ok = ok & torch.where(live, its.valid & ~(want_refr & tir), True)
        o_new = _offset_ray(its.p, its.ng, d_new)
        o = torch.where(live[..., None], o_new, o)
        d = torch.where(live[..., None], d_new, d)
    its = fill_interaction(pack, o, d, intersect(pack, o, d))
    return its.p, ok & its.valid


def _residual(pack, p0, ng0, d, sig, klen, kmax, b_p, fr_t):
    p_end, ok = _chain_end(pack, p0, ng0, d, sig, klen, kmax)
    dp = p_end - b_p
    return torch.stack([mm.dot(dp, fr_t.s), mm.dot(dp, fr_t.t)], dim=-1), ok


def _fd_jacobian(pack, p0, ng0, d_c, sig, klen, kmax, b_p, fr_t, eps):
    """The forward-difference Jacobian of the tangent-plane endpoint offset
    with respect to 2D direction offsets around d_c.  Returns (e0, |det|,
    ok)."""
    fr_d = mm.Frame.from_normal(d_c)

    def ev(x0, x1):
        d = mm.normalize(d_c + x0 * fr_d.s + x1 * fr_d.t)
        return _residual(pack, p0, ng0, d, sig, klen, kmax, b_p, fr_t)

    e0, ok0 = ev(0.0, 0.0)
    ex, okx = ev(eps, 0.0)
    ey, oky = ev(0.0, eps)
    j00 = (ex[..., 0] - e0[..., 0]) / eps
    j10 = (ex[..., 1] - e0[..., 1]) / eps
    j01 = (ey[..., 0] - e0[..., 0]) / eps
    j11 = (ey[..., 1] - e0[..., 1]) / eps
    return e0, torch.abs(j00 * j11 - j01 * j10), ok0 & okx & oky


def solve_chain(pack, p0, ng0, d0, sig, klen, kmax, b_p, b_n, iters=8, eps=1e-4):
    """Newton-solve the start direction so that the chain lands on b_p.
    Returns (d_sol, err, det_J, ok); det_J is taken in a frame centred at
    the solution (isometric near zero, so comparable across lanes and
    states)."""
    fr_t = mm.Frame.from_normal(b_n)
    fr_d = mm.Frame.from_normal(d0)

    def res(x):
        d = mm.normalize(d0 + x[..., 0:1] * fr_d.s + x[..., 1:2] * fr_d.t)
        return _residual(pack, p0, ng0, d, sig, klen, kmax, b_p, fr_t)

    x = torch.zeros(p0.shape[0], 2, dtype=torch.float32, device=p0.device)
    for _ in range(iters):
        x = newton_step(res, x, eps)
    d_sol = mm.normalize(d0 + x[..., 0:1] * fr_d.s + x[..., 1:2] * fr_d.t)
    e0, det, ok = _fd_jacobian(pack, p0, ng0, d_sol, sig, klen, kmax, b_p, fr_t, eps)
    return d_sol, _norm2(e0), det, ok


def propose_manifold(pack, integ, cam, w, h, U, k, seed_mlt, lanes, kmax=KMAX):
    """The manifold proposal of every lane.  Returns (U_prop, corr, ok):
    corr = (pdf'_cos / pdf_cos) * (|det J| / |det J'|), the acceptance
    correction; a lane with ok False keeps its row of U and gets corr 0."""
    from mitsuba_tpu_torch.integrator.mlt import _perturb_lens

    dmax = kmax + 2
    c = classify(trace_path_info(pack, integ, cam, w, h, U, dmax), kmax)
    elig, klen, sig = c["elig"], c["klen"], c["sig"]
    tol = 1e-3 * (1.0 + mm.length(c["b_p"] - c["p0"]))

    # the current state's Jacobian (it lies on the constraint manifold)
    fr_t = mm.Frame.from_normal(c["b_n"])
    _, det_x, okx = _fd_jacobian(pack, c["p0"], c["ng0"], c["d0_out"], sig, klen, kmax,
                                 c["b_p"], fr_t, 1e-4)
    pdf_x = torch.clamp(c["cos0"], min=1e-6) / math.pi

    # the lens perturbation moves the first vertex to a'
    U_lens = _perturb_lens(U, w, h, rng.rand4(lanes, k, 11, seed_mlt))
    o_new, d_new = generate_rays(cam, U_lens[:, 0:2], U_lens[:, 2:4])
    its0 = fill_interaction(pack, o_new, d_new, intersect(pack, o_new, d_new))
    frame0 = shading_frame(pack, its0)
    typ0 = _chain_type(shading_params(pack, its0.mat, its0.uv, mip_footprint(pack, its0),
                                      its=its0))
    ok_a = its0.valid & ((typ0 == DIFFUSE) | (typ0 == ROUGHDIFFUSE))

    # solve the chain from a' to the old endpoint b
    d0 = mm.normalize(c["s1_p"] - its0.p)
    d_sol, err, det_y, ok_w = solve_chain(pack, its0.p, its0.ng, d0, sig, klen, kmax,
                                          c["b_p"], c["b_n"])
    cos_y = mm.dot(d_sol, frame0.n)
    pdf_y = torch.clamp(cos_y, min=1e-6) / math.pi
    ok = (elig & okx & ok_a & ok_w & (err < tol) & (cos_y > 1e-4)
          & (det_x > 1e-12) & (det_y > 1e-12))

    # write the solved direction back as primary samples
    U_prop = U_lens.clone()
    U_prop[:, _HEAD + 3:_HEAD + 5] = warp.cosine_hemisphere_to_square(frame0.to_local(d_sol))
    U_prop = torch.where(ok[:, None], U_prop, U)

    # the proposal's structure: the same chain, landing on b
    cp = classify(trace_path_info(pack, integ, cam, w, h, U_prop, dmax), kmax)
    sig_pos = torch.arange(kmax, device=U.device)[None, :] < klen[:, None]
    ok = (ok & cp["elig"] & (cp["klen"] == klen)
          & ((cp["sig"] == sig) | ~sig_pos).all(dim=-1)
          & (mm.length(cp["b_p"] - c["b_p"]) < 4.0 * tol))
    corr = torch.where(ok, (pdf_y / pdf_x) * (det_x / det_y), 0.0)
    return torch.where(ok[:, None], U_prop, U), corr, ok
