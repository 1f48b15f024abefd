"""Medium sampling over lanes (port of mitsuba_tpu/medium/eval.py):
distance sampling, transmittance and the phase functions, the fiber
phases (kkay, microflake) among them, which read the orientation volume
at the event's position.

Homogeneous media sample free paths in closed form (reference
src/medium/homogeneous.cpp:149-330: channel balance, a fixed density,
or the maximum of exponentials, all wrapped by the medium sampling
weight).  Heterogeneous media track through the corner-packed density
grid with supergrid majorants (reference heterogeneous.cpp:172, Woodcock
/ delta tracking; ratio tracking or composite Simpson for transmittance).
`med` is the per-lane medium id; -1 is vacuum (no interaction,
transmittance 1), and every gather clamps it as the reference does.

The tracking keeps the reference's batch of TRACK_BATCH candidates per
iteration and its RNG slot layout, which decide the random numbers each
lane draws; the reference's `while any(alive)` becomes a host loop over
the lanes still alive (core/lanes.py), as Simpson transmittance runs on
the lanes in a heterogeneous medium: the reference computes every lane
(fixed shapes on the TPU), and each lane's result is the same either way.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.core import lanes, rng, warp
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.lanes import LiveLanes
from mitsuba_tpu_torch.core.gather import take_fused
from mitsuba_tpu_torch.medium.plugins import HG, KKAY, MICROFLAKE, RAYLEIGH

INV_FOURPI = 0.25 / math.pi
MAX_TRACKING_STEPS = 256  # total tentative collisions (RNG slot space)
# tentative collisions per tracking iteration (the reference's knob: it
# fixes which random numbers a lane draws)
TRACK_BATCH = int(os.environ.get("MTS_TRACK_BATCH", 4))
# composite-Simpson intervals of method="simpson" transmittance
QUAD_STEPS = int(os.environ.get("MTS_QUAD_STEPS", 32))


class MediumSample(NamedTuple):
    is_medium: torch.Tensor  # [R] bool, scattered inside the medium
    t: torch.Tensor  # [R] sampled distance (== t_max on failure)
    weight: torch.Tensor  # [R, 3] throughput factor (both outcomes)


def _het_params(pack, med):
    """Per-lane heterogeneous-grid descriptors: slot -1 where the lane's
    medium is vacuum or homogeneous."""
    m = torch.clamp(med, min=0)
    slot = torch.where(med >= 0, pack.med_het_slot[m], -1)
    w2g, albedo, dims, sdims, cbase, sbase = take_fused(
        torch.clamp(slot, min=0), pack.het_w2g, pack.het_albedo, pack.het_dims,
        pack.het_sdims, pack.het_cbase, pack.het_sbase,
    )
    return {
        "slot": slot,
        "w2g": w2g,  # [R, 12] row-major 3x4
        "albedo": albedo,
        "dims": dims.to(torch.float32),  # [R, 3] (D, H, W)
        "sdims": sdims,
        "cbase": cbase,
        "sbase": sbase,
    }


def _to_grid(hp, p):
    """World position -> grid-normalized q in [0, 1]^3."""
    w = hp["w2g"]
    x = w[..., 0] * p[..., 0] + w[..., 1] * p[..., 1] + w[..., 2] * p[..., 2] + w[..., 3]
    y = w[..., 4] * p[..., 0] + w[..., 5] * p[..., 1] + w[..., 6] * p[..., 2] + w[..., 7]
    z = w[..., 8] * p[..., 0] + w[..., 9] * p[..., 1] + w[..., 10] * p[..., 2] + w[..., 11]
    return torch.stack([x, y, z], dim=-1)


def _to_grid_dir(hp, d):
    w = hp["w2g"]
    x = w[..., 0] * d[..., 0] + w[..., 1] * d[..., 1] + w[..., 2] * d[..., 2]
    y = w[..., 4] * d[..., 0] + w[..., 5] * d[..., 1] + w[..., 6] * d[..., 2]
    z = w[..., 8] * d[..., 0] + w[..., 9] * d[..., 1] + w[..., 10] * d[..., 2]
    return torch.stack([x, y, z], dim=-1)


def _het_density_q(pack, hp, q):
    """Trilinear density at grid-normalized q: one corner-row gather
    (reference gridvolume.cpp lookupFloat), interpolated along x, then y,
    then z.  0 outside the grid."""
    d_, h_, w_ = hp["dims"][..., 0], hp["dims"][..., 1], hp["dims"][..., 2]
    fx = q[..., 0] * w_ - 0.5
    fy = q[..., 1] * h_ - 0.5
    fz = q[..., 2] * d_ - 0.5
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    ax, ay, az = fx - x0, fy - y0, fz - z0
    inb = ((x0 >= -1.0) & (x0 <= w_ - 1.0) & (y0 >= -1.0) & (y0 <= h_ - 1.0)
           & (z0 >= -1.0) & (z0 <= d_ - 1.0))
    xi = torch.clamp(torch.minimum(x0, w_ - 1.0), min=-1.0) + 1.0
    yi = torch.clamp(torch.minimum(y0, h_ - 1.0), min=-1.0) + 1.0
    zi = torch.clamp(torch.minimum(z0, d_ - 1.0), min=-1.0) + 1.0
    cell = hp["cbase"] + ((zi * (h_ + 1.0) + yi) * (w_ + 1.0) + xi).to(torch.int32)
    n = pack.het_corners.shape[0]
    c8 = pack.het_corners[torch.clamp(cell, 0, n - 1)].to(torch.float32)  # [..., 8]
    bx, by = ax[..., None], ay[..., None]
    c_y = c8[..., 0::2] * (1 - bx) + c8[..., 1::2] * bx  # [..., 4] (z, y)
    c_z = c_y[..., 0::2] * (1 - by) + c_y[..., 1::2] * by  # [..., 2] (z)
    dens = c_z[..., 0] * (1 - az) + c_z[..., 1] * az
    return torch.where(inb, dens, 0.0)


def _super_lookup(pack, hp, q, b):
    """Local majorant and the supercell's bounds at grid-normalized q:
    (sigma [R], lo_q [R, 3], hi_q [R, 3])."""
    dims = hp["dims"]
    s_d, s_h, s_w = hp["sdims"][..., 0], hp["sdims"][..., 1], hp["sdims"][..., 2]

    def cell(g, n):
        i = torch.floor(g / b).to(torch.int32)
        return torch.minimum(torch.clamp(i, min=0), n - 1)

    sx = cell(q[..., 0] * dims[..., 2], s_w)
    sy = cell(q[..., 1] * dims[..., 1], s_h)
    sz = cell(q[..., 2] * dims[..., 0], s_d)
    scell = hp["sbase"] + (sz * s_h + sy) * s_w + sx
    n = pack.het_super.shape[0]
    sig = pack.het_super[torch.clamp(scell, 0, n - 1)]
    lo = torch.stack([sx.float() * b / dims[..., 2], sy.float() * b / dims[..., 1],
                      sz.float() * b / dims[..., 0]], dim=-1)
    hi = torch.stack([(sx + 1).float() * b / dims[..., 2], (sy + 1).float() * b / dims[..., 1],
                      (sz + 1).float() * b / dims[..., 0]], dim=-1)
    return sig, lo, hi


def _slab(qo, qd, lo, hi):
    """Ray-box slab test in grid coordinates: (t_enter, t_exit)."""
    inv = 1.0 / torch.where(torch.abs(qd) < 1e-12, 1e-12, qd)
    t0 = (lo - qo) * inv
    t1 = (hi - qo) * inv
    return torch.minimum(t0, t1).amax(dim=-1), torch.maximum(t0, t1).amin(dim=-1)


def _cumsum(x):
    """Prefix sums along the last (short) axis, added in order: the same
    float32 sums on every device (torch's CPU cumsum accumulates in
    double, and its GPU scan of a short innermost axis is slow)."""
    acc = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        acc.append(acc[-1] + x[..., j])
    return torch.stack(acc, dim=-1)


def _expand(hp):
    """Descriptors broadcast over a trailing candidate axis."""
    return {k: v[:, None] if v.dim() == 1 else v[:, None, :] for k, v in hp.items()}


def _het_track(pack, hp, o, d, t_max, lane, sidx, slot, seed_t, ratio):
    """Supergrid-DDA delta tracking (reference eval.py:167-300), shared by
    distance sampling (ratio=False: stop at the first real collision) and
    ratio-tracking transmittance (ratio=True).  Each iteration draws
    TRACK_BATCH tentative collisions in the current supercell, from RNG
    slots slot * MAX_TRACKING_STEPS + (2 * step + base) * n4 + j.

    The iterations run on the lanes still alive (`LiveLanes`).  Returns (t, hit_real,
    w_ratio)."""
    r = o.shape[0]
    dev = o.device
    b = float(pack.meta["het_super_b"])
    k = TRACK_BATCH
    qo = _to_grid(hp, o)
    qd = _to_grid_dir(hp, d)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    tn, tf = _slab(qo, qd, torch.zeros_like(qo), torch.ones_like(qo))
    t = torch.clamp(tn, min=0.0)  # entering the grid's box
    alive = (hp["slot"] >= 0) & (tf > t) & (t < t_max)
    hit_real = torch.zeros(r, dtype=torch.bool, device=dev)
    w = torch.ones(r, dtype=torch.float32, device=dev)
    out = (t, hit_real, w)  # every lane's result, written back at each exit check
    t_lim = torch.minimum(t_max, tf)
    # boundary-crossing epsilon: a small fraction of one supercell
    cell_t = b / torch.clamp((torch.abs(qd) * hp["dims"].flip(-1)).amax(dim=-1), min=1e-12)
    eps_t = 1e-3 * cell_t
    lane = torch.as_tensor(lane, device=dev).expand(r)
    sidx = torch.as_tensor(sidx, device=dev).expand(r)
    n4 = (k + 3) // 4  # rand4 draws per batch of jumps (and of acceptances)
    slots = torch.arange(2 * n4, device=dev)  # (base, j) -> base * n4 + j
    live = LiveLanes(r, dev)
    for step in range(MAX_TRACKING_STEPS // k):
        if step % lanes.EXIT_CHECK_EVERY == 0:
            live.write(out, (t, hit_real, w))
            sub = live.narrow(alive, alive, t, hit_real, w, qo, qd, t_lim, eps_t, lane, sidx, hp)
            if sub is None:
                break
            alive, t, hit_real, w, qo, qd, t_lim, eps_t, lane, sidx, hp = sub
            hp_k = _expand(hp)
        # the jump and acceptance uniforms of the batch, drawn in one call
        u = rng.rand4(lane[:, None], sidx[:, None],
                      slot * MAX_TRACKING_STEPS + 2 * step * n4 + slots, seed_t)
        u = u.reshape(-1, 2, 4 * n4)
        u_jump, u_acc = u[:, 0, :k], u[:, 1, :k]  # [R, K]
        sig, lo, hi = _super_lookup(pack, hp, qo + qd * t[..., None], b)
        # the local majorant bounds the density only inside this
        # supercell: candidates past its boundary are free flights
        t_exit = torch.maximum(_slab(qo, qd, lo, hi)[1], t)
        delta = -torch.log(torch.clamp(1.0 - u_jump, min=1e-20)) / torch.clamp(
            sig, min=1e-20)[..., None]
        t_c = t[..., None] + _cumsum(delta)  # K cumulative jumps [R, K]
        in_cell = (sig > 0.0)[..., None] & (t_c <= t_exit[..., None]) & (t_c < t_lim[..., None])
        q_c = qo[:, None, :] + qd[:, None, :] * t_c[..., None]  # [R, K, 3]
        frac = _het_density_q(pack, hp_k, q_c) / torch.clamp(sig, min=1e-20)[..., None]
        all_in = in_cell[..., k - 1]
        if ratio:
            # every in-cell candidate is a null collision
            mult = torch.where(in_cell, torch.clamp(1.0 - frac, min=0.0), 1.0)
            w = torch.where(alive, w * torch.prod(mult, dim=-1), w)
            t_new = torch.where(all_in, t_c[..., k - 1], t_exit + eps_t)
            beyond = t_new >= t_lim
            alive_next = alive & ~beyond & (w > 1e-5)
        else:
            real_k = in_cell & (u_acc < frac)
            any_real = real_k.any(dim=-1)
            # the first real candidate (argmax returns the first maximum)
            first = torch.argmax(real_k.to(torch.uint8), dim=-1, keepdim=True)
            t_new = torch.where(
                any_real, t_c.gather(-1, first)[..., 0],
                torch.where(all_in, t_c[..., k - 1], t_exit + eps_t),
            )
            beyond = t_new >= t_lim
            hit_real = hit_real | (alive & any_real & ~beyond)
            alive_next = alive & ~beyond & ~any_real
        t = torch.where(alive, torch.minimum(t_new, t_lim), t)
        alive = alive_next
    else:
        live.write(out, (t, hit_real, w))
    return out


def sample_distance(pack, med, o, d, t_max, u3, lane, sidx, slot, seed):
    """Sample a scattering distance along each lane's ray (reference
    eval.py:303-452): homogeneous media in closed form under their
    strategy, heterogeneous media by delta tracking (weight = albedo at a
    real collision, 1 otherwise)."""
    r = med.shape[0]
    dev = med.device
    in_medium = med >= 0
    m = torch.clamp(med, min=0)
    sigma_s = pack.med_sigma_s[m]
    sigma_t = sigma_s + pack.med_sigma_a[m]
    # the medium sampling weight: the probability of attempting a
    # medium event at all (homogeneous.cpp:168-181, :280)
    w_med = pack.med_sampling_w[m]
    strategies = pack.meta.get("hom_strategies", (0,))
    attempt = u3[..., 0] < w_med
    u_resc = torch.clamp(u3[..., 0] / torch.clamp(w_med, min=1e-8), 0.0, mm.ONE_MINUS_EPS)
    # balance: an exponential with a uniformly picked channel's rate
    ch = torch.clamp((u_resc * 3).to(torch.int64), max=2)
    st_c = sigma_t.gather(-1, ch[..., None])[..., 0]
    strat = pack.med_strategy[m]
    if 1 in strategies:  # single / manual: one fixed rate
        st_c = torch.where(strat == 1, pack.med_density[m], st_c)
    t_h = -torch.log(torch.clamp(1.0 - u3[..., 1], min=1e-20)) / torch.clamp(st_c, min=1e-20)
    if 2 in strategies:
        # maximum of exponentials: pick the dominating interval by its
        # CDF, then invert that interval's exponential (maxexp.h:60-74)
        mxs, mxi, mxc, mxn = (pack.med_mx_sigma[m], pack.med_mx_istart[m],
                              pack.med_mx_cdf[m], pack.med_mx_norm[m])
        u1 = torch.clamp(u3[..., 1], 0.0, mm.ONE_MINUS_EPS)
        idx = (u1[..., None] >= mxc[..., 1:3]).sum(dim=-1, keepdim=True)
        s_i = mxs.gather(-1, idx)[..., 0]
        i_i = mxi.gather(-1, idx)[..., 0]
        c_i = mxc.gather(-1, idx)[..., 0]
        arg = torch.exp(-i_i * s_i) - mxn * (u1 - c_i)
        t_mx = -torch.log(torch.clamp(arg, min=1e-30)) / torch.clamp(s_i, min=1e-20)
        t_h = torch.where(strat == 2, t_mx, t_h)
        st_c = torch.where(strat == 2, s_i, st_c)

    t_max_b = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    success_h = attempt & (t_h < t_max_b) & (st_c > 0)
    t_h = torch.where(success_h, t_h, t_max_b)
    tr_t = torch.exp(-sigma_t * t_h[..., None])
    tr_max = torch.exp(-sigma_t * t_max_b[..., None])
    # balance pdfs: the mean over the channels
    pdf_success = torch.mean(sigma_t * tr_t, dim=-1)
    pdf_failure_g = torch.mean(tr_max, dim=-1)
    if 1 in strategies:
        dens = pack.med_density[m]
        pdf_success = torch.where(strat == 1, dens * torch.exp(-dens * t_h), pdf_success)
        pdf_failure_g = torch.where(strat == 1, torch.exp(-dens * t_max_b), pdf_failure_g)
    if 2 in strategies:
        # pdf(t) = s_k e^{-s_k t} / Z on the interval holding t; the
        # failure pdf is 1 - CDF(t_max) (maxexp.h:77-97)
        def mx_pdf_cdf(t):
            k = (t[..., None] >= mxi[..., 1:3]).sum(dim=-1, keepdim=True)
            s_k = mxs.gather(-1, k)[..., 0]
            c_k = mxc.gather(-1, k)[..., 0]
            s_km1 = mxs.gather(-1, torch.clamp(k - 1, min=0))[..., 0]
            k = k[..., 0]
            lower = torch.where(
                k == 0, -1.0,
                -torch.pow(
                    s_k / torch.clamp(s_km1, min=1e-20),
                    -s_k / torch.where(torch.abs(s_k - s_km1) > 1e-20, s_k - s_km1, 1.0),
                ),
            )
            upper = -torch.exp(-s_k * t)
            pdf = s_k * torch.exp(-s_k * t) / torch.clamp(mxn, min=1e-20)
            cdf = c_k + (upper - lower) / torch.clamp(mxn, min=1e-20)
            return pdf, cdf

        ps_mx, _ = mx_pdf_cdf(t_h)
        _, cdf_max = mx_pdf_cdf(t_max_b)
        pdf_success = torch.where(strat == 2, ps_mx, pdf_success)
        pdf_failure_g = torch.where(strat == 2, torch.clamp(1.0 - cdf_max, 0.0, 1.0),
                                    pdf_failure_g)

    pdf_success = w_med * pdf_success
    pdf_failure = (1.0 - w_med) + w_med * pdf_failure_g
    w_success = sigma_s * tr_t / torch.clamp(pdf_success, min=1e-20)[..., None]
    w_failure = tr_max / torch.clamp(pdf_failure, min=1e-20)[..., None]
    w_h = torch.where(success_h[..., None], w_success, w_failure)
    out_t = torch.where(in_medium & success_h, t_h, t_max_b)
    out_w = torch.where(in_medium[..., None], w_h, 1.0)
    out_med = in_medium & success_h

    if pack.meta.get("n_het", 0) > 0:
        hp = _het_params(pack, med)
        is_het = in_medium & (hp["slot"] >= 0)
        # tracking draws from its own stream, so its slots never alias the
        # integrator's
        seed_t = rng.stream_seed(seed, rng.STREAM_MEDIUM_DIST)
        t_het, real_het, _ = _het_track(pack, hp, o, d, t_max_b, lane, sidx, slot, seed_t,
                                        ratio=False)
        w_het = torch.where(real_het[..., None], hp["albedo"], 1.0)
        out_t = torch.where(is_het, torch.where(real_het, t_het, t_max_b), out_t)
        out_w = torch.where(is_het[..., None], w_het, out_w)
        out_med = torch.where(is_het, real_het, out_med)
    return MediumSample(is_medium=out_med, t=out_t, weight=out_w)


def _het_transmittance_quad(pack, hp, o, d, dist, n_steps=None):
    """Deterministic composite-Simpson transmittance over the grid's box
    (reference heterogeneous.cpp:546-548 integrateDensity): one batched
    corner gather over n_steps + 1 points, weights 1-4-2-...-4-1."""
    m = n_steps or QUAD_STEPS  # an even number of intervals
    r = o.shape[0]
    qo = _to_grid(hp, o)
    qd = _to_grid_dir(hp, d)
    dist = torch.as_tensor(dist, dtype=torch.float32, device=o.device).expand(r)
    tn, tf = _slab(qo, qd, torch.zeros_like(qo), torch.ones_like(qo))
    t0 = torch.clamp(tn, min=0.0)
    seg = torch.clamp(torch.minimum(dist, tf) - t0, min=0.0)
    frac = torch.arange(m + 1, dtype=torch.float32, device=o.device) / m
    ts = t0[:, None] + seg[:, None] * frac[None, :]  # [R, M+1]
    dens = _het_density_q(pack, _expand(hp), qo[:, None, :] + qd[:, None, :] * ts[..., None])
    w = torch.ones(m + 1, dtype=torch.float32, device=o.device)
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    tau = (dens * w).sum(dim=-1) * (seg / (3.0 * m))
    return torch.exp(-tau)


def transmittance(pack, med, o, d, dist, lane, sidx, slot, seed):
    """Tr along a segment inside one medium (shadow rays): closed form in
    homogeneous media; in heterogeneous ones ratio tracking, or Simpson
    quadrature when every heterogeneous medium asks for method="simpson"."""
    in_medium = med >= 0
    m = torch.clamp(med, min=0)
    sigma_t = pack.med_sigma_s[m] + pack.med_sigma_a[m]
    tr = torch.exp(-sigma_t * dist[..., None])
    if pack.meta.get("n_het", 0) > 0:
        hp = _het_params(pack, med)
        is_het = in_medium & (hp["slot"] >= 0)
        if pack.meta.get("het_simpson", False):
            # only the lanes in a heterogeneous medium (per-lane work)
            w_het = torch.ones(med.shape[0], dtype=torch.float32, device=med.device)
            live = LiveLanes(med.shape[0], med.device)
            sub = live.narrow(is_het, hp, o, d,
                              torch.as_tensor(dist, device=med.device).expand(med.shape[0]))
            if sub is not None:
                live.write((w_het,), (_het_transmittance_quad(pack, *sub),))
        else:
            seed_t = rng.stream_seed(seed, rng.STREAM_MEDIUM_TRANS)
            _, _, w_het = _het_track(pack, hp, o, d, dist, lane, sidx, slot, seed_t, ratio=True)
        tr = torch.where(is_het[..., None], w_het[..., None], tr)
    return torch.where(in_medium[..., None], tr, 1.0)


# --- phase functions ---------------------------------------------------------

def _phase_eval_one(kind, g, cos):
    """One component's value (= pdf): isotropic, HG or Rayleigh."""
    hg = warp.square_to_phase_hg_pdf(cos, g)
    iso = torch.full_like(cos, INV_FOURPI)
    ray = 3.0 / (16.0 * math.pi) * (1.0 + cos * cos)  # src/phase/rayleigh.cpp
    out = torch.where((kind == HG) & (torch.abs(g) > 1e-4), hg, iso)
    return torch.where(kind == RAYLEIGH, ray, out)


def _phase_eval_dot(pack, med, cos):
    """The phase's value and pdf (equal for these kinds; a mixture blends
    its leaves by weight) at cos = dot(propagation direction, outgoing
    direction)."""
    m = torch.clamp(med, min=0)
    kinds, gs, ws = pack.med_ph_kinds[m], pack.med_ph_gs[m], pack.med_ph_ws[m]  # [R, C]
    out = torch.zeros_like(cos)
    for ci in range(kinds.shape[-1]):
        p_i = _phase_eval_one(kinds[..., ci], gs[..., ci], cos)
        out = out + torch.where(kinds[..., ci] >= 0, ws[..., ci] * p_i, 0.0)
    return out


# --- fiber phases (kkay, microflake) on orientation volumes ---------------

def _has_fiber_phases(pack):
    pk = pack.meta.get("phase_kinds", ())
    return KKAY in pk or MICROFLAKE in pk


def _orient_at(pack, med, p):
    """The unit fiber axis at world position p from the medium's
    corner-packed orientation grid: trilinear, normalized after the
    interpolation (reference eval.py:563-601, gridvolume lookupVector).
    The cell is clamped into het_ocorners.  Returns (axis [R, 3], valid
    [R]: a heterogeneous medium with an orientation volume and a nonzero
    vector there)."""
    hp = _het_params(pack, med)
    slot = torch.clamp(hp["slot"], min=0)
    obase = pack.het_obase[slot]
    odims = pack.het_odims[slot].to(torch.float32)
    q = _to_grid(hp, p)
    d_, h_, w_ = odims[..., 0], odims[..., 1], odims[..., 2]
    fx = q[..., 0] * w_ - 0.5
    fy = q[..., 1] * h_ - 0.5
    fz = q[..., 2] * d_ - 0.5
    x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
    ax, ay, az = fx - x0, fy - y0, fz - z0
    xi = torch.clamp(torch.minimum(x0, w_ - 1.0), min=-1.0) + 1.0
    yi = torch.clamp(torch.minimum(y0, h_ - 1.0), min=-1.0) + 1.0
    zi = torch.clamp(torch.minimum(z0, d_ - 1.0), min=-1.0) + 1.0
    cell = obase + ((zi * (h_ + 1.0) + yi) * (w_ + 1.0) + xi).to(torch.int32)
    n = pack.het_ocorners.shape[0]
    c = pack.het_ocorners[torch.clamp(cell, 0, n - 1)]  # [R, 24]
    c = c.reshape(c.shape[:-1] + (8, 3))
    bx, by = ax[..., None, None], ay[..., None, None]
    cy = c[..., 0::2, :] * (1 - bx) + c[..., 1::2, :] * bx  # [R, 4, 3]
    cz = cy[..., 0::2, :] * (1 - by) + cy[..., 1::2, :] * by  # [R, 2, 3]
    v = cz[..., 0, :] * (1 - az)[..., None] + cz[..., 1, :] * az[..., None]
    ln = torch.linalg.vector_norm(v, dim=-1)
    valid = (obase >= 0) & (ln > 1e-6) & (hp["slot"] >= 0)
    return v / torch.clamp(ln, min=1e-12)[..., None], valid


def _flake_d(pack, m, c):
    """The gaussian fiber's flake-normal density D(cos) on the sphere."""
    s = pack.med_flake_stddev[m]
    return pack.med_flake_norm[m] * torch.exp(-c * c / (2.0 * s * s))


def _flake_sigt(pack, m, cos_w):
    """sigma_t(|cos theta_w|), linear in the medium's table."""
    lut = pack.med_flake_sigt[m]  # [R, FLAKE_LUT]
    n = lut.shape[-1]
    x = torch.clamp(torch.abs(cos_w), 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    fr = x - i0.to(torch.float32)
    a = lut.gather(-1, i0[..., None])[..., 0]
    b = lut.gather(-1, (i0 + 1)[..., None])[..., 0]
    return a * (1.0 - fr) + b * fr


def _kkay_eval(pack, m, axis, valid, wi, wo):
    """Kajiya-Kay (reference eval.py:627-646, kkay.cpp eval): kd / 4 pi +
    ks norm max(0, cos of the cone angle)^exponent, the cone mirrored
    about the fiber's plane; its dot is zR zo + sqrt((1 - zR^2)(1 - zo^2))
    since R shares wo's azimuth about the fiber.  Without an axis, the
    diffuse part alone."""
    zr = -mm.dot(wi, axis)
    zo = mm.dot(wo, axis)
    cone = zr * zo + torch.sqrt(torch.clamp((1.0 - zr * zr) * (1.0 - zo * zo), min=0.0))
    spec = (torch.clamp(cone, min=0.0) ** pack.med_ph_exp[m]
            * pack.med_ph_knorm[m] * pack.med_ph_ks[m])
    diff = pack.med_ph_kd[m] * INV_FOURPI
    return torch.where(valid, spec + diff, diff)


def _microflake_eval(pack, m, axis, valid, wi, wo):
    """Specular microflakes (reference eval.py:649-660, microflake.cpp
    eval): 0.5 D(cos theta_h) / sigma_t(cos theta_wi) in the fiber's
    frame; 0 without an axis."""
    h = wi + wo
    hl = torch.linalg.vector_norm(h, dim=-1)
    ch = mm.dot(h, axis) / torch.clamp(hl, min=1e-9)
    val = 0.5 * _flake_d(pack, m, ch) / torch.clamp(_flake_sigt(pack, m, mm.dot(wi, axis)),
                                                    min=1e-9)
    return torch.where(valid & (hl > 1e-9), val, 0.0)


def phase_eval(pack, med, d_in, d_out, p=None):
    """Phase value; d_in = propagation direction into the event, d_out =
    the outgoing direction, p = the event's position, where the fiber
    phases read the orientation volume (without p they evaluate as the
    scalar kinds' table, as in the reference)."""
    out = _phase_eval_dot(pack, med, mm.dot(d_out, d_in))
    if _has_fiber_phases(pack) and p is not None:
        m = torch.clamp(med, min=0)
        axis, valid = _orient_at(pack, med, p)
        kind = pack.med_phase[m]
        pk = pack.meta.get("phase_kinds", ())
        if KKAY in pk:
            out = torch.where(kind == KKAY, _kkay_eval(pack, m, axis, valid, -d_in, d_out), out)
        if MICROFLAKE in pk:
            out = torch.where(kind == MICROFLAKE,
                              _microflake_eval(pack, m, axis, valid, -d_in, d_out), out)
    return out


def phase_pdf(pack, med, d_in, d_out, p=None):
    """Directional density of phase_sample (for MIS): phase_eval for the
    kinds sampled exactly; kkay samples uniformly; microflake samples
    flake normals from D, and both normals +-m mirror wi onto one wo, so
    the density is D / (2 |wi . h|) (reference eval.py:684-713)."""
    out = _phase_eval_dot(pack, med, mm.dot(d_out, d_in))
    if _has_fiber_phases(pack) and p is not None:
        m = torch.clamp(med, min=0)
        axis, valid = _orient_at(pack, med, p)
        wi = -d_in
        kind = pack.med_phase[m]
        pk = pack.meta.get("phase_kinds", ())
        if KKAY in pk:
            out = torch.where(kind == KKAY, INV_FOURPI, out)
        if MICROFLAKE in pk:
            h = wi + d_out
            hl = torch.clamp(torch.linalg.vector_norm(h, dim=-1), min=1e-9)
            hn = h / hl[..., None]
            pdf_m = _flake_d(pack, m, mm.dot(hn, axis)) / torch.clamp(
                2.0 * torch.abs(mm.dot(wi, hn)), min=1e-6)
            out = torch.where(kind == MICROFLAKE, torch.where(valid, pdf_m, 0.0), out)
    return out


def _rayleigh_sample_cos(u):
    """Invert the Rayleigh CDF: mu^3 + 3 mu = 8u - 4 (Cardano's single real
    root; reference rayleigh.cpp sample).  a > 0, so its real cube root is
    a power."""
    q_half = 2.0 - 4.0 * u
    a = -q_half + torch.sqrt(q_half * q_half + 1.0)
    cb = torch.pow(a, 1.0 / 3.0)
    return torch.clamp(cb - 1.0 / cb, -1.0, 1.0)


def _phase_local_dir(kind, g, u2):
    """Local direction (+z = forward) for one phase component."""
    local = warp.square_to_phase_hg(u2, g)  # isotropic through g = 0
    ct_r = _rayleigh_sample_cos(u2[..., 0])
    st_r = torch.sqrt(torch.clamp(1.0 - ct_r * ct_r, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    local_r = torch.stack([st_r * torch.cos(phi), st_r * torch.sin(phi), ct_r], dim=-1)
    return torch.where((kind == RAYLEIGH)[..., None], local_r, local)


def phase_sample(pack, med, d_in, u2, p=None):
    """Sample an outgoing direction: (d_out, pdf, weight), weight = phase /
    pdf (reference eval.py:729-820): 1 for the scalar kinds, where a
    mixture picks a leaf over its weight CDF with the first uniform,
    remapped to stay uniform within the leaf, and the pdf is the blended
    density of the drawn direction.  At p, kkay samples the sphere
    uniformly (weight 4 pi eval); microflake draws a flake normal from D
    by erf / erfinv inversion and mirrors wi about it (weight 2 |wi . m| /
    sigma_t, as pdf times 2 |wi . m| / D)."""
    m = torch.clamp(med, min=0)
    kinds, gs, ws = pack.med_ph_kinds[m], pack.med_ph_gs[m], pack.med_ph_ws[m]  # [R, C]
    cum = _cumsum(ws)
    u0 = u2[..., 0]
    sel = (u0[..., None] >= cum[..., :-1]).sum(dim=-1)
    sel = torch.minimum(sel, torch.clamp((kinds >= 0).sum(dim=-1) - 1, min=0))[..., None]
    lo_c = torch.where(sel > 0, cum.gather(-1, torch.clamp(sel - 1, min=0)), 0.0)[..., 0]
    w_sel = ws.gather(-1, sel)[..., 0]
    u0 = (u0 - lo_c) / torch.clamp(w_sel, min=1e-8)
    u2r = torch.stack([torch.clamp(u0, 0.0, mm.ONE_MINUS_EPS), u2[..., 1]], dim=-1)
    kind_sel = torch.clamp(kinds.gather(-1, sel)[..., 0], min=0)
    g_sel = gs.gather(-1, sel)[..., 0]
    # a frame around the propagation direction (+z = forward scattering)
    d_out = mm.Frame.from_normal(d_in).to_world(_phase_local_dir(kind_sel, g_sel, u2r))
    pdf = _phase_eval_dot(pack, med, mm.dot(d_out, d_in))
    weight = torch.ones_like(pdf)
    if _has_fiber_phases(pack) and p is not None:
        axis, valid = _orient_at(pack, med, p)
        wi = -d_in
        kind = pack.med_phase[m]
        pk = pack.meta.get("phase_kinds", ())
        if KKAY in pk:
            d_uni = warp.square_to_uniform_sphere(u2)
            is_k = kind == KKAY
            d_out = torch.where(is_k[..., None], d_uni, d_out)
            pdf = torch.where(is_k, INV_FOURPI, pdf)
            weight = torch.where(is_k, _kkay_eval(pack, m, axis, valid, wi, d_uni)
                                 * (4.0 * math.pi), weight)
        if MICROFLAKE in pk:
            s_ = pack.med_flake_stddev[m]
            t = 2.0 * u2[..., 0] - 1.0
            c = math.sqrt(2.0) * s_ * torch.erfinv(
                torch.clamp(t, -mm.ONE_MINUS_EPS, mm.ONE_MINUS_EPS)
                * torch.erf(1.0 / (math.sqrt(2.0) * s_)))
            c = torch.clamp(c, -mm.ONE_MINUS_EPS, mm.ONE_MINUS_EPS)
            st = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
            phi = 2.0 * math.pi * u2[..., 1]
            m_fl = mm.Frame.from_normal(axis).to_world(
                torch.stack([st * torch.cos(phi), st * torch.sin(phi), c], dim=-1))
            dwm = mm.dot(wi, m_fl)
            wo_f = 2.0 * dwm[..., None] * m_fl - wi
            pdf_f = _flake_d(pack, m, c) / torch.clamp(2.0 * torch.abs(dwm), min=1e-6)
            w_f = torch.abs(dwm) / torch.clamp(_flake_sigt(pack, m, mm.dot(wi, axis)), min=1e-9)
            is_f = kind == MICROFLAKE
            ok_f = valid & (torch.abs(dwm) > 1e-6)
            d_out = torch.where(is_f[..., None], wo_f, d_out)
            pdf = torch.where(is_f, torch.where(ok_f, pdf_f, 0.0), pdf)
            weight = torch.where(is_f, torch.where(ok_f, w_f, 0.0), weight)
    return d_out, pdf, weight
