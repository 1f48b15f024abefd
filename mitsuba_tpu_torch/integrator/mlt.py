"""Veach-style MLT and ERPT over primary-sample chain tensors (port of
mitsuba_tpu/integrator/mlt.py; reference src/integrators/mlt/{mlt.cpp,
mlt_proc.cpp:67-224}, src/integrators/erpt/{erpt.cpp:134,
erpt_proc.cpp:120-260}, the mutators of include/mitsuba/bidir/).

A chain is a row of the primary-sample tensor U [CHAINS, D], re-traced by
pssmlt.path_from_primary, and each of Veach's perturbations is a
structured move on that row:

* lens (mut_lens.h): the image-plane dims U[0:2] move by an exponentially
  distributed radius in [0.1 px, sqrt(5 % of the image)] (Veach's sizes,
  erpt_proc.cpp:117-118); every decision dim is kept;
* caustic (mut_caustic.h): one uniformly chosen bounce's BSDF dims take a
  Kelemen step;
* multi-chain (mut_mchain.h): the lens move and every bounce's BSDF dims;
* bidirectional (mut_bidir.h): a fresh U row (the large step).

Every move is symmetric in primary space, so a = min(1, I'/I).  With
manifoldPerturbation, every 4th step is the manifold perturbation
(integrator/mut_manifold.py) with its Jacobian correction.

ERPT (Cline et al. 2005): path-traced seeds, each starting min(1, I/e_d)
chains (in expectation) of chainLength perturbation-only mutations, each
step depositing the quantum e_d split (1 - a) / a between the current and
the proposed state.

The reference's scans over steps and over the chain length become host
loops, and its lax.cond on the step index a host branch.  The draws are
the reference's on STREAM_MLT: slots 3, 4, 5 for a Veach proposal, 6 for
its accept test, 11 for the manifold lens move; for ERPT, index 9000 + b
for bootstrap batch b, round * 2 + 101 for a round's seeds, slot 7 for
the chain count and 8 for the accept test, keyed on step round * 65536 + k.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_tpu_torch.bsdf.plugins import CONDUCTOR, DIELECTRIC
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core.spectrum import luminance
from mitsuba_tpu_torch.integrator.pssmlt import (
    _HEAD,
    _MASK,
    _PER_DEPTH,
    _S1,
    _S2,
    _kelemen_mutate,
    _mh,
    _splat,
    add_direct_component,
    bootstrap_chains,
    chain_setup,
    dim_words,
    dims_for,
    path_from_primary,
)

# Veach's lens-perturbation jump sizes (erpt_proc.cpp:117-118): minJump
# 0.1 px, covered area 5 % of the image
_LENS_R1_PX = 0.1
_LENS_AREA = 0.05


def _exp_step(u, r1, r2):
    """Exponentially distributed step in [r1, r2] (mut_lens.h):
    r = r2 * exp(-log(r2 / r1) * u), the log taken in float32 as the
    reference takes it."""
    return r2 * torch.exp(-float(np.log(np.float32(r2 / r1))) * u)


def _perturb_lens(U, w, h, u4):
    """Perturb the image-plane dims 0:2 only: an exponential radius in
    pixels at a uniform angle; every decision dim is kept."""
    r = _exp_step(u4[..., 0], _LENS_R1_PX, float(np.sqrt(_LENS_AREA * w * h)))
    phi = 2.0 * math.pi * u4[..., 1]
    x = U[:, 0] + r * torch.cos(phi) / w
    y = U[:, 1] + r * torch.sin(phi) / h
    out = U.clone()
    out[:, 0] = x - torch.floor(x)
    out[:, 1] = y - torch.floor(y)
    return out


def _kelemen_step(u_mut):
    return _S2 * torch.exp(-math.log(_S2 / _S1) * u_mut)


def _perturb_block(U, k, u_mut, u_sign, n_dims=3, off=3):
    """Kelemen-perturb `n_dims` dims of each lane's depth block k [N] (by
    default the BSDF direction and lobe dims, at offset 3 in the block)."""
    cols = ((_HEAD + _PER_DEPTH * k)[:, None] + torch.arange(n_dims, device=U.device)[None, :]
            + off)
    step = _kelemen_step(u_mut)
    rows = torch.arange(U.shape[0], device=U.device)[:, None]
    vals = U[rows, cols] + torch.where(u_sign < 0.5, step, -step)
    out = U.clone()
    out[rows, cols] = vals - torch.floor(vals)
    return out


def propose_veach(U, k, seed_mlt, w, h, max_depth, p_large, lanes=None):
    """One structured mutation per chain (reference mlt.py:110-159): a large
    step with probability p_large, else one of {full small step, lens,
    caustic, multi-chain} uniformly.  `lanes` are the chains' RNG keys
    (default arange).  Returns (U_prop, is_large)."""
    n, D = U.shape
    if lanes is None:
        lanes = torch.arange(n, device=U.device)
    u_ctl = rng.rand4(lanes, k, 3, seed_mlt)
    um = rng.rand4(dim_words(lanes, D), k, 4, seed_mlt)
    u_mut = um[:, 0].reshape(n, D)
    u_sign = um[:, 1].reshape(n, D)
    u_fresh = um[:, 2].reshape(n, D)
    u_pb = rng.rand4(lanes, k, 5, seed_mlt)

    large = u_ctl[:, 0] < p_large
    which = (u_ctl[:, 1] * 4.0).to(torch.int32)  # 0..3

    U_small = _kelemen_mutate(U, u_mut, u_sign)
    U_lens = _perturb_lens(U, w, h, u_pb)
    kblk = torch.clamp((u_pb[..., 2] * max_depth).to(torch.int64), max=max_depth - 1)
    U_caustic = _perturb_block(U, kblk, u_mut[:, 0:3], u_sign[:, 0:3])
    U_mc = _perturb_lens(U, w, h, u_pb)
    for kb in range(max_depth):
        base = _HEAD + _PER_DEPTH * kb + 3
        vals = U_mc[:, base:base + 3] + torch.where(
            u_sign[:, base:base + 3] < 0.5, 1.0, -1.0) * _kelemen_step(u_mut[:, base:base + 3])
        U_mc[:, base:base + 3] = vals - torch.floor(vals)

    U_prop = torch.where((which == 0)[:, None], U_small, U_lens)
    U_prop = torch.where((which == 2)[:, None], U_caustic, U_prop)
    U_prop = torch.where((which == 3)[:, None], U_mc, U_prop)
    return torch.where(large[:, None], u_fresh, U_prop), large


def _mh_tail(film, state, U_prop, corr, k, trace, seed_mlt, lanes, w, h):
    """The rest of step k once its proposals are made (reference mlt.py
    _mh_tail): the re-trace, the splats and the accept test on slot 6.
    Returns (film, the new state, a, accept)."""
    u_acc = rng.rand4(lanes, k, 6, seed_mlt)[:, 1]
    pos_p, L_p = trace(U_prop)
    return _mh(film, state, (U_prop, pos_p, L_p, luminance(L_p)), u_acc, corr, w, h)


def render_mlt(scene, spp=None, seed=0, pack=None, chains=None, device="cuda"):
    """A Veach-mutation MLT render (= MLT::render, mlt.cpp) on `device`:
    PSSMLT's normalization and film with the structured proposals above.
    `spp` is the mutations per pixel.  Returns numpy [H, W, 3]."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    # the bidirectional mutation (the large step) is one of five mutators
    _, integ, w, h, cam, max_depth, n_px, mutations_pp, n_chains, p_large = chain_setup(
        scene, pack, spp, chains, device, 0.2)
    D = dims_for(max_depth)
    seed_mlt = rng.stream_seed(seed, rng.STREAM_MLT)

    def trace(U):
        return path_from_primary(pack, integ, cam, w, h, U)

    n_boot = max(integ.luminance_samples // n_chains, 2)
    U_cur, b_norm = bootstrap_chains(trace, D, n_chains, n_boot, seed, seed_mlt, device)
    if U_cur is None:
        return np.zeros((h, w, 3), np.float32)
    pos_cur, L_cur = trace(U_cur)
    state = (U_cur, pos_cur, L_cur, luminance(L_cur))
    n_steps = max(mutations_pp * n_px // n_chains, 1)

    # the manifold perturbation runs as every 4th step when it is on and
    # the scene has smooth delta chains to solve (reference mlt.cpp
    # manifoldPerturbation)
    mani_on = bool(integ.manifold_perturbation
                   and any(t in (CONDUCTOR, DIELECTRIC) for t in pack.meta["present_types"])
                   and max_depth >= 3)
    # (mut_manifold imports this module's lens move)
    from mitsuba_tpu_torch.integrator.mut_manifold import propose_manifold

    lanes = torch.arange(n_chains, device=device)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    for k in range(n_steps):
        if mani_on and k % 4 == 3:
            U_prop, corr, _ = propose_manifold(pack, integ, cam, w, h, state[0], k, seed_mlt,
                                               lanes)
        else:
            U_prop, _ = propose_veach(state[0], k, seed_mlt, w, h, max_depth, p_large,
                                      lanes=lanes)
            corr = 1.0
        film, state, _, _ = _mh_tail(film, state, U_prop, corr, k, trace, seed_mlt, lanes, w, h)
    scale = b_norm * n_px / (n_steps * n_chains)
    return add_direct_component((film * scale).cpu().numpy(), scene, pack, integ, seed, device)


def render_erpt(scene, spp=None, seed=0, pack=None, chains=None, device="cuda"):
    """Energy redistribution path tracing (= ERPT::render, erpt.cpp:134) on
    `device`.  Each round: fresh path-traced seeds; each seed runs
    floor(I / e_d + u) chains' worth of deposition over `chainLength`
    perturbation-only mutations (no large steps), each step depositing
    the quantum with expected-value (1 - a) / a splitting.  `spp` is the
    seeds per pixel (None: the sampler's sampleCount).  Returns numpy
    [H, W, 3]."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    sen = scene.sensor.record
    integ = scene.integrator
    w, h = sen.film.width, sen.film.height
    cam = sen.pack(w, h, device)
    max_depth = integ.max_depth if integ.max_depth > 0 else 16
    D = dims_for(max_depth)
    n_px = w * h
    samples_pp = spp or sen.sampler.sample_count
    chain_len = max(integ.chain_length or 100, 1)
    n_lanes = chains or min(1 << 16, n_px)
    seed_mlt = rng.stream_seed(seed, rng.STREAM_MLT)

    def trace(U):
        return path_from_primary(pack, integ, cam, w, h, U)

    lanes = torch.arange(n_lanes, device=device)
    words = dim_words(lanes, D)

    def rows(index):
        return rng.rand4(words // D, words % D, index, seed_mlt)[:, 0].reshape(n_lanes, D)

    # the deposition quantum e_d = b, the mean path luminance, so that a
    # seed starts one chain in expectation (erpt.cpp numChains = 1)
    boot = [luminance(trace(rows(9000 + b))[1]).cpu().numpy() for b in range(4)]
    b_norm = float(np.concatenate(boot).mean())
    if b_norm <= 0:
        return np.zeros((h, w, 3), np.float32)
    e_d = b_norm

    n_rounds = max((samples_pp * n_px) // n_lanes, 1)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    for ri in range(n_rounds):
        U = rows(ri * 2 + 101)
        pos, L = trace(U)
        I = luminance(L)
        # a chain runs with probability min(1, I / e_d); bright seeds
        # carry proportionally more deposition
        n_c = torch.floor(I / e_d + rng.rand4(lanes, ri, 7, seed_mlt)[:, 0])
        dep = n_c * e_d / float(chain_len)  # per-step deposit
        run = n_c > 0
        for k in range(chain_len):
            kk = (ri * 65536 + k) & _MASK
            u_acc = rng.rand4(lanes, kk, 8, seed_mlt)
            U_p, _ = propose_veach(U, kk, seed_mlt, w, h, max_depth, 0.0, lanes=lanes)
            pos_p, L_p = trace(U_p)
            I_p = luminance(L_p)
            a = torch.clamp(I_p / torch.clamp(I, min=1e-12), 0.0, 1.0)
            # equal-deposition splat: e_d (1 - a) at x, e_d a at y
            v_cur = torch.where((run & (I > 0))[:, None],
                                L / torch.clamp(I, min=1e-12)[:, None] * (dep * (1.0 - a))[:, None],
                                0.0)
            v_p = torch.where((run & (I_p > 0))[:, None],
                              L_p / torch.clamp(I_p, min=1e-12)[:, None] * (dep * a)[:, None], 0.0)
            film = _splat(film, pos, v_cur, w, h)
            film = _splat(film, pos_p, v_p, w, h)
            accept = u_acc[:, 1] < a
            U = torch.where(accept[:, None], U_p, U)
            pos = torch.where(accept[:, None], pos_p, pos)
            L = torch.where(accept[:, None], L_p, L)
            I = torch.where(accept, I_p, I)
    # each seed stands for 1 / (seeds per pixel) of the estimator
    scale = n_px / (n_rounds * n_lanes)
    return add_direct_component((film * scale).cpu().numpy(), scene, pack, integ, seed, device)
