"""Primary-sample-space Metropolis light transport, Kelemen-style (port of
mitsuba_tpu/integrator/pssmlt.py, reference
src/integrators/pssmlt/{pssmlt.cpp:150-198, pssmlt_sampler.h:34-112}).

The sampler state is a dense [CHAINS, D] tensor of primary samples, and
every Metropolis step mutates, re-traces and accepts or rejects all
chains in lockstep:

* bootstrap: ordinary path samples estimate the luminance normalization b
  and seed the chains in proportion to path luminance (pssmlt.cpp:181-198);
* small steps: Kelemen's symmetric log-space mutation
  (pssmlt_sampler.h:70-103); large steps with probability pLarge;
* both the current and the proposed state are splatted with their
  expected-value weights.

A chain re-traces through the bidirectional sampler (the reference's
default technique: the port's `make_bdpt_chunk(..., U=)`, every decision
from the chain's row of U) or, with `bidirectional` off, outside the bdpt
envelope or with heterogeneous media, through `path_from_primary`, a path
loop whose decisions come from U instead of the counter hash.

The reference cuts the step scan into executions of MTS_TPU_MLT_STEPS
steps for its TPU's per-execution budget; the port runs the steps as a
host loop over device tensors and keeps the chain state on the device.
Split over the ranks of a mesh (`mesh=`), the chains' films merge every
MTS_TPU_MLT_STEPS steps, as the reference's sharded executions do.
The path loop checks its exit every EXIT_CHECK_EVERY depths (core/lanes.py).
The chain draws are the reference's: `rand4` on STREAM_MLT, slot 1 for a
step's control draws, slot 2 for its per-dimension draws, index 7000 + b
for bootstrap batch b.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch

from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect, occluded
from mitsuba_tpu_torch.bsdf.eval import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdf.plugins import NULL_BSDF
from mitsuba_tpu_torch.core import lanes as _lanes
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core.gather import take_rows
from mitsuba_tpu_torch.core.spectrum import luminance
from mitsuba_tpu_torch.emitter import eval as em
from mitsuba_tpu_torch.integrator import path as _path
from mitsuba_tpu_torch.scene.texture_eval import mip_footprint, shading_frame, shading_params
from mitsuba_tpu_torch.sensor.plugins import generate_rays

# primary-sample layout of one path: [0:2] film position, [2:4] lens
# sample, per depth d [4+8d : 12+8d] = NEE(3) + BSDF(3) + RR(1) + spare(1)
_HEAD = 4
_PER_DEPTH = 8

# Kelemen mutation sizes (reference pssmlt_sampler.h:37)
_S1 = 1.0 / 1024.0
_S2 = 1.0 / 64.0

_MASK = 0xFFFFFFFF
# mutations per pixel when render is given no spp (the reference's
# record default; no property sets it)
MUTATIONS_PER_PIXEL = 100


def dims_for(max_depth: int) -> int:
    return _HEAD + _PER_DEPTH * max_depth


def path_from_primary(pack, integ, cam, w, h, U, stats=None):
    """Trace one path per chain from explicit primary samples U [N, D]
    (reference pssmlt.py:61-212).  Returns (pos [N, 2] film position in
    pixels, L [N, 3]).  With `stats`, stats["rays"] accumulates the
    closest-hit and shadow rays of live lanes."""
    n = U.shape[0]
    dev = U.device
    present = pack.meta["present_types"]
    max_depth = integ.max_depth if integ.max_depth > 0 else 16
    rr_depth = max(integ.rr_depth, 1)
    # directSamples >= 0: the direct component (paths of at most 2 edges)
    # renders separately with ordinary sampling, and the chains cover only
    # longer paths (reference BidirectionalUtils::renderDirectComponent)
    split_direct = integ.direct_samples >= 0

    pos01 = U[:, 0:2]
    o, d = generate_rays(cam, pos01, U[:, 2:4])

    def u_at(depth, off, count):
        base = _HEAD + _PER_DEPTH * depth + off
        return U[:, base:base + count]

    L = torch.zeros(n, 3, dtype=torch.float32, device=dev)
    thr = torch.ones(n, 3, dtype=torch.float32, device=dev)
    eta = torch.ones(n, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.ones(n, dtype=torch.float32, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(max_depth):
        if depth % _lanes.EXIT_CHECK_EVERY == 0 and not bool(active.any()):
            break
        if stats is not None:
            stats["rays"] = stats["rays"] + active.sum()
        hit = intersect(pack, o, d)
        its = fill_interaction(pack, o, d, hit)
        found = its.valid & active

        if pack.meta.get("has_env", False):
            escape = active & ~its.valid
            if split_direct:
                escape = escape & (depth >= 2)
            env_l = em.eval_env(pack, d)
            w_env = torch.where(
                prev_delta, 1.0, _path.mi_weight(prev_pdf, em.pdf_direct_env(pack, d))
            )
            L = L + torch.where(escape[..., None], thr * env_l * w_env[..., None], 0.0)
        if pack.meta["has_area"]:
            cos_l = mm.dot(its.ns, its.wi_world)
            emissive = found & (its.emit >= 0) & (cos_l > 0)
            if split_direct:
                emissive = emissive & (depth >= 2)
            le = take_rows(pack.em_rgb, torch.clamp(its.emit, min=0))
            p_direct = em.pdf_direct_area(pack, its.emit, its.t, cos_l)
            w_hit = torch.where(prev_delta, 1.0, _path.mi_weight(prev_pdf, p_direct))
            L = L + torch.where(emissive[..., None], thr * le * w_hit[..., None], 0.0)

        active = found
        frame = shading_frame(pack, its)
        wi_l = frame.to_local(its.wi_world)
        sp = shading_params(pack, its.mat, its.uv, mip_footprint(pack, its), its=its)

        if pack.meta["n_emitters"] > 0:
            if stats is not None:
                stats["rays"] = stats["rays"] + active.sum()
            ds = em.sample_direct(pack, its.p, u_at(depth, 0, 3))
            wo_l = frame.to_local(ds.d)
            f = bsdf_eval(sp, wi_l, wo_l, present)
            o_sh = _path._offset_ray(its.p, its.ng, ds.d)
            shadow_t = torch.where(
                ds.dist >= em.ENV_DIST, 1e7, ds.dist * (1.0 - _path.SHADOW_EPS)
            )
            occ = occluded(pack, o_sh, ds.d, shadow_t)
            b_pdf = torch.where(ds.delta, 0.0, bsdf_pdf(sp, wi_l, wo_l, present))
            w_nee = torch.where(ds.delta, 1.0, _path.mi_weight(ds.pdf, b_pdf))
            # the reference's maxDepth gate (see path_trace)
            nee_on = active & ~occ & (depth + 2 <= max_depth)
            if split_direct:
                nee_on = nee_on & (depth >= 1)
            L = L + torch.where(nee_on[..., None], thr * ds.value * f * w_nee[..., None], 0.0)

        u_b = u_at(depth, 3, 3)
        bs = bsdf_sample(sp, wi_l, u_b[:, 0:2], u_b[:, 2], present)
        thr = thr * torch.where(active[..., None], bs.weight, 1.0)
        eta = eta * torch.where(active, bs.eta, 1.0)
        d_new = frame.to_world(bs.wo)
        o_new = _path._offset_ray(its.p, its.ng, d_new)
        thr_max = thr.amax(dim=-1)
        active = active & (thr_max > 0)
        thr, active = _path._roulette(thr, thr_max, eta, active, depth + 1 >= rr_depth,
                                      u_at(depth, 6, 1)[:, 0])

        is_null = sp["type"] == NULL_BSDF
        a3 = active[..., None]
        o = torch.where(a3, o_new, o)
        d = torch.where(a3, d_new, d)
        prev_pdf = torch.where(active, torch.where(is_null, prev_pdf, bs.pdf), prev_pdf)
        prev_delta = torch.where(active, torch.where(is_null, prev_delta, bs.delta), prev_delta)

    pos = torch.stack([pos01[:, 0] * w, pos01[:, 1] * h], dim=-1)
    return pos, L


def make_chain_trace(pack, integ, sen, cam, w, h):
    """The chain re-trace (reference pssmlt.py:214-285): returns (trace, D,
    S), trace(U [N, D]) -> (pos [N, S, 2], val [N, S, 3]), S splats per
    sample: 1 for the unidirectional technique, 1 + the light-image splats
    for the bidirectional one.  trace.stats["rays"] accumulates the rays
    it traces (as make_bdpt_chunk counts them).

    Light-image splat values are scaled by 1 / pixels, so the summed
    luminance target and the b * pixels / (steps * chains) normalization
    stay those of the unidirectional estimator."""
    from mitsuba_tpu_torch.integrator import bdpt as _bdpt

    n_px = w * h
    # heterogeneous media fall back: delta tracking draws unbounded
    # randomness that a finite primary vector cannot hold
    want = integ.bidirectional
    media_ok = not pack.meta.get("has_media", False) or pack.meta.get("n_het", 0) == 0
    if want and _bdpt.supports_bdpt(pack) and media_ok:
        max_edges = _bdpt.bdpt_max_edges(integ)
        D = _bdpt.primary_dims(max_edges, has_media=pack.meta.get("has_media", False))
        split_direct = integ.direct_samples >= 0
        chunk = _bdpt.make_bdpt_chunk(pack, integ, sen, w, h, seed=0, exclude_direct=split_direct)

        def trace(U):
            zeros = torch.zeros(U.shape[0], dtype=torch.int64, device=U.device)
            L, splats = chunk(zeros, zeros, U=U)
            pos_all = [torch.stack([U[:, 0] * w, U[:, 1] * h], dim=-1)]
            val_all = [L]
            for pos, val, ok in splats:
                # masked-off splats can carry NaN positions (projections of
                # invalid vertices): zero them, or 0 * NaN poisons the film
                pos_all.append(torch.where(ok[..., None], pos, 0.0))
                val_all.append(torch.where(ok[..., None], val, 0.0) / n_px)
            return torch.stack(pos_all, dim=1), torch.stack(val_all, dim=1)

        trace.stats = chunk.stats
        n_splats = 1 + len([s for s in range(1, max_edges + 1) if not split_direct or s > 2])
        return trace, D, n_splats

    D = dims_for(integ.max_depth if integ.max_depth > 0 else 16)

    def trace(U):
        pos, L = path_from_primary(pack, integ, cam, w, h, U, stats=trace.stats)
        return pos[:, None, :], L[:, None, :]

    trace.stats = {"rays": 0}
    return trace, D, 1


def _chain_lum(val):
    """The chain's scalar target: the luminance summed over the splat list,
    in order.  val: [N, 3] (one splat: the mlt/erpt re-trace) or [N, S, 3]."""
    lum = luminance(val)
    if lum.dim() == 1:
        return lum
    total = lum[:, 0]
    for s in range(1, lum.shape[1]):
        total = total + lum[:, s]
    return total


def _kelemen_mutate(U, u_mut, u_sign):
    """Symmetric log-space perturbation (pssmlt_sampler.h:70-103)."""
    step = _S2 * torch.exp(-math.log(_S2 / _S1) * u_mut)
    out = U + torch.where(u_sign < 0.5, step, -step)
    return out - torch.floor(out)  # wrap to [0, 1)


def _splat(film, pos, value, w, h):
    """Bilinear (2x2 tent) scatter-add of value [N, 3] at pos [N, 2] into
    film [h, w, 3], in place (reference pssmlt.py:304-324).  On the card
    the adds land in any order (index_add_: atomics, where index_put_'s
    accumulate sorts the indices and took 9 ms per 65,536-row add)."""
    fx = pos[:, 0] - 0.5
    fy = pos[:, 1] - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    flat = film.view(-1, 3)
    for dx, dy, wgt in ((0, 0, (1 - ax) * (1 - ay)), (1, 0, ax * (1 - ay)),
                        (0, 1, (1 - ax) * ay), (1, 1, ax * ay)):
        x = torch.clamp(x0 + dx, 0, w - 1)
        y = torch.clamp(y0 + dy, 0, h - 1)
        flat.index_add_(0, y * w + x, value * wgt)
    return film


def _boot_rows(n_chains, D, batch, seed_mlt, device):
    """Bootstrap batch `batch`'s primary samples [n_chains, D]."""
    idx = torch.arange(n_chains * D, dtype=torch.int64, device=device) & _MASK
    return rng.rand4(idx // D, idx % D, 7000 + batch, seed_mlt)[:, 0].reshape(n_chains, D)


def bootstrap_chains(trace, D, n_chains, n_boot_batches, seed, seed_mlt, device):
    """The luminance normalization and proportional seed resampling
    (reference pssmlt.py:327-368, pssmlt.cpp:181-198).  Returns (U_cur
    [N, D] on `device`, b_norm), or (None, 0.0) for a black scene.  The
    target is the total splat luminance of a sample.  The seeds are
    resampled on the host with the reference's numpy call, so the same
    luminances choose the same seeds."""
    boot_lum = []
    for b in range(n_boot_batches):
        _, val = trace(_boot_rows(n_chains, D, b, seed_mlt, device))
        boot_lum.append(_chain_lum(val).cpu().numpy())
    boot_lum = np.concatenate(boot_lum)
    b_norm = float(boot_lum.mean())
    if b_norm <= 0:
        return None, 0.0

    p = boot_lum / boot_lum.sum()
    chosen = np.random.default_rng(seed).choice(len(boot_lum), size=n_chains, p=p)
    U_cur = torch.zeros(n_chains, D, dtype=torch.float32, device=device)
    for b in range(n_boot_batches):
        mask = (chosen // n_chains) == b
        if not mask.any():
            continue
        rows = torch.as_tensor(chosen[mask] % n_chains, device=device)
        U_cur[torch.as_tensor(mask, device=device)] = _boot_rows(
            n_chains, D, b, seed_mlt, device)[rows]
    return U_cur, b_norm


def add_direct_component(img, scene, pack, integ, seed, device):
    """directSamples >= 0: add the separately rendered direct component
    (emission and single scattering, the paths the chains exclude) with
    ordinary sampling (reference pssmlt.py:373-397,
    BidirectionalUtils::renderDirectComponent)."""
    n = integ.direct_samples
    if n < 0:
        return img
    from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
    from mitsuba_tpu_torch.renderer import render

    s2 = copy.copy(scene)
    s2.integrator = IntegratorRecord(kind="direct")
    return img + render(s2, spp=max(n, 1), seed=seed ^ 0xD17EC7, device=device, pack=pack)


def dim_words(lanes, D):
    """The per-dimension RNG keys lane * D + dim of every chain, flat,
    as uint32 words (the reference's uint32 arithmetic)."""
    words = lanes[:, None] * D + torch.arange(D, device=lanes.device)[None, :]
    return (words & _MASK).reshape(-1)


def _propose(U_cur, k, lanes, seed_mlt, p_large):
    """One step's proposals (reference pssmlt.py:457-471): a large step
    (fresh uniforms) with probability p_large, else Kelemen's small step.
    Returns (U_prop, u_ctl)."""
    n, D = U_cur.shape
    u_ctl = rng.rand4(lanes, k, 1, seed_mlt)
    um = rng.rand4(dim_words(lanes, D), k, 2, seed_mlt)
    u_mut = um[:, 0].reshape(n, D)
    u_sign = um[:, 1].reshape(n, D)
    u_fresh = um[:, 2].reshape(n, D)
    large = u_ctl[:, 0] < p_large
    U_prop = torch.where(large[:, None], u_fresh, _kelemen_mutate(U_cur, u_mut, u_sign))
    return U_prop, u_ctl


def _splat_all(film, pos, val, wgt, w, h):
    """Every splat of a sample, with the chain's weight (SplatList
    semantics, reference pathsampler.cpp:93-127); pos [N, S, 2], val
    [N, S, 3]."""
    for s in range(pos.shape[1]):
        film = _splat(film, pos[:, s], val[:, s] * wgt[:, None], w, h)
    return film


def _mh(film, cur, prop, u_acc, corr, w, h):
    """Expected-value splatting of both states and the accept test
    (reference pssmlt.py:475-495, mlt.py:209-229): cur and prop are (U,
    pos, L, I); corr multiplies the ratio (1.0, or the manifold
    perturbation's Jacobian correction).  Returns (film, the new state, a,
    accept)."""
    U_cur, pos_cur, L_cur, I_cur = cur
    U_p, pos_p, L_p, I_p = prop
    with torch.profiler.record_function("stage:splat"):
        a = torch.clamp(I_p / torch.clamp(I_cur, min=1e-12) * corr, 0.0, 1.0)
        w_cur = (1.0 - a) / torch.clamp(I_cur, min=1e-12)
        w_prop = a / torch.clamp(I_p, min=1e-12)
        if pos_cur.dim() == 2:
            film = _splat(film, pos_cur, L_cur * w_cur[:, None], w, h)
            film = _splat(film, pos_p, L_p * w_prop[:, None], w, h)
        else:
            film = _splat_all(film, pos_cur, L_cur, w_cur, w, h)
            film = _splat_all(film, pos_p, L_p, w_prop, w, h)
    with torch.profiler.record_function("stage:accept"):
        accept = u_acc < a
        sel = accept.reshape(-1, *([1] * (pos_cur.dim() - 1)))
        state = (torch.where(accept[:, None], U_p, U_cur), torch.where(sel, pos_p, pos_cur),
                 torch.where(sel, L_p, L_cur), torch.where(accept, I_p, I_cur))
    return film, state, a, accept


def chain_setup(scene, pack, spp, chains, device, p_large_default, world=1):
    """What every chain render starts from: (sensor record, integrator,
    w, h, the packed camera, max_depth, pixels, mutations per pixel,
    chains, p_large).  The chains are padded to a multiple of `world`, the
    ranks that split them."""
    sen = scene.sensor.record
    integ = scene.integrator
    w, h = sen.film.width, sen.film.height
    cam = sen.pack(w, h, device)
    max_depth = integ.max_depth if integ.max_depth > 0 else 16
    n_px = w * h
    mutations_pp = spp or MUTATIONS_PER_PIXEL
    p_large = integ.p_large if integ.p_large > 0 else p_large_default
    n_chains = -(-(chains or min(1 << 17, n_px)) // world) * world
    return sen, integ, w, h, cam, max_depth, n_px, mutations_pp, n_chains, p_large


def chain_shard(mesh, n_chains, device):
    """This rank's chain ids (all of them without a mesh)."""
    lo, hi = (0, n_chains) if mesh is None else mesh.shard(n_chains)
    return torch.arange(lo, hi, device=device), slice(lo, hi)


def merge_every(n_steps):
    """Steps between two merges of the ranks' films (MTS_TPU_MLT_STEPS,
    64, as the reference's executions)."""
    return max(min(int(os.environ.get("MTS_TPU_MLT_STEPS", 64)), n_steps), 1)


def iter_pssmlt(scene, pack, spp=None, seed=0, chains=None, device="cuda", mesh=None):
    """The steps of a PSSMLT render, one at a time (reference
    pssmlt.py:400-562).  `spp` is the mutations per pixel (None:
    MUTATIONS_PER_PIXEL).  Yields (the image of the steps so far [H, W, 3]
    on the device, the direct component not included; steps done; steps in
    all; the trace's stats), once after the bootstrap (0 steps: a black
    image) and after every step.  A black scene yields once.

    With `mesh` (parallel/mesh.py) the chains, padded to a multiple of the
    world, split over the ranks (reference pssmlt.py:427-431, :515-550):
    every rank runs the bootstrap over all chains, then its own chains
    against its own film, which one all-reduce merges every merge_every()
    steps into the image; it yields after each merge.  The work of each step sits
    in record_function ranges "stage:bootstrap", "stage:propose",
    "stage:trace", "stage:splat" and "stage:accept"."""
    device = torch.device(device)
    sen, integ, w, h, cam, _, n_px, mutations_pp, n_chains, p_large = chain_setup(
        scene, pack, spp, chains, device, 0.3, 1 if mesh is None else mesh.world)
    seed_mlt = rng.stream_seed(seed, rng.STREAM_MLT)
    trace, D, _ = make_chain_trace(pack, integ, sen, cam, w, h)
    n_steps = max(mutations_pp * n_px // n_chains, 1)
    film = torch.zeros(h, w, 3, dtype=torch.float32, device=device)
    lanes, mine = chain_shard(mesh, n_chains, device)

    n_boot_batches = max(integ.luminance_samples // n_chains, 2)
    with torch.profiler.record_function("stage:bootstrap"):
        U_cur, b_norm = bootstrap_chains(trace, D, n_chains, n_boot_batches, seed, seed_mlt,
                                         device)
        if U_cur is not None:
            U_cur = U_cur[mine]
            pos_cur, L_cur = trace(U_cur)
            I_cur = _chain_lum(L_cur)
    yield film.clone(), 0, n_steps, trace.stats
    if U_cur is None:
        return
    state = (U_cur, pos_cur, L_cur, I_cur)
    merged = film.clone()
    every = merge_every(n_steps)
    for k in range(n_steps):
        with torch.profiler.record_function("stage:propose"):
            U_prop, u_ctl = _propose(state[0], k, lanes, seed_mlt, p_large)
        with torch.profiler.record_function("stage:trace"):
            pos_p, L_p = trace(U_prop)
            I_p = _chain_lum(L_p)
        film, state, _, _ = _mh(film, state, (U_prop, pos_p, L_p, I_p), u_ctl[:, 1], 1.0, w, h)
        # each splat pair carries total weight L / I: scale so that the
        # image equals the path-traced mean
        scale = b_norm * n_px / ((k + 1) * n_chains)
        if mesh is None:
            yield film * scale, k + 1, n_steps, trace.stats
        elif (k + 1) % every == 0 or k + 1 == n_steps:
            merged = merged + mesh.all_reduce(film)
            film = torch.zeros_like(film)
            yield merged * scale, k + 1, n_steps, trace.stats


def render_pssmlt(scene, spp=None, seed=0, pack=None, chains=None, device="cuda", mesh=None):
    """A PSSMLT render (= PSSMLT::render, pssmlt.cpp) on `device`: `spp`
    is the mutations per pixel.  Returns the linear HDR image as numpy
    [H, W, 3]; the rays traced (by this rank, with `mesh`) are left in
    render_pssmlt.last_ray_count.  With `mesh` the chains split over its
    ranks (iter_pssmlt), which run on mesh.device, and every rank returns
    the image."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device) if mesh is None else mesh.device
    if pack is None:
        pack = pack_scene(scene, device)
    for img, _, _, stats in iter_pssmlt(scene, pack, spp, seed, chains, device, mesh):
        pass
    render_pssmlt.last_ray_count = stats["rays"]
    return add_direct_component(img.cpu().numpy(), scene, pack, scene.integrator, seed, device)
