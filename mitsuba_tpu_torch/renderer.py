"""Render orchestration (port of mitsuba_tpu/renderer.py: both branches
of `make_render_pass` and the whole-frame pass loop of `render`).

One render pass traces every pixel x a chunk of samples per pixel; passes
loop on the host.  Two strategies, chosen as the reference chooses them
(renderer.py:78-92):

* the regenerating wavefront, for scenes without media under a filter
  that supports importance sampling (box, tent, gaussian): each lane
  owns a pixel, starts the pixel's next sample as soon as a path ends,
  and accumulates into its own pixel with dense adds;
* the batched wavefront otherwise (every media scene, and the mitchell,
  catmullrom and lanczos filters): one lane per (sample, pixel), traced
  to completion by the integrator's trace function, and splatted into
  the filter footprint with `splat_grid`.

The lane -> (pixel, sample index) mapping is the reference's, so the port
draws the reference's random numbers.  A scene with subsurface materials
first runs the irradiance pass on a copy of its pack (integrator/sss.py
prepare_sss).  Spectral mode (`spectral_bins`) wraps all of this: it
renders each bin group on its own copy of the pack and projects the
groups through CIE XYZ.  The meta-integrators: `adaptive` and `irrcache`
have their own orchestration, `multichannel` renders each nested
integrator and stacks the images, and a render pass of a
meta-integrator is one of its nested integrator.  In the batched branch
a lane's result depends only on its (pixel, sample index), so the
reference's media lane budget and row bands (sized for its TPU's
execution limits) would change only the order of the film's float sums;
the port renders the frame whole.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np
import torch

from mitsuba_tpu_torch.film.film import develop, new_film, splat_grid
from mitsuba_tpu_torch.film.plugins import filter_importance_sample, supports_fis
from mitsuba_tpu_torch.integrator import volpath  # noqa: F401 (registers "volpath")
from mitsuba_tpu_torch.integrator.path import TRACE_FNS, path_trace_regen
from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.sensor.plugins import generate_rays

# lane budgets of the reference's defaults (renderer.py:27 and :98-100);
# they fix the lane -> (pixel, sample index) mapping, so they must match
DEFAULT_LANES_PER_PASS = 1 << 21  # rays in flight per pass
TARGET_LANES = 1 << 18  # regenerating lanes per pass at small resolutions
META_KINDS = ("adaptive", "irrcache", "multichannel")


def uses_regen(pack, film_rec) -> bool:
    """The reference's choice of the regenerating wavefront: a filter with
    importance sampling and no media (path and volpath are path-like)."""
    return supports_fis(film_rec.rfilter) and not pack.meta.get("has_media", False)


def make_render_pass(pack, integ, sensor_rec, film_rec, sampler_rec, spp_chunk,
                     device):
    """Build one render pass: fn(film, sample_base, seed) -> (film,
    n_rays), with n_rays the closest-hit + shadow rays it traced (an
    int64 tensor on `device`)."""
    w, h = film_rec.width, film_rec.height
    n_px = w * h
    cam = sensor_rec.pack(w, h, device)
    rfilter = film_rec.rfilter
    if integ.kind in META_KINDS:
        # a meta-integrator's pass is its nested integrator's, `path`
        # where that is missing or another meta-integrator (reference
        # renderer.py:60-67)
        integ = integ.sub_integrator or integ
        if integ.kind in META_KINDS:
            integ = IntegratorRecord(kind="path")
    if integ.kind not in TRACE_FNS:
        raise NotImplementedError(f"integrator '{integ.kind}' not yet ported")
    # only the path-like integrators regenerate (reference renderer.py:75-93)
    if integ.kind not in ("path", "volpath") or not uses_regen(pack, film_rec):
        return _batched_pass(pack, integ, cam, film_rec, sampler_rec, spp_chunk, device)

    # several regenerating lanes per pixel keep the device full at small
    # resolutions (reference renderer.py:95-105)
    lpp = max(min(TARGET_LANES // n_px, spp_chunk), 1)
    while spp_chunk % lpp:
        lpp -= 1
    spp_per_lane = spp_chunk // lpp
    n_lanes = lpp * n_px

    lane_all = torch.arange(n_lanes, dtype=torch.int64, device=device)
    lane = lane_all % n_px  # pixel id (RNG key)
    layer = lane_all // n_px
    px_x = (lane % w).to(torch.float32)
    px_y = (lane // w).to(torch.float32)

    def render_pass(film, sample_base, seed):
        sidx_off = (sample_base + layer * spp_per_lane) & 0xFFFFFFFF

        def make_ray(sample_i):
            sidx = sidx_off + sample_i.to(torch.int64)
            u2 = sampler_rec.pixel_sample(lane, sidx, sampler_rec.sample_count)
            jitter = filter_importance_sample(rfilter, u2)
            x = px_x + jitter[..., 0]
            y = px_y + jitter[..., 1]
            pos01 = torch.stack([x / w, y / h], dim=-1)
            u_lens = (
                sampler_rec.lens_sample(lane, sidx)
                if cam["use_lens"] else torch.zeros_like(u2)
            )
            return generate_rays(cam, pos01, u_lens)

        L_sum, n_done, n_rays = path_trace_regen(
            pack, integ, make_ray, n_lanes, spp_per_lane, lane, sampler_rec,
            seed, sidx_offset=sidx_off,
        )
        contrib = torch.cat([L_sum, n_done.to(torch.float32)[..., None]], dim=-1)
        film = film + contrib.reshape(lpp, h, w, 4).sum(dim=0)
        return film, n_rays

    return render_pass


def _batched_pass(pack, integ, cam, film_rec, sampler_rec, spp_chunk, device):
    """The classic batched wavefront (reference renderer.py:144-195):
    lanes [spp_chunk, H * W], grid-aligned so that the splat is dense."""
    trace = TRACE_FNS[integ.kind]
    w, h = film_rec.width, film_rec.height
    n_px = w * h
    px = torch.arange(n_px, dtype=torch.int64, device=device)
    lane = px[None, :].expand(spp_chunk, n_px).reshape(-1)
    px_x = (lane % w).to(torch.float32)
    px_y = (lane // w).to(torch.float32)
    s_i = torch.arange(spp_chunk, dtype=torch.int64, device=device)[:, None]

    def render_pass(film, sample_base, seed):
        sidx = ((sample_base + s_i) & 0xFFFFFFFF).expand(spp_chunk, n_px).reshape(-1)
        jitter = sampler_rec.pixel_sample(lane, sidx, sampler_rec.sample_count)
        pos01 = torch.stack([(px_x + jitter[..., 0]) / w, (px_y + jitter[..., 1]) / h], dim=-1)
        u_lens = (
            sampler_rec.lens_sample(lane, sidx) if cam["use_lens"] else torch.zeros_like(jitter)
        )
        o, d = generate_rays(cam, pos01, u_lens)
        L = trace(pack, integ, o, d, lane, sidx, sampler_rec, seed)
        film = splat_grid(film, jitter.reshape(spp_chunk, h, w, 2),
                          L.reshape(spp_chunk, h, w, 3), film_rec.rfilter)
        return film, trace.last_ray_count

    return render_pass


def render(scene, spp=None, seed=0, *, device="cuda", pack=None, spectral_bins=None,
           _spectral_inner=False):
    """Render a SceneDescription on `device` (the card unless the caller
    asks for another, e.g. "cpu"); returns the linear HDR image as numpy
    [H, W, 3], [H, W, 3 n] for a multichannel integrator of n nested ones
    (= RenderJob::run, reference src/librender/renderjob.cpp:87-113).
    `pack` is not changed: the irradiance pass of a subsurface scene and
    spectral mode fill copies.

    spectral_bins: render with N wavelength bins (a multiple of 3; also
    read from MTS_SPECTRAL_BINS) as N/3 bin-group renders of the 3-channel
    machinery, each with the shared seed, projected through CIE XYZ
    (reference renderer.py:231-262, core/spectral.py).

    render.last_ray_count: the rays that the last render traced through
    the pass loop below, over all bin groups in spectral mode (None after
    an integrator with its own orchestration)."""
    render.last_ray_count = None
    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    n_spec = spectral_bins or int(os.environ.get("MTS_SPECTRAL_BINS", "0"))
    if n_spec and not _spectral_inner:
        return _render_spectral(scene, spp, seed, device, pack, n_spec)
    integ = scene.integrator
    if pack.meta.get("has_sss", False):
        # the dipole preprocess (reference renderer.py:267-272,
        # dipole.cpp:preprocess)
        from mitsuba_tpu_torch.integrator.sss import prepare_sss

        pack = prepare_sss(pack, integ, seed)
    if integ.kind == "multichannel" and integ.sub_integrators:
        # each nested integrator renders with the same pack and seed, and
        # the channels stack (reference renderer.py:274-292; its children
        # render in lock-step in multichannel.cpp)
        imgs = []
        for sub in integ.sub_integrators:
            s2 = copy.copy(scene)
            s2.integrator = sub
            imgs.append(render(s2, spp=spp, seed=seed, device=device, pack=pack))
        return np.concatenate(imgs, axis=-1)
    if integ.kind == "irrcache":
        from mitsuba_tpu_torch.integrator.irrcache import render_irrcache

        return render_irrcache(scene, spp=spp, seed=seed, pack=pack, device=device)
    if integ.kind == "adaptive":
        from mitsuba_tpu_torch.integrator.adaptive import render_adaptive

        return render_adaptive(scene, spp=spp, seed=seed, pack=pack, device=device)
    # integrators with their own orchestration (reference renderer.py:298-310)
    if scene.integrator.kind == "bdpt":
        from mitsuba_tpu_torch.integrator.bdpt import render_bdpt

        return render_bdpt(scene, spp=spp, seed=seed, pack=pack, device=device)
    if scene.integrator.kind == "ptracer":
        from mitsuba_tpu_torch.integrator.ptracer import render_ptracer

        return render_ptracer(scene, spp=spp, seed=seed, pack=pack, device=device)
    # the chain integrators: spp is the mutations per pixel for pssmlt and
    # mlt, the seeds per pixel for erpt
    if scene.integrator.kind == "pssmlt":
        from mitsuba_tpu_torch.integrator.pssmlt import render_pssmlt

        return render_pssmlt(scene, spp=spp, seed=seed, pack=pack, device=device)
    if scene.integrator.kind in ("mlt", "erpt"):
        from mitsuba_tpu_torch.integrator import mlt

        fn = mlt.render_mlt if scene.integrator.kind == "mlt" else mlt.render_erpt
        return fn(scene, spp=spp, seed=seed, pack=pack, device=device)
    # the photon-density and many-light family (reference renderer.py:312-326)
    if scene.integrator.kind == "vpl":
        from mitsuba_tpu_torch.integrator.vpl import render_vpl

        return render_vpl(scene, spp=spp, seed=seed, pack=pack, device=device)
    if scene.integrator.kind == "photonmapper":
        # media scenes get the volume map and the beam radiance estimate;
        # without media this is sppm
        from mitsuba_tpu_torch.integrator.photonmapper import render_photonmapper

        return render_photonmapper(scene, spp=spp, seed=seed, pack=pack, device=device)
    if scene.integrator.kind in ("sppm", "ppm"):
        from mitsuba_tpu_torch.integrator.sppm import render_sppm

        return render_sppm(scene, spp=spp, seed=seed, pack=pack, device=device)
    sensor_rec = scene.sensor.record
    film_rec = sensor_rec.film
    sampler_rec = sensor_rec.sampler
    w, h = film_rec.width, film_rec.height
    spp = spp or sampler_rec.sample_count
    spp_chunk = max(1, min(spp, DEFAULT_LANES_PER_PASS // (w * h)))
    n_passes = math.ceil(spp / spp_chunk)
    render_pass = make_render_pass(
        pack, scene.integrator, sensor_rec, film_rec, sampler_rec, spp_chunk,
        device,
    )
    film = new_film(h, w, device)
    rays = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(n_passes):
        film, n_rays = render_pass(film, i * spp_chunk, seed)
        rays = rays + n_rays
    img = develop(film) * sensor_rec.ray_weight
    render.last_ray_count = int(rays)
    return img.cpu().numpy()


def _render_spectral(scene, spp, seed, device, pack, n_spec):
    """The spectral branch of `render`: every integrator renders each bin
    group on that group's pack (scene/builder.py apply_spectral_pack) with
    the same seed, so the groups share their noise; the developed images
    go to CIE XYZ through each group's slice of the binned matching
    functions, and the sum back to linear RGB, clamped at 0.
    render.last_ray_count is left at the rays of all groups (None where
    the integrator does not count them)."""
    from mitsuba_tpu_torch.core.spectral import make_bins
    from mitsuba_tpu_torch.core.spectrum import _XYZ_TO_RGB
    from mitsuba_tpu_torch.scene.builder import apply_spectral_pack

    bins = make_bins(n_spec)
    xyz, rays = None, 0
    for g in range(bins.n_groups):
        img_g = np.asarray(render(scene, spp=spp, seed=seed, device=device,
                                  pack=apply_spectral_pack(pack, bins, g), _spectral_inner=True))
        n = render.last_ray_count
        rays = None if n is None or rays is None else rays + n
        m3, _ = bins.group(g)
        contrib = img_g @ np.asarray(m3, np.float32).T
        xyz = contrib if xyz is None else xyz + contrib
    render.last_ray_count = rays
    return np.maximum(xyz @ _XYZ_TO_RGB.T, 0.0)
