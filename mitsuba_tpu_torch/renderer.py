"""Render orchestration (port of mitsuba_tpu/renderer.py: both branches
of `make_render_pass`, the pass loop of `render` with its options, the
row bands of the out-of-core film, and `render_to_file`).

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
meta-integrator is one of its nested integrator.

`render`'s options are the reference's: `lanes_per_pass` (or
MTS_TPU_LANES_PER_PASS) bounds the lanes, and so the memory, of a pass;
`progress(i, n)` is called after each pass, once the device has finished
it; `checkpoint` saves the film every `checkpoint_every` passes and
resumes from the file it finds; `return_film` returns the [H, W, 4] film
beside the image.  Both pass loops (the whole frame's and each row
band's) run through parallel/elastic.py `run_passes`: a recoverable
failure re-queues the passes lost since the checkpoint, or since the
film's start.  The `tiledhdrfilm` film renders in row bands through
the batched wavefront (whatever its filter), each band with a halo of the
filter's footprint, and flushes each developed band to a host memory-map
(reference renderer.py:379-462).  Lane ids stay global pixel ids, so a
band's samples are those of the whole-frame splat.  The reference also
bands media scenes past MTS_TPU_MEDIA_LANES: that budget bounds the time
of one of its TPU's executions, which the card does not have, and in the
batched branch a lane's result depends only on its (pixel, sample index),
so bands would change only the order of the film's float sums; the port
renders a media scene in whole-frame passes, which `lanes_per_pass`
bounds.
"""

from __future__ import annotations

import copy
import math
import os
import tempfile

import numpy as np
import torch

from mitsuba_tpu_torch.core.logging import counter, logger
from mitsuba_tpu_torch.film.film import develop, new_film, splat_grid
from mitsuba_tpu_torch.film.plugins import filter_importance_sample, supports_fis
from mitsuba_tpu_torch.integrator import volpath  # noqa: F401 (registers "volpath")
from mitsuba_tpu_torch.integrator.path import TRACE_FNS, path_trace_regen
from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
from mitsuba_tpu_torch.parallel import elastic
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
                     device, band_rows=None):
    """Build one render pass: fn(film, sample_base, seed) -> (film,
    n_rays), with n_rays the closest-hit + shadow rays it traced (an
    int64 tensor on `device`).  With `band_rows` the pass is the batched
    wavefront's over `band_rows` film rows: fn(band, sample_base, seed,
    row0), band [band_rows, W, 4], its first row at film row `row0` (below
    0 or past the frame in a halo, where its lanes add nothing)."""
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
    # only the path-like integrators regenerate, and never in bands
    # (reference renderer.py:75-93)
    if (integ.kind not in ("path", "volpath") or not uses_regen(pack, film_rec)
            or band_rows is not None):
        return _batched_pass(pack, integ, cam, film_rec, sampler_rec, spp_chunk, device,
                             band_rows)

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


def _batched_pass(pack, integ, cam, film_rec, sampler_rec, spp_chunk, device, band_rows=None):
    """The classic batched wavefront (reference renderer.py:144-195):
    lanes [spp_chunk, rows * W], grid-aligned so that the splat is dense;
    the whole frame, or `band_rows` rows from a row given to each call."""
    trace = TRACE_FNS[integ.kind]
    w, h = film_rec.width, film_rec.height
    n_px = w * h
    rows = h if band_rows is None else band_rows
    s_i = torch.arange(spp_chunk, dtype=torch.int64, device=device)[:, None]

    def lanes(base_px):
        """Each lane's pixel (clamped into the frame), its coordinates, and
        whether the pixel lies in the frame."""
        px_i = base_px + torch.arange(rows * w, dtype=torch.int64, device=device)
        in_frame = (px_i >= 0) & (px_i < n_px)
        lane = torch.clamp(px_i, 0, n_px - 1)[None, :].expand(spp_chunk, rows * w).reshape(-1)
        valid = in_frame[None, :].expand(spp_chunk, rows * w).reshape(spp_chunk, rows, w)
        return lane, (lane % w).to(torch.float32), (lane // w).to(torch.float32), valid

    frame = lanes(0) if band_rows is None else None

    def render_pass(film, sample_base, seed, row0=None):
        lane, px_x, px_y, valid = frame if row0 is None else lanes(row0 * w)
        sidx = ((sample_base + s_i) & 0xFFFFFFFF).expand(spp_chunk, rows * w).reshape(-1)
        jitter = sampler_rec.pixel_sample(lane, sidx, sampler_rec.sample_count)
        pos01 = torch.stack([(px_x + jitter[..., 0]) / w, (px_y + jitter[..., 1]) / h], dim=-1)
        u_lens = (
            sampler_rec.lens_sample(lane, sidx) if cam["use_lens"] else torch.zeros_like(jitter)
        )
        o, d = generate_rays(cam, pos01, u_lens)
        L = trace(pack, integ, o, d, lane, sidx, sampler_rec, seed)
        film = splat_grid(film, jitter.reshape(spp_chunk, rows, w, 2),
                          L.reshape(spp_chunk, rows, w, 3), film_rec.rfilter,
                          valid=None if row0 is None else valid)
        return film, trace.last_ray_count

    return render_pass


def render(scene, spp=None, seed=0, *, device="cuda", pack=None, lanes_per_pass=None,
           progress=None, return_film=False, checkpoint=None, checkpoint_every=8,
           spectral_bins=None, _spectral_inner=False):
    """Render a SceneDescription on `device` (the card unless the caller
    asks for another, e.g. "cpu"); returns the linear HDR image as numpy
    [H, W, 3], [H, W, 3 n] for a multichannel integrator of n nested ones,
    a host np.memmap for the tiledhdrfilm film
    (= RenderJob::run, reference src/librender/renderjob.cpp:87-113).
    `pack` is not changed: the irradiance pass of a subsurface scene and
    spectral mode fill copies.

    lanes_per_pass: the lanes of one pass (default DEFAULT_LANES_PER_PASS,
    or MTS_TPU_LANES_PER_PASS): a pass renders max(1, lanes // (W H))
    samples per pixel, and ceil(spp / that) passes run.
    progress(i, n): called after pass i of n (1-based) has finished on the
    device.
    checkpoint: an .npz path; the film, the passes done and the samples
    per pass are saved every `checkpoint_every` passes and after the last,
    and a render finding the file with its film shape and samples per pass
    resumes from it (the counter RNG makes the result that of an
    uninterrupted render; the reference's analogue is its render queue's
    snapshot and resume).
    return_film: return (image, film), the film [H, W, 4] (weighted RGB,
    weight) on `device`; for an integrator with its own orchestration,
    multichannel and spectral mode, the image's first three channels with
    an alpha of ones.

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
        img = _render_spectral(scene, spp, seed, device, pack, n_spec, lanes_per_pass)
        return (img, _ones_alpha(img, device)) if return_film else img
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
        out = np.concatenate(imgs, axis=-1)
        return (out, _ones_alpha(imgs[0], device)) if return_film else out
    img = _render_orchestrated(scene, spp, seed, device, pack)
    if img is not None:
        return (img, _ones_alpha(img, device)) if return_film else img
    sensor_rec = scene.sensor.record
    film_rec = sensor_rec.film
    w, h = film_rec.width, film_rec.height
    spp = spp or sensor_rec.sampler.sample_count
    lanes = lanes_per_pass or int(os.environ.get("MTS_TPU_LANES_PER_PASS",
                                                 DEFAULT_LANES_PER_PASS))
    if film_rec.out_of_core:
        return _render_bands(scene, pack, spp, seed, device, lanes, progress, return_film)
    spp_chunk = max(1, min(spp, lanes // (w * h)))
    n_passes = math.ceil(spp / spp_chunk)
    logger.debug("render: %dx%d, %d spp (%d passes x %d), integrator=%s",
                 w, h, spp, n_passes, spp_chunk, integ.kind)
    rays = {}  # pass -> its rays; a re-queued pass replaces its entry

    def build_pass(attempt):
        return make_render_pass(pack, integ, sensor_rec, film_rec, sensor_rec.sampler,
                                spp_chunk, device)

    def run_pass(render_pass, film, i):
        film, rays[i] = render_pass(film, i * spp_chunk, seed)
        return film

    def after_pass(film, i):
        counter("Samples rendered").add(spp_chunk * w * h)
        if checkpoint and ((i + 1) % checkpoint_every == 0 or i + 1 == n_passes):
            np.savez(checkpoint, film=film.cpu().numpy(), passes_done=i + 1,
                     spp_chunk=spp_chunk)
        if progress:
            _synchronize(device)
            progress(i + 1, n_passes)

    # the checkpoint is also the re-queue point after a recoverable failure
    film = elastic.run_passes(
        build_pass, run_pass, n_passes, film_init=lambda: new_film(h, w, device),
        reload_state=lambda: _resume(checkpoint, (h, w, 4), spp_chunk), after_pass=after_pass,
        device=device)
    # constant sampleRay importance (irradiancemeter's pi; 1 otherwise)
    img = (develop(film) * sensor_rec.ray_weight).cpu().numpy()
    render.last_ray_count = int(sum(rays.values(), torch.zeros((), dtype=torch.int64)))
    return (img, film) if return_film else img


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ones_alpha(img, device):
    """The film an integrator without a weighted film returns: the image's
    first three channels and an alpha of ones, [H, W, 4] float32 on
    `device` (reference renderer.py:254-256)."""
    rgb = torch.as_tensor(np.asarray(img)[..., :3], dtype=torch.float32, device=device)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def _resume(checkpoint, shape, spp_chunk):
    """(film as numpy, passes done) of a checkpoint whose film shape and
    samples per pass match, else None."""
    if not checkpoint or not os.path.exists(checkpoint):
        return None
    with np.load(checkpoint) as ck:
        if tuple(ck["film"].shape) != shape or int(ck["spp_chunk"]) != spp_chunk:
            return None
        logger.info("render: resumed from %s at pass %d", checkpoint, int(ck["passes_done"]))
        return ck["film"], int(ck["passes_done"])


def _render_orchestrated(scene, spp, seed, device, pack):
    """The image of an integrator with its own orchestration (reference
    renderer.py:298-326), else None."""
    kind = scene.integrator.kind
    kw = dict(spp=spp, seed=seed, pack=pack, device=device)
    if kind == "irrcache":
        from mitsuba_tpu_torch.integrator.irrcache import render_irrcache

        return render_irrcache(scene, **kw)
    if kind == "adaptive":
        from mitsuba_tpu_torch.integrator.adaptive import render_adaptive

        return render_adaptive(scene, **kw)
    if kind == "bdpt":
        from mitsuba_tpu_torch.integrator.bdpt import render_bdpt

        return render_bdpt(scene, **kw)
    if kind == "ptracer":
        from mitsuba_tpu_torch.integrator.ptracer import render_ptracer

        return render_ptracer(scene, **kw)
    # the chain integrators: spp is the mutations per pixel for pssmlt and
    # mlt, the seeds per pixel for erpt
    if kind == "pssmlt":
        from mitsuba_tpu_torch.integrator.pssmlt import render_pssmlt

        return render_pssmlt(scene, **kw)
    if kind in ("mlt", "erpt"):
        from mitsuba_tpu_torch.integrator import mlt

        return (mlt.render_mlt if kind == "mlt" else mlt.render_erpt)(scene, **kw)
    # the photon-density and many-light family
    if kind == "vpl":
        from mitsuba_tpu_torch.integrator.vpl import render_vpl

        return render_vpl(scene, **kw)
    if kind == "photonmapper":
        # media scenes get the volume map and the beam radiance estimate;
        # without media this is sppm
        from mitsuba_tpu_torch.integrator.photonmapper import render_photonmapper

        return render_photonmapper(scene, **kw)
    if kind in ("sppm", "ppm"):
        from mitsuba_tpu_torch.integrator.sppm import render_sppm

        return render_sppm(scene, **kw)
    return None


def band_plan(film_rec, spp, lanes):
    """(rows a band renders, halo rows on each side, bands, samples per
    pixel a pass, passes a band) of the out-of-core film: bands of
    `lanes` // W rows less the halos, at least 8 and at most the film's
    height, whose halo holds every filter footprint that crosses the
    band's edge (reference renderer.py:379-392, which sizes them by
    MTS_TPU_MEDIA_LANES and does not cap them)."""
    w, h = film_rec.width, film_rec.height
    pad = max(int(math.ceil(0.5 + film_rec.rfilter.radius)) - 1, 0)
    hb = min(max(lanes // w - 2 * pad, 8), h)
    spp_chunk = max(1, min(spp, max(lanes // ((hb + 2 * pad) * w), 1)))
    return hb, pad, math.ceil(h / hb), spp_chunk, math.ceil(spp / spp_chunk)


def _render_bands(scene, pack, spp, seed, device, lanes, progress, return_film):
    """tiledhdrfilm: render row band after row band, each with its filter
    halo, and flush each developed band to a host memory-map in a new
    temporary directory, so the whole film never lies on the device
    (reference renderer.py:393-462; tiledhdrfilm.cpp's out-of-core
    contract, its custom EXR tile writer aside)."""
    sensor_rec = scene.sensor.record
    film_rec = sensor_rec.film
    w, h = film_rec.width, film_rec.height
    hb, pad, n_bands, spp_chunk, n_passes = band_plan(film_rec, spp, lanes)
    hbe = hb + 2 * pad

    def build_pass(attempt):
        return make_render_pass(pack, scene.integrator, sensor_rec, film_rec,
                                sensor_rec.sampler, spp_chunk, device, band_rows=hbe)
    tdir = tempfile.mkdtemp(prefix="mts_tiledfilm_")
    film_mm = np.lib.format.open_memmap(os.path.join(tdir, "film.npy"), mode="w+",
                                        dtype=np.float32, shape=(h, w, 4))
    img_mm = np.lib.format.open_memmap(os.path.join(tdir, "image.npy"), mode="w+",
                                       dtype=np.float32, shape=(h, w, 3))
    rays = {}  # (band, pass) -> its rays; a re-queued pass replaces its entry
    for b in range(n_bands):
        def run_pass(render_pass, band, i, b=b):
            band, rays[b, i] = render_pass(band, i * spp_chunk, seed, b * hb - pad)
            return band

        def after_pass(band, i, b=b):
            if progress:
                _synchronize(device)
                progress(b * n_passes + i + 1, n_bands * n_passes)

        # a failure re-queues only the current band's passes
        band = elastic.run_passes(build_pass, run_pass, n_passes,
                                  film_init=lambda: new_film(hbe, w, device),
                                  after_pass=after_pass, device=device)
        rows = min(hb, h - b * hb)
        band = band[pad:pad + rows]
        film_mm[b * hb:b * hb + rows] = band.cpu().numpy()
        img_mm[b * hb:b * hb + rows] = (develop(band) * sensor_rec.ray_weight).cpu().numpy()
    film_mm.flush()
    img_mm.flush()
    render.last_ray_count = int(sum(rays.values(), torch.zeros((), dtype=torch.int64)))
    return (img_mm, film_mm) if return_film else img_mm


def render_to_file(scene, output=None, **kw):
    """Render and write through the film's output format (= film->develop
    and Bitmap::write, reference hdrfilm.cpp; renderer.py:535-547): the
    image goes through `FilmRecord.develop_to_array`, to `output` or else
    beside the scene's XML with the film's extension.  `kw` are render's.
    Returns (the path written, the developed image)."""
    from mitsuba_tpu_torch.io.images import write_image

    img = render(scene, **kw)
    film_rec = scene.sensor.record.film
    img = film_rec.develop_to_array(img)
    if output is None:
        output = os.path.splitext(scene.path)[0] + film_rec.output_extension()
    write_image(output, img)
    return output, img


def _render_spectral(scene, spp, seed, device, pack, n_spec, lanes_per_pass=None):
    """The spectral branch of `render`: every integrator renders each bin
    group on that group's pack (scene/builder.py apply_spectral_pack) with
    the same seed and lanes per pass, so the groups share their noise; the
    developed images go to CIE XYZ through each group's slice of the
    binned matching functions, and the sum back to linear RGB, clamped at
    0.  render.last_ray_count is left at the rays of all groups (None where
    the integrator does not count them)."""
    from mitsuba_tpu_torch.core.spectral import make_bins
    from mitsuba_tpu_torch.core.spectrum import _XYZ_TO_RGB
    from mitsuba_tpu_torch.scene.builder import apply_spectral_pack

    bins = make_bins(n_spec)
    xyz, rays = None, 0
    for g in range(bins.n_groups):
        img_g = np.asarray(render(scene, spp=spp, seed=seed, device=device,
                                  pack=apply_spectral_pack(pack, bins, g),
                                  lanes_per_pass=lanes_per_pass, _spectral_inner=True))
        n = render.last_ray_count
        rays = None if n is None or rays is None else rays + n
        m3, _ = bins.group(g)
        contrib = img_g @ np.asarray(m3, np.float32).T
        xyz = contrib if xyz is None else xyz + contrib
    render.last_ray_count = rays
    return np.maximum(xyz @ _XYZ_TO_RGB.T, 0.0)
