"""Adaptive sampling meta-integrator (port of
mitsuba_tpu/integrator/adaptive.py, reference
src/integrators/misc/adaptive.cpp).

The reference renders blocks repeatedly and stops a block once a t-test
on its sample mean passes at maxError; the wavefront form, which this
port keeps:

* base: two independent half buffers A and B (same pixels, disjoint
  sample ranges), each `half` samples of the nested integrator a pixel;
* error map: |lum(A) - lum(B)| / (2 half), relative to lum(mean), a
  two-fold jackknife in place of the t-test statistic; pixels above
  maxError carry their error as mass;
* refinement rounds: every lane is re-aimed at a pixel drawn in
  proportion to the mass (stratified inversion of its CDF) and traces
  one more sample there, added to (sum, count).  Lanes that land on one
  pixel take consecutive sample indices past its count, so every sample
  index of a pixel is used once;
* stop: when no pixel is above maxError, or after maxSampleFactor * spp /
  2 rounds.

The nested integrator is the first child (`path` when there is none),
traced by path_trace as in the reference.
"""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.integrator.path import path_trace
from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
from mitsuba_tpu_torch.sensor.plugins import generate_rays

LUM = (0.212671, 0.715160, 0.072169)


def error_cdf(sum_l, count, a, b, half, max_error):
    """The refinement's error map: the mean's luminance, the half
    buffers' jackknife error relative to it (at least 1e-3), and the CDF
    of the mass of the pixels above max_error.  Returns the CDF [n_px]."""
    lum = torch.tensor(LUM, dtype=torch.float32, device=sum_l.device)
    lum_m = (sum_l / count[:, None]) @ lum
    err = torch.abs((a - b) @ lum) / (2.0 * half)
    rel = err / torch.clamp(lum_m, min=1e-3)
    return torch.cumsum(torch.where(rel > max_error, rel, 0.0), dim=0)


def refine_targets(cdf, count, it, seed):
    """One round's (pixel, sample index) per lane [n_px]: lane i aims at
    the pixel owning the mass slice (i + u) / n of the CDF's total; lanes
    sharing a pixel take consecutive indices past its count, in lane
    order."""
    n_px = cdf.shape[0]
    dev = cdf.device
    lane = torch.arange(n_px, dtype=torch.int64, device=dev)
    u = rng.rand1(lane, it, 4021, rng.stream_seed(seed, rng.STREAM_CAMERA))
    pos = (lane.to(torch.float32) + u) / n_px * cdf[-1]
    px = torch.clamp(torch.searchsorted(cdf, pos, right=True), 0, n_px - 1)
    order = torch.argsort(px, stable=True)
    px_s = px[order]
    first = torch.searchsorted(px_s, px_s, right=False)
    rank = torch.empty_like(px)
    rank[order] = lane - first
    sidx = (count[px].to(torch.int64) + rank) & 0xFFFFFFFF
    return px, sidx


def render_adaptive(scene, spp=None, seed=0, pack=None, device="cuda"):
    """Adaptive rendering on `device` (reference adaptive.py:39-127).
    Returns numpy [H, W, 3]; the refinement rounds run and the rays traced
    (closest-hit and shadow) are left in render_adaptive.last_stats."""
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = torch.device(device)
    if pack is None:
        pack = pack_scene(scene, device)
    sensor = scene.sensor.record
    sampler = sensor.sampler
    w, h = sensor.film.width, sensor.film.height
    spp = spp or sampler.sample_count
    cam = sensor.pack(w, h, device)
    integ = scene.integrator
    sub = integ.sub_integrator or IntegratorRecord(kind="path")
    max_error = integ.max_error or 0.05
    max_factor = integ.max_sample_factor or 8

    n_px = w * h
    lane = torch.arange(n_px, dtype=torch.int64, device=device)
    rays = []

    def trace_px(px, sidx):
        u2 = sampler.pixel_sample(px, sidx, spp)
        pos01 = torch.stack([((px % w).to(torch.float32) + u2[..., 0]) / w,
                             ((px // w).to(torch.float32) + u2[..., 1]) / h], dim=-1)
        o, d = generate_rays(cam, pos01, torch.zeros_like(u2))
        L = path_trace(pack, sub, o, d, px, sidx, sampler, seed)
        rays.append(path_trace.last_ray_count)
        return L

    half = max(spp // 2, 2)

    def base_pass(sidx0):
        acc = torch.zeros(n_px, 3, dtype=torch.float32, device=device)
        for k in range(half):
            acc = acc + trace_px(lane, torch.full_like(lane, sidx0 + k))
        return acc

    a = base_pass(0)
    b = base_pass(half)
    sum_l = a + b
    count = torch.full((n_px,), 2.0 * half, dtype=torch.float32, device=device)

    rounds = 0
    for it in range(int(math.ceil(max_factor * spp / 2))):
        cdf = error_cdf(sum_l, count, a, b, half, max_error)
        px, sidx = refine_targets(cdf, count, 1000 + it, seed)
        L = trace_px(px, sidx)
        live = float(cdf[-1]) > 0.0
        scale = 1.0 if live else 0.0
        sum_l = sum_l.index_add(0, px, L * scale)
        count = count.index_add(0, px, torch.full_like(count, scale))
        rounds += 1
        if not live:
            break
    render_adaptive.last_stats = {"rounds": rounds, "rays": int(sum(rays))}
    img = sum_l / count[:, None]
    return img.reshape(h, w, 3).cpu().numpy()


render_adaptive.last_stats = None
