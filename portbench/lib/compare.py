"""The comparisons that decide `correct`.

Renders.  A sample of pixels, drawn from the seed, is rendered again by
the plain reference with many samples each, which gives each pixel's
expected value R and the variance S of one sample.  The sampled pixels
are dealt out in turn to the window's images, so every image is checked
and each pixel against one image only: the program's value P of a pixel
holds n_p = spp samples, and P - R has the variance
v = S (1 / n_p + 1 / n_r).  (Two images of one window are not independent
where they share a pixel: the program draws the film jitter of a pixel's
sample from the pixel and the sample's index alone, not from the render
seed.)  Two numbers are compared:

* bias_z: the largest over the colour channels of |sum (P - R)| /
  sqrt(sum v), a z-score of the whole sample's error: a biased image
  reads high;
* noise_ratio: sum (P - R)^2 / sum v: an image with fewer samples than
  it claims, a shifted one or a noisy one reads high.

A non-finite value anywhere in any image fails the run outright.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def pixel_sample(width, height, k, seed):
    """k distinct flat pixel ids (y W + x), drawn from `seed`."""
    g = torch.Generator().manual_seed(mix(seed, 0x5EED))
    return torch.randperm(width * height, generator=g)[:min(k, width * height)]


def mix(seed, salt):
    return (int(seed) * 0x9E3779B1 + salt) % (1 << 62)


def reference_generator(seed, device):
    return torch.Generator(device=device).manual_seed(mix(seed, 0xBEEF))


def render_numbers(p, r, s, n_p, n_r):
    """bias_z and noise_ratio of the program's pixel values p [K, 3]
    against the reference's means r and sample variances s (numpy)."""
    p, r, s = (np.asarray(x, np.float64) for x in (p, r, s))
    v = s * (1.0 / n_p + 1.0 / n_r)
    d = p - r
    vsum = np.maximum(v.sum(axis=0), 1e-300)
    bias_z = float(np.max(np.abs(d.sum(axis=0)) / np.sqrt(vsum)))
    noise_ratio = float((d * d).sum() / max(v.sum(), 1e-300))
    if not np.all(np.isfinite(p)):
        bias_z = noise_ratio = math.inf
    return {"bias_z": bias_z, "noise_ratio": noise_ratio}


def dealt_pixels(images, pix):
    """(the value [K, 3] float64 of pixel pix[j] in image j mod len(images),
    the count of non-finite values over all images)."""
    idx = pix.numpy()
    out = np.empty((len(idx), 3), np.float64)
    bad = 0
    for k, img in enumerate(images):
        flat = np.asarray(img, np.float32).reshape(-1, 3)
        bad += int(flat.size - np.isfinite(flat).sum())
        mine = np.arange(k, len(idx), len(images))
        out[mine] = flat[idx[mine]]
    return out, bad


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): each number at most its limit."""
    lines = [(k, numbers[k], limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in lines)
    return ok, lines


def check_render(images, ref, spp, seed, device, pixels, ref_spp, lanes=1 << 21):
    """The render comparison of the window's `images` (numpy [H, W, 3],
    each of `spp` samples) against the plain reference of RefScene `ref`
    on `device`: bias_z, noise_ratio and nonfinite_values."""
    from portbench.reference.pathtrace import Tracer, render_pixels

    pix = pixel_sample(ref.width, ref.height, pixels, seed)
    p, bad = dealt_pixels(images, pix)
    tracer = Tracer(ref, device, torch.float32)
    _, r, s = render_pixels(tracer, pix.to(device), ref_spp, reference_generator(seed, device),
                            lanes)
    numbers = render_numbers(p, r.cpu().numpy(), s.cpu().numpy(), spp, ref_spp)
    numbers["nonfinite_values"] = float(bad)
    return numbers
