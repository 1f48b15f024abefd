"""BSDF sample / eval / pdf over lanes (port of mitsuba_tpu/bsdf/eval.py,
the `diffuse` type).

Conventions as in the reference: `wi`, `wo` in the local shading frame
(+z = shading normal), both pointing away from the surface; `bsdf_eval`
returns f(wi, wo) * |cos theta_o|; `bsdf_sample` returns the weight
f * |cos| / pdf.  `present` is the static tuple of material types in the
scene; any type other than diffuse raises NotImplementedError.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_tpu_torch.bsdf.plugins import DIFFUSE
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core import warp

INV_PI = 1.0 / math.pi


class BSDFSample(NamedTuple):
    wo: torch.Tensor  # [..., 3] local frame
    weight: torch.Tensor  # [..., 3] f*cos/pdf
    pdf: torch.Tensor  # [...] solid-angle pdf
    delta: torch.Tensor  # [...] bool, sampled a Dirac lobe
    eta: torch.Tensor  # [...] relative IOR change


def _check(sp, present):
    if "mix" in sp:
        raise NotImplementedError("mixture/coating BSDFs not yet ported")
    other = sorted(set(present) - {DIFFUSE})
    if other:
        raise NotImplementedError(f"bsdf types {other} not yet ported")


def _mask3(mask, rgb):
    return torch.where(mask[..., None], rgb, 0.0)


def _diffuse_eval(sp, wi, wo):
    mask = (mm.cos_theta(wi) > 0) & (mm.cos_theta(wo) > 0)
    return _mask3(
        mask, sp["cA"] * (INV_PI * torch.clamp(mm.cos_theta(wo), min=0.0))[..., None]
    )


def _diffuse_pdf(sp, wi, wo):
    mask = (mm.cos_theta(wi) > 0) & (mm.cos_theta(wo) > 0)
    return torch.where(mask, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _flip_twosided(sp, wi, *rest):
    """Two-sided materials: mirror the frame when hit from the back
    (reference src/bsdfs/twosided.cpp)."""
    flip = (sp["twosided"] > 0.5) & (mm.cos_theta(wi) < 0)
    fz = torch.where(flip, -1.0, 1.0)[..., None]
    flip_vec = torch.cat([torch.ones_like(fz), torch.ones_like(fz), fz], dim=-1)
    return flip_vec, [wi * flip_vec] + [w * flip_vec for w in rest]


def bsdf_eval(sp, wi, wo, present):
    """f(wi, wo) * |cos_o| for the per-lane material."""
    _check(sp, present)
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    return _mask3(sp["type"] == DIFFUSE, _diffuse_eval(sp, wi, wo))


def bsdf_pdf(sp, wi, wo, present):
    """Solid-angle density of bsdf_sample producing wo."""
    _check(sp, present)
    _, (wi, wo) = _flip_twosided(sp, wi, wo)
    return torch.where(sp["type"] == DIFFUSE, _diffuse_pdf(sp, wi, wo), 0.0)


def bsdf_sample(sp, wi, u2, ulobe, present):
    """Sample an outgoing direction per lane (cosine-weighted for the
    diffuse lobe); lanes lit from below get weight 0."""
    _check(sp, present)
    flip_vec, (wi,) = _flip_twosided(sp, wi)
    tm = sp["type"] == DIFFUSE
    wo = warp.square_to_cosine_hemisphere(u2)
    weight = _mask3(tm, _mask3(mm.cos_theta(wi) > 0, sp["cA"]))
    pdf = torch.where(tm, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)
    wo = _mask3(tm, wo) * flip_vec
    return BSDFSample(
        wo=wo,
        weight=weight,
        pdf=pdf,
        delta=torch.zeros_like(tm),
        eta=torch.ones_like(pdf),
    )
