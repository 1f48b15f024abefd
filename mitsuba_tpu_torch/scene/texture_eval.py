"""Per-lane shading parameters and frames (port of
mitsuba_tpu/scene/texture_eval.py for constant material parameters;
textures, mip maps and bump maps are not ported yet)."""

from __future__ import annotations

import torch

from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_fused


def mip_footprint(pack, its):
    """uv-space footprint for mip filtering: None without mip maps."""
    if pack.meta.get("has_mips", False):
        raise NotImplementedError("mip-mapped textures not yet ported")
    return None


def shading_params(pack, mat_id, uv, fp=None, its=None):
    """Gather the per-lane material parameters bsdf/eval.py reads."""
    if fp is not None or pack.meta.get("has_textures", False):
        raise NotImplementedError("textures not yet ported")
    m = torch.clamp(mat_id, min=0)
    typ, cA, twos = take_fused(m, pack.mat_type, pack.mat_cA, pack.mat_twosided)
    return {"type": typ, "cA": cA, "twosided": twos}


def shading_frame(pack, its):
    """Shading frame at the hit (no bump or normal maps)."""
    if pack.meta.get("has_bumpmaps", False):
        raise NotImplementedError("bump/normal maps not yet ported")
    return mm.Frame.from_normal(its.ns)
