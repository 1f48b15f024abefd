"""Per-lane shading parameters, textures and frames (port of
mitsuba_tpu/scene/texture_eval.py for scenes without mip maps: constant
and checkerboard textures, and the row chains of mixtures and coatings;
bitmaps, mip maps and bump maps are not ported yet)."""

from __future__ import annotations

import numpy as np
import torch

from mitsuba_tpu_torch.bsdf.plugins import (
    COATING,
    CONDUCTOR,
    DIELECTRIC,
    DIFFTRANS,
    DIFFUSE,
    HK,
    PHONG_BSDF,
    PLASTIC,
    ROUGHCOATING,
    ROUGHCONDUCTOR,
    ROUGHDIELECTRIC,
    ROUGHDIFFUSE,
    ROUGHPLASTIC,
    THINDIELECTRIC,
    WARD,
)
from mitsuba_tpu_torch.core import math as mm
from mitsuba_tpu_torch.core.gather import take_fused
from mitsuba_tpu_torch.scene.textures import TEX_CHECKERBOARD

# the per-material parameters shading_params reads: (key, the pack's
# array, width, integer).  The pack also holds those that the scene's
# material types read (material_columns) stacked in two tables, one gather
# each: mat_params (float32) and mat_iparams (int32).  A gather per array
# would be one more kernel launch per bounce for each.  The tables are
# column-major ([rows, M]), so that each parameter's lanes come out
# contiguous
MAT_COLUMNS = (
    ("type", "mat_type", 1, True),
    ("cA", "mat_cA", 3, False),
    ("cB", "mat_cB", 3, False),
    ("cC", "mat_cC", 3, False),
    ("cD", "mat_cD", 3, False),
    ("alpha_u", "mat_alpha_u", 1, False),
    ("alpha_v", "mat_alpha_v", 1, False),
    ("eta", "mat_eta", 1, False),
    ("exponent", "mat_exponent", 1, False),
    ("dist", "mat_dist", 1, True),
    ("nonlinear", "mat_nonlinear", 1, False),
    ("twosided", "mat_twosided", 1, False),
    ("fdr_int", "mat_fdr_int", 1, False),
    ("spec_w", "mat_spec_w", 1, False),
    ("texA", "mat_texA", 1, True),
    ("rt", "mat_rt", 4, False),
    ("rt_fdr", "mat_rt_fdr", 1, False),
    # the link of a mixture chain or a coating to its next row (-1: none)
    # and the two weights (scenes with mixtures only; shading_params
    # follows the links into sp["mix"])
    ("mix_b", "mat_mix_b", 1, True),
    ("mix_wa", "mat_mix_wa", 1, False),
    ("mix_wb", "mat_mix_wb", 1, False),
)
_MIX_KEYS = ("mix_b", "mix_wa", "mix_wb")

_MICROFACET = ("dist", "alpha_u", "alpha_v")
# the parameters each ported type reads in bsdf/eval.py, beside "type"
# and "twosided", which every lane reads
TYPE_KEYS = {
    DIFFUSE: ("cA",),
    CONDUCTOR: ("cB", "cC", "cD"),
    ROUGHCONDUCTOR: ("cB", "cC", "cD") + _MICROFACET,
    DIELECTRIC: ("eta", "cB", "cC"),
    ROUGHDIELECTRIC: ("eta", "cB", "cC") + _MICROFACET,
    PLASTIC: ("eta", "spec_w", "cA", "cB", "fdr_int", "nonlinear"),
    ROUGHPLASTIC: ("eta", "spec_w", "cA", "cB", "rt", "rt_fdr", "nonlinear") + _MICROFACET,
    ROUGHDIFFUSE: ("cA", "alpha_u"),
    THINDIELECTRIC: ("eta", "cB", "cC"),
    PHONG_BSDF: ("spec_w", "cA", "cB", "exponent"),
    WARD: ("spec_w", "cA", "cB", "alpha_u", "alpha_v"),
    DIFFTRANS: ("cA",),
    HK: ("cB", "cC", "alpha_u", "alpha_v"),
    COATING: ("eta", "spec_w", "cB", "cD"),
    ROUGHCOATING: ("eta", "spec_w", "cB", "cD", "rt") + _MICROFACET,
}


def material_columns(meta):
    """The MAT_COLUMNS entries that a scene with this meta reads: those of
    its material types, and, where it has textures, texA with cA, the
    colour of the lanes without one."""
    keys = {"type", "twosided"}
    for t in meta.get("present_types", (DIFFUSE,)):
        keys.update(TYPE_KEYS.get(t, ()))
    if meta.get("has_textures", False):
        keys.update(("texA", "cA"))
    if meta.get("has_mixtures", False):
        keys.update(_MIX_KEYS)
    return tuple(c for c in MAT_COLUMNS if c[0] in keys)


def material_table(arrays, meta):
    """(mat_params [F, M] float32, mat_iparams [I, M] int32): the
    material_columns arrays, one row per component."""
    n = len(arrays["mat_type"])
    cols = material_columns(meta)

    def rows(integer, dtype):
        parts = [np.asarray(arrays[name], dtype).reshape(n, w).T
                 for _, name, w, i in cols if i == integer]
        return np.concatenate(parts, axis=0)

    return rows(False, np.float32), rows(True, np.int32)


def eval_texture(pack, tid, uv, default_rgb):
    """tid: [R] int32 texture ids (-1 -> default_rgb [R, 3]); uv: [R, 2].
    The pack holds constant and checkerboard textures only (the builder
    refuses other kinds)."""
    has = tid >= 0
    kind, c0, c1, scale, uvt = take_fused(
        torch.clamp(tid, min=0), pack.tex_type, pack.tex_c0, pack.tex_c1,
        pack.tex_scale, pack.tex_uv,
    )  # uvt = uscale, vscale, uoffset, voffset
    u = uv[..., 0] * uvt[..., 0] + uvt[..., 2]
    v = uv[..., 1] * uvt[..., 1] + uvt[..., 3]
    # checkerboard (src/textures/checkerboard.cpp eval): parity of
    # floor(2u) + floor(2v), a floor-mod as the reference's int32 %
    xi = torch.floor(u * 2.0).to(torch.int32)
    yi = torch.floor(v * 2.0).to(torch.int32)
    checker = torch.where((torch.remainder(xi + yi, 2) == 0)[..., None], c0, c1)
    out = torch.where((kind == TEX_CHECKERBOARD)[..., None], checker, c0) * scale
    return torch.where(has[..., None], out, default_rgb)


def mip_footprint(pack, its):
    """uv-space footprint for mip filtering: None without mip maps."""
    if pack.meta.get("has_mips", False):
        raise NotImplementedError("mip-mapped textures not yet ported")
    return None


def _gather_params(pack, m, uv):
    """The material_columns parameters of material m on every lane: one
    gather from each table (index_select takes the int32 ids as they are;
    indexing would first copy them to int64)."""
    cols = material_columns(pack.meta)
    floats = [c for c in cols if not c[3]]
    ints = [c for c in cols if c[3]]
    sp = {}
    flanes = torch.index_select(pack.mat_params, 1, m)
    for (key, _, w, _), col in zip(floats, torch.split(flanes, [c[2] for c in floats], dim=0)):
        sp[key] = col[0] if w == 1 else col.T
    for (key, _, _, _), col in zip(ints, torch.index_select(pack.mat_iparams, 1, m)):
        sp[key] = col
    if pack.meta.get("has_textures", False):
        sp["cA"] = eval_texture(pack, sp.pop("texA"), uv, sp["cA"])
    # STATIC: the microfacet distributions of the scene (the pack's
    # mf_dists), so that sample_m skips absent samplers; never part of a
    # per-lane select
    sp["mf_dists"] = pack.meta.get("mf_dists")
    return sp


def _attach(pack, m, sp, uv, depth):
    """sp["mix"] of rows m, whose parameters sp holds with their links:
    the next row's parameters (spB; the row itself where it links to
    none) and the weights, (1, 0) where there is no link.  `depth` more
    hops follow (the pack's static mix_depth: N-ary chains)."""
    mix_b, wa, wb = (sp.pop(k) for k in _MIX_KEYS)
    has = mix_b >= 0
    mb = torch.where(has, mix_b, m)
    spB = _gather_params(pack, mb, uv)
    if depth > 1:
        spB["mix"] = _attach(pack, mb, spB, uv, depth - 1)
    else:
        for k in _MIX_KEYS:
            del spB[k]
    return {"spB": spB, "wa": torch.where(has, wa, 1.0), "wb": torch.where(has, wb, 0.0)}


def shading_params(pack, mat_id, uv, fp=None, its=None):
    """Gather and texture-resolve the per-lane material parameters that
    bsdf/eval.py reads; in scenes with mixtures or coatings, with the
    chain of the rows they link to in sp["mix"]."""
    if fp is not None:
        raise NotImplementedError("mip-mapped textures not yet ported")
    m = torch.clamp(mat_id, min=0)
    sp = _gather_params(pack, m, uv)
    if pack.meta.get("has_mixtures", False):
        sp["mix"] = _attach(pack, m, sp, uv, pack.meta.get("mix_depth", 1))
    return sp


def shading_frame(pack, its):
    """Shading frame at the hit (no bump or normal maps)."""
    if pack.meta.get("has_bumpmaps", False):
        raise NotImplementedError("bump/normal maps not yet ported")
    return mm.Frame.from_normal(its.ns)
