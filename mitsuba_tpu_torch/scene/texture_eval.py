"""Per-lane shading parameters, textures and frames (port of
mitsuba_tpu/scene/texture_eval.py).

Textures dispatch over the packed texture table (scene/builder.py
_pack_textures): constant, checkerboard and grid; bitmaps as bilinear or
nearest gathers from the shared atlas with repeat wrapping, trilinear
across the mip pyramid where a footprint is given (mip_footprint, the
camera's ray cone), with the footprint's ellipse filtered by probes along
its major axis ("feline", the default) or by the reference's elliptically
weighted average (MTS_TEX_FILTER=ewa, mipmap.h:296-420); the geometry
kinds (vertex colours, wireframe, curvature) from the hit triangle.
shading_params gathers each lane's material row, resolves its textures,
follows the row chains of mixtures and coatings and looks up irawan's
yarns; shading_frame perturbs the shading frame by bump and normal maps.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from mitsuba_tpu_torch.bsdf import irawan as iw
from mitsuba_tpu_torch.bsdf.plugins import (
    COATING,
    CONDUCTOR,
    DIELECTRIC,
    DIFFTRANS,
    DIFFUSE,
    HK,
    IRAWAN,
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
from mitsuba_tpu_torch.core import rng
from mitsuba_tpu_torch.core.gather import take_fused
from mitsuba_tpu_torch.scene.textures import (
    TEX_BITMAP,
    TEX_CHECKERBOARD,
    TEX_CURVATURE,
    TEX_GRID,
    TEX_VERTEXCOLORS,
    TEX_WIREFRAME,
)

# the reference's settings, read the same way with the same defaults:
# anisotropic probes along the footprint's major axis (1: isotropic
# trilinear only), the clamped anisotropy (mipmap.h maxAnisotropy), the
# filter ("feline": the fixed probes; "ewa": the Gaussian texel loop of
# the reference's default filter, mipmap.h:296-420 evalEWA) and the EWA
# window's half size in texels
TEX_ANISO = int(os.environ.get("MTS_TEX_ANISO", 4))
TEX_MAX_ANISO = float(os.environ.get("MTS_TEX_MAX_ANISO", 8.0))
TEX_FILTER = os.environ.get("MTS_TEX_FILTER", "feline")
TEX_EWA_K = int(os.environ.get("MTS_TEX_EWA_K", 6))
_EXP_M2 = math.exp(-2.0)

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
    IRAWAN: (),  # its yarn parameters: sp["iw"]
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


def _atlas_index(pack, rect, xi, yi):
    """Flat atlas rows of texels (xi, yi) of each lane's rect (x, y, w, h),
    wrapped by floor-mod (the reference's int32 jnp.mod)."""
    xi = torch.remainder(xi, torch.clamp(rect[..., 2], min=1))
    yi = torch.remainder(yi, torch.clamp(rect[..., 3], min=1))
    return (rect[..., 1] + yi) * pack.tex_atlas.shape[1] + rect[..., 0] + xi


def _texel_coords(rect, u, v):
    """Texel-space position of (u, v) repeated into the rect; image row 0
    is v = 1 (the reference bitmap's uv (0, 0) = top-left)."""
    w = torch.clamp(rect[..., 2], min=1).to(torch.float32)
    h = torch.clamp(rect[..., 3], min=1).to(torch.float32)
    return (u - torch.floor(u)) * w - 0.5, (v - torch.floor(v)) * h - 0.5


def _fetch(pack, idx):
    atlas = pack.tex_atlas.reshape(-1, 3)
    return torch.index_select(atlas, 0, idx.reshape(-1)).reshape(idx.shape + (3,))


def _fetch_nearest(pack, rect, u, v):
    fx, fy = _texel_coords(rect, u, v)
    # round half to even, as jnp.round
    return _fetch(pack, _atlas_index(pack, rect, torch.round(fx).to(torch.int32),
                                     torch.round(fy).to(torch.int32)))


def _bitmap_fetch(pack, rect, u, v, nearest_sel):
    """Bilinear gather from each lane's atlas rect, or the nearest texel
    where nearest_sel > 0 (reference texture_eval.py:39-75)."""
    fx, fy = _texel_coords(rect, u, v)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    c00 = _fetch(pack, _atlas_index(pack, rect, x0, y0))
    c10 = _fetch(pack, _atlas_index(pack, rect, x0 + 1, y0))
    c01 = _fetch(pack, _atlas_index(pack, rect, x0, y0 + 1))
    c11 = _fetch(pack, _atlas_index(pack, rect, x0 + 1, y0 + 1))
    bilin = c00 * (1 - ax) * (1 - ay) + c10 * ax * (1 - ay) + c01 * (1 - ax) * ay + c11 * ax * ay
    if not pack.meta.get("tex_nearest_any", True):
        return bilin
    return torch.where((nearest_sel > 0)[..., None], _fetch_nearest(pack, rect, u, v), bilin)


def _ewa_level(pack, rect_l, u, v, uvt, minor_uv, major_uv, nearest_sel):
    """The reference's EWA at one mip level (mipmap.h:296-420): the
    Gaussian-weighted sum of the texels inside the footprint ellipse,
    over a static (2K+1)^2 window; the bilinear fetch where no texel
    weighs in.  Accumulates texel by texel: no lane holds the window."""
    wl = torch.clamp(rect_l[..., 2], min=1).to(torch.float32)
    hl = torch.clamp(rect_l[..., 3], min=1).to(torch.float32)
    # the footprint's axes in this level's texels
    g0u, g0v = major_uv[..., 0] * uvt[..., 0] * wl, major_uv[..., 1] * uvt[..., 1] * hl
    g1u, g1v = minor_uv[..., 0] * uvt[..., 0] * wl, minor_uv[..., 1] * uvt[..., 1] * hl
    a = g0v ** 2 + g1v ** 2 + 1.0
    b = -2.0 * (g0u * g0v + g1u * g1v)
    cq = g0u ** 2 + g1u ** 2 + 1.0
    f = torch.clamp(a * cq - 0.25 * b * b, min=1e-6)
    a, b, cq = a / f, b / f, cq / f
    su = (u - torch.floor(u)) * wl - 0.5
    sv = (v - torch.floor(v)) * hl - 0.5
    s0 = torch.floor(su).to(torch.int32)
    t0 = torch.floor(sv).to(torch.int32)
    acc = torch.zeros(u.shape + (3,), dtype=torch.float32, device=u.device)
    wsum = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for j in range(-TEX_EWA_K, TEX_EWA_K + 1):
        for i in range(-TEX_EWA_K, TEX_EWA_K + 1):
            di = s0.to(torch.float32) + i - su
            dj = t0.to(torch.float32) + j - sv
            r2 = a * di * di + b * di * dj + cq * dj * dj
            wgt = torch.where(r2 < 1.0, torch.exp(-2.0 * r2) - _EXP_M2, 0.0)
            uu = ((s0 + i).to(torch.float32) + 0.5) / wl
            vv = ((t0 + j).to(torch.float32) + 0.5) / hl
            acc = acc + wgt[..., None] * _fetch_nearest(pack, rect_l, uu, vv)
            wsum = wsum + wgt
    return torch.where((wsum > 1e-8)[..., None], acc / torch.clamp(wsum, min=1e-8)[..., None],
                       _bitmap_fetch(pack, rect_l, u, v, nearest_sel))


def _bitmap(pack, t, rect, nearest_sel, uvt, u, v, fp):
    """The bitmap arm: level 0 without a footprint (or without mip maps);
    trilinear across the mip pair of the footprint's level otherwise, the
    level from the minor axis of an anisotropic footprint, averaged over
    TEX_ANISO probes along its major axis, or its EWA (reference
    texture_eval.py:116-240)."""
    if fp is None or not pack.meta.get("has_mips", False):
        return _bitmap_fetch(pack, rect, u, v, nearest_sel)
    n_lev = pack.tex_n_lev[t]
    w0 = torch.clamp(rect[..., 2], min=1).to(torch.float32)
    h0 = torch.clamp(rect[..., 3], min=1).to(torch.float32)
    aniso = isinstance(fp, tuple)
    if aniso:
        minor_uv, major_uv = fp

        def texel_len(vec):  # through the texture's uv tiling
            return torch.sqrt((vec[..., 0] * uvt[..., 0] * w0) ** 2
                              + (vec[..., 1] * uvt[..., 1] * h0) ** 2)

        maj_tex = texel_len(major_uv)
        # the anisotropy clamped, and each probe's filter covering the
        # spacing between probes (major / N), so that they cannot alias
        fp_tex = torch.maximum(torch.maximum(texel_len(minor_uv), maj_tex / TEX_MAX_ANISO),
                               maj_tex / TEX_ANISO)
    else:
        fp_tex = torch.maximum(torch.abs(fp * uvt[..., 0]) * w0, torch.abs(fp * uvt[..., 1]) * h0)
    lod = torch.log2(torch.clamp(fp_tex, 1.0, 1e9))
    lod = torch.minimum(lod, (n_lev - 1).to(torch.float32))
    l0 = torch.floor(lod).to(torch.int32)
    frac = (lod - l0.to(torch.float32))[..., None]
    l1 = torch.minimum(l0 + 1, n_lev - 1)
    n_mips = pack.tex_mip_rect.shape[1]
    mip_flat = pack.tex_mip_rect.reshape(-1, 4)
    # a lane whose footprint is not finite (a miss) has no level: its
    # index is clamped into the table, as the reference's gather clamps
    # it, and its value stays NaN through frac
    rect_a = _rows(mip_flat, t * n_mips + l0)
    rect_b = _rows(mip_flat, t * n_mips + l1)
    if aniso and TEX_FILTER == "ewa":
        return (_ewa_level(pack, rect_a, u, v, uvt, minor_uv, major_uv, nearest_sel) * (1.0 - frac)
                + _ewa_level(pack, rect_b, u, v, uvt, minor_uv, major_uv, nearest_sel) * frac)

    def tri_fetch(uu, vv):
        return (_bitmap_fetch(pack, rect_a, uu, vv, nearest_sel) * (1.0 - frac)
                + _bitmap_fetch(pack, rect_b, uu, vv, nearest_sel) * frac)

    if aniso and TEX_ANISO > 1:
        acc = 0.0
        for i in range(TEX_ANISO):
            c = (i + 0.5) / TEX_ANISO - 0.5
            acc = acc + tri_fetch(u + c * major_uv[..., 0] * uvt[..., 0],
                                  v + c * major_uv[..., 1] * uvt[..., 1])
        return acc / TEX_ANISO
    return tri_fetch(u, v)


def _rows(table, idx):
    """table[idx] with the index clamped into the table, as the
    reference's plain jnp indexing clamps it: a lane whose prim is a
    sphere or segment id reads the triangle row of that number (ROADMAP
    C4), and never past the table."""
    return table[torch.clamp(idx, 0, table.shape[0] - 1)]


def _geometry(pack, kinds, kind, c0, c1, uvt, lw, geom, out):
    """The geometry-driven kinds from the hit triangle and its
    barycentrics (reference src/textures/{vertexcolors,wireframe,
    curvature}.cpp; texture_eval.py:243-304)."""
    prim, bary = geom
    bu, bv = bary[..., 0], bary[..., 1]
    bw = 1.0 - bu - bv
    if TEX_VERTEXCOLORS in kinds:
        vc = (bw[..., None] * _rows(pack.tri_c0, prim) + bu[..., None] * _rows(pack.tri_c1, prim)
              + bv[..., None] * _rows(pack.tri_c2, prim))
        out = torch.where((kind == TEX_VERTEXCOLORS)[..., None], vc, out)
    if TEX_WIREFRAME in kinds:
        # the 3D distance to the nearest edge through a smoothstep
        # (wireframe.cpp eval, stepWidth 0.5)
        v0, e1, e2 = _rows(pack.tri_v0, prim), _rows(pack.tri_e1, prim), _rows(pack.tri_e2, prim)
        p = v0 + bu[..., None] * e1 + bv[..., None] * e2

        def edge_d2(c, d):
            dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
            r = p - c
            perp = r - dn * torch.sum(r * dn, dim=-1, keepdim=True)
            return torch.sum(perp * perp, dim=-1)

        d2min = torch.minimum(torch.minimum(edge_d2(v0, e1), edge_d2(v0, e2)),
                              edge_d2(v0 + e1, e2 - e1))
        t01 = torch.clamp((torch.sqrt(d2min) - 0.5 * lw) / torch.clamp(0.5 * lw, min=1e-12),
                          0.0, 1.0)
        a = t01 * t01 * (3.0 - 2.0 * t01)
        wf = c1 * (1.0 - a)[..., None] + c0 * a[..., None]
        out = torch.where((kind == TEX_WIREFRAME)[..., None], wf, out)
    if TEX_CURVATURE in kinds:
        # the uoffset column selects Gaussian curvature, lw holds the scale
        kv = torch.where((uvt[..., 2] > 0.5)[..., None], _rows(pack.tri_kg, prim),
                         _rows(pack.tri_kh, prim))
        k_i = torch.clamp((bw * kv[..., 0] + bu * kv[..., 1] + bv * kv[..., 2]) * lw, -1.0, 1.0)
        cur = torch.stack([torch.clamp(k_i, min=0.0), torch.zeros_like(k_i),
                           torch.clamp(-k_i, min=0.0)], dim=-1)
        out = torch.where((kind == TEX_CURVATURE)[..., None], cur, out)
    return out


def eval_texture(pack, tid, uv, default_rgb, fp=None, geom=None):
    """tid: [R] int32 texture ids (-1 -> default_rgb [R, 3]); uv: [R, 2].

    fp (optional): the shading sample's uv footprint, a scalar diameter
    [R] or an ellipse (minor_uv [R, 2], major_uv [R, 2]) (mip_footprint):
    selects the mip levels of bitmaps.  geom (optional (prim [R], bary
    [R, 2])): the hit triangle and its barycentrics for the geometry
    kinds.  Arms of kinds the pack does not hold are skipped (the pack's
    static tex_kinds; every arm selects by kind, so skipping one changes
    nothing)."""
    has = tid >= 0
    t = torch.clamp(tid, min=0)
    kind, c0, c1, scale, uvt, lw, rect, nearest_sel = take_fused(
        t, pack.tex_type, pack.tex_c0, pack.tex_c1, pack.tex_scale, pack.tex_uv, pack.tex_lw,
        pack.tex_rect, pack.tex_nearest,
    )  # uvt = uscale, vscale, uoffset, voffset
    kinds = pack.meta.get("tex_kinds")
    kinds = set(range(TEX_CURVATURE + 1)) if kinds is None else set(kinds)
    u = uv[..., 0] * uvt[..., 0] + uvt[..., 2]
    v = uv[..., 1] * uvt[..., 1] + uvt[..., 3]
    out = c0  # constant
    if TEX_CHECKERBOARD in kinds:
        # checkerboard.cpp eval: parity of floor(2u) + floor(2v), a
        # floor-mod as the reference's int32 %
        xi = torch.floor(u * 2.0).to(torch.int32)
        yi = torch.floor(v * 2.0).to(torch.int32)
        checker = torch.where((torch.remainder(xi + yi, 2) == 0)[..., None], c0, c1)
        out = torch.where((kind == TEX_CHECKERBOARD)[..., None], checker, out)
    if TEX_GRID in kinds:  # gridtexture.cpp
        fu = u - torch.floor(u)
        fv = v - torch.floor(v)
        on_line = (fu < lw) | (fu > 1.0 - lw) | (fv < lw) | (fv > 1.0 - lw)
        out = torch.where((kind == TEX_GRID)[..., None],
                          torch.where(on_line[..., None], c1, c0), out)
    if TEX_BITMAP in kinds:
        out = torch.where((kind == TEX_BITMAP)[..., None],
                          _bitmap(pack, t, rect, nearest_sel, uvt, u, v, fp), out)
    gk = pack.meta.get("geom_tex_kinds", ())
    if gk and geom is not None:
        out = _geometry(pack, gk, kind, c0, c1, uvt, lw, geom, out)
    return torch.where(has[..., None], out * scale, default_rgb)


def mip_footprint(pack, its):
    """uv-space footprint of a camera-cone shading sample, None without
    mip maps (reference texture_eval.py:310-359): the cone of the camera's
    pixel angle at the hit distance (secondary bounces reuse it), with
    TEX_ANISO > 1 projected onto the surface as an ellipse, minor axis the
    cone's radius, major axis radius / cos(theta) along the projected view
    direction, both mapped into uv through the (dpdu, dpdv) metric:
    (minor_uv [R, 2], major_uv [R, 2]); else the scalar diameter."""
    ang = pack.meta.get("cam_pix_angle", 0.0)
    if not pack.meta.get("has_mips", False) or ang <= 0.0:
        return None
    r = its.t * ang
    if TEX_ANISO <= 1:
        return r / torch.clamp(torch.linalg.norm(its.dpdu, dim=-1), min=1e-8)
    dpdu, dpdv = its.dpdu, its.dpdv
    E = torch.sum(dpdu * dpdu, dim=-1)
    F = torch.sum(dpdu * dpdv, dim=-1)
    G = torch.sum(dpdv * dpdv, dim=-1)
    det = torch.clamp(E * G - F * F, min=1e-24)
    w = -its.wi_world  # unit, toward the surface
    n = its.ns
    cosv = torch.clamp(torch.abs(mm.dot(w, n)), 1.0 / TEX_MAX_ANISO, 1.0)
    m_dir = mm.cross(n, w)
    m_len = torch.linalg.norm(m_dir, dim=-1, keepdim=True)
    dpdu_unit = dpdu / torch.clamp(torch.linalg.norm(dpdu, dim=-1, keepdim=True), min=1e-12)
    m_dir = torch.where(m_len > 1e-6, m_dir / torch.clamp(m_len, min=1e-12), dpdu_unit)
    a_dir = mm.normalize(mm.cross(m_dir, n))

    def to_uv(x):
        pu = torch.sum(x * dpdu, dim=-1)
        pv = torch.sum(x * dpdv, dim=-1)
        return torch.stack([(G * pu - F * pv) / det, (E * pv - F * pu) / det], dim=-1)

    return to_uv(m_dir * r[..., None]), to_uv(a_dir * (r / cosv)[..., None])


def _gather_params(pack, m, uv, fp=None, geom=None):
    """The material_columns parameters of material m on every lane: one
    gather from each table (index_select takes the int32 ids as they are;
    indexing would first copy them to int64), with the textured
    reflectance resolved."""
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
        sp["cA"] = eval_texture(pack, sp.pop("texA"), uv, sp["cA"], fp, geom)
    # STATIC: the microfacet distributions of the scene (the pack's
    # mf_dists), so that sample_m skips absent samplers; never part of a
    # per-lane select
    sp["mf_dists"] = pack.meta.get("mf_dists")
    return sp


def _attach(pack, m, sp, uv, depth, fp, geom):
    """sp["mix"] of rows m, whose parameters sp holds with their links:
    the next row's parameters (spB; the row itself where it links to
    none) and the weights, (1, 0) where there is no link.  `depth` more
    hops follow (the pack's static mix_depth: N-ary chains)."""
    mix_b, wa, wb = (sp.pop(k) for k in _MIX_KEYS)
    has = mix_b >= 0
    mb = torch.where(has, mix_b, m)
    spB = _gather_params(pack, mb, uv, fp, geom)
    if depth > 1:
        spB["mix"] = _attach(pack, mb, spB, uv, depth - 1, fp, geom)
    else:
        for k in _MIX_KEYS:
            del spB[k]
    return {"spB": spB, "wa": torch.where(has, wa, 1.0), "wb": torch.where(has, wb, 0.0)}


def shading_params(pack, mat_id, uv, fp=None, its=None):
    """Gather and texture-resolve the per-lane material parameters that
    bsdf/eval.py reads.  fp: the uv footprint of mip_footprint (None:
    bitmaps at level 0).  its: the SurfaceInteraction, whose hit triangle
    and barycentrics the geometry kinds read (without it, as for stored
    photon-map points, those kinds give their constant colour).  In
    scenes with irawan, the lanes' yarn parameters go in sp["iw"]; in
    scenes with mixtures or coatings, the chain of the rows they link to
    in sp["mix"]."""
    m = torch.clamp(mat_id, min=0)
    geom = (its.prim, its.bary) if its is not None and pack.meta.get("geom_tex_kinds", ()) else None
    sp = _gather_params(pack, m, uv, fp, geom)
    if pack.meta.get("has_irawan", False):
        seed = rng.stream_seed(0, rng.STREAM_WEAVE)
        tabs = {k: pack.arrays["iw_" + k] for k in iw.TABLE_KEYS}
        sp["iw"] = iw.lane_params(tabs, torch.clamp(pack.mat_iw[m], min=0), uv,
                                  lambda i, j: rng.rand1(i, j, 0, seed),
                                  pack.meta.get("iw_noise", False))
    if pack.meta.get("has_mixtures", False):
        sp["mix"] = _attach(pack, m, sp, uv, pack.meta.get("mix_depth", 1), fp, geom)
    return sp


def shading_frame(pack, its):
    """The shading frame at the hit, perturbed by bump and normal maps
    (reference src/bsdfs/{bumpmap,normalmap}.cpp getFrame;
    texture_eval.py:447-502).  Scenes without them get the plain frame of
    the shading normal.  A normal map's colour (2c - 1) is a
    tangent-space normal in the TBN basis of dp/du; a bump map tilts the
    normal by its height's forward differences at eps = 1/1024 in uv; the
    result is kept in the shading normal's hemisphere."""
    if not pack.meta.get("has_bumpmaps", False):
        return mm.Frame.from_normal(its.ns)
    m = torch.clamp(its.mat, min=0)
    tex_b, is_nm = take_fused(m, pack.mat_tex_bump, pack.mat_bump_nm)
    has = tex_b >= 0
    ns = its.ns
    # the orthonormal TBN basis from the uv tangent
    t_raw = its.dpdu - ns * torch.sum(its.dpdu * ns, dim=-1, keepdim=True)
    t_len = torch.linalg.norm(t_raw, dim=-1, keepdim=True)
    t = torch.where(t_len > 1e-8, t_raw / torch.clamp(t_len, min=1e-12),
                    mm.Frame.from_normal(ns).s)
    b = mm.cross(ns, t)
    # normal map: c in [0, 1]^3 -> the tangent-space normal
    c = eval_texture(pack, tex_b, its.uv, torch.full_like(ns, 0.5))
    n_t = 2.0 * c - 1.0
    n_nm = mm.normalize(t * n_t[..., 0:1] + b * n_t[..., 1:2] + ns * n_t[..., 2:3])
    # bump map: the height's differences (h0 is c's mean: their default
    # colours differ only on lanes without a bump texture, which keep ns)
    eps = 1.0 / 1024.0
    zero = torch.zeros_like(ns)
    h0 = c.mean(-1)
    hu = eval_texture(pack, tex_b, its.uv + torch.tensor([eps, 0.0], device=ns.device),
                      zero).mean(-1)
    hv = eval_texture(pack, tex_b, its.uv + torch.tensor([0.0, eps], device=ns.device),
                      zero).mean(-1)
    n_bm = mm.normalize(ns - t * ((hu - h0) / eps)[..., None] - b * ((hv - h0) / eps)[..., None])
    n_new = torch.where((is_nm > 0.5)[..., None], n_nm, n_bm)
    n_new = torch.where(has[..., None], n_new, ns)
    n_new = torch.where((torch.sum(n_new * ns, dim=-1) < 0)[..., None], -n_new, n_new)
    return mm.Frame.from_normal(n_new)
