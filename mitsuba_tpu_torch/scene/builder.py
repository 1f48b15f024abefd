"""Scene packing: host scene description -> flat device tensors
(`ScenePack`); the port of mitsuba_tpu/scene/builder.py for the slice it
renders: triangle meshes (brute force up to 512 triangles, BVH + cluster
tables above, over the static triangles: the rows of animated and
deformable shapes follow them, with their relative motions and keyframe
stacks), analytic spheres (tessellated where they emit) and
miter-clipped cylinder segments (hair fibers and cylinders), every
material type of the reference, with the row chains of mixtures and
coatings, irawan's weave tables, every texture kind (the bitmaps and
their mip pyramids shelf-packed into one atlas, the geometry kinds'
per-corner colours and curvatures), bump and normal maps with the
triangles' uv partials, area emitters, a constant or image-based
(`envmap`) environment, homogeneous and heterogeneous media attached
to shapes as their interior or exterior, fiber phases and orientation
volumes among them (`_pack_media`), the camera of the motion integrator,
and the
subsurface point sets and coefficients of dipole and singlescatter shapes
(`_pack_sss`).  `apply_spectral_pack` makes the pack of one bin group of
spectral mode.

Array names, dtypes, shapes and meta keys are the reference's, so a
reference pack converted with `pack_from_numpy` and the port's own pack
of the same scene are interchangeable.
"""

from __future__ import annotations

import copy
import math
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.accel.bvh import LEAF_SIZE, build_bvh, octant_node_rows
from mitsuba_tpu_torch.accel.clusters import pack_clusters
from mitsuba_tpu_torch.accel.pallas_kernels import (
    pack_triangles_sublane,
    pack_triangles_transposed,
)
from mitsuba_tpu_torch.bsdf.eval import PORTED as PORTED_TYPES
from mitsuba_tpu_torch.bsdf.irawan_host import pack_tables, tables_have_noise
from mitsuba_tpu_torch.bsdf.plugins import (
    COATING,
    DIFFUSE,
    IRAWAN,
    MIXTURE,
    ROUGHCOATING,
    ROUGHCONDUCTOR,
    ROUGHDIELECTRIC,
    ROUGHPLASTIC,
    BSDFRecord,
)
from mitsuba_tpu_torch.bsdf.rtrans import fit_rtrans_poly
from mitsuba_tpu_torch.core.distribution import Distribution2D, build_alias
from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.emitter.eval import PORTED_KINDS
from mitsuba_tpu_torch.emitter.plugins import AREA, CONSTANT, DIRECTIONAL, ENVMAP
from mitsuba_tpu_torch.medium.plugins import (
    FLAKE_LUT,
    HETEROGENEOUS,
    HG,
    KKAY,
    MAX_PHASE_COMPONENTS,
    MICROFLAKE,
)
from mitsuba_tpu_torch.scene.shapes import _apply_transform, _uv_sphere
from mitsuba_tpu_torch.scene.subsurface import sample_surface_points
from mitsuba_tpu_torch.scene.texture_eval import material_table
from mitsuba_tpu_torch.scene.textures import (
    GEOMETRY_KINDS,
    TEX_BITMAP,
    TEX_CURVATURE,
    TEX_VERTEXCOLORS,
    TEX_WIREFRAME,
)

# scenes above this many triangles go through the BVH and cluster tables
BRUTE_FORCE_MAX_TRIS = 512

# the texture kinds the port evaluates: every kind of the reference
PORTED_TEXTURES = frozenset(range(TEX_CURVATURE + 1))
# mip levels per bitmap: 2048 x 2048 down to 1 x 1
MAX_MIP_LEVELS = 12
# BSDF types whose lobes sample a microfacet normal: their distributions
# make the static mf_dists meta
_MF_TYPES = (ROUGHCONDUCTOR, ROUGHDIELECTRIC, ROUGHPLASTIC, ROUGHCOATING)

# the arrays and meta keys the ported slice reads
SLICE_ARRAYS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_emit", "tri_s", "tri_t",
    "mat_type", "mat_cA", "mat_cB", "mat_cC", "mat_cD", "mat_alpha_u",
    "mat_alpha_v", "mat_eta", "mat_disp", "mat_exponent", "mat_dist", "mat_nonlinear",
    "mat_twosided", "mat_fdr_int", "mat_spec_w", "mat_texA", "mat_rt", "mat_rt_fdr",
    "mat_opacity", "mat_tex_opacity", "mat_mix_b", "mat_mix_wa", "mat_mix_wb",
    "mat_tex_bump", "mat_bump_nm", "mat_iw", "tri_dpdu", "tri_dpdv",
    "tex_type", "tex_c0", "tex_c1", "tex_scale", "tex_uv", "tex_rect", "tex_mip_rect",
    "tex_n_lev", "tex_lw", "tex_nearest", "tex_atlas",
    "sph_center", "sph_radius", "sph_mat", "sph_emit", "sph_flip",
    "cyl_p0", "cyl_p1", "cyl_n0", "cyl_n1", "cyl_rad", "cyl_mat", "cyl_flip",
    "em_kind", "em_rgb", "em_area", "em_tri_lo", "em_tri_hi", "em_pos", "em_dir",
    "em_cos_cutoff", "em_cos_beam",
    "area_tri_idx", "area_tri_cdf", "emitter_pmf", "emitter_cdf",
    "env_image", "env_to_world", "env_to_local", "env_density", "env_alias_prob",
    "env_alias_idx", "env_alias_fused",
)
SLICE_META = (
    "n_tris", "n_spheres", "n_cyls", "n_emitters", "present_types", "mf_dists", "emitter_kinds",
    "has_mixtures", "mix_depth",
    "use_bvh", "has_area", "has_env", "has_envmap", "env_idx", "env_alias_fused_ok",
    "has_textures", "has_mips", "geom_tex_kinds", "has_bumpmaps", "cam_pix_angle",
    "has_delta_emitters", "scene_center", "scene_radius",
)
# ... the static prefix, the animated and deformable ranges (their
# keyframe stacks deform_tri9_{r} besides) and the camera of the motion
# integrator ...
MOTION_ARRAYS = ("anim_m1", "cam_w2c")
MOTION_META = (
    "n_static_tris", "anim_ranges", "deform_ranges", "shutter_open", "shutter_close",
    "cam_tan_half", "cam_film", "cam_kind",
)
# ... for scenes with geometry-driven textures, the per-corner colours
# (vertexcolors) and curvatures (curvature) ...
GEOM_TEX_ARRAYS = ("tri_c0", "tri_c1", "tri_c2", "tri_kh", "tri_kg")
# ... for scenes with media, the medium tables (`_pack_media`) ...
MEDIA_ARRAYS = (
    "tri_med_in", "tri_med_ex", "sph_med_in", "sph_med_ex",
    "med_sigma_s", "med_sigma_a", "med_phase", "med_ph_kinds", "med_ph_gs", "med_ph_ws",
    "med_sampling_w", "med_strategy", "med_density", "med_mx_sigma", "med_mx_istart",
    "med_mx_cdf", "med_mx_norm", "med_het_slot", "het_corners", "het_super", "het_w2g",
    "het_albedo", "het_dims", "het_sdims", "het_cbase", "het_sbase",
    "med_ph_ks", "med_ph_kd", "med_ph_exp", "med_ph_knorm", "med_flake_norm",
    "med_flake_stddev", "med_flake_sigt", "het_ocorners", "het_obase", "het_odims",
)
MEDIA_META = (
    "has_media", "n_media", "hom_strategies", "phase_kinds", "n_het", "het_simpson",
    "het_super_b", "camera_medium",
)
# ... the subsurface tables (placeholders in scenes without subsurface) ...
SSS_ARRAYS = (
    "mat_sss", "sss_p", "sss_n", "sss_area", "sss_obj", "sss_zr", "sss_zv", "sss_str",
    "sss_eta", "sss_sigs", "sss_sigt", "sss_g", "sss_kind", "sss_E",
)
SSS_META = (
    "has_sss", "sss_irr_samples", "sss_indirect", "sss_has_single", "sss_has_dipole",
    "sss_ss_samples", "sss_ss_depth",
)
# ... and, for scenes above BRUTE_FORCE_MAX_TRIS, the BVH and clusters
BVH_ARRAYS = ("bvh_nodes", "tri9", "cl_tri", "cl_box", "cl_sup", "cl_mbox", "cl_pad2prim")
BVH_META = (
    "bvh_n_layouts", "n_clusters", "cluster_tc", "n_supers",
    "cluster_super_g", "cluster_vmem_ok",
)
# meta flags of reference features the port does not render yet:
# (key, value meaning "absent", feature name)
_UNPORTED_FEATURES = (
    ("has_instances", False, "instancing"),
)


@dataclass
class ScenePack:
    arrays: dict  # name -> tensor
    meta: dict  # static metadata (counts, flags)

    def __getattr__(self, name):
        arrays = object.__getattribute__(self, "arrays")
        if name in arrays:
            return arrays[name]
        meta = object.__getattribute__(self, "meta")
        if name in meta:
            return meta[name]
        raise AttributeError(name)


def check_slice(meta: dict):
    """Raise NotImplementedError for a pack that needs unported features."""
    for key, absent, feature in _UNPORTED_FEATURES:
        if meta.get(key, absent) != absent:
            raise NotImplementedError(f"{feature} not yet ported")
    types = set(meta.get("present_types", (DIFFUSE,)))
    if types - PORTED_TYPES:
        raise NotImplementedError(
            f"bsdf types {sorted(types - PORTED_TYPES)} not yet ported"
        )
    kinds = set(meta.get("emitter_kinds", ()))
    if kinds - PORTED_KINDS:
        raise NotImplementedError(
            f"emitter kinds {sorted(kinds - PORTED_KINDS)} not yet ported"
        )
    if meta.get("use_bvh", False):
        _check_clusters(meta)


def _check_textures(arrays: dict, meta: dict):
    """Raise NotImplementedError for texture kinds the port does not
    evaluate (scene/texture_eval.py: those of PORTED_TEXTURES)."""
    if not meta.get("has_textures", False):
        return
    kinds = set(np.asarray(arrays["tex_type"]).tolist()) - PORTED_TEXTURES
    if kinds:
        raise NotImplementedError(f"texture kinds {sorted(kinds)} not yet ported")


def _downsample2(img):
    """2 x 2 box average, odd edges repeated (reference mipmap.h resample,
    builder.py:82-96)."""
    h, w, c = img.shape
    if h > 1 and h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    if w > 1 and w % 2:
        img = np.concatenate([img, img[:, -1:]], axis=1)
        w += 1
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h > 1:
        img = img.reshape(nh, 2, w, c).mean(axis=1)
    if w > 1:
        img = img.reshape(nh, nw, 2, c).mean(axis=2)
    return img


def _mip_chain(img):
    """The image and its halvings down to 1 x 1, at most MAX_MIP_LEVELS."""
    levels = [np.asarray(img, np.float32)]
    while max(levels[-1].shape[:2]) > 1 and len(levels) < MAX_MIP_LEVELS:
        levels.append(_downsample2(levels[-1]))
    return levels


def _pack_textures(textures: list) -> dict:
    """The texture table (reference builder.py:108-186): each texture's
    kind, colours, scale, uv transform, line width and filter; every
    bitmap level, tallest first, shelf-packed into one atlas no narrower
    than 64 texels (a 1 x 1 x 3 atlas without bitmaps), with its rect
    (x, y, w, h) per level, levels past a pyramid's last repeating it."""
    n = max(len(textures), 1)
    tex = {
        "tex_type": np.zeros(n, np.int32),
        "tex_c0": np.zeros((n, 3), np.float32),
        "tex_c1": np.ones((n, 3), np.float32),
        "tex_scale": np.ones((n, 3), np.float32),
        # uscale, vscale, uoffset, voffset
        "tex_uv": np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (n, 1)),
        "tex_rect": np.zeros((n, 4), np.int32),  # level 0
        "tex_mip_rect": np.zeros((n, MAX_MIP_LEVELS, 4), np.int32),
        "tex_n_lev": np.ones(n, np.int32),
        "tex_lw": np.full(n, 0.01, np.float32),
        "tex_nearest": np.zeros(n, np.int32),
        "tex_atlas": np.zeros((1, 1, 3), np.float32),
    }
    items = [(i, lvl, im) for i, t in enumerate(textures) if t.kind == TEX_BITMAP
             for lvl, im in enumerate(_mip_chain(t.image))]
    if items:
        items.sort(key=lambda it: -it[2].shape[0])  # stable: by height
        max_w = max(max(im.shape[1] for _, _, im in items), 1)
        atlas_w = max(1 << int(np.ceil(np.log2(max_w))), 64)
        x = y = shelf_h = 0
        places = {}
        for i, lvl, im in items:
            h, w = im.shape[:2]
            if x + w > atlas_w:
                y, x, shelf_h = y + shelf_h, 0, 0
            places[(i, lvl)] = (x, y, w, h)
            shelf_h = max(shelf_h, h)
            x += w
        atlas = np.zeros((y + shelf_h, atlas_w, 3), np.float32)
        for i, lvl, im in items:
            px, py, w, h = places[(i, lvl)]
            atlas[py:py + h, px:px + w] = im
            tex["tex_mip_rect"][i, lvl] = [px, py, w, h]
            if lvl == 0:
                tex["tex_rect"][i] = [px, py, w, h]
            tex["tex_n_lev"][i] = max(tex["tex_n_lev"][i], lvl + 1)
        for i in {i for i, _, _ in items}:
            tex["tex_mip_rect"][i, tex["tex_n_lev"][i]:] = tex["tex_mip_rect"][
                i, tex["tex_n_lev"][i] - 1]
        tex["tex_atlas"] = atlas
    for i, t in enumerate(textures):
        tex["tex_type"][i] = t.kind
        tex["tex_c0"][i] = t.color0
        tex["tex_c1"][i] = t.color1
        tex["tex_scale"][i] = t.scale
        tex["tex_uv"][i] = [*t.uv_scale, *t.uv_offset]
        tex["tex_lw"][i] = t.line_width
        tex["tex_nearest"][i] = int(t.filter_nearest)
    return tex


def _cam_pix_angle(scene):
    """The camera's per-pixel cone angle, 2 tan(xfov / 2) / width (0
    without a camera): the footprint of mip_footprint (reference
    builder.py:219-230)."""
    try:
        cam = scene.sensor.record
        return float(2.0 * math.tan(math.radians(cam.xfov_deg) / 2.0) / max(cam.film.width, 1))
    except (AttributeError, TypeError):
        return 0.0


def _cam_motion(scene) -> tuple[np.ndarray, dict]:
    """The camera's world-to-camera matrix and its tan(xfov / 2), film
    size and kind: the motion integrator's screen projection (reference
    builder.py:189-215, :1728-1733)."""
    if scene.sensor is None:
        return np.eye(4, dtype=np.float32), {"cam_tan_half": 0.0, "cam_film": (1, 1),
                                             "cam_kind": 0}
    rec = scene.sensor.record
    return np.asarray(rec.to_world.inv, np.float32), {
        "cam_tan_half": float(math.tan(math.radians(rec.xfov_deg) / 2.0)),
        "cam_film": (int(rec.film.width), int(rec.film.height)),
        "cam_kind": int(rec.kind),
    }


def _vertex_curvatures(mesh):
    """Per-vertex (mean H, Gaussian K) curvature estimates on the mesh
    with its positional duplicates welded (reference builder.py:233-296):
    the angle deficit over the barycentric vertex area, and half the
    cotangent Laplacian's length, signed positive where it points
    against the area-weighted normal."""
    p_raw = np.asarray(mesh.positions, np.float64)
    idx_raw = np.asarray(mesh.indices, np.int64)
    key = np.round(p_raw * 1e6).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    p = p_raw[uniq_idx]
    idx = inv[idx_raw]
    nv = len(p)
    a, b, c = p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]]
    area2 = np.maximum(np.linalg.norm(np.cross(b - a, c - a), axis=-1), 1e-20)  # 2 x area
    angle_sum = np.zeros(nv)
    varea = np.zeros(nv)
    lap = np.zeros((nv, 3))

    def corner(vi, e1, e2, vj, vk):
        """The angle at vi; its cotangent weights the opposite edge (vj, vk)."""
        l1 = np.linalg.norm(e1, axis=-1)
        l2 = np.linalg.norm(e2, axis=-1)
        cosang = np.clip(np.sum(e1 * e2, axis=-1) / np.maximum(l1 * l2, 1e-20), -1, 1)
        np.add.at(angle_sum, vi, np.arccos(cosang))
        cot = cosang / np.maximum(np.sqrt(1.0 - cosang * cosang), 1e-6)
        np.add.at(lap, vj, 0.5 * cot[:, None] * (p[vk] - p[vj]))
        np.add.at(lap, vk, 0.5 * cot[:, None] * (p[vj] - p[vk]))

    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    corner(i0, b - a, c - a, i1, i2)
    corner(i1, a - b, c - b, i0, i2)
    corner(i2, a - c, b - c, i0, i1)
    third = area2 / 6.0
    for col in (i0, i1, i2):
        np.add.at(varea, col, third)
    varea = np.maximum(varea, 1e-20)
    kg = (2.0 * np.pi - angle_sum) / varea
    n = np.zeros((nv, 3))
    fn = np.cross(b - a, c - a)
    for col in (i0, i1, i2):
        np.add.at(n, col, fn)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    kh = -np.sign(np.sum(lap * n, axis=-1)) * (0.5 * np.linalg.norm(lap, axis=-1) / varea)
    return kh[inv].astype(np.float32), kg[inv].astype(np.float32)


def _texture_descs(materials):
    """The texture descriptors of the material records and their nested
    records."""
    out, stack = [], list(materials)
    while stack:
        rec = stack.pop()
        out += [t for t in (rec.texA, rec.tex_opacity, rec.tex_bump) if t is not None]
        stack.extend(rec.children or [])
    return out


def _geometry_tables(descs, meshes, tri):
    """The per-corner tables of the geometry-driven kinds the textures
    use (reference builder.py:696-750): vertex colours (white where a
    mesh has none) and the corners' (mean, Gaussian) curvatures, and the
    automatic wireframe width, a tenth of the mean edge length, set on
    the descriptors that ask for it.  Returns (kinds, {name: table})."""
    kinds = tuple(sorted({t.kind for t in descs if t.kind in GEOMETRY_KINDS}))
    out = {}
    def cat(parts):
        return np.concatenate(parts).astype(np.float32) if parts else np.zeros((0, 3), np.float32)

    if TEX_VERTEXCOLORS in kinds:
        for k in range(3):
            out[f"tri_c{k}"] = cat([
                np.asarray(m.colors, np.float32)[m.indices.astype(np.int64)[:, k]]
                if m.colors is not None else np.ones((len(m.indices), 3), np.float32)
                for m in meshes])
    if TEX_CURVATURE in kinds:
        curv = [(hg, m.indices.astype(np.int64)) for m in meshes
                for hg in [_vertex_curvatures(m)]]
        out["tri_kh"] = cat([h[i] for (h, _), i in curv])
        out["tri_kg"] = cat([g[i] for (_, g), i in curv])
    if TEX_WIREFRAME in kinds:
        e1, e2 = tri["tri_e1"], tri["tri_e2"]
        el = (np.linalg.norm(e1, axis=-1) + np.linalg.norm(e2, axis=-1)
              + np.linalg.norm(e2 - e1, axis=-1))
        auto_lw = 0.1 * float(el.mean()) / 3.0 if len(e1) else 0.01
        for t in descs:
            if t.kind == TEX_WIREFRAME and t.line_width <= 0.0:
                t.line_width = auto_lw
    return kinds, out


def _uv_partials(tri):
    """dp/du and dp/dv of each triangle from its uv (reference
    builder.py:872-886; e1 and e2 where the uv are degenerate)."""
    duv1 = tri["tri_uv1"] - tri["tri_uv0"]
    duv2 = tri["tri_uv2"] - tri["tri_uv0"]
    uv_det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    safe = np.abs(uv_det) > 1e-12
    inv_det = np.where(safe, 1.0 / np.where(safe, uv_det, 1.0), 0.0)
    e1, e2 = tri["tri_e1"], tri["tri_e2"]
    dpdu = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_det[:, None]
    dpdv = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv_det[:, None]
    return (np.where(safe[:, None], dpdu, e1).astype(np.float32),
            np.where(safe[:, None], dpdv, e2).astype(np.float32))


def _irawan_tables(materials, mt):
    """mat_iw (each irawan row's entry in the weave tables, -1 for other
    rows) and the iw_* tables with their meta (reference
    builder.py:1119-1138)."""
    mt["mat_iw"] = np.full(len(mt["mat_type"]), -1, np.int32)
    entries = []
    for i, rec in enumerate(materials):
        if rec.type == IRAWAN and rec.weave is not None:
            mt["mat_iw"][i] = len(entries)
            entries.append((rec.weave, rec.repeat_u, rec.repeat_v, rec.iw_norm))
    if not entries:
        return {}, {}
    tabs = pack_tables(entries)
    return ({"iw_" + k: v for k, v in tabs.items()},
            {"has_irawan": True, "iw_noise": tables_have_noise(tabs)})


def _emissive_sphere_meshes(spheres):
    """Emissive spheres become triangles, so that area sampling stays
    triangle-only (reference builder.py:513-541): a 32 x 16 UV sphere
    whose radius is scaled so that its area is the sphere's, 4 pi r^2."""
    base = _uv_sphere(32, 16)
    bp = base.positions
    bi = base.indices.astype(np.int64)
    e1 = bp[bi[:, 1]] - bp[bi[:, 0]]
    e2 = bp[bi[:, 2]] - bp[bi[:, 0]]
    a_unit = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum()
    corr = float(np.sqrt(4.0 * np.pi / a_unit))
    out = []
    for s in spheres:
        rr = s.radius * corr
        t = Transform.translate(*s.center) * Transform.scale(rr, rr, rr)
        out.append(_apply_transform(base, t, s.flip_normals))
    return out


def _bounding_sphere(tri, spheres, cyl, n_cyl, deform_stacks=()):
    """(center, radius) of the scene's bounds, in float32 as the reference
    computes them (reference builder.py:1658-1682): the triangles'
    corners, every keyframe's corners of the deformable shapes, the
    analytic spheres' boxes and the segments' ends, each +- its radius."""
    v = tri["tri_v0"]
    pts = [v, v + tri["tri_e1"], v + tri["tri_e2"]] if len(v) else []
    for stack in deform_stacks:
        f = stack.reshape(-1, 9)
        pts += [f[:, 0:3], f[:, 0:3] + f[:, 3:6], f[:, 0:3] + f[:, 6:9]]
    if spheres:
        c = np.array([s[0].center for s in spheres], np.float32)
        r = np.array([s[0].radius for s in spheres], np.float32)
        pts += [c - r[:, None], c + r[:, None]]
    if n_cyl:
        r = cyl["cyl_rad"][:n_cyl, None]
        for end in (cyl["cyl_p0"][:n_cyl], cyl["cyl_p1"][:n_cyl]):
            pts += [end - r, end + r]
    if not pts:
        return (0.0, 0.0, 0.0), 1.0
    allp = np.concatenate(pts, axis=0)
    lo, hi = allp.min(axis=0), allp.max(axis=0)
    center = 0.5 * (lo + hi)
    return tuple(float(x) for x in center), float(np.linalg.norm(hi - center)) + 1e-6


def _relative_motion(inst, emit_id):
    """An animated shape's relative motion M1 = A(t_end) A(t_0)^-1 from its
    first and last keyframes, as 9 linear entries (row-major) and 3
    translation entries (reference builder.py:602-633); its rows hold
    keyframe 0, and the intersector lerps I -> M1 over the shutter."""
    kf = inst.animation
    t0_m = np.asarray(kf[0][1].m, np.float64)
    t1_m = np.asarray(kf[-1][1].m, np.float64)
    m_rel = (t1_m @ np.linalg.inv(t0_m))[:3, :]
    rot = m_rel[:3, :3] - np.eye(3)
    if np.abs(rot - np.diag(np.diag(rot))).max() > 1e-5:
        warnings.warn(f"animated shape '{inst.id}': rotation keyframes use chordal matrix "
                      "interpolation and frame-0 shading normals (translation/scale are exact)")
    if emit_id >= 0:
        warnings.warn(f"animated shape '{inst.id}': area emission is sampled at keyframe 0")
    return np.concatenate([m_rel[:, :3].reshape(-1), m_rel[:, 3]]).astype(np.float32)


def _deform_tables(deform_marks) -> dict:
    """deform_tri9_{r}: each deformable shape's keyframes as a [K, T, 9]
    stack of (v0, e1, e2) rows (reference builder.py:660-694)."""
    out = {}
    for r, (inst, _, _) in enumerate(deform_marks):
        stack = []
        for meshes in inst.deform_frames:
            rows = []
            for mesh in meshes:
                p = mesh.positions
                i = mesh.indices.astype(np.int64)
                a, b, c = p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]
                rows.append((a, b - a, c - a))
            stack.append(np.concatenate(
                [np.concatenate([x[j] for x in rows]) for j in range(3)], axis=-1
            ).astype(np.float32))
        out[f"deform_tri9_{r}"] = np.stack(stack)
        if inst.emitter is not None:
            warnings.warn(f"deformable '{inst.id}': area emission is sampled at keyframe 0")
    return out


def _luminance(rgb):
    """Y of linear RGB in float32 (reference core/spectrum.py luminance,
    spectrum.h getLuminance)."""
    return (rgb[..., 0] * np.float32(0.212671) + rgb[..., 1] * np.float32(0.715160)
            + rgb[..., 2] * np.float32(0.072169))


def _env_table(rec) -> tuple[dict, dict]:
    """The environment's arrays and meta (reference builder.py:1236-1331):
    for an envmap its scaled image, its transforms and the alias table of
    its luminance x sin(theta) weights (+1e-12, so that every pixel can
    be drawn), each row fused as [prob, alias, dens_self, dens_alias];
    for a constant environment or none, the reference's 1 x 2 stand-in.
    The alias table replaces the reference's hierarchical CDF inversion
    (src/emitters/envmap.cpp sampleDirection) with the same per-pixel
    density, so pdfs and MIS weights are unchanged."""
    env_image = np.zeros((1, 2, 3), np.float32)
    env_to_world = np.eye(4, dtype=np.float32)
    env_weights = np.ones((1, 2))
    if rec is not None and rec.kind == ENVMAP:
        env_image = rec.env_image * rec.scale
        env_to_world = rec.to_world.m.astype(np.float32)
    if rec is not None and env_image.size > 3:
        h = env_image.shape[0]
        sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)
        env_weights = _luminance(env_image) * sin_t[:, None] + 1e-12
    dist = Distribution2D.from_weights(env_weights)
    prob, alias = build_alias(env_weights)
    fused_ok = prob.size < (1 << 24)  # alias ids exact in float32
    dens = dist.density.reshape(-1)
    fused = (
        np.stack([prob, alias.astype(np.float32), dens, dens[alias]], axis=-1).astype(np.float32)
        if fused_ok else np.zeros((1, 4), np.float32)
    )
    arrays = {
        "env_image": np.asarray(env_image, np.float32),
        "env_to_world": env_to_world,
        "env_to_local": np.linalg.inv(env_to_world.astype(np.float64)).astype(np.float32),
        "env_density": dist.density,
        "env_alias_prob": prob,
        "env_alias_idx": alias,
        "env_alias_fused": fused,
    }
    meta = {"env_alias_fused_ok": fused_ok,
            "has_envmap": rec is not None and rec.kind == ENVMAP}
    return arrays, meta


# grid cells per supergrid cell along each axis (reference builder.py:1382)
SUPER_B = 8


def _bf16(a):
    """float32 numpy -> the nearest bfloat16 value (ties to even), as
    float32; what the reference's ml_dtypes cast gives."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _maxexp_tables(st):
    """Maximum-of-exponentials tables of one medium (maxexp.h:30-58):
    the descending rates, interval starts, normalized CDF knots and the
    normalization (reference builder.py:1516-1551)."""
    s = np.sort(st.astype(np.float64))[::-1]
    cdf = np.zeros(4, np.float64)
    istart = np.zeros(3, np.float64)
    for k in range(3):
        lower = -1.0 if k == 0 else -((s[k] / s[k - 1]) ** (-s[k] / (s[k] - s[k - 1])))
        upper = 0.0 if k == 2 else -((s[k + 1] / s[k]) ** (-s[k] / (s[k + 1] - s[k])))
        cdf[k + 1] = cdf[k] + (upper - lower)
        istart[k] = 0.0 if k == 0 else np.log(s[k] / s[k - 1]) / (s[k] - s[k - 1])
    return s, istart, cdf / cdf[3], cdf[3]


def _het_grid(m, bf16):
    """A heterogeneous medium's grid tables (reference builder.py:1407-1475):
    the scaled density grid, quantized to bfloat16 where `bf16` holds, so
    that the majorants bound exactly what tracking reads; its corner
    rows (one 8-wide row per base point (z, y, x) in [-1, D-1] x ..., the
    2 x 2 x 2 block of a trilinear lookup, over a zero-padded grid); the
    supergrid of SUPER_B^3-cell maxima dilated by one cell; the
    world -> grid-normalized affine map."""
    vol = m.density
    grid = vol.grid[..., 0] if vol.grid.ndim == 4 else vol.grid
    grid = np.ascontiguousarray(grid * m.scale, np.float32)
    if bf16:
        grid = _bf16(grid)
    d_, h_, w_ = grid.shape
    gp = np.zeros((d_ + 2, h_ + 2, w_ + 2), np.float32)
    gp[1:-1, 1:-1, 1:-1] = grid
    corners = np.empty((d_ + 1, h_ + 1, w_ + 1, 8), np.float32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corners[..., dz * 4 + dy * 2 + dx] = gp[
                    dz:dz + d_ + 1, dy:dy + h_ + 1, dx:dx + w_ + 1
                ]
    sd = [max((n + SUPER_B - 1) // SUPER_B, 1) for n in (d_, h_, w_)]
    sup = np.zeros(sd, np.float32)
    for z in range(sd[0]):
        for y in range(sd[1]):
            for x in range(sd[2]):
                sup[z, y, x] = grid[
                    max(z * SUPER_B - 1, 0):(z + 1) * SUPER_B + 1,
                    max(y * SUPER_B - 1, 0):(y + 1) * SUPER_B + 1,
                    max(x * SUPER_B - 1, 0):(x + 1) * SUPER_B + 1,
                ].max()
    ext = np.maximum(vol.aabb_max - vol.aabb_min, 1e-9)
    to_local = np.eye(4)
    to_local[:3, :3] = np.diag(1.0 / ext)
    to_local[:3, 3] = -vol.aabb_min / ext
    w2g = (to_local @ vol.to_world.inv).astype(np.float32)[:3].reshape(-1)
    return corners.reshape(-1, 8), sup.reshape(-1), [d_, h_, w_], sd, w2g


def _orientation_corners(vol):
    """An orientation volume's 3-channel grid, zero-padded by one voxel and
    packed as one [24] row of its 8 corners' vectors per cell, corner dz *
    4 + dy * 2 + dx (reference builder.py:1484-1510): ([cells, 24], [D, H,
    W])."""
    og = np.ascontiguousarray(vol.grid[..., :3], np.float32)
    d_, h_, w_ = og.shape[:3]
    ogp = np.zeros((d_ + 2, h_ + 2, w_ + 2, 3), np.float32)
    ogp[1:-1, 1:-1, 1:-1] = og
    oc = np.empty((d_ + 1, h_ + 1, w_ + 1, 8, 3), np.float32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                oc[..., dz * 4 + dy * 2 + dx, :] = ogp[dz:dz + d_ + 1, dy:dy + h_ + 1,
                                                        dx:dx + w_ + 1]
    return oc.reshape(-1, 24), [d_, h_, w_]


def _pack_media(media: list) -> tuple[dict, dict]:
    """The medium table (reference builder.py:1335-1620, meta :1738-1761):
    per medium its homogeneous coefficients, free-path strategy (0
    balance, 1 a fixed density for single/manual, 2 maximum) and sampling
    weight, its phase (med_phase) and the phase as up to
    MAX_PHASE_COMPONENTS (kind, g, weight) leaves (kind -1: empty), the
    fiber phases' parameters (kkay's ks, kd, exponent and normalization;
    microflake's normalization, deviation and sigma_t table), and for
    heterogeneous media a slot in the grid tables, with the corner rows
    of its orientation volume where it has one (het_obase -1 where not).
    The density corner rows are stored as bfloat16 when the grid was
    quantized (the same values, one 16-byte row per lookup)."""
    n_med = max(len(media), 1)
    a = {
        "med_sigma_s": np.zeros((n_med, 3), np.float32),
        "med_sigma_a": np.zeros((n_med, 3), np.float32),
        "med_ph_kinds": np.full((n_med, MAX_PHASE_COMPONENTS), -1, np.int32),
        "med_ph_gs": np.zeros((n_med, MAX_PHASE_COMPONENTS), np.float32),
        "med_ph_ws": np.zeros((n_med, MAX_PHASE_COMPONENTS), np.float32),
        "med_sampling_w": np.zeros(n_med, np.float32),
        "med_strategy": np.zeros(n_med, np.int32),
        "med_density": np.zeros(n_med, np.float32),
        "med_mx_sigma": np.ones((n_med, 3), np.float32),
        "med_mx_istart": np.zeros((n_med, 3), np.float32),
        "med_mx_cdf": np.zeros((n_med, 4), np.float32),
        "med_mx_norm": np.ones(n_med, np.float32),
        "med_het_slot": np.full(n_med, -1, np.int32),
        "med_phase": np.zeros(n_med, np.int32),
        "med_ph_ks": np.zeros(n_med, np.float32),
        "med_ph_kd": np.zeros(n_med, np.float32),
        "med_ph_exp": np.ones(n_med, np.float32),
        "med_ph_knorm": np.zeros(n_med, np.float32),
        "med_flake_norm": np.zeros(n_med, np.float32),
        "med_flake_stddev": np.full(n_med, 0.1, np.float32),
        "med_flake_sigt": np.ones((n_med, FLAKE_LUT), np.float32),
    }
    # the reference's knob: bfloat16 densities (the default) or float32
    bf16 = os.environ.get("MTS_HET_BF16", "1") != "0"
    a["med_ph_kinds"][:, 0] = 0
    a["med_ph_ws"][:, 0] = 1.0
    corners, sup, dims, sdims, w2g, albedo, cbase, sbase = [], [], [], [], [], [], [], []
    ocorners, obase, odims = [], [], []
    for i, m in enumerate(media):
        ph = m.phase
        a["med_phase"][i] = ph.kind
        if ph.kind == KKAY:
            a["med_ph_ks"][i], a["med_ph_kd"][i] = ph.ks, ph.kd
            a["med_ph_exp"][i], a["med_ph_knorm"][i] = ph.exponent, ph.knorm
        elif ph.kind == MICROFLAKE:
            a["med_flake_norm"][i], a["med_flake_stddev"][i] = ph.flake_norm, ph.stddev
            a["med_flake_sigt"][i] = ph.flake_sigt
        comps = m.phase.components or [(m.phase.kind, m.phase.g, 1.0)]
        for ci, (k_, g_, w_) in enumerate(comps):
            a["med_ph_kinds"][i, ci] = k_
            a["med_ph_gs"][i, ci] = g_ if k_ == HG else 0.0
            a["med_ph_ws"][i, ci] = w_
        if m.kind == HETEROGENEOUS:
            a["med_het_slot"][i] = len(dims)
            c, s_, d_, sd, w = _het_grid(m, bf16)
            cbase.append(sum(p.shape[0] for p in corners))
            sbase.append(sum(p.shape[0] for p in sup))
            corners.append(c)
            sup.append(s_)
            dims.append(d_)
            sdims.append(sd)
            w2g.append(w)
            albedo.append(np.asarray(m.albedo.constant, np.float32)
                          if m.albedo is not None and m.albedo.constant is not None
                          else np.full(3, 0.9, np.float32))
            ov = m.orientation
            if ov is not None and ov.grid is not None and ov.grid.ndim == 4:
                oc, od = _orientation_corners(ov)
                obase.append(sum(p.shape[0] for p in ocorners))
                ocorners.append(oc)
                odims.append(od)
            else:
                obase.append(-1)
                odims.append([1, 1, 1])
            continue
        a["med_sigma_s"][i] = m.sigma_s
        a["med_sigma_a"][i] = m.sigma_a
        # sampling weight = the largest single-channel albedo, at least
        # 0.5 where it scatters (reference homogeneous.cpp:168-181)
        st = m.sigma_s + m.sigma_a
        alb = float(np.where(st > 0, m.sigma_s / np.maximum(st, 1e-20), 0.0).max())
        a["med_sampling_w"][i] = max(alb, 0.5) if alb > 0 else 0.0
        if m.sampling_weight >= 0:
            a["med_sampling_w"][i] = m.sampling_weight
        if m.strategy in ("single", "manual"):
            a["med_strategy"][i] = 1
            a["med_density"][i] = m.sampling_density
        elif m.strategy == "maximum":
            a["med_strategy"][i] = 2
            (a["med_mx_sigma"][i], a["med_mx_istart"][i], a["med_mx_cdf"][i],
             a["med_mx_norm"][i]) = _maxexp_tables(st)
    n_het = len(dims)
    if n_het == 0:
        corners, sup = [np.zeros((1, 8), np.float32)], [np.zeros(1, np.float32)]
        dims, sdims, cbase, sbase = [[1, 1, 1]], [[1, 1, 1]], [0], [0]
        w2g = [np.eye(4, dtype=np.float32)[:3].reshape(-1)]
        albedo = [np.full(3, 0.9, np.float32)]
        obase, odims = [-1], [[1, 1, 1]]
    het_corners = np.concatenate(corners)
    a.update({
        # a torch tensor: numpy has no bfloat16 (_to_device keeps it)
        "het_corners": (torch.from_numpy(het_corners).to(torch.bfloat16)
                        if n_het and bf16 else het_corners),
        "het_super": np.concatenate(sup),
        "het_w2g": np.stack(w2g),  # [K, 12] row-major 3x4
        "het_albedo": np.stack(albedo),
        "het_dims": np.asarray(dims, np.int32),  # [K, 3] (D, H, W)
        "het_sdims": np.asarray(sdims, np.int32),
        "het_cbase": np.asarray(cbase, np.int32),
        "het_sbase": np.asarray(sbase, np.int32),
        "het_ocorners": np.concatenate(ocorners or [np.zeros((1, 24), np.float32)]),
        "het_obase": np.asarray(obase, np.int32),
        "het_odims": np.asarray(odims, np.int32),
    })
    meta = {
        "has_media": len(media) > 0,
        "n_media": len(media),
        "hom_strategies": tuple(sorted({int(s) for s in a["med_strategy"].tolist()}))
        if media else (0,),
        "phase_kinds": tuple(sorted({int(k) for k in a["med_ph_kinds"].ravel() if k >= 0}))
        if media else (),
        "n_het": n_het,
        # deterministic Simpson transmittance iff every heterogeneous
        # medium asks for it (a static per-scene dispatch)
        "het_simpson": n_het > 0 and all(
            m.method == "simpson" for m in media if m.kind == HETEROGENEOUS
        ),
        "het_super_b": SUPER_B,
        "camera_medium": -1,
    }
    return a, meta


def _pack_cylinders(cyls: list) -> tuple[dict, int]:
    """The segment table (reference builder.py:906-934) and the number of
    real segments: padded to a multiple of 128 rows (at least 128) with
    radius-0 rows, p1 = n0 = n1 = (0, 0, 1), for accel/cyl.py's blocks."""
    n_cyl = sum(len(cd.p0) for cd, _ in cyls)
    n_pad = max(-(-max(n_cyl, 1) // 128) * 128, 128)
    z = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n_pad, 1))
    out = {
        "cyl_p0": np.zeros((n_pad, 3), np.float32), "cyl_p1": z.copy(), "cyl_n0": z.copy(),
        "cyl_n1": z.copy(), "cyl_rad": np.zeros(n_pad, np.float32),  # radius 0: padding
        "cyl_mat": np.zeros(n_pad, np.int32), "cyl_flip": np.ones(n_pad, np.float32),
    }
    at = 0
    for cd, m in cyls:
        sl = slice(at, at + len(cd.p0))
        out["cyl_p0"][sl], out["cyl_p1"][sl] = cd.p0, cd.p1
        out["cyl_n0"][sl], out["cyl_n1"][sl] = cd.n0, cd.n1
        out["cyl_rad"][sl] = cd.radius
        out["cyl_mat"][sl] = m
        out["cyl_flip"][sl] = -1.0 if cd.flip_normals else 1.0
        at = sl.stop
    return out, n_cyl


def _chain_rows(materials: list, add_material) -> tuple[dict, list, int]:
    """Register the rows of mixtures and layers (reference
    builder.py:963-1055): a mixture flattens to weighted leaves, heaviest
    first; its own row holds leaf A and links to a chain of fresh rows,
    row k holding leaf k and linking to row k + 1 with the renormalized
    tail weights, so that f = sum w_k f_k with the deficit 1 - sum w_k
    absorbed at the top only; a coating's row links to its nested
    record's row with weights (1, 0).  Returns ({mixture row: leaf A},
    [(row, link, wa, wb)], the longest chain's hops)."""
    leaf_a, links, depth = {}, [], 0
    for i, rec in enumerate(list(materials)):
        if rec.type != MIXTURE:
            continue
        leaves = []

        def flatten(r, w):
            if r.type == MIXTURE:
                ws = r.weights or [1.0 / len(r.children)] * len(r.children)
                for c, cw in zip(r.children, ws):
                    flatten(c, w * cw)
            else:
                leaves.append((r, w))

        flatten(rec, 1.0)
        if any(r.type == IRAWAN for r, _ in leaves):
            raise ValueError("irawan cannot be a mixture/blend component (its yarn lookup is "
                             "keyed on the surface material row)")
        leaves.sort(key=lambda lw: -lw[1])
        depth = max(depth, len(leaves) - 1)

        def chain(tail):
            r0, w0 = tail[0]
            rid = add_material(copy.copy(r0))  # a row of its own for each chain
            if len(tail) > 1:
                tot = sum(wt for _, wt in tail)
                links.append((rid, chain(tail[1:]), w0 / tot, (tot - w0) / tot))
            return rid

        a_rec, w_a = leaves[0]
        if len(leaves) > 1:
            w_b = sum(wt for _, wt in leaves[1:])
            b_id = chain(leaves[1:])
        else:
            b_id, w_b = add_material(a_rec), 0.0
        leaf_a[i] = a_rec
        links.append((i, b_id, w_a, w_b))
    for i, rec in enumerate(list(materials)):
        if rec.type in (COATING, ROUGHCOATING) and rec.children:
            if rec.children[0].type == IRAWAN:
                raise ValueError("irawan cannot be nested under a coating (its yarn lookup is "
                                 "keyed on the surface material row)")
            links.append((i, add_material(rec.children[0]), 1.0, 0.0))
    return leaf_a, links, depth


def _pack_sss(n_mat: int, sss_mat_rows: list, sss_objs: list) -> tuple[dict, dict]:
    """The subsurface tables (reference builder.py:1140-1213): mat_sss,
    the subsurface object of each material row (-1: none); each object's
    points, normals, area per point and object id; per object the dipole
    coefficients (zr, zv, sigma_tr), eta, sigma_s and sigma_t after
    `scale`, g and its kind (0 dipole, 1 singlescatter); sss_E, the
    irradiance at each point, zero until the renderer's irradiance pass
    (integrator/sss.py prepare_sss) fills a copy of the pack.  Scenes
    without subsurface get the reference's one-row placeholders."""
    mat_sss = np.full(n_mat, -1, np.int32)
    for row, sid in sss_mat_rows:
        mat_sss[row] = sid
    if not sss_objs:
        return {
            "mat_sss": mat_sss,
            "sss_p": np.zeros((1, 3), np.float32),
            "sss_n": np.array([[0, 0, 1]], np.float32),
            "sss_area": np.zeros(1, np.float32),
            "sss_obj": np.zeros(1, np.int32),
            "sss_zr": np.ones((1, 3), np.float32),
            "sss_zv": np.ones((1, 3), np.float32),
            "sss_str": np.ones((1, 3), np.float32),
            "sss_eta": np.ones(1, np.float32),
            "sss_sigs": np.ones((1, 3), np.float32),
            "sss_sigt": np.ones((1, 3), np.float32),
            "sss_g": np.zeros(1, np.float32),
            "sss_kind": np.zeros(1, np.int32),
            "sss_E": np.zeros((1, 3), np.float32),
        }, {"has_sss": False}
    recs = [o[0] for o in sss_objs]
    coeffs = [r.dipole_coefficients() for r in recs]
    kinds = [1 if r.kind == "singlescatter" else 0 for r in recs]
    sss_p = np.concatenate([o[1] for o in sss_objs]).astype(np.float32)
    arrays = {
        "mat_sss": mat_sss,
        "sss_p": sss_p,
        "sss_n": np.concatenate([o[2] for o in sss_objs]).astype(np.float32),
        "sss_area": np.concatenate([np.full(len(o[1]), o[3], np.float32) for o in sss_objs]),
        "sss_obj": np.concatenate(
            [np.full(len(o[1]), k, np.int32) for k, o in enumerate(sss_objs)]
        ),
        "sss_zr": np.stack([c[0] for c in coeffs]),
        "sss_zv": np.stack([c[1] for c in coeffs]),
        "sss_str": np.stack([c[2] for c in coeffs]),
        "sss_eta": np.asarray([r.eta for r in recs], np.float32),
        "sss_sigs": np.stack([r.sigma_s * r.scale for r in recs]).astype(np.float32),
        "sss_sigt": np.stack([(r.sigma_s + r.sigma_a) * r.scale for r in recs]).astype(np.float32),
        "sss_g": np.asarray([r.g for r in recs], np.float32),
        "sss_kind": np.asarray(kinds, np.int32),
        "sss_E": np.zeros_like(sss_p),
    }
    meta = {
        "has_sss": True,
        "sss_irr_samples": max(r.irr_samples for r in recs),
        "sss_indirect": any(r.indirect for r in recs),
        # static: which of the path loop's subsurface arms run
        "sss_has_single": any(kinds),
        "sss_has_dipole": any(k == 0 for k in kinds),
        "sss_ss_samples": max(r.ss_samples for r in recs),
        "sss_ss_depth": max(r.ss_depth for r in recs),
    }
    return arrays, meta


def _check_clusters(meta: dict):
    """The port renders BVH scenes through the cluster tables (K3-K10).
    The reference packs none past its HBM budget (CLUSTER_HBM_MAX, at
    24,576 clusters of 128) and walks the BVH with XLA there, which is
    not a ported render path."""
    if meta.get("n_clusters", 0) == 0:
        raise NotImplementedError(
            "BVH traversal without cluster tables (the reference's XLA BVH "
            "walk, past its cluster HBM budget) not yet ported"
        )


def _to_device(arrays: dict, device) -> dict:
    """Each array as a C-contiguous tensor on `device`.  torch.tensor keeps
    a numpy array's strides, and cl_tri and tri_t are built as transposes:
    left so, every kernel wrapper's .contiguous() copied them per call.
    bfloat16 tables (het_corners) come as tensors, or from a reference
    pack as numpy arrays of ml_dtypes' bfloat16, which torch cannot read."""
    def tensor(v):
        if torch.is_tensor(v):
            return v.to(device).contiguous()
        if v.dtype.name == "bfloat16":
            return torch.from_numpy(v.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
        return torch.tensor(np.ascontiguousarray(v), device=device)

    return {k: tensor(v) for k, v in arrays.items()}


def cluster_columns(cl_tri, tc: int):
    """cl_cnt [C] i32: 1 + the last column of each cluster's [9, Tc] tile
    whose e2 rows are not all zero, rounded up to a multiple of 4 and
    capped at Tc (0 for a tile without one).  Past it every column has
    e2 = 0, so det = 0 and Moller-Trumbore accepts no hit there: K6 tests
    only these columns, whoever built the pack."""
    e2 = np.asarray(cl_tri)[6:9].reshape(3, -1, tc)
    nonzero = (e2 != 0).any(axis=0)  # [C, Tc]
    last = np.where(nonzero.any(axis=1), tc - np.argmax(nonzero[:, ::-1], axis=1), 0)
    return np.minimum((last + 3) // 4 * 4, tc).astype(np.int32)


def _with_derived(arrays: dict, meta: dict) -> dict:
    """arrays, plus the port's tables that the reference's pack lacks,
    where it holds what they derive from: mat_params and mat_iparams
    (texture_eval.material_table) from the material table, cl_cnt
    (cluster_columns) from the cluster tables."""
    out = dict(arrays)
    if "mat_type" in arrays:
        out["mat_params"], out["mat_iparams"] = material_table(arrays, meta)
    if "cl_tri" in arrays:
        out["cl_cnt"] = cluster_columns(arrays["cl_tri"], meta["cluster_tc"])
    return out


def _derived_meta(arrays: dict, meta: dict) -> dict:
    """meta, plus the port's static keys that the reference's lacks:
    tex_kinds, the texture kinds the table holds, and tex_nearest_any,
    whether a texture picks nearest texels (texture_eval.py skips the
    arms of absent kinds), where it holds the texture table."""
    if "tex_type" not in arrays:
        return dict(meta)
    out = {**meta, "tex_kinds": tuple(sorted(set(np.asarray(arrays["tex_type"]).tolist())))}
    if "tex_nearest" in arrays:
        out["tex_nearest_any"] = bool(np.asarray(arrays["tex_nearest"]).any())
    return out


def pack_from_numpy(arrays: dict, meta: dict, device) -> ScenePack:
    """Turn a reference pack ({name: numpy array} plus its meta) into the
    port's pack on `device`, with the port's derived tables.  Raises
    NotImplementedError when the scene needs features the port does not
    render yet."""
    check_slice(meta)
    _check_textures(arrays, meta)
    return ScenePack(_to_device(_with_derived(arrays, meta), device), _derived_meta(arrays, meta))


def pack_scene(scene, device="cuda") -> ScenePack:
    """scene: SceneDescription from the XML loader; the pack lies on
    `device` (the card unless the caller asks for another)."""
    materials: list[BSDFRecord] = []
    mat_index: dict[int, int] = {}
    default_bsdf = BSDFRecord(type=DIFFUSE)
    textures, tex_index = [], {}

    def add_texture(t):
        if t is None:
            return -1
        if id(t) not in tex_index:
            tex_index[id(t)] = len(textures)
            textures.append(t)
        return tex_index[id(t)]

    def add_material(rec):
        rec = default_bsdf if rec is None else rec
        if id(rec) not in mat_index:
            mat_index[id(rec)] = len(materials)
            materials.append(rec)
        return mat_index[id(rec)]

    emitters = list(scene.emitters)
    em_ids = {id(r): i for i, r in enumerate(emitters)}

    def add_emitter(rec):
        if rec is None:
            return -1
        if id(rec) not in em_ids:
            em_ids[id(rec)] = len(emitters)
            emitters.append(rec)
        return em_ids[id(rec)]

    media, med_ids = [], {}
    # subsurface shapes: (material row, object id) and (record, points,
    # normals, area per point) (reference builder.py:370-373)
    sss_mat_rows, sss_objs = [], []

    def add_medium(rec):
        if rec is None:
            return -1
        if id(rec) not in med_ids:
            med_ids[id(rec)] = len(media)
            media.append(rec)
        return med_ids[id(rec)]

    # ---------------- flatten geometry ----------------
    v0s, e1s, e2s, n0s, n1s, n2s = [], [], [], [], [], []
    uv0s, uv1s, uv2s, tmats, temits, tmed_in, tmed_ex = [], [], [], [], [], [], []
    all_meshes = []  # in triangle order: the geometry-driven textures' tables
    spheres = []  # (SphereData, material id, emitter id, interior, exterior)
    cyls = []  # (CylData, material id)
    # the triangle rows of static shapes first, then of animated shapes
    # (two keyframes or more), then of deformable ones: the accelerators
    # cover the static prefix only (reference builder.py:375-399)
    deform_i = [i for i in scene.shapes if i.deform_frames]
    anim_i = [i for i in scene.shapes
              if not i.deform_frames and i.animation and len(i.animation) >= 2]
    moving = {id(i) for i in deform_i + anim_i}
    row = 0
    anim_ranges, anim_m1, deform_marks = [], [], []
    for inst in [i for i in scene.shapes if id(i) not in moving] + anim_i + deform_i:
        start = row
        if inst.subsurface is not None:
            # a row of its own (mat_sss is per row): a copy of the BSDF
            # record, or an all-absorbing diffuse where the shape has none
            # (reference builder.py:477-505, shape.cpp:49-56)
            mat_id = add_material(
                copy.copy(inst.bsdf) if inst.bsdf is not None
                else BSDFRecord(type=DIFFUSE, cA=np.zeros(3, np.float32))
            )
            pts, nrm, a_pt, capped = sample_surface_points(inst.meshes, inst.spheres,
                                                           inst.subsurface)
            if capped:
                print(f"[subsurface] point density capped at MTS_SSS_MAX_POINTS for shape "
                      f"'{inst.id}' (raise it for a denser cache)")
            sss_mat_rows.append((mat_id, len(sss_objs)))
            sss_objs.append((inst.subsurface, pts, nrm, a_pt))
        else:
            mat_id = add_material(inst.bsdf)
        emit_id = add_emitter(inst.emitter)
        med_in = add_medium(inst.interior_medium)
        med_ex = add_medium(inst.exterior_medium)
        meshes = list(inst.meshes)
        if emit_id >= 0:
            meshes += _emissive_sphere_meshes(inst.spheres)
        else:
            spheres += [(sph, mat_id, emit_id, med_in, med_ex) for sph in inst.spheres]
        for cy in inst.cylinders:
            if emit_id >= 0 or med_in >= 0 or med_ex >= 0 or inst.subsurface is not None:
                raise ValueError(
                    "analytic cylinder segments support plain surface BSDFs only: set "
                    "exact=false on the shape to tessellate it for emitters, media or "
                    "subsurface scattering")
            cyls.append((cy, mat_id))
        for mesh in meshes:
            p = mesh.positions
            i = mesh.indices.astype(np.int64)
            a, b, c = p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]
            v0s.append(a)
            e1s.append(b - a)
            e2s.append(c - a)
            gn = np.cross(b - a, c - a)
            gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            if mesh.normals is not None and not mesh.face_normals:
                n0s.append(mesh.normals[i[:, 0]])
                n1s.append(mesh.normals[i[:, 1]])
                n2s.append(mesh.normals[i[:, 2]])
            else:
                n0s.append(gn)
                n1s.append(gn)
                n2s.append(gn)
            if mesh.texcoords is not None:
                uv0s.append(mesh.texcoords[i[:, 0]])
                uv1s.append(mesh.texcoords[i[:, 1]])
                uv2s.append(mesh.texcoords[i[:, 2]])
            else:
                z = np.zeros((len(i), 2), np.float32)
                uv0s.append(z)
                uv1s.append(z)
                uv2s.append(z)
            tmats.append(np.full(len(i), mat_id, np.int32))
            temits.append(np.full(len(i), emit_id, np.int32))
            tmed_in.append(np.full(len(i), med_in, np.int32))
            tmed_ex.append(np.full(len(i), med_ex, np.int32))
            all_meshes.append(mesh)
            row += len(i)
        if inst.deform_frames:
            deform_marks.append((inst, start, row))
        elif id(inst) in moving:
            anim_ranges.append((start, row - start))
            anim_m1.append(_relative_motion(inst, emit_id))

    def cat(parts, shape_tail, dtype=np.float32):
        if parts:
            return np.concatenate(parts).astype(dtype)
        return np.zeros((0,) + shape_tail, dtype)

    tri = {
        "tri_v0": cat(v0s, (3,)), "tri_e1": cat(e1s, (3,)),
        "tri_e2": cat(e2s, (3,)), "tri_n0": cat(n0s, (3,)),
        "tri_n1": cat(n1s, (3,)), "tri_n2": cat(n2s, (3,)),
        "tri_uv0": cat(uv0s, (2,)), "tri_uv1": cat(uv1s, (2,)),
        "tri_uv2": cat(uv2s, (2,)),
        "tri_mat": cat(tmats, (), np.int32),
        "tri_emit": cat(temits, (), np.int32),
        "tri_med_in": cat(tmed_in, (), np.int32),
        "tri_med_ex": cat(tmed_ex, (), np.int32),
    }
    n_tris = len(tri["tri_v0"])
    n_static = n_tris - sum(c for _, c in anim_ranges) - sum(e - b for _, b, e in deform_marks)
    descs = _texture_descs(materials)
    geom_tex_kinds, geom_tex = _geometry_tables(descs, all_meshes, tri)
    tri.update(geom_tex)
    use_bvh = n_static > BRUTE_FORCE_MAX_TRIS
    if use_bvh:
        v0, e1, e2 = (tri[k][:n_static] for k in ("tri_v0", "tri_e1", "tri_e2"))
        lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
        hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
        bvh = build_bvh(v0 + (e1 + e2) / 3.0, lo, hi)
        # every per-row table: the static prefix permuted, the moving rows
        # kept in place
        tri = {k: np.concatenate([a[:n_static][bvh.order], a[n_static:]])
               for k, a in tri.items()}
    tri_s = pack_triangles_sublane(
        tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], n_static
    )
    tri_t = pack_triangles_transposed(
        tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], n_static
    )
    deform = _deform_tables(deform_marks)
    tri_area = 0.5 * np.linalg.norm(
        np.cross(tri["tri_e1"], tri["tri_e2"]), axis=-1
    )
    tri_emit = tri["tri_emit"]
    cyl, n_cyl = _pack_cylinders(cyls)
    center, radius = _bounding_sphere(tri, spheres, cyl, n_cyl, deform.values())
    # pad with LEAF_SIZE far-away rows: index-clamped gathers and the
    # cluster tiles' dummy slots (index n_tris) never leave the tables
    pad_fill = {"tri_v0": 1e30, "tri_emit": -1, "tri_med_in": -1, "tri_med_ex": -1,
                "tri_c0": 1.0, "tri_c1": 1.0, "tri_c2": 1.0}
    for k, a in tri.items():
        pad = np.full((LEAF_SIZE,) + a.shape[1:], pad_fill.get(k, 0), a.dtype)
        tri[k] = np.concatenate([a, pad])
    tri["tri_dpdu"], tri["tri_dpdv"] = _uv_partials(tri)

    bvh_arrays, bvh_meta = {}, {}
    if use_bvh:
        bvh_nodes, n_layouts = octant_node_rows(bvh)
        tri9 = np.concatenate(
            [tri["tri_v0"], tri["tri_e1"], tri["tri_e2"]], axis=1
        ).astype(np.float32)
        # the tiles' dummy slot is row n_tris (padding), past every moving
        # row, as in the reference (builder.py:846-851)
        cl = pack_clusters(bvh, tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], n_tris)
        cl_arrays, cl_meta = cl if cl is not None else ({}, {})
        bvh_arrays = {"bvh_nodes": bvh_nodes, "tri9": tri9, **cl_arrays}
        bvh_meta = {"bvh_n_layouts": n_layouts, **cl_meta}

    # ---------------- spheres ----------------
    n_sph = len(spheres)
    sph = {
        "sph_center": np.zeros((max(n_sph, 1), 3), np.float32),
        "sph_radius": np.zeros(max(n_sph, 1), np.float32),
        "sph_mat": np.zeros(max(n_sph, 1), np.int32),
        "sph_emit": np.full(max(n_sph, 1), -1, np.int32),
        "sph_flip": np.zeros(max(n_sph, 1), np.float32),
        "sph_med_in": np.full(max(n_sph, 1), -1, np.int32),
        "sph_med_ex": np.full(max(n_sph, 1), -1, np.int32),
    }
    for k, (sd, m, e, mi, mx) in enumerate(spheres):
        sph["sph_center"][k] = sd.center
        sph["sph_radius"][k] = sd.radius
        sph["sph_mat"][k] = m
        sph["sph_emit"][k] = e
        sph["sph_flip"][k] = -1.0 if sd.flip_normals else 1.0
        sph["sph_med_in"][k] = mi
        sph["sph_med_ex"][k] = mx

    # ---------------- material table ----------------
    leaf_a, links, mix_depth = _chain_rows(materials, add_material)
    n_mat = max(len(materials), 1)
    mt = {
        "mat_type": np.zeros(n_mat, np.int32),
        "mat_cA": np.full((n_mat, 3), 0.5, np.float32),
        "mat_cB": np.ones((n_mat, 3), np.float32),
        "mat_cC": np.ones((n_mat, 3), np.float32),
        "mat_cD": np.zeros((n_mat, 3), np.float32),
        "mat_alpha_u": np.full(n_mat, 0.1, np.float32),
        "mat_alpha_v": np.full(n_mat, 0.1, np.float32),
        "mat_eta": np.full(n_mat, 1.5046, np.float32),
        "mat_disp": np.zeros(n_mat, np.float32),  # Cauchy B [um^2]
        "mat_exponent": np.full(n_mat, 30.0, np.float32),
        "mat_dist": np.zeros(n_mat, np.int32),
        "mat_nonlinear": np.zeros(n_mat, np.float32),
        "mat_twosided": np.zeros(n_mat, np.float32),
        "mat_fdr_int": np.zeros(n_mat, np.float32),
        "mat_spec_w": np.full(n_mat, 0.5, np.float32),
        "mat_texA": np.full(n_mat, -1, np.int32),
        # a mask's opacity: packed, and read by nothing (ROADMAP C3)
        "mat_opacity": np.ones((n_mat, 3), np.float32),
        "mat_tex_opacity": np.full(n_mat, -1, np.int32),
        "mat_tex_bump": np.full(n_mat, -1, np.int32),
        "mat_bump_nm": np.zeros(n_mat, np.float32),  # 1: a normal map
        "mat_mix_b": np.full(n_mat, -1, np.int32),
        "mat_mix_wa": np.ones(n_mat, np.float32),
        "mat_mix_wb": np.zeros(n_mat, np.float32),
    }
    for i, b_id, wa, wb in links:
        mt["mat_mix_b"][i], mt["mat_mix_wa"][i], mt["mat_mix_wb"][i] = b_id, wa, wb
    present_types = set()
    mf_dists = set()  # microfacet distributions in use
    for i, rec in enumerate(materials):
        rec = leaf_a.get(i, rec)  # a mixture's row holds its leaf A
        present_types.add(rec.type)
        if rec.type in _MF_TYPES:
            mf_dists.add(int(rec.dist))
        mt["mat_type"][i] = rec.type
        mt["mat_cA"][i] = rec.cA
        mt["mat_cB"][i] = rec.cB
        mt["mat_cC"][i] = rec.cC
        mt["mat_cD"][i] = rec.cD
        mt["mat_alpha_u"][i] = rec.alpha_u
        mt["mat_alpha_v"][i] = rec.alpha_v
        mt["mat_eta"][i] = rec.eta
        mt["mat_disp"][i] = rec.dispersion
        mt["mat_exponent"][i] = rec.exponent
        mt["mat_dist"][i] = rec.dist
        mt["mat_nonlinear"][i] = float(rec.nonlinear)
        mt["mat_twosided"][i] = float(rec.twosided)
        mt["mat_fdr_int"][i] = rec.fdr_int
        mt["mat_spec_w"][i] = rec.spec_sampling_weight
        if rec.opacity is not None:
            mt["mat_opacity"][i] = rec.opacity
        mt["mat_texA"][i] = add_texture(rec.texA)
        mt["mat_tex_opacity"][i] = add_texture(rec.tex_opacity)
        mt["mat_tex_bump"][i] = add_texture(rec.tex_bump)
        mt["mat_bump_nm"][i] = float(rec.bump_is_normalmap)

    # rough-transmittance fits for roughplastic and roughcoating (reference
    # rtrans.h:44-186): a cubic in cos(theta) of the external
    # transmittance and the internal diffuse reflectance, per unique
    # (dist, alpha, eta) (bsdf/rtrans.py)
    mt["mat_rt"] = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (n_mat, 1))
    mt["mat_rt_fdr"] = mt["mat_fdr_int"].copy()
    rt_cache = {}
    for i in np.nonzero(np.isin(mt["mat_type"], (ROUGHPLASTIC, ROUGHCOATING)))[0]:
        key = (
            int(mt["mat_dist"][i]),
            round(max(float(mt["mat_alpha_u"][i]), 1e-3), 4),
            round(float(mt["mat_eta"][i]), 4),
        )
        if key not in rt_cache:
            c_ext, _ = fit_rtrans_poly(*key)
            _, tdiff_int = fit_rtrans_poly(key[0], key[1], 1.0 / key[2])
            rt_cache[key] = (c_ext, 1.0 - tdiff_int)
        mt["mat_rt"][i] = rt_cache[key][0]
        mt["mat_rt_fdr"][i] = rt_cache[key][1]

    iw_arrays, iw_meta = _irawan_tables(materials, mt)

    # ---------------- emitter table ----------------
    n_em = max(len(emitters), 1)
    em = {
        "em_kind": np.zeros(n_em, np.int32),
        "em_rgb": np.zeros((n_em, 3), np.float32),
        "em_area": np.ones(n_em, np.float32),
        "em_tri_lo": np.zeros(n_em, np.int32),
        "em_tri_hi": np.zeros(n_em, np.int32),
        "em_pos": np.zeros((n_em, 3), np.float32),
        "em_dir": np.tile(np.array([[0, 0, 1]], np.float32), (n_em, 1)),
        "em_cos_cutoff": np.zeros(n_em, np.float32),
        "em_cos_beam": np.zeros(n_em, np.float32),
    }
    idx_parts, cdf_parts = [], []
    at_cursor = 0
    env_idx = -1
    weights = np.zeros(n_em, np.float64)
    for i, rec in enumerate(emitters):  # kinds: check_slice below
        em["em_kind"][i] = rec.kind
        em["em_rgb"][i] = rec.radiance
        weights[i] = rec.sampling_weight
        if rec.kind in (CONSTANT, ENVMAP):
            if rec.kind == ENVMAP:
                em["em_rgb"][i] = rec.radiance * rec.scale
            env_idx = i
            continue
        if rec.is_delta():
            # point / spot / collimated carry an intensity, directional an
            # irradiance; spot's cone as cosines (reference builder.py)
            em["em_rgb"][i] = rec.irradiance if rec.kind == DIRECTIONAL else rec.intensity
            em["em_pos"][i] = rec.position
            em["em_dir"][i] = rec.direction
            em["em_cos_cutoff"][i] = np.cos(np.deg2rad(rec.cutoff_angle_deg))
            em["em_cos_beam"][i] = np.cos(np.deg2rad(rec.beam_width_deg))
            continue
        ids = np.nonzero(tri_emit == i)[0]
        areas = tri_area[ids]
        total = float(areas.sum())
        em["em_area"][i] = max(total, 1e-12)
        em["em_tri_lo"][i] = at_cursor
        em["em_tri_hi"][i] = at_cursor + len(ids)
        at_cursor += len(ids)
        idx_parts.append(ids.astype(np.int32))
        cdf_parts.append((np.cumsum(areas) / max(total, 1e-12)).astype(np.float32))
    if not emitters:
        weights = np.ones(1)
    pmf = weights / weights.sum() if weights.sum() > 0 else weights
    emitter_cdf = np.concatenate([[0.0], np.cumsum(pmf)]).astype(np.float32)
    emitter_cdf[-1] = 1.0
    env_arrays, env_meta = _env_table(emitters[env_idx] if env_idx >= 0 else None)
    med_arrays, med_meta = _pack_media(media)
    sss_arrays, sss_meta = _pack_sss(n_mat, sss_mat_rows, sss_objs)

    arrays = {
        **tri,
        "tri_s": tri_s,
        "tri_t": tri_t,
        "anim_m1": np.stack(anim_m1) if anim_m1 else np.zeros((1, 12), np.float32),
        **deform,
        **bvh_arrays,
        **sph,
        **cyl,
        **mt,
        **_pack_textures(textures),
        **em,
        "area_tri_idx": (
            np.concatenate(idx_parts).astype(np.int32)
            if idx_parts else np.zeros(1, np.int32)
        ),
        "area_tri_cdf": (
            np.concatenate(cdf_parts).astype(np.float32)
            if cdf_parts else np.ones(1, np.float32)
        ),
        "emitter_pmf": pmf.astype(np.float32),
        "emitter_cdf": emitter_cdf,
        **env_arrays,
        **med_arrays,
        **sss_arrays,
        **iw_arrays,
    }
    arrays["cam_w2c"], cam_meta = _cam_motion(scene)
    sensor = scene.sensor.record if scene.sensor is not None else None
    meta = {
        "n_tris": n_tris,
        "n_static_tris": int(n_static),
        "anim_ranges": tuple(anim_ranges),
        "deform_ranges": tuple((b, e - b, inst.deform_times) for inst, b, e in deform_marks),
        "shutter_open": float(getattr(sensor, "shutter_open", 0.0)),
        "shutter_close": float(getattr(sensor, "shutter_close", 0.0)),
        "n_spheres": n_sph,
        "n_cyls": n_cyl,
        "n_emitters": len(emitters),
        "present_types": tuple(sorted(present_types)) or (DIFFUSE,),
        "mf_dists": tuple(sorted(mf_dists)),
        "emitter_kinds": tuple(sorted({r.kind for r in emitters})),
        "use_bvh": use_bvh,
        **bvh_meta,
        "has_area": any(r.kind == AREA for r in emitters),
        "env_idx": env_idx,
        "has_env": env_idx >= 0,
        **env_meta,
        "has_textures": len(textures) > 0,
        "geom_tex_kinds": geom_tex_kinds,
        "has_mips": any(t.kind == TEX_BITMAP for t in textures)
        and os.environ.get("MTS_TPU_NO_MIPS", "0") != "1",
        "cam_pix_angle": _cam_pix_angle(scene),
        **cam_meta,
        "has_bumpmaps": any(rec.tex_bump is not None for rec in materials),
        "has_mixtures": bool(links),
        # the links shading_params follows (N-ary mixtures)
        "mix_depth": max(mix_depth, 1),
        "has_delta_emitters": any(r.is_delta() for r in emitters),
        # the scene's bounding sphere: where directional and environment
        # emission starts (bdpt, ptracer)
        "scene_center": center,
        "scene_radius": radius,
        **med_meta,
        **sss_meta,
        **iw_meta,
    }
    check_slice(meta)
    return ScenePack(_to_device(_with_derived(arrays, meta), device), _derived_meta(arrays, meta))


# ---------------- N-bin spectral repacking ----------------

# Pack leaves holding colour quantities (trailing dim 3), re-expressed per
# bin group in spectral mode (reference builder.py:1776-1788).  Positions,
# normals and data textures (bump and opacity, restored from the original
# atlas below) are not listed; the dipole tables hold distances and keep
# their RGB channels.
_SPECTRAL_LEAVES = (
    "tex_c0", "tex_c1", "tex_scale",
    "mat_cA", "mat_cB", "mat_cC", "mat_cD",
    "mat_mix_wa", "mat_mix_wb",
    "med_sigma_s", "med_sigma_a", "het_albedo",
    "med_ph_ks", "med_ph_kd",
    "tri_c0", "tri_c1", "tri_c2",
    "iw_y_kd", "iw_y_ks",
)

# emission leaves carry D65-shaped illuminant spectra, so that their RGB
# projects back exactly (core/spectral.py upsample_illum)
_EMISSION_LEAVES = ("em_rgb", "env_image")


def apply_spectral_pack(pack: ScenePack, bins, g: int) -> ScenePack:
    """The pack of spectral bin group `g` (reference builder.py:1791-1848):
    each colour leaf's RGB upsampled to a smooth spectrum and sliced to the
    group's three bins, and dielectric IORs moved to the group's hero
    wavelength by the Cauchy model.  The rewrite runs in host numpy, the
    reference's own code, so that every leaf is bit-equal to the
    reference's; the new leaves go back to the pack's device.  The meta,
    the sampling tables (env_density, the alias table, emitter_pmf and
    emitter_cdf, built from the RGB luminance) and every other tensor are
    the caller's, so each group draws the same samples; `pack` is not
    changed.  The port's material table (mat_params) is rebuilt from the
    new material columns."""
    from mitsuba_tpu_torch.core.spectral import cauchy_eta, upsample_illum, upsample_rgb

    sl = slice(3 * g, 3 * g + 3)
    _, lam_mid = bins.group(g)
    arrays = dict(pack.arrays)

    def host(name):
        return pack.arrays[name].cpu().numpy()

    def put(name, a):
        arrays[name] = torch.tensor(np.ascontiguousarray(a), device=pack.arrays[name].device)

    def xform(a, up=upsample_rgb):
        return np.maximum(up(np.asarray(a, np.float32), bins)[..., sl], 0.0)

    def colour(name):
        return name in arrays and arrays[name].ndim and arrays[name].shape[-1] == 3

    for name in _SPECTRAL_LEAVES:
        if colour(name):
            put(name, xform(host(name)))
    for name in _EMISSION_LEAVES:
        if colour(name):
            put(name, xform(host(name), upsample_illum))

    if "tex_atlas" in arrays and not bins.identity:
        atlas0 = host("tex_atlas")
        atlas = xform(atlas0)
        # bump and opacity entries store data, not colours: restore them
        data_tex = set()
        for leaf in ("mat_tex_bump", "mat_tex_opacity"):
            data_tex |= {int(t) for t in host(leaf) if int(t) >= 0}
        if data_tex:
            mip = host("tex_mip_rect")
            nlev = host("tex_n_lev")
            for t in data_tex:
                for lvl in range(int(nlev[t])):
                    x, y, w, h = (int(v) for v in mip[t, lvl])
                    atlas[y:y + h, x:x + w] = atlas0[y:y + h, x:x + w]
        put("tex_atlas", atlas)

    # hero-wavelength dispersion for dielectrics (Cauchy, eta given at
    # the d-line)
    disp = host("mat_disp")
    if (disp != 0.0).any():
        put("mat_eta", cauchy_eta(host("mat_eta"), disp, lam_mid).astype(np.float32))
    if "mat_params" in arrays:
        cols = {k: v.cpu().numpy() for k, v in arrays.items() if k.startswith("mat_")}
        params, iparams = material_table(cols, pack.meta)
        put("mat_params", params)
        put("mat_iparams", iparams)
    return ScenePack(arrays, pack.meta)
