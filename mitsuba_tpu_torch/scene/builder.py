"""Scene packing: host scene description -> flat device tensors
(`ScenePack`); the port of mitsuba_tpu/scene/builder.py for the slice it
renders: triangle meshes (brute force up to 512 triangles, BVH + cluster
tables above), analytic spheres (tessellated where they emit), the
diffuse, conductor, dielectric, plastic and null material families
(smooth and rough) with checkerboard-textured reflectances, area
emitters, a constant or image-based (`envmap`) environment, and
homogeneous and heterogeneous media attached to shapes as their
interior or exterior (`_pack_media`).

Array names, dtypes, shapes and meta keys are the reference's, so a
reference pack converted with `pack_from_numpy` and the port's own pack
of the same scene are interchangeable.
"""

from __future__ import annotations

import os
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
from mitsuba_tpu_torch.bsdf.plugins import (
    DIFFUSE,
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
    HETEROGENEOUS,
    HG,
    KKAY,
    MAX_PHASE_COMPONENTS,
    MICROFLAKE,
)
from mitsuba_tpu_torch.scene.shapes import _apply_transform, _uv_sphere
from mitsuba_tpu_torch.scene.texture_eval import material_table
from mitsuba_tpu_torch.scene.textures import TEX_CONSTANT, TEX_CHECKERBOARD

# scenes above this many triangles go through the BVH and cluster tables
BRUTE_FORCE_MAX_TRIS = 512

# the texture kinds the port evaluates
PORTED_TEXTURES = frozenset((TEX_CONSTANT, TEX_CHECKERBOARD))
# BSDF types whose lobes sample a microfacet normal: their distributions
# make the static mf_dists meta
_MF_TYPES = (ROUGHCONDUCTOR, ROUGHDIELECTRIC, ROUGHPLASTIC)

# the arrays and meta keys the ported slice reads
SLICE_ARRAYS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_emit", "tri_s", "tri_t",
    "mat_type", "mat_cA", "mat_cB", "mat_cC", "mat_cD", "mat_alpha_u",
    "mat_alpha_v", "mat_eta", "mat_exponent", "mat_dist", "mat_nonlinear",
    "mat_twosided", "mat_fdr_int", "mat_spec_w", "mat_texA", "mat_rt", "mat_rt_fdr",
    "tex_type", "tex_c0", "tex_c1", "tex_scale", "tex_uv",
    "sph_center", "sph_radius", "sph_mat", "sph_emit", "sph_flip",
    "em_kind", "em_rgb", "em_area", "em_tri_lo", "em_tri_hi", "em_pos", "em_dir",
    "em_cos_cutoff", "em_cos_beam",
    "area_tri_idx", "area_tri_cdf", "emitter_pmf", "emitter_cdf",
    "env_image", "env_to_world", "env_to_local", "env_density", "env_alias_prob",
    "env_alias_idx", "env_alias_fused",
)
SLICE_META = (
    "n_tris", "n_spheres", "n_emitters", "present_types", "mf_dists", "emitter_kinds",
    "use_bvh", "has_area", "has_env", "has_envmap", "env_idx", "env_alias_fused_ok",
    "has_textures", "has_mips", "has_delta_emitters", "scene_center", "scene_radius",
)
# ... for scenes with media, the medium tables (`_pack_media`) ...
MEDIA_ARRAYS = (
    "tri_med_in", "tri_med_ex", "sph_med_in", "sph_med_ex",
    "med_sigma_s", "med_sigma_a", "med_ph_kinds", "med_ph_gs", "med_ph_ws", "med_sampling_w",
    "med_strategy", "med_density", "med_mx_sigma", "med_mx_istart", "med_mx_cdf",
    "med_mx_norm", "med_het_slot", "het_corners", "het_super", "het_w2g", "het_albedo",
    "het_dims", "het_sdims", "het_cbase", "het_sbase",
)
MEDIA_META = (
    "has_media", "n_media", "hom_strategies", "phase_kinds", "n_het", "het_simpson",
    "het_super_b", "camera_medium",
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
    ("n_cyls", 0, "analytic cylinders"),
    ("has_sss", False, "subsurface scattering"),
    ("has_mips", False, "bitmap textures"),
    ("geom_tex_kinds", (), "geometry-driven textures"),
    ("has_bumpmaps", False, "bump/normal maps"),
    ("has_mixtures", False, "mixture/coating BSDFs"),
    ("has_irawan", False, "bsdf 'irawan'"),
    ("has_instances", False, "instancing"),
    ("anim_ranges", (), "animated shapes"),
    ("deform_ranges", (), "deformable shapes"),
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
    fiber = {KKAY: "kkay", MICROFLAKE: "microflake"}
    for kind in meta.get("phase_kinds", ()):
        if kind in fiber:
            raise NotImplementedError(f"phase '{fiber[kind]}' not yet ported")
    kinds = set(meta.get("emitter_kinds", ()))
    if kinds - PORTED_KINDS:
        raise NotImplementedError(
            f"emitter kinds {sorted(kinds - PORTED_KINDS)} not yet ported"
        )
    if meta.get("use_bvh", False):
        _check_clusters(meta)


def _check_textures(arrays: dict, meta: dict):
    """Raise NotImplementedError for texture kinds the port does not
    evaluate (scene/texture_eval.py: constant and checkerboard)."""
    if not meta.get("has_textures", False):
        return
    kinds = set(np.asarray(arrays["tex_type"]).tolist()) - PORTED_TEXTURES
    if kinds:
        raise NotImplementedError(f"texture kinds {sorted(kinds)} not yet ported")


def _pack_textures(textures: list) -> dict:
    """The texture table of the procedural kinds (the reference's
    _pack_textures without its bitmap atlas)."""
    n = max(len(textures), 1)
    tex = {
        "tex_type": np.zeros(n, np.int32),
        "tex_c0": np.zeros((n, 3), np.float32),
        "tex_c1": np.ones((n, 3), np.float32),
        "tex_scale": np.ones((n, 3), np.float32),
        # uscale, vscale, uoffset, voffset
        "tex_uv": np.tile(np.array([1.0, 1.0, 0.0, 0.0], np.float32), (n, 1)),
    }
    for i, t in enumerate(textures):
        tex["tex_type"][i] = t.kind
        tex["tex_c0"][i] = t.color0
        tex["tex_c1"][i] = t.color1
        tex["tex_scale"][i] = t.scale
        tex["tex_uv"][i] = [*t.uv_scale, *t.uv_offset]
    return tex


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


def _bounding_sphere(tri, spheres):
    """(center, radius) of the scene's bounds, in float32 as the reference
    computes them (reference builder.py): the triangles' corners and the
    analytic spheres' boxes."""
    v = tri["tri_v0"]
    pts = [v, v + tri["tri_e1"], v + tri["tri_e2"]] if len(v) else []
    if spheres:
        c = np.array([s[0].center for s in spheres], np.float32)
        r = np.array([s[0].radius for s in spheres], np.float32)
        pts += [c - r[:, None], c + r[:, None]]
    if not pts:
        return (0.0, 0.0, 0.0), 1.0
    allp = np.concatenate(pts, axis=0)
    lo, hi = allp.min(axis=0), allp.max(axis=0)
    center = 0.5 * (lo + hi)
    return tuple(float(x) for x in center), float(np.linalg.norm(hi - center)) + 1e-6


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


def _pack_media(media: list) -> tuple[dict, dict]:
    """The medium table (reference builder.py:1335-1620, meta :1738-1761)
    without the fiber-phase tables: per medium its homogeneous
    coefficients, free-path strategy (0 balance, 1 a fixed density for
    single/manual, 2 maximum) and sampling weight, its phase as up to
    MAX_PHASE_COMPONENTS (kind, g, weight) leaves (kind -1: empty), and
    for heterogeneous media a slot in the grid tables.  The corner rows
    are stored as bfloat16 when the grid was quantized (the same values,
    one 16-byte row per lookup)."""
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
    }
    # the reference's knob: bfloat16 densities (the default) or float32
    bf16 = os.environ.get("MTS_HET_BF16", "1") != "0"
    a["med_ph_kinds"][:, 0] = 0
    a["med_ph_ws"][:, 0] = 1.0
    corners, sup, dims, sdims, w2g, albedo, cbase, sbase = [], [], [], [], [], [], [], []
    for i, m in enumerate(media):
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


def pack_from_numpy(arrays: dict, meta: dict, device) -> ScenePack:
    """Turn a reference pack ({name: numpy array} plus its meta) into the
    port's pack on `device`, with the port's derived tables.  Raises
    NotImplementedError when the scene needs features the port does not
    render yet."""
    check_slice(meta)
    _check_textures(arrays, meta)
    return ScenePack(_to_device(_with_derived(arrays, meta), device), dict(meta))


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
    spheres = []  # (SphereData, material id, emitter id, interior, exterior)
    for inst in scene.shapes:
        mat_id = add_material(inst.bsdf)
        emit_id = add_emitter(inst.emitter)
        med_in = add_medium(inst.interior_medium)
        med_ex = add_medium(inst.exterior_medium)
        meshes = list(inst.meshes)
        if emit_id >= 0:
            meshes += _emissive_sphere_meshes(inst.spheres)
        else:
            spheres += [(sph, mat_id, emit_id, med_in, med_ex) for sph in inst.spheres]
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
    use_bvh = n_tris > BRUTE_FORCE_MAX_TRIS
    if use_bvh:
        v0, e1, e2 = tri["tri_v0"], tri["tri_e1"], tri["tri_e2"]
        lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
        hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
        bvh = build_bvh(v0 + (e1 + e2) / 3.0, lo, hi)
        tri = {k: a[bvh.order] for k, a in tri.items()}
    tri_s = pack_triangles_sublane(
        tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], n_tris
    )
    tri_t = pack_triangles_transposed(
        tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], n_tris
    )
    tri_area = 0.5 * np.linalg.norm(
        np.cross(tri["tri_e1"], tri["tri_e2"]), axis=-1
    )
    tri_emit = tri["tri_emit"]
    center, radius = _bounding_sphere(tri, spheres)
    # pad with LEAF_SIZE far-away rows: index-clamped gathers and the
    # cluster tiles' dummy slots (index n_tris) never leave the tables
    pad_fill = {"tri_v0": 1e30, "tri_emit": -1, "tri_med_in": -1, "tri_med_ex": -1}
    for k, a in tri.items():
        pad = np.full((LEAF_SIZE,) + a.shape[1:], pad_fill.get(k, 0), a.dtype)
        tri[k] = np.concatenate([a, pad])

    bvh_arrays, bvh_meta = {}, {}
    if use_bvh:
        bvh_nodes, n_layouts = octant_node_rows(bvh)
        tri9 = np.concatenate(
            [tri["tri_v0"], tri["tri_e1"], tri["tri_e2"]], axis=1
        ).astype(np.float32)
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
        "mat_exponent": np.full(n_mat, 30.0, np.float32),
        "mat_dist": np.zeros(n_mat, np.int32),
        "mat_nonlinear": np.zeros(n_mat, np.float32),
        "mat_twosided": np.zeros(n_mat, np.float32),
        "mat_fdr_int": np.zeros(n_mat, np.float32),
        "mat_spec_w": np.full(n_mat, 0.5, np.float32),
        "mat_texA": np.full(n_mat, -1, np.int32),
    }
    present_types = set()
    mf_dists = set()  # microfacet distributions in use
    for i, rec in enumerate(materials):
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
        mt["mat_exponent"][i] = rec.exponent
        mt["mat_dist"][i] = rec.dist
        mt["mat_nonlinear"][i] = float(rec.nonlinear)
        mt["mat_twosided"][i] = float(rec.twosided)
        mt["mat_fdr_int"][i] = rec.fdr_int
        mt["mat_spec_w"][i] = rec.spec_sampling_weight
        mt["mat_texA"][i] = add_texture(rec.texA)

    # rough-transmittance fits for roughplastic (reference rtrans.h:44-186):
    # a cubic in cos(theta) of the external transmittance and the internal
    # diffuse reflectance, per unique (dist, alpha, eta) (bsdf/rtrans.py)
    mt["mat_rt"] = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (n_mat, 1))
    mt["mat_rt_fdr"] = mt["mat_fdr_int"].copy()
    rt_cache = {}
    for i in np.nonzero(mt["mat_type"] == ROUGHPLASTIC)[0]:
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

    arrays = {
        **tri,
        "tri_s": tri_s,
        "tri_t": tri_t,
        **bvh_arrays,
        **sph,
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
    }
    meta = {
        "n_tris": n_tris,
        "n_spheres": n_sph,
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
        "has_mips": False,
        "has_delta_emitters": any(r.is_delta() for r in emitters),
        # the scene's bounding sphere: where directional and environment
        # emission starts (bdpt, ptracer)
        "scene_center": center,
        "scene_radius": radius,
        **med_meta,
    }
    check_slice(meta)
    return ScenePack(_to_device(_with_derived(arrays, meta), device), meta)
