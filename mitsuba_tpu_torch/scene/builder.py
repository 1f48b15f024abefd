"""Scene packing: host scene description -> flat device tensors
(`ScenePack`); the port of mitsuba_tpu/scene/builder.py for the slice it
renders: triangle meshes (brute force up to 512 triangles, BVH + cluster
tables above), analytic spheres (tessellated where they emit), the
diffuse, conductor, dielectric and plastic material families (smooth and
rough) with checkerboard-textured reflectances, area emitters and a
constant or image-based (`envmap`) environment.

Array names, dtypes, shapes and meta keys are the reference's, so a
reference pack converted with `pack_from_numpy` and the port's own pack
of the same scene are interchangeable.
"""

from __future__ import annotations

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
from mitsuba_tpu_torch.emitter.plugins import AREA, CONSTANT, ENVMAP
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
    "em_kind", "em_rgb", "em_area", "em_tri_lo", "em_tri_hi",
    "area_tri_idx", "area_tri_cdf", "emitter_pmf", "emitter_cdf",
    "env_image", "env_to_world", "env_to_local", "env_density", "env_alias_prob",
    "env_alias_idx", "env_alias_fused",
)
SLICE_META = (
    "n_tris", "n_spheres", "n_emitters", "present_types", "mf_dists", "emitter_kinds",
    "use_bvh", "has_area", "has_env", "has_envmap", "env_idx", "env_alias_fused_ok",
    "has_textures", "has_mips",
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
    ("has_media", False, "participating media"),
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
    left so, every kernel wrapper's .contiguous() copied them per call."""
    return {k: torch.tensor(np.ascontiguousarray(v), device=device) for k, v in arrays.items()}


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

    # ---------------- flatten geometry ----------------
    v0s, e1s, e2s, n0s, n1s, n2s = [], [], [], [], [], []
    uv0s, uv1s, uv2s, tmats, temits = [], [], [], [], []
    spheres = []  # (SphereData, material id, emitter id)
    for inst in scene.shapes:
        mat_id = add_material(inst.bsdf)
        emit_id = add_emitter(inst.emitter)
        meshes = list(inst.meshes)
        if emit_id >= 0:
            meshes += _emissive_sphere_meshes(inst.spheres)
        else:
            spheres += [(sph, mat_id, emit_id) for sph in inst.spheres]
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
    # pad with LEAF_SIZE far-away rows: index-clamped gathers and the
    # cluster tiles' dummy slots (index n_tris) never leave the tables
    pad_fill = {"tri_v0": 1e30, "tri_emit": -1}
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
    }
    for k, (sd, m, e) in enumerate(spheres):
        sph["sph_center"][k] = sd.center
        sph["sph_radius"][k] = sd.radius
        sph["sph_mat"][k] = m
        sph["sph_emit"][k] = e
        sph["sph_flip"][k] = -1.0 if sd.flip_normals else 1.0

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
    }
    check_slice(meta)
    return ScenePack(_to_device(_with_derived(arrays, meta), device), meta)
