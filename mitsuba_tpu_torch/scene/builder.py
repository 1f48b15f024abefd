"""Scene packing: host scene description -> flat device tensors
(`ScenePack`); the port of mitsuba_tpu/scene/builder.py for the slice it
renders: triangle meshes (brute force up to 512 triangles, BVH + cluster
tables above), diffuse materials with constant reflectance, area
emitters and a constant environment.

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
from mitsuba_tpu_torch.bsdf.plugins import DIFFUSE, BSDFRecord
from mitsuba_tpu_torch.emitter.eval import PORTED_KINDS
from mitsuba_tpu_torch.emitter.plugins import AREA, CONSTANT

# scenes above this many triangles go through the BVH and cluster tables
BRUTE_FORCE_MAX_TRIS = 512

# the arrays and meta keys the ported slice reads
SLICE_ARRAYS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_emit", "tri_s", "tri_t",
    "mat_type", "mat_cA", "mat_twosided",
    "em_kind", "em_rgb", "em_area", "em_tri_lo", "em_tri_hi",
    "area_tri_idx", "area_tri_cdf", "emitter_pmf", "emitter_cdf",
)
SLICE_META = (
    "n_spheres", "n_emitters", "present_types", "emitter_kinds", "use_bvh",
    "has_area", "has_env", "has_envmap", "env_idx",
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
    ("n_spheres", 0, "analytic spheres"),
    ("n_cyls", 0, "analytic cylinders"),
    ("has_envmap", False, "envmap emitters"),
    ("has_media", False, "participating media"),
    ("has_sss", False, "subsurface scattering"),
    ("has_textures", False, "textures"),
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
    if types != {DIFFUSE}:
        raise NotImplementedError(
            f"bsdf types {sorted(types - {DIFFUSE})} not yet ported"
        )
    kinds = set(meta.get("emitter_kinds", ()))
    if kinds - PORTED_KINDS:
        raise NotImplementedError(
            f"emitter kinds {sorted(kinds - PORTED_KINDS)} not yet ported"
        )
    if meta.get("use_bvh", False):
        _check_clusters(meta)


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


def _with_cl_cnt(arrays: dict, meta: dict) -> dict:
    """arrays, plus cl_cnt (cluster_columns; not in the reference's pack)
    where the pack has cluster tables."""
    if "cl_tri" not in arrays:
        return arrays
    return {**arrays, "cl_cnt": cluster_columns(arrays["cl_tri"], meta["cluster_tc"])}


def pack_from_numpy(arrays: dict, meta: dict, device) -> ScenePack:
    """Turn a reference pack ({name: numpy array} plus its meta) into the
    port's pack on `device`, with the port's cl_cnt.  Raises
    NotImplementedError when the scene needs features the port does not
    render yet."""
    check_slice(meta)
    return ScenePack(_to_device(_with_cl_cnt(arrays, meta), device), dict(meta))


def pack_scene(scene, device="cuda") -> ScenePack:
    """scene: SceneDescription from the XML loader; the pack lies on
    `device` (the card unless the caller asks for another)."""
    materials: list[BSDFRecord] = []
    mat_index: dict[int, int] = {}
    default_bsdf = BSDFRecord(type=DIFFUSE)

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
    for inst in scene.shapes:
        mat_id = add_material(inst.bsdf)
        emit_id = add_emitter(inst.emitter)
        for mesh in inst.meshes:
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

    # ---------------- material table ----------------
    n_mat = max(len(materials), 1)
    mt = {
        "mat_type": np.zeros(n_mat, np.int32),
        "mat_cA": np.full((n_mat, 3), 0.5, np.float32),
        "mat_twosided": np.zeros(n_mat, np.float32),
    }
    present_types = set()
    for i, rec in enumerate(materials):
        present_types.add(rec.type)
        mt["mat_type"][i] = rec.type
        mt["mat_cA"][i] = rec.cA
        mt["mat_twosided"][i] = float(rec.twosided)

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
        if rec.kind == CONSTANT:
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

    arrays = {
        **tri,
        "tri_s": tri_s,
        "tri_t": tri_t,
        **bvh_arrays,
        **mt,
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
    }
    meta = {
        "n_spheres": 0,
        "n_emitters": len(emitters),
        "present_types": tuple(sorted(present_types)) or (DIFFUSE,),
        "emitter_kinds": tuple(sorted({r.kind for r in emitters})),
        "use_bvh": use_bvh,
        **bvh_meta,
        "has_area": any(r.kind == AREA for r in emitters),
        "env_idx": env_idx,
        "has_env": env_idx >= 0,
        "has_envmap": False,
    }
    check_slice(meta)
    return ScenePack(_to_device(_with_cl_cnt(arrays, meta), device), meta)
