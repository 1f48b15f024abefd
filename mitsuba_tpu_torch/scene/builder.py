"""Scene packing: host scene description -> flat device tensors
(`ScenePack`); the port of mitsuba_tpu/scene/builder.py for the slice it
renders: triangle meshes of at most 512 triangles, diffuse materials
with constant reflectance, and area emitters.

Array names, dtypes, shapes and meta keys are the reference's, so a
reference pack converted with `pack_from_numpy` and the port's own pack
of the same scene are interchangeable.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch.accel.pallas_kernels import pack_triangles_sublane
from mitsuba_tpu_torch.bsdf.plugins import DIFFUSE, BSDFRecord
from mitsuba_tpu_torch.emitter.plugins import AREA

# scenes above this many triangles need the BVH (not ported yet)
BRUTE_FORCE_MAX_TRIS = 512
# rows of padding after the triangle tables (the reference's BVH leaf
# size, mitsuba_tpu/accel/bvh.py LEAF_SIZE default)
LEAF_SIZE = 8

# the arrays and meta keys the ported slice reads
SLICE_ARRAYS = (
    "tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
    "tri_uv0", "tri_uv1", "tri_uv2", "tri_mat", "tri_emit", "tri_s",
    "mat_type", "mat_cA", "mat_twosided",
    "em_kind", "em_rgb", "em_area", "em_tri_lo", "em_tri_hi",
    "area_tri_idx", "area_tri_cdf", "emitter_pmf", "emitter_cdf",
)
SLICE_META = (
    "n_spheres", "n_emitters", "present_types", "emitter_kinds", "use_bvh",
    "has_area", "has_env",
)
# meta flags of reference features the port does not render yet:
# (key, value meaning "absent", feature name)
_UNPORTED_FEATURES = (
    ("use_bvh", False, "BVH traversal (scenes above 512 triangles)"),
    ("n_spheres", 0, "analytic spheres"),
    ("n_cyls", 0, "analytic cylinders"),
    ("has_env", False, "environment emitters"),
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
    if kinds - {AREA}:
        raise NotImplementedError(
            f"emitter kinds {sorted(kinds - {AREA})} not yet ported"
        )


def _to_device(arrays: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in arrays.items()}


def pack_from_numpy(arrays: dict, meta: dict, device) -> ScenePack:
    """Turn a reference pack ({name: numpy array} plus its meta) into the
    port's pack on `device`.  Raises NotImplementedError when the scene
    needs features the port does not render yet."""
    check_slice(meta)
    return ScenePack(_to_device(arrays, device), dict(meta))


def pack_scene(scene, device) -> ScenePack:
    """scene: SceneDescription from the XML loader."""
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
    if n_tris > BRUTE_FORCE_MAX_TRIS:
        raise NotImplementedError(
            f"BVH traversal (scenes above {BRUTE_FORCE_MAX_TRIS} triangles, "
            f"this one has {n_tris}) not yet ported"
        )
    tri_s = pack_triangles_sublane(
        tri["tri_v0"], tri["tri_e1"], tri["tri_e2"], n_tris
    )
    tri_area = 0.5 * np.linalg.norm(
        np.cross(tri["tri_e1"], tri["tri_e2"]), axis=-1
    )
    tri_emit = tri["tri_emit"]
    # pad so index-clamped gathers never leave the tables
    pad_fill = {"tri_v0": 1e30, "tri_emit": -1}
    for k, a in tri.items():
        pad = np.full((LEAF_SIZE,) + a.shape[1:], pad_fill.get(k, 0), a.dtype)
        tri[k] = np.concatenate([a, pad])

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
    weights = np.zeros(n_em, np.float64)
    for i, rec in enumerate(emitters):
        if rec.kind != AREA:
            raise NotImplementedError(f"emitter kind {rec.kind} not yet ported")
        em["em_kind"][i] = rec.kind
        em["em_rgb"][i] = rec.radiance
        ids = np.nonzero(tri_emit == i)[0]
        areas = tri_area[ids]
        total = float(areas.sum())
        em["em_area"][i] = max(total, 1e-12)
        em["em_tri_lo"][i] = at_cursor
        em["em_tri_hi"][i] = at_cursor + len(ids)
        at_cursor += len(ids)
        idx_parts.append(ids.astype(np.int32))
        cdf_parts.append((np.cumsum(areas) / max(total, 1e-12)).astype(np.float32))
        weights[i] = rec.sampling_weight
    if not emitters:
        weights = np.ones(1)
    pmf = weights / weights.sum() if weights.sum() > 0 else weights
    emitter_cdf = np.concatenate([[0.0], np.cumsum(pmf)]).astype(np.float32)
    emitter_cdf[-1] = 1.0

    arrays = {
        **tri,
        "tri_s": tri_s,
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
        "use_bvh": False,
        "has_area": any(r.kind == AREA for r in emitters),
        "has_env": False,
    }
    return ScenePack(_to_device(arrays, device), meta)
