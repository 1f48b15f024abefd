"""The `hair` shape (port of mitsuba_tpu/scene/hair.py; reference
src/shapes/hair.{h,cpp}): fiber curves from a .hair file, as miter-clipped
analytic cylinder segments (`exact`) or tessellated into k-gon tubes with
end caps, radial smooth normals and a per-fiber uv (u = arc length, v =
azimuth), so that they ride the triangle kernels.  File formats: the
reference's ascii (x y z per line, a blank line starts a new fiber) and
BINARY_HAIR little-endian (hair.cpp:85-99, 630-700), with the tangent
merge of nearly collinear segments (angleThreshold) and `reduction`'s
seeded fiber dropping.  All of it is numpy in float64, as in the
reference, so the meshes and segment tables are the reference's bit for
bit.
"""

from __future__ import annotations

import struct

import numpy as np

from mitsuba_tpu_torch.io.meshes import MeshData
from mitsuba_tpu_torch.scene.registry import register
from mitsuba_tpu_torch.scene.shapes import (
    CylData,
    ShapeInstance,
    _apply_transform,
    uniform_scale_of,
)


def load_hair(path, angle_threshold_deg=1.0, reduction=0.0, seed=0):
    """Parse a mitsuba .hair file -> list of [P_i, 3] float32 fibers."""
    dp_thresh = float(np.cos(np.radians(angle_threshold_deg)))
    rng = np.random.default_rng(seed)
    with open(path, "rb") as f:
        blob = f.read()

    fibers = []
    cur = []
    tangent = None

    def push_point(p, new_fiber):
        nonlocal cur, tangent
        if new_fiber:
            if len(cur) >= 2:
                fibers.append(np.asarray(cur, np.float32))
            cur = [p]
            tangent = None
            return
        if not cur:
            cur = [p]
            return
        last = cur[-1]
        d = np.asarray(p) - np.asarray(last)
        n = np.linalg.norm(d)
        if n < 1e-12:
            return  # degenerate
        nt = d / n
        if tangent is None:
            cur.append(p)
            tangent = nt
        elif float(np.dot(nt, tangent)) > dp_thresh:
            # merge nearly-collinear segments (hair.cpp dpThresh)
            cur[-1] = p
        else:
            cur.append(p)
            tangent = nt

    if blob[:11] == b"BINARY_HAIR":
        (n_verts,) = struct.unpack_from("<I", blob, 11)
        data = np.frombuffer(blob, np.dtype("<f4"), offset=15)
        i = 0
        read = 0
        new_fiber = True
        ignore = False
        while read < n_verts and i + 2 < len(data):
            if np.isinf(data[i]):
                i += 1
                new_fiber = True
                if reduction > 0:
                    ignore = rng.uniform() < reduction
            p = data[i : i + 3].astype(np.float64)
            i += 3
            read += 1
            if not ignore:
                push_point(p, new_fiber)
            new_fiber = False
    else:
        new_fiber = True
        ignore = False
        for line in blob.decode("utf-8", "replace").splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                new_fiber = True
                if reduction > 0:
                    ignore = rng.uniform() < reduction
                continue
            parts = line.split()
            if len(parts) < 3:
                continue
            p = np.array([float(x) for x in parts[:3]])
            if not ignore:
                push_point(p, new_fiber)
            new_fiber = False
    if len(cur) >= 2:
        fibers.append(np.asarray(cur, np.float32))
    return fibers


def _fiber_frames(pts):
    """Per-vertex (tangent, normal, binormal) with parallel transport
    (rotation-minimizing frames keep the tube from twisting)."""
    n = len(pts)
    seg = pts[1:] - pts[:-1]
    seg_t = seg / np.maximum(
        np.linalg.norm(seg, axis=-1, keepdims=True), 1e-12
    )
    # miter tangents at interior vertices (hair.cpp miter joints)
    t = np.empty((n, 3))
    t[0] = seg_t[0]
    t[-1] = seg_t[-1]
    if n > 2:
        m = seg_t[:-1] + seg_t[1:]
        ml = np.linalg.norm(m, axis=-1, keepdims=True)
        t[1:-1] = np.where(ml > 1e-8, m / np.maximum(ml, 1e-12), seg_t[:-1])
    # initial normal: anything orthogonal to t[0]
    a = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(a, t[0])) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    nrm = np.empty((n, 3))
    nrm[0] = np.cross(t[0], a)
    nrm[0] /= max(np.linalg.norm(nrm[0]), 1e-12)
    for i in range(1, n):
        # transport previous normal across the tangent change
        v = nrm[i - 1] - t[i] * np.dot(nrm[i - 1], t[i])
        ln = np.linalg.norm(v)
        if ln < 1e-8:
            v = np.cross(t[i], a)
            ln = max(np.linalg.norm(v), 1e-12)
        nrm[i] = v / ln
    binrm = np.cross(t, nrm)
    return t, nrm, binrm


def tessellate_fibers(fibers, radius, sides=4):
    """Fibers -> one MeshData tube mesh with radial smooth normals."""
    pos_l, nrm_l, uv_l, idx_l = [], [], [], []
    base = 0
    ang = 2.0 * np.pi * np.arange(sides) / sides
    ca, sa = np.cos(ang), np.sin(ang)
    for pts in fibers:
        n = len(pts)
        t, nr, bn = _fiber_frames(pts)
        # ring vertices: [n, sides, 3]
        ring_n = (
            nr[:, None, :] * ca[None, :, None]
            + bn[:, None, :] * sa[None, :, None]
        )
        ring_p = pts[:, None, :] + radius * ring_n
        arc = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(pts[1:] - pts[:-1], axis=-1))]
        )
        uv = np.stack(
            [
                np.broadcast_to(arc[:, None], (n, sides)),
                np.broadcast_to(ang[None, :] / (2 * np.pi), (n, sides)),
            ],
            axis=-1,
        )
        pos_l.append(ring_p.reshape(-1, 3))
        nrm_l.append(ring_n.reshape(-1, 3))
        uv_l.append(uv.reshape(-1, 2))
        for i in range(n - 1):
            r0 = base + i * sides
            r1 = r0 + sides
            for k in range(sides):
                k2 = (k + 1) % sides
                idx_l.append([r0 + k, r1 + k, r1 + k2])
                idx_l.append([r0 + k, r1 + k2, r0 + k2])
        base += n * sides
        # end caps: open tube mouths read as black pinholes (the ray
        # hits the inside wall, where the radial shading normal faces
        # away) — the reference's hair primitive is a closed cylinder
        # (hair.cpp:446).  Rim vertices are duplicated so cap shading
        # normals are the +/- tangent, not the tube's radial normal.
        for end, sgn in ((0, -1.0), (n - 1, 1.0)):
            cap_n = sgn * t[end]
            ctr = base
            pos_l.append(
                np.concatenate([pts[end][None], ring_p[end]], axis=0)
            )
            nrm_l.append(np.broadcast_to(cap_n, (sides + 1, 3)).copy())
            uv_l.append(
                np.broadcast_to(uv[end, 0], (sides + 1, 2)).copy()
            )
            for k in range(sides):
                k2 = (k + 1) % sides
                tri = [ctr, ctr + 1 + k2, ctr + 1 + k]
                idx_l.append(tri if sgn < 0 else tri[::-1])
            base += sides + 1
    return MeshData(
        np.concatenate(pos_l).astype(np.float32),
        np.asarray(idx_l, np.uint32),
        np.concatenate(nrm_l).astype(np.float32),
        np.concatenate(uv_l).astype(np.float32),
    )


def fibers_to_segments(fibers, radius):
    """Fibers -> CylData segment batch with miter-plane joint normals
    (= HairKDTree's firstMiterNormal/secondMiterNormal, the averaged
    adjacent tangents; reference src/shapes/hair.cpp:560-575)."""
    p0_l, p1_l, n0_l, n1_l = [], [], [], []
    for pts in fibers:
        t, _, _ = _fiber_frames(pts)  # t: miter tangents per vertex
        p0_l.append(pts[:-1])
        p1_l.append(pts[1:])
        n0_l.append(t[:-1])
        n1_l.append(t[1:])
    p0 = np.concatenate(p0_l).astype(np.float32)
    return CylData(
        p0=p0,
        p1=np.concatenate(p1_l).astype(np.float32),
        n0=np.concatenate(n0_l).astype(np.float32),
        n1=np.concatenate(n1_l).astype(np.float32),
        radius=np.full((len(p0),), radius, np.float32),
    )


@register("shape", "hair")
class HairShape:
    """reference: src/shapes/hair.cpp.  `exact` true intersects the
    miter-clipped cylinder segments as the reference's HairKDTree does
    (hair.cpp:485-542; under a uniform scale only); the default
    tessellates `sides`-gon tubes."""

    def __init__(self, props):
        self.props = props
        self.instance = ShapeInstance(id=props.id)
        t = props.get_transform("toWorld")
        flip = props.get_bool("flipNormals", False)
        path = props.resolve_path(props.get_string("filename"))
        radius = props.get_float("radius", 0.025)
        fibers = load_hair(path, props.get_float("angleThreshold", 1.0),
                           props.get_float("reduction", 0.0))
        if not fibers:
            raise ValueError(f"hair: no fibers in {path}")
        scale = uniform_scale_of(t)
        if props.get_bool("exact", False) and scale is not None:
            cyl = fibers_to_segments(fibers, radius)
            cyl.p0 = t.transform_point_np(cyl.p0).astype(np.float32)
            cyl.p1 = t.transform_point_np(cyl.p1).astype(np.float32)
            lin = np.asarray(t.m, np.float64)[:3, :3]
            for attr in ("n0", "n1"):
                v = getattr(cyl, attr) @ lin.T
                v /= np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
                setattr(cyl, attr, v.astype(np.float32))
            cyl.radius = (cyl.radius * scale).astype(np.float32)
            cyl.flip_normals = flip
            self.instance.cylinders.append(cyl)
            return
        mesh = tessellate_fibers(fibers, radius, props.get_int("sides", 4))
        self.instance.meshes.append(_apply_transform(mesh, t, flip))
