"""Shape plugins of the ported slice (port of mitsuba_tpu/scene/shapes.py):

* `rectangle`: the XY square spanning [-1,1]^2, normal +z
  (reference src/shapes/rectangle.cpp:99-110)
* `cube`: [-1,1]^3 with per-face normals (reference src/shapes/cube.cpp:24-30)
* `disk`: the unit disk in the XY plane as a fan of 64 triangles, normal
  +z (reference src/shapes/disk.cpp)
* `obj`, `ply`, `serialized`: triangle meshes from a file (reference
  src/shapes/obj.cpp, ply/*, serialized.cpp), with `faceNormals`; obj
  flips its v coordinate unless `flipTexCoords` is false, serialized
  reads mesh `shapeIndex`
* `heightfield`: the [-1,1]^2 grid displaced along z by the first channel
  of an image times `scale`, strided down to at most 257 x 257 texels and
  tessellated (reference src/shapes/heightfield.cpp intersects the grid
  directly)
* `shapegroup` / `instance`: a group of shapes and its placements
  (reference src/shapes/shapegroup.cpp, instance.cpp); the XML loader
  collects them and the builder expands them or builds the two-level
  accelerator (accel/tlas.py)
* `sphere`: `center` + `radius` and/or toWorld (reference
  src/shapes/sphere.cpp:73-110), kept analytic; a non-uniform scale
  tessellates it
* `cylinder`: p0 / p1 / radius, an analytic open cylinder (reference
  src/shapes/cylinder.cpp) unless `exact` is false or the transform
  scales unevenly, where it tessellates
* `hair`: fibers from a .hair file (scene/hair.py)
* `deformable`: per-vertex keyframes from nested shapes of one topology
  (reference src/shapes/deformable.cpp)

Every shape keeps its `toWorld` animation track (`<animation>`): its
geometry is keyframe 0, and the builder turns a track of two keyframes
or more into a relative motion (scene/builder.py).

Every shape plugin of the reference is registered.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.io.images import read_image
from mitsuba_tpu_torch.io.meshes import MeshData, load_obj, load_ply, load_serialized
from mitsuba_tpu_torch.scene.registry import register


@dataclass
class SphereData:
    center: np.ndarray  # [3]
    radius: float
    flip_normals: bool = False


@dataclass
class CylData:
    """A batch of analytic cylinder segments in world space, clipped by
    miter planes (reference src/shapes/hair.cpp intersect:485-542,
    src/shapes/cylinder.cpp): a point q of the side wall is kept where
    (q - p0) . n0 >= 0 and (q - p1) . n1 <= 0."""

    p0: np.ndarray  # [S, 3] segment starts
    p1: np.ndarray  # [S, 3] segment ends
    n0: np.ndarray  # [S, 3] the miter plane's normal at p0 (along the fiber)
    n1: np.ndarray  # [S, 3] the miter plane's normal at p1
    radius: np.ndarray  # [S]
    flip_normals: bool = False


@dataclass
class ShapeInstance:
    """A shape plugin's output: world-space meshes, analytic spheres and
    cylinder segments, and attachments."""

    meshes: list = field(default_factory=list)  # list[MeshData]
    spheres: list = field(default_factory=list)  # list[SphereData]
    cylinders: list = field(default_factory=list)  # list[CylData]
    bsdf = None  # set by the XML loader
    emitter = None
    interior_medium = None  # MediumRecord or None (vacuum)
    exterior_medium = None
    subsurface = None  # SubsurfaceRecord or None
    animation = None  # [(time, Transform), ...] rigid keyframes
    deform_frames = None  # [[MeshData, ...] per keyframe] (deformable)
    deform_times = None  # tuple of keyframe times
    id: str = ""


def _apply_transform(mesh: MeshData, t: Transform, flip: bool) -> MeshData:
    pos = t.transform_point_np(mesh.positions).astype(np.float32)
    nrm = mesh.normals
    if nrm is not None:
        nrm = t.transform_normal_np(nrm)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = (nrm / np.maximum(ln, 1e-20)).astype(np.float32)
    idx = mesh.indices
    # a mirroring transform flips triangle orientation; re-wind so the
    # geometric normal matches the transformed shading normal
    if t.det3() < 0.0:
        idx = idx[:, ::-1].copy()
    if flip:
        idx = idx[:, ::-1].copy()
        if nrm is not None:
            nrm = -nrm
    return MeshData(
        positions=pos,
        indices=np.ascontiguousarray(idx),
        normals=nrm,
        texcoords=mesh.texcoords,
        colors=mesh.colors,
        face_normals=mesh.face_normals,
        name=mesh.name,
    )


class _ShapeBase:
    def __init__(self, props):
        self.props = props
        self.instance = ShapeInstance(id=props.id)
        t = props.get_transform("toWorld")
        flip = props.get_bool("flipNormals", False)
        for mesh in self._meshes():
            self.instance.meshes.append(_apply_transform(mesh, t, flip))
        self.instance.animation = props.get_animation("toWorld")

    def _meshes(self) -> list[MeshData]:
        return [self._mesh()]

    def _mesh(self) -> MeshData:
        raise NotImplementedError


@register("shape", "rectangle")
class RectangleShape(_ShapeBase):
    def _mesh(self):
        pos = np.array(
            [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
        )
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
        idx = np.array([[0, 1, 2], [2, 3, 0]], np.uint32)
        return MeshData(pos, idx, nrm, uv)


@register("shape", "cube")
class CubeShape(_ShapeBase):
    def _mesh(self):
        # 24 vertices (4 per face) so each face has its own normal/uv
        face_defs = [
            (np.array([0, -1, 0]), np.array([1, 0, 0]), np.array([0, 0, -1])),
            (np.array([0, 1, 0]), np.array([-1, 0, 0]), np.array([0, 0, -1])),
            (np.array([1, 0, 0]), np.array([0, 1, 0]), np.array([0, 0, -1])),
            (np.array([-1, 0, 0]), np.array([0, -1, 0]), np.array([0, 0, -1])),
            (np.array([0, 0, 1]), np.array([1, 0, 0]), np.array([0, -1, 0])),
            (np.array([0, 0, -1]), np.array([-1, 0, 0]), np.array([0, -1, 0])),
        ]
        pos, nrm, uv, idx = [], [], [], []
        for n, u, v in face_defs:
            base = len(pos)
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                pos.append(n + a * u + b * v)
                nrm.append(n)
                uv.append([(a + 1) / 2, (b + 1) / 2])
            idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        return MeshData(
            np.asarray(pos, np.float32),
            np.asarray(idx, np.uint32),
            np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32),
        )


@register("shape", "disk")
class DiskShape(_ShapeBase):
    SEGMENTS = 64

    def _mesh(self):
        n = self.SEGMENTS
        ang = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
        rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(n)], axis=-1).astype(np.float32)
        pos = np.concatenate([np.zeros((1, 3), np.float32), rim])
        nrm = np.tile(np.array([[0, 0, 1]], np.float32), (n + 1, 1))
        uv = np.concatenate(
            [np.array([[0.5, 0.5]], np.float32), (rim[:, :2] + 1) / 2]
        ).astype(np.float32)
        idx = np.array([[0, 1 + i, 1 + (i + 1) % n] for i in range(n)], np.uint32)
        return MeshData(pos, idx, nrm, uv)


class _FileShape(_ShapeBase):
    """A mesh file's meshes; `faceNormals` drops the vertex normals."""

    def _meshes(self):
        meshes = self._load(self.props.resolve_path(self.props.get_string("filename")))
        if self.props.get_bool("faceNormals", False):
            for mesh in meshes:
                mesh.normals = None
                mesh.face_normals = True
        return meshes

    def _load(self, path) -> list[MeshData]:
        raise NotImplementedError


@register("shape", "obj")
class ObjShape(_FileShape):
    def _load(self, path):
        meshes = load_obj(path)
        if self.props.get_bool("flipTexCoords", True):
            for mesh in meshes:
                if mesh.texcoords is not None:
                    mesh.texcoords = np.stack(
                        [mesh.texcoords[:, 0], 1.0 - mesh.texcoords[:, 1]], axis=-1
                    )
        return meshes


@register("shape", "ply")
class PlyShape(_FileShape):
    def _load(self, path):
        return load_ply(path)


@register("shape", "serialized")
class SerializedShape(_FileShape):
    def _load(self, path):
        return load_serialized(path, self.props.get_int("shapeIndex", 0))


@register("shape", "heightfield")
class HeightfieldShape(_ShapeBase):
    MAX_RES = 257

    def _mesh(self):
        props = self.props
        if "filename" in props:
            img, _ = read_image(props.resolve_path(props.get_string("filename")))
            hmap = np.asarray(img[..., 0], np.float32)
        else:
            hmap = np.zeros((2, 2), np.float32)
        hr, wr = hmap.shape
        hmap = hmap[::max(1, hr // self.MAX_RES), ::max(1, wr // self.MAX_RES)]
        hr, wr = hmap.shape
        xs = np.linspace(-1, 1, wr)
        ys = np.linspace(-1, 1, hr)
        gx, gy = np.meshgrid(xs, ys)
        pos = np.stack([gx, gy, hmap * props.get_float("scale", 1.0)], -1).reshape(-1, 3)
        uv = np.stack([np.tile((xs + 1) / 2, hr), np.repeat((ys + 1) / 2, wr)], -1)
        # two triangles per cell, cells row by row
        a = (np.arange(hr - 1)[:, None] * wr + np.arange(wr - 1)[None]).reshape(-1)
        idx = np.stack([np.stack([a, a + 1, a + wr], -1),
                        np.stack([a + 1, a + wr + 1, a + wr], -1)], axis=1).reshape(-1, 3)
        return MeshData(pos.astype(np.float32), idx.astype(np.uint32), None,
                        uv.astype(np.float32))


@register("shape", "shapegroup")
class ShapeGroup(_ShapeBase):
    """A container of shapes that instances place (reference
    src/shapes/shapegroup.cpp); the XML loader fills `children`."""

    def _meshes(self):
        self.children = []
        return []


@register("shape", "instance")
class InstanceShape(_ShapeBase):
    """A placement of a shape group by `toWorld` (reference
    src/shapes/instance.cpp); the XML loader finds the group among its
    children."""

    def _meshes(self):
        self.to_world = self.props.get_transform("toWorld")
        return []


@register("shape", "sphere")
class SphereShape:
    def __init__(self, props):
        self.props = props
        self.instance = ShapeInstance(id=props.id)
        center = props.get_point("center", np.zeros(3))
        radius = props.get_float("radius", 1.0)
        t = props.get_transform("toWorld")
        flip = props.get_bool("flipNormals", False)
        # toWorld * translate(center) * scale(radius) (sphere.cpp:108-112
        # folds center and radius into the object transform); analytic
        # under a uniform scale only
        full = t * Transform.translate(*center) * Transform.scale(radius, radius, radius)
        scales = np.linalg.norm(full.m[:3, :3], axis=0)
        if np.allclose(scales, scales[0], rtol=1e-4):
            c = full.transform_point_np(np.zeros(3))
            self.instance.spheres.append(
                SphereData(center=np.asarray(c, np.float32), radius=float(scales[0]),
                           flip_normals=flip)
            )
        else:
            self.instance.meshes.append(_apply_transform(_uv_sphere(64, 32), full, flip))
        self.instance.animation = props.get_animation("toWorld")


def uniform_scale_of(t: Transform):
    """The uniform scale of t's linear part, or None where it scales
    unevenly (analytic cylinders survive similarity transforms only)."""
    lin = np.asarray(t.m, np.float64)[:3, :3]
    s = np.linalg.norm(lin, axis=0)
    if np.max(s) - np.min(s) > 1e-5 * max(np.max(s), 1e-12):
        return None
    return float(s.mean())


@register("shape", "cylinder")
class CylinderShape:
    SEGMENTS = 64

    def __init__(self, props):
        self.props = props
        self.instance = ShapeInstance(id=props.id)
        p0 = props.get_point("p0", np.array([0.0, 0.0, 0.0]))
        p1 = props.get_point("p1", np.array([0.0, 0.0, 1.0]))
        radius = props.get_float("radius", 1.0)
        t = props.get_transform("toWorld")
        flip = props.get_bool("flipNormals", False)
        scale = uniform_scale_of(t)
        self.instance.animation = props.get_animation("toWorld")
        if props.get_bool("exact", True) and scale is not None:
            # the analytic open cylinder (cylinder.cpp rayIntersect: the
            # infinite cylinder's quadratic and an axial clip, no caps);
            # the clip planes are the discs perpendicular to the axis
            q0 = t.transform_point_np(p0[None])[0]
            q1 = t.transform_point_np(p1[None])[0]
            ax = q1 - q0
            ln = float(np.linalg.norm(ax))
            if ln > 1e-9:
                ax = ax / ln
                self.instance.cylinders.append(CylData(
                    p0=q0[None].astype(np.float32), p1=q1[None].astype(np.float32),
                    n0=ax[None].astype(np.float32), n1=ax[None].astype(np.float32),
                    radius=np.asarray([radius * scale], np.float32), flip_normals=flip,
                ))
                return
        axis = p1 - p0
        z = axis / np.linalg.norm(axis)
        x = np.cross([0.0, 1.0, 0.0], z)
        if np.linalg.norm(x) < 1e-6:
            x = np.cross([1.0, 0.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        n = self.SEGMENTS
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        ring = np.cos(ang)[:, None] * x[None, :] + np.sin(ang)[:, None] * y[None, :]
        pos = np.concatenate(
            [p0[None] + radius * ring, p0[None] + axis[None] + radius * ring]
        ).astype(np.float32)
        nrm = np.concatenate([ring, ring]).astype(np.float32)
        uv = np.concatenate([
            np.stack([ang / (2 * np.pi), np.zeros(n)], -1),
            np.stack([ang / (2 * np.pi), np.ones(n)], -1),
        ]).astype(np.float32)
        idx = []
        for i in range(n):
            j = (i + 1) % n
            idx += [[i, n + i, n + j], [i, n + j, j]]
        mesh = MeshData(pos, np.asarray(idx, np.uint32), nrm, uv)
        self.instance.meshes.append(_apply_transform(mesh, t, flip))


def _uv_sphere(n_phi, n_theta) -> MeshData:
    """Unit UV sphere of (n_theta + 1) x (n_phi + 1) vertices with
    normals and uv (the reference's tessellation)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    ).reshape(-1, 3)
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], axis=-1).reshape(-1, 2)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * (n_phi + 1) + j
            b = a + n_phi + 1
            idx += [[a, b, a + 1], [a + 1, b, b + 1]]
    return MeshData(
        pos.astype(np.float32),
        np.asarray(idx, np.uint32),
        pos.astype(np.float32),
        uv.astype(np.float32),
    )


@register("shape", "deformable")
class DeformableShape:
    """Per-vertex keyframe animation (reference src/shapes/deformable.cpp,
    mitsuba_tpu/scene/shapes.py:378-423): the nested shapes are the
    keyframes, of one topology, at the `times` given (evenly spaced over
    [0, 1] when absent).  Its geometry and shading normals are keyframe
    0's; the intersector lerps each lane's rows between the keyframes of
    its time (accel/intersect.py)."""

    def __init__(self, props):
        self.props = props
        self.instance = ShapeInstance(id=props.id)
        frames = [child.instance.meshes for _, child in props.children
                  if getattr(child, "instance", None) is not None and child.instance.meshes]
        if len(frames) < 2:
            raise ValueError("deformable: needs >=2 nested keyframe shapes")
        times_str = props.get_string("times", "").strip()
        if times_str:
            times = [float(x) for x in re.split(r"[,;\s]+", times_str) if x]
        else:
            times = np.linspace(0.0, 1.0, len(frames)).tolist()
        if len(times) != len(frames):
            raise ValueError("deformable: times count must match keyframe count")
        if len({tuple(len(m.indices) for m in fs) for fs in frames}) != 1:
            raise ValueError("deformable: keyframes must share topology")
        self.instance.meshes = frames[0]
        self.instance.deform_frames = frames
        self.instance.deform_times = tuple(float(t) for t in times)
        self.instance.animation = props.get_animation("toWorld")
