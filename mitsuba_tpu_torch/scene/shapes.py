"""Shape plugins of the ported slice (port of mitsuba_tpu/scene/shapes.py):

* `rectangle`: the XY square spanning [-1,1]^2, normal +z
  (reference src/shapes/rectangle.cpp:99-110)
* `cube`: [-1,1]^3 with per-face normals (reference src/shapes/cube.cpp:24-30)

Other shape plugins are not registered and raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mitsuba_tpu_torch.core.transform import Transform
from mitsuba_tpu_torch.io.meshes import MeshData
from mitsuba_tpu_torch.scene.registry import register


@dataclass
class ShapeInstance:
    """A shape plugin's output: world-space meshes + attachments."""

    meshes: list = field(default_factory=list)  # list[MeshData]
    bsdf = None  # set by the XML loader
    emitter = None
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
        face_normals=mesh.face_normals,
        name=mesh.name,
    )


class _ShapeBase:
    def __init__(self, props):
        self.props = props
        self.instance = ShapeInstance(id=props.id)
        mesh = self._mesh()
        t = props.get_transform("toWorld")
        flip = props.get_bool("flipNormals", False)
        self.instance.meshes.append(_apply_transform(mesh, t, flip))

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
