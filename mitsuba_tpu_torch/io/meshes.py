"""Triangle mesh container (the `MeshData` of mitsuba_tpu/io/meshes.py;
the OBJ/PLY/serialized readers are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class MeshData:
    positions: np.ndarray  # [V, 3] float32
    indices: np.ndarray  # [T, 3] uint32
    normals: np.ndarray | None = None  # [V, 3]
    texcoords: np.ndarray | None = None  # [V, 2]
    face_normals: bool = False
    name: str = ""
