"""4x4 affine transforms (port of mitsuba_tpu/core/transform.py).

Host-side construction in numpy float64 at scene-load time, and device
application helpers on tensors with a trailing dimension of 3.
"""

from __future__ import annotations

import numpy as np


class Transform:
    """Matrix + inverse pair (reference transform.h:39 stores both)."""

    def __init__(self, m, inv=None):
        self.m = np.asarray(m, np.float64).reshape(4, 4)
        self.inv = (
            np.linalg.inv(self.m) if inv is None else np.asarray(inv, np.float64)
        )

    @staticmethod
    def identity():
        return Transform(np.eye(4))

    @staticmethod
    def translate(x, y, z):
        m = np.eye(4)
        m[:3, 3] = [x, y, z]
        return Transform(m)

    @staticmethod
    def scale(x, y, z):
        return Transform(np.diag([x, y, z, 1.0]))

    @staticmethod
    def rotate(axis, angle_deg):
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        a = np.deg2rad(angle_deg)
        c, s = np.cos(a), np.sin(a)
        x, y, z = axis
        r = np.array(
            [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
            ]
        )
        m = np.eye(4)
        m[:3, :3] = r
        return Transform(m)

    @staticmethod
    def look_at(origin, target, up):
        """Camera-to-world: +z looks at target, +y is up, +x is left
        (the reference's Transform::lookAt)."""
        origin = np.asarray(origin, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        d = target - origin
        d = d / np.linalg.norm(d)
        left = np.cross(up / np.linalg.norm(up), d)
        n = np.linalg.norm(left)
        if n < 1e-9:
            raise ValueError("lookAt: up and view direction are collinear")
        left /= n
        new_up = np.cross(d, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = d
        m[:3, 3] = origin
        return Transform(m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.inv @ self.inv)

    def inverse(self) -> "Transform":
        return Transform(self.inv, self.m)

    def transform_point_np(self, p):
        p = np.asarray(p, np.float64)
        r = p @ self.m[:3, :3].T + self.m[:3, 3]
        w = p @ self.m[3, :3].T + self.m[3, 3]
        return r / w[..., None] if np.ndim(w) else r / w

    def transform_vector_np(self, v):
        return np.asarray(v, np.float64) @ self.m[:3, :3].T

    def transform_normal_np(self, n):
        return np.asarray(n, np.float64) @ self.inv[:3, :3]

    def det3(self):
        return float(np.linalg.det(self.m[:3, :3]))


def transform_point_affine(m, p):
    """m: [4,4] float32 tensor with last row (0,0,0,1); p: [..., 3]."""
    return p @ m[:3, :3].T + m[:3, 3]


def transform_vector(m, v):
    return v @ m[:3, :3].T
