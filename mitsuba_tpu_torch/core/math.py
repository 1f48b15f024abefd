"""Vector math on trailing-dimension tensors (port of
mitsuba_tpu/core/math.py, the subset the path tracer uses).  A "vector"
is a tensor whose last axis has size 3."""

from __future__ import annotations

import torch

ONE_MINUS_EPS = 0.99999994  # largest float32 < 1


def dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdim=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-30))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def sign(x):
    """Sign that never returns 0 (1 for x >= 0)."""
    return torch.where(x >= 0.0, 1.0, -1.0)


def coordinate_system(n):
    """Orthonormal (s, t) around unit normal n (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = sign(nz)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t1, t2


class Frame:
    """Shading frame (s, t, n), each [..., 3]; local z = normal."""

    def __init__(self, s, t, n):
        self.s, self.t, self.n = s, t, n

    @staticmethod
    def from_normal(n):
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v):
        return torch.stack(
            [dot(v, self.s), dot(v, self.t), dot(v, self.n)], dim=-1
        )

    def to_world(self, v):
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )


def cos_theta(w):
    return w[..., 2]
