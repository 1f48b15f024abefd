"""Piecewise-constant distributions for environment-map importance
sampling (port of mitsuba_tpu/core/distribution.py `build_alias` and
`Distribution2D`; reference src/emitters/envmap.cpp:103-229).

Tables are built on the host in numpy, as in the reference; `sample_2d`
and `pdf_2d` are plain tensor functions of a `Distribution2D`'s tables.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from mitsuba_tpu_torch import native


def _declare_alias(lib):
    fn = lib.mts_build_alias
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # weights
        ctypes.c_longlong,  # n
        ctypes.POINTER(ctypes.c_float),  # out prob
        ctypes.POINTER(ctypes.c_int32),  # out alias
    ]


def alias_library():
    """The compiled alias builder (csrc/host/alias_table.cpp), or None
    when no C++ compiler can build it."""
    return native.load_host("alias", "alias_table.cpp", _declare_alias)


def build_alias(weights):
    """Walker alias table: (prob [N] f32, alias [N] i32).  A draw picks
    i uniformly, keeps it with probability prob[i] and else takes
    alias[i]: one table row per draw for the density of the weights.
    The compiled O(n) Vose build of the reference's source, with the
    reference's pure-Python Vose as the fallback (its float64 sum may
    round otherwise, so the two can differ in a bin at 1.0)."""
    w = np.ascontiguousarray(np.maximum(np.asarray(weights, np.float64).ravel(), 0.0))
    n = w.size
    prob = np.empty(n, np.float32)
    alias = np.empty(n, np.int32)
    lib = alias_library()
    if lib is not None:
        lib.mts_build_alias(
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return prob, alias

    s = w.sum()
    p = (w * (n / s)) if s > 0 else np.ones(n, np.float64)
    alias[:] = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if p[i] < 1.0]
    large = [i for i in range(n) if p[i] >= 1.0]
    while small and large:
        si = small.pop()
        li = large.pop()
        prob[si] = p[si]
        alias[si] = li
        p[li] = (p[li] + p[si]) - 1.0
        (small if p[li] < 1.0 else large).append(li)
    for i in large + small:  # numerical leftovers
        prob[i] = 1.0
    return prob, alias


@dataclass
class Distribution2D:
    """Piecewise-constant 2D distribution over an [H, W] grid: a row from
    the marginal CDF, then a column from that row's conditional CDF."""

    marginal_cdf: np.ndarray  # [H+1] f32
    conditional_cdf: np.ndarray  # [H, W+1] f32
    density: np.ndarray  # [H, W] f32, mean over the grid 1

    @staticmethod
    def from_weights(weights) -> "Distribution2D":
        w = np.maximum(np.asarray(weights, np.float64), 0.0)
        h, wid = w.shape
        if w.sum() <= 0.0:
            w = np.ones_like(w)
        row_sums = w.sum(axis=1)
        marg_cdf = np.concatenate([[0.0], np.cumsum(row_sums / row_sums.sum())])
        marg_cdf[-1] = 1.0
        cond = w / np.maximum(row_sums[:, None], 1e-300)
        cond = np.where(row_sums[:, None] > 0, cond, 1.0 / wid)
        cond_cdf = np.concatenate([np.zeros((h, 1)), np.cumsum(cond, axis=1)], axis=1)
        cond_cdf[:, -1] = 1.0
        density = w / w.mean()  # pdf(u, v) on the unit square
        return Distribution2D(
            marg_cdf.astype(np.float32), cond_cdf.astype(np.float32),
            density.astype(np.float32),
        )


def sample_2d(marginal_cdf, conditional_cdf, density, u2):
    """u2 [..., 2] in [0,1)^2 -> (xy [..., 2] on the unit square, pdf
    there), by inverting the marginal, then the row's conditional CDF."""
    h, w = density.shape
    uy = u2[..., 1].contiguous()
    ux = u2[..., 0].contiguous()
    row = torch.clamp(torch.searchsorted(marginal_cdf, uy, right=True) - 1, 0, h - 1)
    lo = marginal_cdf[row]
    dv = torch.clamp(marginal_cdf[row + 1] - lo, min=1e-20)
    v = (row + torch.clamp((uy - lo) / dv, 0.0, 0.99999994)) / h
    cdf_row = conditional_cdf[row]  # [..., W+1]
    col = torch.searchsorted(cdf_row, ux[..., None], right=True)[..., 0] - 1
    col = torch.clamp(col, 0, w - 1)
    lo_c = torch.gather(cdf_row, -1, col[..., None])[..., 0]
    hi_c = torch.gather(cdf_row, -1, col[..., None] + 1)[..., 0]
    du = torch.clamp(hi_c - lo_c, min=1e-20)
    uu = (col + torch.clamp((ux - lo_c) / du, 0.0, 0.99999994)) / w
    pdf = density.reshape(-1)[row * w + col]
    return torch.stack([uu, v], dim=-1), pdf


def pdf_2d(density, xy):
    """The density at unit-square coordinates xy [..., 2]."""
    h, w = density.shape
    col = torch.clamp((xy[..., 0] * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((xy[..., 1] * h).to(torch.int64), 0, h - 1)
    return density.reshape(-1)[row * w + col]
