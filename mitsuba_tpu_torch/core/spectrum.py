"""Colour helpers (port of mitsuba_tpu/core/spectrum.py): the host numpy
part the scene loader calls (the sRGB curve, blackbody and tabulated
spectra to linear RGB), the CIE conversion matrices of spectral mode, and
`luminance`, the Metropolis chains' target."""

from __future__ import annotations

import numpy as np
import torch

# CIE conversion matrices for linear sRGB / Rec.709 primaries, D65
# (reference: src/libcore/spectrum.cpp toLinearRGB/fromLinearRGB).
_RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)


def rgb_to_xyz(rgb):
    """[..., 3] float32 tensor, linear RGB -> CIE XYZ."""
    return rgb @ torch.as_tensor(_RGB_TO_XYZ.T, device=rgb.device)


def xyz_to_rgb(xyz):
    return xyz @ torch.as_tensor(_XYZ_TO_RGB.T, device=xyz.device)


def srgb_degamma(srgb):
    """sRGB transfer curve -> linear, float32 numpy."""
    srgb = np.maximum(np.asarray(srgb, np.float32), np.float32(0.0))
    return np.where(
        srgb <= np.float32(0.04045),
        srgb / np.float32(12.92),
        np.power((srgb + np.float32(0.055)) / np.float32(1.055), np.float32(2.4)),
    ).astype(np.float32)


def luminance(rgb):
    """Y of linear RGB (reference spectrum.h getLuminance); rgb [..., 3]."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def blackbody_rgb(temperature_k):
    """Normalized linear-RGB tint of a Planck blackbody emitter.

    Host-side helper for <blackbody> spectrum properties
    (reference: include/mitsuba/core/spectrum.h BlackBodySpectrum:203).
    Integrates Planck's law against CIE 1931 curves sampled at 10nm via
    analytic Gaussian fits (Wyman et al. 2013), adequate for RGB mode.
    """
    t = float(temperature_k)
    lam = np.arange(380.0, 731.0, 5.0)  # nm

    def planck(lam_nm):
        lam_m = lam_nm * 1e-9
        h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
        return (2.0 * h * c * c) / (
            lam_m**5 * (np.exp(h * c / (lam_m * kb * t)) - 1.0)
        )

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    xbar = (
        1.056 * g(lam, 599.8, 37.9, 31.0)
        + 0.362 * g(lam, 442.0, 16.0, 26.7)
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    )
    ybar = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    zbar = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)

    le = planck(lam)
    xyz = np.array(
        [np.trapezoid(le * xbar, lam), np.trapezoid(le * ybar, lam),
         np.trapezoid(le * zbar, lam)]
    )
    rgb = _XYZ_TO_RGB.astype(np.float64) @ xyz
    rgb = np.maximum(rgb, 0.0)
    # scale so that luminance matches the raw Planck-integrated Y in
    # renderer units (W/(m^2 sr nm) integrated); keep relative scale only
    return rgb.astype(np.float32)


def interpolated_spectrum_to_rgb(wavelengths, values):
    """Convert a tabulated spectrum (e.g. .spd file) to linear RGB.

    reference: include/mitsuba/core/spectrum.h InterpolatedSpectrum:92 +
    Spectrum::fromContinuousSpectrum in RGB mode.
    """
    lam = np.arange(380.0, 731.0, 5.0)
    vals = np.interp(lam, wavelengths, values, left=0.0, right=0.0)

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    xbar = (
        1.056 * g(lam, 599.8, 37.9, 31.0)
        + 0.362 * g(lam, 442.0, 16.0, 26.7)
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    )
    ybar = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(lam, 530.9, 16.3, 31.1)
    zbar = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(lam, 459.0, 26.0, 13.8)
    norm = np.trapezoid(ybar, lam)
    xyz = np.array(
        [
            np.trapezoid(vals * xbar, lam) / norm,
            np.trapezoid(vals * ybar, lam) / norm,
            np.trapezoid(vals * zbar, lam) / norm,
        ]
    )
    rgb = _XYZ_TO_RGB.astype(np.float64) @ xyz
    return rgb.astype(np.float32)
