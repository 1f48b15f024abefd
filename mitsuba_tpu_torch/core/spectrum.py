"""Colour helpers (port of mitsuba_tpu/core/spectrum.py): the host numpy
part the scene loader calls, and `luminance`, the Metropolis chains'
target.  The port renders linear RGB; tabulated spectra and blackbody
emitters are not ported yet."""

from __future__ import annotations

import numpy as np


def srgb_degamma(srgb):
    """sRGB transfer curve -> linear, float32 numpy."""
    srgb = np.maximum(np.asarray(srgb, np.float32), np.float32(0.0))
    return np.where(
        srgb <= np.float32(0.04045),
        srgb / np.float32(12.92),
        np.power((srgb + np.float32(0.055)) / np.float32(1.055), np.float32(2.4)),
    ).astype(np.float32)


def blackbody_rgb(temperature_k):
    raise NotImplementedError("spectrum 'blackbody' not yet ported")


def interpolated_spectrum_to_rgb(wavelengths, values):
    raise NotImplementedError("tabulated spectra not yet ported")


def luminance(rgb):
    """Y of linear RGB (reference spectrum.h getLuminance); rgb [..., 3]."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169
