"""Colour helpers the scene loader calls (host numpy part of
mitsuba_tpu/core/spectrum.py).  The port renders linear RGB; tabulated
spectra and blackbody emitters are not ported yet."""

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
