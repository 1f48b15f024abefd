"""N-bin spectral rendering support (port of mitsuba_tpu/core/spectral.py,
the same host numpy code, so that its tables are bit-equal).

The reference selects SPECTRUM_SAMPLES at compile time and renders with
N wavelength bins over 360-830nm (include/mitsuba/core/spectrum.h:63-75,
SPECTRUM_MIN_WAVELENGTH/SPECTRUM_MAX_WAVELENGTH); RGB scene inputs are
upsampled to smooth spectra (spectrum.cpp Spectrum::fromLinearRGB, after
Smits 1999) and the film converts bins back through the CIE 1931
observer (spectrum.cpp toXYZ).

The design keeps every kernel 3-channel: N bins render as N/3
*bin-group passes* over the unmodified RGB machinery.  Each pass
re-packs the scene's spectral leaves so channel c of pass g carries bin
3g+c, renders as usual, and the developed pass images are projected to
CIE XYZ with the binned matching functions and summed; a final XYZ->RGB
matrix produces the output.

RGB->spectrum upsampling follows Smits' decomposition: seven smooth
basis spectra (white/cyan/magenta/yellow/red/green/blue) built here by
least-squares correction of smooth seeds so their RGB projections hit
the corners of the RGB cube *exactly*.  The white basis is (near-)flat,
so neutral grays stay neutral under repeated spectral multiplication,
and `project(upsample(rgb)) == rgb` holds for every rgb >= 0 - in
3-bin mode the spectral pipeline degenerates to RGB mode exactly.

Wavelength-dependent refraction (dispersion) uses one representative
wavelength per pass (the group's middle bin), the hero-wavelength
approximation, via the Cauchy model in `cauchy_eta`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mitsuba_tpu_torch.core.spectrum import _RGB_TO_XYZ, _XYZ_TO_RGB

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0

# Fine quadrature grid for building binned CIE integrals.
_FINE = np.arange(LAMBDA_MIN, LAMBDA_MAX + 1e-3, 1.0)


def _cie_fine():
    """CIE 1931 matching functions on the fine grid (Wyman et al. 2013
    multi-Gaussian fits, same fit the rest of core/spectrum.py uses)."""
    lam = _FINE

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    xbar = (
        1.056 * g(lam, 599.8, 37.9, 31.0)
        + 0.362 * g(lam, 442.0, 16.0, 26.7)
        - 0.065 * g(lam, 501.1, 20.4, 26.2)
    )
    ybar = 0.821 * g(lam, 568.8, 46.9, 40.5) + 0.286 * g(
        lam, 530.9, 16.3, 31.1
    )
    zbar = 1.217 * g(lam, 437.0, 11.8, 36.0) + 0.681 * g(
        lam, 459.0, 26.0, 13.8
    )
    return np.stack([xbar, ybar, zbar], axis=0)  # [3, F]


# CIE standard illuminant D65 relative SPD, 10nm steps 380-780nm
# (standard colorimetric data; Rec.709's white point).  Illuminant
# spectra are D65-shaped times an upsampled reflectance, and the
# reflectance basis is corrected against the D65-weighted projection —
# so emission projects back to its RGB exactly AND neutral reflectances
# stay neutral under it (the pbrt-3/Smits split of illuminant vs
# reflectance upsampling; reference spectrum.cpp fromLinearRGB uses the
# same reflectance/illuminant distinction via its rgbRefl/rgbIllum
# tables).
_D65_10NM = np.array([
    49.98, 54.65, 82.75, 91.49, 93.43, 86.68, 104.86, 117.01, 117.81,
    114.86, 115.92, 108.81, 109.35, 107.80, 104.79, 107.69, 104.41,
    104.05, 100.00, 96.33, 95.79, 88.69, 90.01, 89.60, 87.70, 83.29,
    83.70, 80.03, 80.21, 82.28, 78.28, 69.72, 71.61, 74.35, 61.60,
    69.89, 75.09, 63.59, 46.42, 66.81, 63.38,
])
_D65_LAM = np.arange(380.0, 781.0, 10.0)

# Smits basis row order + their exact RGB projection targets.
_TARGETS = np.array(
    [
        [1.0, 1.0, 1.0],  # white
        [0.0, 1.0, 1.0],  # cyan
        [1.0, 0.0, 1.0],  # magenta
        [1.0, 1.0, 0.0],  # yellow
        [1.0, 0.0, 0.0],  # red
        [0.0, 1.0, 0.0],  # green
        [0.0, 0.0, 1.0],  # blue
    ]
)


@dataclass(frozen=True)
class SpectralBins:
    """Layout + conversion matrices for an N-bin spectral render.

    n:        number of bins (multiple of 3; 3 bins per render pass)
    edges:    [n+1] bin edges in nm (uniform over 360-830)
    centers:  [n] bin centers in nm (per-channel wavelength of each
              pass; 3-bin identity mode stores the R/G/B primaries'
              representative wavelengths instead)
    to_xyz:   [3, n] binned CIE matrix: xyz = to_xyz @ bins for a
              piecewise-constant spectrum (ybar-normalized so a
              unit-luminance spectrum keeps Y=1)
    basis:    [7, n] Smits REFLECTANCE basis spectra, corrected so
              project(d65 * basis_i) hits its RGB target exactly
              (None in 3-bin identity mode)
    d65:      [n] binned D65 whitepoint spectrum (None in identity
              mode); emission leaves carry d65 * upsample(rgb)
    """

    n: int
    edges: np.ndarray
    centers: np.ndarray
    to_xyz: np.ndarray
    basis: np.ndarray | None
    d65: np.ndarray | None = None

    @property
    def identity(self):
        return self.basis is None

    @property
    def n_groups(self):
        return self.n // 3

    def group(self, g):
        """(M3 [3,3] bins->xyz slice, lam_mid nm) for render pass g."""
        sl = slice(3 * g, 3 * g + 3)
        return self.to_xyz[:, sl], float(self.centers[3 * g + 1])


def make_bins(n):
    """Build the N-bin layout.  n must be a positive multiple of 3."""
    n = int(n)
    if n <= 0 or n % 3 != 0:
        raise ValueError(
            f"spectral bin count must be a positive multiple of 3, got {n}"
        )
    edges = np.linspace(LAMBDA_MIN, LAMBDA_MAX, n + 1)
    if n == 3:
        # Three 157nm-wide bins make the CIE inversion hopelessly
        # ill-conditioned; define 3-bin mode as RGB mode exactly
        # (channels ARE Rec.709 primaries), which doubles as a
        # plumbing-parity test of the spectral path.
        return SpectralBins(
            n=3,
            edges=edges,
            centers=np.array([630.0, 532.0, 462.0]),  # R, G, B
            to_xyz=_RGB_TO_XYZ.astype(np.float32),
            basis=None,
        )
    centers = 0.5 * (edges[:-1] + edges[1:])
    cie = _cie_fine()  # [3, F]
    ynorm = np.trapezoid(cie[1], _FINE)

    # xyz = sum_i bins_i * integral_{bin i} cie dl / ynorm
    idx = np.clip(np.searchsorted(edges, _FINE, side="right") - 1, 0, n - 1)
    to_xyz = np.zeros((3, n))
    for c in range(3):
        np.add.at(to_xyz[c], idx, cie[c])
    to_xyz /= ynorm  # fine grid is 1nm so the sum IS the integral

    # Smooth seeds: flat white, raised-cosine primary bumps, and their
    # complements for the secondaries; then the minimal-norm linear
    # correction so each basis projects to its RGB-cube corner exactly.
    lam = centers

    def bump(mu, width):
        t = np.clip((lam - mu) / width, -1.0, 1.0)
        return 0.5 * (1.0 + np.cos(np.pi * t))

    s_r = np.minimum(bump(640.0, 120.0) + 0.55 * bump(760.0, 120.0), 1.0)
    s_g = bump(532.0, 95.0)
    s_b = np.minimum(bump(460.0, 85.0) + 0.4 * bump(390.0, 70.0), 1.0)
    seeds = np.stack(
        [np.ones(n), 1.0 - s_r, 1.0 - s_g, 1.0 - s_b, s_r, s_g, s_b],
        axis=0,
    )  # [7, n]
    proj = _XYZ_TO_RGB.astype(np.float64) @ to_xyz  # [3, n] bins->rgb

    # binned D65, normalized to unit luminance (Y = 1)
    d65 = np.interp(
        _FINE, _D65_LAM, _D65_10NM,
        left=_D65_10NM[0], right=_D65_10NM[-1],
    )
    num = np.zeros(n)
    den = np.zeros(n)
    np.add.at(num, idx, d65)
    np.add.at(den, idx, 1.0)
    d65 = num / np.maximum(den, 1.0)
    d65 /= float(to_xyz[1] @ d65)

    # correct the reflectance seeds against the D65-WEIGHTED projection:
    # project(d65 * basis_i) == target_i exactly, so any product of
    # upsampled reflectances under a D65-shaped illuminant projects back
    # without whitepoint ripple (neutral grays stay neutral).
    proj_d = proj * d65[None, :]
    pinv_d = np.linalg.pinv(proj_d)  # [n, 3]
    basis = seeds + (_TARGETS - seeds @ proj_d.T) @ pinv_d.T
    return SpectralBins(
        n=n,
        edges=edges,
        centers=centers,
        to_xyz=to_xyz.astype(np.float32),
        basis=basis.astype(np.float32),
        d65=d65.astype(np.float32),
    )


def upsample_rgb(rgb, bins):
    """[..., 3] linear RGB REFLECTANCE -> [..., n] smooth bin spectrum
    via Smits' white/secondary/primary decomposition (reference
    spectrum.cpp Spectrum::fromLinearRGB, m_rgbRefl tables).  Exact
    under the D65 whitepoint: project(d65 * out) == rgb for every
    rgb >= 0; use `upsample_illum` for emission quantities."""
    rgb = np.asarray(rgb, np.float32)
    if bins.identity:
        return rgb.copy()
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    zero = np.zeros_like(r)
    mr = (r <= g) & (r <= b)
    mg = (~mr) & (g <= b)
    mb = ~(mr | mg)
    coef = np.stack(
        [
            np.minimum(np.minimum(r, g), b),  # white
            np.where(mr, np.minimum(g, b) - r, zero),  # cyan
            np.where(mg, np.minimum(r, b) - g, zero),  # magenta
            np.where(mb, np.minimum(r, g) - b, zero),  # yellow
            np.where(mg & (r > b), r - b, zero)
            + np.where(mb & (r > g), r - g, zero),  # red
            np.where(mr & (g > b), g - b, zero)
            + np.where(mb & (r <= g), g - r, zero),  # green
            np.where(mr & (g <= b), b - g, zero)
            + np.where(mg & (r <= b), b - r, zero),  # blue
        ],
        axis=-1,
    )
    return coef @ bins.basis


def upsample_illum(rgb, bins):
    """[..., 3] linear RGB EMISSION -> [..., n] bin spectrum: a
    D65-shaped illuminant times an upsampled reflectance (reference
    spectrum.cpp m_rgbIllum tables; pbrt's RGBIlluminantSpectrum).
    Exact: project(out) == rgb."""
    spec = upsample_rgb(rgb, bins)
    if bins.identity:
        return spec
    return spec * bins.d65


def spd_to_bins(wavelengths, values, bins):
    """Average a tabulated spectrum over each bin (reference
    InterpolatedSpectrum::average, spectrum.cpp:447)."""
    vals = np.interp(_FINE, wavelengths, values, left=0.0, right=0.0)
    idx = np.clip(
        np.searchsorted(bins.edges, _FINE, side="right") - 1, 0, bins.n - 1
    )
    num = np.zeros(bins.n)
    den = np.zeros(bins.n)
    np.add.at(num, idx, vals)
    np.add.at(den, idx, 1.0)
    return (num / np.maximum(den, 1.0)).astype(np.float32)


def cauchy_eta(eta_d, dispersion_b, lam_nm):
    """Cauchy dispersion model eta(lambda) = A + B/lambda^2 with the
    scene-provided eta taken at the Fraunhofer d-line (587.6nm);
    `dispersion_b` is B in um^2 (~0.0042 for BK7 glass)."""
    lam_um = lam_nm * 1e-3
    return eta_d + dispersion_b * (1.0 / lam_um**2 - 1.0 / 0.5876**2)
