"""Daylight models baked to environment maps (port of
mitsuba_tpu/emitter/sky.py: the same host numpy code, so that the baked
images are bit-equal): Preetham sun/sky and the Hosek-Wilkie fit.

The Preetham, Shirley & Smits model ("A Practical Analytic Model for
Daylight", SIGGRAPH 99) is closed-form; the Hosek-Wilkie model (the
reference's default, src/emitters/sunsky/skymodel.cpp) interpolates an RGB
dataset fit.  Like the reference (sky.cpp precomputes a bitmap for
importance sampling), the sky is baked into a lat-long environment map at
scene-load time and then sampled through the envmap tables: no ray
evaluates the model.

Conventions: +Y is up (world frame of the emitter's toWorld transform),
matching emitter/eval.py's lat-long mapping: u = atan2(x, -z)/2pi,
v = acos(y)/pi.
"""

from __future__ import annotations

import math

import numpy as np

# Perez coefficient rows [A..E] as linear functions of turbidity:
# value = c0 * T + c1   (Preetham Table A.1)
_PEREZ_Y = np.array([
    [0.1787, -1.4630],
    [-0.3554, 0.4275],
    [-0.0227, 5.3251],
    [0.1206, -2.5771],
    [-0.0670, 0.3703],
])
_PEREZ_x = np.array([
    [-0.0193, -0.2592],
    [-0.0665, 0.0008],
    [-0.0004, 0.2125],
    [-0.0641, -0.8989],
    [-0.0033, 0.0452],
])
_PEREZ_y = np.array([
    [-0.0167, -0.2608],
    [-0.0950, 0.0092],
    [-0.0079, 0.2102],
    [-0.0441, -1.6537],
    [-0.0109, 0.0529],
])

# zenith chromaticity matrices (Preetham Table A.2)
_ZENITH_X = np.array([
    [0.00166, -0.00375, 0.00209, 0.0],
    [-0.02903, 0.06377, -0.03202, 0.00394],
    [0.11693, -0.21196, 0.06052, 0.25886],
])
_ZENITH_Y = np.array([
    [0.00275, -0.00610, 0.00317, 0.0],
    [-0.04214, 0.08970, -0.04153, 0.00516],
    [0.15346, -0.26756, 0.06670, 0.26688],
])

# CIE XYZ -> linear sRGB
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311],
])

SUN_APP_RADIUS_DEG = 0.5358 / 2.0  # apparent solar radius


def _perez(coeff, theta, gamma):
    A, B, C, D, E = coeff
    cos_t = np.maximum(np.cos(theta), 1e-3)
    return (1.0 + A * np.exp(B / cos_t)) * (
        1.0 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2
    )


_DAYS_BEFORE_MONTH = [0, 0, 31, 59, 90, 120, 151, 181, 212, 243, 273,
                      304, 334]


def sun_direction_from_time(year, month, day, hour, latitude, longitude,
                            timezone):
    """Solar position (Preetham appendix A.6, the formulas the
    reference's sun.cpp configure path implements) -> unit direction
    with +Y up, +X east, -Z north."""
    J = _DAYS_BEFORE_MONTH[month] + day  # day of year (leap ignored)
    sm = timezone * math.pi / 12.0  # standard meridian (radians)
    lon = math.radians(longitude)
    t_s = (
        hour
        + 0.170 * math.sin(4.0 * math.pi * (J - 80) / 373.0)
        - 0.129 * math.sin(2.0 * math.pi * (J - 8) / 355.0)
        + 12.0 * (sm - lon) / math.pi
    )
    decl = 0.4093 * math.sin(2.0 * math.pi * (J - 81) / 368.0)
    lat = math.radians(latitude)
    ha = math.pi * t_s / 12.0  # hour angle term; t_s = 12 -> cos = -1
    elevation = math.asin(
        math.sin(lat) * math.sin(decl)
        - math.cos(lat) * math.cos(decl) * math.cos(ha)
    )
    # azimuth measured from SOUTH, positive toward west
    azimuth = math.atan2(
        -math.cos(decl) * math.sin(ha),
        math.cos(lat) * math.sin(decl)
        - math.sin(lat) * math.cos(decl) * math.cos(ha),
    )
    y = math.sin(elevation)
    r = math.cos(elevation)
    # south = +Z (so north = -Z), west = -X (east = +X)
    return np.array(
        [-r * math.sin(azimuth), y, r * math.cos(azimuth)], np.float64
    )


def sun_irradiance_rgb(cos_theta_s, turbidity):
    """Direct-normal solar irradiance split into RGB (W/m^2), attenuated
    by Rayleigh scattering, aerosols, and ozone (Preetham appendix
    transmittance formulas at three representative wavelengths)."""
    cos_t = max(float(cos_theta_s), 0.0)
    if cos_t <= 0.0:
        return np.zeros(3, np.float64)
    theta_deg = math.degrees(math.acos(min(cos_t, 1.0)))
    m = 1.0 / (cos_t + 0.15 * (93.885 - theta_deg) ** -1.253)
    lam = np.array([0.612, 0.549, 0.465])  # micrometers
    tau_r = np.exp(-0.008735 * m * lam ** -4.08)
    beta = 0.04608 * turbidity - 0.04586
    tau_a = np.exp(-beta * m * lam ** -1.3)
    k_o = np.array([0.060, 0.085, 0.009])  # ozone absorption ~per channel
    tau_o = np.exp(-k_o * 0.35 * m)
    s0 = np.array([480.0, 500.0, 470.0])  # ~1360 W/m^2 split to RGB bands
    return s0 * tau_r * tau_a * tau_o


def _hosek_dataset():
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "hosek_rgb.npz",
    )
    d = np.load(path)
    return d["rgb"].astype(np.float64), d["rad"].astype(np.float64)


def _hosek_config(turbidity, albedo, elevation):
    """Quintic-Bezier elevation interpolation + bilinear in turbidity
    and ground albedo (the reference's ArHosekSkyModel cook-configuration
    scheme, src/emitters/sunsky/skymodel.cpp).  Returns (config [3,9],
    radiance [3])."""
    rgb, rad = _hosek_dataset()  # [3,2,10,6,9], [3,2,10,6]
    x = (max(elevation, 0.0) / (math.pi / 2.0)) ** (1.0 / 3.0)
    x = min(x, 1.0)
    b = np.array([
        (1 - x) ** 5,
        5 * (1 - x) ** 4 * x,
        10 * (1 - x) ** 3 * x * x,
        10 * (1 - x) ** 2 * x**3,
        5 * (1 - x) * x**4,
        x**5,
    ])
    t = float(np.clip(turbidity, 1.0, 10.0))
    ti = int(min(math.floor(t) - 1, 8))
    tf = t - (ti + 1)
    a = float(np.clip(albedo, 0.0, 1.0))

    def lerp_t(arr):  # arr [3, 2, 10, 6, ...] -> [3, 2, ...]
        lo = np.tensordot(arr[:, :, ti], b, axes=([2], [0]))
        hi = np.tensordot(arr[:, :, min(ti + 1, 9)], b, axes=([2], [0]))
        return lo * (1 - tf) + hi * tf

    cfg_ab = lerp_t(rgb)  # [3, 2, 9]
    rad_ab = lerp_t(rad)  # [3, 2]
    cfg = cfg_ab[:, 0] * (1 - a) + cfg_ab[:, 1] * a
    radv = rad_ab[:, 0] * (1 - a) + rad_ab[:, 1] * a
    return cfg, radv


def hosek_sky_image(
    turbidity,
    sun_dir,
    resolution=512,
    sky_scale=1.0,
    sun_scale=1.0,
    with_sun=False,
    ground_albedo=0.15,
):
    """Bake the Hosek-Wilkie sky (SIGGRAPH 2012; the reference's
    default model, src/emitters/sunsky/skymodel.cpp) into a lat-long
    env image [H, W, 3] f32.  Same interface and radiometric scale as
    preetham_sky_image; dataset from the port's own copy, mitsuba_tpu_torch/data/hosek_rgb.npz."""
    T = float(np.clip(turbidity, 1.0, 10.0))
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    elevation = math.asin(np.clip(s[1], -1.0, 1.0))
    ga = float(np.mean(np.atleast_1d(ground_albedo)))
    cfg, radv = _hosek_config(T, ga, elevation)

    h = resolution
    w = 2 * resolution
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    st = np.sin(theta)[:, None]
    d = np.stack(
        [
            st * np.sin(phi)[None, :],
            np.broadcast_to(np.cos(theta)[:, None], (h, w)),
            st * (-np.cos(phi)[None, :]),
        ],
        axis=-1,
    )
    cos_gamma = np.clip(d @ s, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    cos_theta = np.clip(d[..., 1], 0.0, 1.0)  # model defined above horizon

    rgb = np.zeros((h, w, 3))
    for c in range(3):
        # coefficient layout per ArHosekSkyModel_GetRadianceInternal:
        # [0]=A [1]=B [2]=C [3]=D [4]=E(exp gamma) [5]=F(rayleigh)
        # [6]=G(mie weight) [7]=I(zenith sqrt) [8]=H(mie anisotropy)
        A, B, C, D, E, F, G, Iz, Hc = cfg[c]
        exp_m = np.exp(E * gamma)
        ray_m = cos_gamma * cos_gamma
        mie_m = (1.0 + ray_m) / np.power(
            np.maximum(1.0 + Hc * Hc - 2.0 * Hc * cos_gamma, 1e-9), 1.5
        )
        zen = np.sqrt(cos_theta)
        val = (
            1.0 + A * np.exp(B / (cos_theta + 0.01))
        ) * (C + D * exp_m + F * ray_m + G * mie_m + Iz * zen)
        rgb[..., c] = val * radv[c]
    # physical scale: the RGB dataset is CIE-converted spectral radiance
    # integrated over ~320-720nm in W/(m^2 sr nm) * nm-bin; normalize to
    # W/(m^2 sr) per channel consistently with the Preetham baking by
    # the luminous-efficacy convention
    rgb = np.maximum(rgb, 0.0) * sky_scale

    below = d[..., 1] < 0.0
    sel = np.abs(d[..., 1]) < 0.05
    horizon_avg = rgb[sel].mean(axis=0) if sel.any() else rgb.mean((0, 1))
    rgb[below] = horizon_avg * ga

    if with_sun and s[1] > 0.0:
        e_sun = sun_irradiance_rgb(s[1], T) * sun_scale
        px_ang = math.pi / h
        support = max(1.5 * px_ang, math.radians(SUN_APP_RADIUS_DEG))
        ang = np.arccos(cos_gamma)
        k = np.maximum(1.0 - ang / support, 0.0) * (d[..., 1] > 0.0)
        omega = (
            np.sin(np.clip(theta, 1e-4, math.pi))[:, None]
            * (math.pi / h) * (2.0 * math.pi / w)
        ) * np.ones((1, w))
        norm = float((k * omega).sum())
        if norm > 0:
            rgb = rgb + (k / norm)[..., None] * e_sun[None, None, :]

    return rgb.astype(np.float32)


def preetham_sky_image(
    turbidity,
    sun_dir,
    resolution=512,
    sky_scale=1.0,
    sun_scale=1.0,
    with_sun=False,
    ground_albedo=0.15,
):
    """Bake the Preetham sky into a lat-long env image [H, W, 3] f32.

    sun_dir: unit vector TOWARD the sun (+Y up).  Radiance is converted
    from the model's cd/m^2 to W/(m^2 sr) with the 683 lm/W luminous
    efficacy, matching the radiometric scale of the other emitters.
    """
    T = float(np.clip(turbidity, 1.2, 10.0))
    s = np.asarray(sun_dir, np.float64)
    s = s / np.linalg.norm(s)
    theta_s = math.acos(np.clip(s[1], -1.0, 1.0))
    theta_s = min(theta_s, math.radians(97.0))  # keep zenith formulas sane

    h = resolution
    w = 2 * resolution
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = v * math.pi  # angle from +Y (up)
    phi = u * 2.0 * math.pi
    st = np.sin(theta)[:, None]
    d = np.stack(
        [
            st * np.sin(phi)[None, :],
            np.broadcast_to(np.cos(theta)[:, None], (h, w)),
            st * (-np.cos(phi)[None, :]),
        ],
        axis=-1,
    )  # [h, w, 3], matches emitter/eval.py's uv<->dir mapping

    cos_gamma = np.clip(d @ s, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    theta_grid = np.arccos(np.clip(d[..., 1], -1.0, 1.0))

    # zenith values
    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * theta_s)
    Yz = (4.0453 * T - 4.9710) * math.tan(chi) - 0.2155 * T + 2.4192  # kcd/m2
    Yz = max(Yz, 1e-3) * 1000.0  # cd/m^2
    tv = np.array([T * T, T, 1.0])
    sv = np.array([theta_s**3, theta_s**2, theta_s, 1.0])
    xz = tv @ _ZENITH_X @ sv
    yz = tv @ _ZENITH_Y @ sv

    def coeffs(m):
        return m[:, 0] * T + m[:, 1]

    cY, cx, cy = coeffs(_PEREZ_Y), coeffs(_PEREZ_x), coeffs(_PEREZ_y)

    # clamp below-horizon directions to the horizon for the Perez eval
    theta_c = np.minimum(theta_grid, math.radians(89.5))
    Y = Yz * _perez(cY, theta_c, gamma) / _perez(cY, 0.0, theta_s)
    x = xz * _perez(cx, theta_c, gamma) / _perez(cx, 0.0, theta_s)
    y = yz * _perez(cy, theta_c, gamma) / _perez(cy, 0.0, theta_s)

    # xyY -> XYZ -> linear sRGB; cd/m^2 -> W/(m^2 sr)
    y = np.maximum(y, 1e-5)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    xyz = np.stack([X, Y, Z], axis=-1) / 683.0
    rgb = np.maximum(xyz @ _XYZ_TO_RGB.T, 0.0) * sky_scale

    # below the horizon: ground lit by the average sky (reference
    # extends with an albedo-scaled average, sky.cpp ground handling)
    below = d[..., 1] < 0.0
    horizon_avg = rgb[np.abs(d[..., 1]) < 0.05].mean(axis=0)
    rgb[below] = horizon_avg * ground_albedo

    if with_sun and s[1] > 0.0:
        # Distribute the sun's direct-normal irradiance over the pixels
        # nearest its direction with an ENERGY-CONSERVING tent kernel:
        # sum_i L_i * Omega_i = E_sun exactly, at any map resolution
        # (the solar disk is far smaller than a texel at typical sizes).
        e_sun = sun_irradiance_rgb(s[1], T) * sun_scale
        px_ang = math.pi / h
        support = max(1.5 * px_ang, math.radians(SUN_APP_RADIUS_DEG))
        ang = np.arccos(cos_gamma)
        k = np.maximum(1.0 - ang / support, 0.0) * (d[..., 1] > 0.0)
        # per-texel solid angle of the lat-long map
        omega = (
            np.sin(np.clip(theta, 1e-4, math.pi))[:, None]
            * (math.pi / h) * (2.0 * math.pi / w)
        ) * np.ones((1, w))
        norm = float((k * omega).sum())
        if norm > 0:
            rgb = rgb + (k / norm)[..., None] * e_sun[None, None, :]

    return rgb.astype(np.float32)
