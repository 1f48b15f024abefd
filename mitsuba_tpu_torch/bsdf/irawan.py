"""Irawan-Marschner woven cloth on the device (port of
mitsuba_tpu/bsdf/irawan.py's lane functions; reference
src/bsdfs/irawan.cpp).

`lane_params` turns a lane's uv and material row into its yarn segment's
parameters by gathers from the packed iw_* tables (the weave pattern's
tile cell -> yarn -> segment frame; scene/texture_eval.py shading_params
stores them in sp["iw"]); `irawan_f` evaluates the filament or staple
specular integrand and the diffuse floor branch-free on every lane
(bsdf/eval.py).  The parser, the tables and the load-time normalization
live in bsdf/irawan_host.py.
"""

from __future__ import annotations

import math

import torch

from mitsuba_tpu_torch.bsdf.irawan_host import TABLE_KEYS  # noqa: F401 (the pack's iw_* keys)

_PI = math.pi


def perlin1(t, rand01):
    """1D gradient noise in roughly [-1, 1] (the reference's
    Noise::perlinNoise role along x, irawan.cpp:267-272)."""
    i0 = torch.floor(t)
    f = t - i0
    i0 = i0.to(torch.int32)
    g0 = rand01(i0, torch.zeros_like(i0) + 101) * 2.0 - 1.0
    g1 = rand01(i0 + 1, torch.zeros_like(i0) + 101) * 2.0 - 1.0
    fade = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)
    return 2.0 * ((1.0 - fade) * g0 * f + fade * g1 * (f - 1.0))


def von_mises(cos_x, b):
    """von Mises pdf at cos_x with concentration b (irawan.cpp:588-605;
    I0 by the Abramowitz & Stegun polynomial)."""
    ab = torch.abs(b)
    t_s = ab / 3.75
    t_s = t_s * t_s
    i0_small = 1.0 + t_s * (3.5156229 + t_s * (3.0899424 + t_s * (
        1.2067492 + t_s * (0.2659732 + t_s * (0.0360768 + t_s * 0.0045813)))))
    t_l = 3.75 / torch.clamp(ab, min=1e-6)
    i0_large = torch.exp(ab) / torch.sqrt(torch.clamp(ab, min=1e-6)) * (
        0.39894228 + t_l * (0.01328592 + t_l * (0.00225319 + t_l * (
            -0.00157565 + t_l * (0.00916281 + t_l * (-0.02057706 + t_l * (
                0.02635537 + t_l * (-0.01647633 + t_l * 0.00392377)))))))
    )
    i0 = torch.where(ab <= 3.75, i0_small, i0_large)
    return torch.exp(b * cos_x) / (2.0 * _PI * i0)


def _seeliger(c1, c2):
    """Lommel-Seeliger attenuation, albedo 1 (irawan.cpp:608-615)."""
    c1 = torch.clamp(c1, min=0.0)
    c2 = torch.clamp(c2, min=0.0)
    s = c1 + c2
    return torch.where((c1 > 0) & (c2 > 0),
                       c1 * c2 / (4.0 * _PI * torch.clamp(s, min=1e-12)), 0.0)


def _atanh(x):
    x = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
    return 0.5 * torch.log((1.0 + x) / (1.0 - x))


def radius_of_curvature(u, umax, kappa, w, l):
    """Spine radius of curvature (irawan.cpp:551-581; thesis 5.3): the
    ellipse (rhat > 0), hyperbola (rhat < 0) and parabola branches."""
    a = 0.5 * w
    tan_umax = torch.tan(umax)
    rhat = 1.0 + kappa * (1.0 + 1.0 / tan_umax)
    arc = 0.5 * l - a * torch.sin(umax)
    tan_u = torch.tan(u)

    rp = torch.clamp(rhat, min=1e-6)
    tmax_e = torch.atan(rp * tan_umax)
    bhat_e = arc / torch.clamp(torch.sin(tmax_e), min=1e-9)
    ahat_e = bhat_e / rp
    t_e = torch.atan(rp * tan_u)
    ct, st = torch.cos(t_e), torch.sin(t_e)
    r_ell = (bhat_e * bhat_e * ct * ct + ahat_e * ahat_e * st * st) ** 1.5 / torch.clamp(
        ahat_e * bhat_e, min=1e-12)

    rn = torch.clamp(rhat, max=-1e-6)
    tmax_h = -_atanh(rn * tan_umax)
    bhat_h = arc / torch.clamp(torch.sinh(tmax_h), min=1e-9)
    ahat_h = bhat_h / rn
    t_h = -_atanh(rn * tan_u)
    ch, sh = torch.cosh(t_h), torch.sinh(t_h)
    r_hyp = -((bhat_h * bhat_h * ch * ch + ahat_h * ahat_h * sh * sh) ** 1.5) / torch.clamp(
        ahat_h * bhat_h, max=-1e-12)

    ahat_p = arc / torch.clamp(2.0 * tan_umax, min=1e-9)
    r_par = 2.0 * ahat_p * (1.0 + tan_u * tan_u) ** 1.5

    eps = 1e-6
    return torch.where(rhat > eps, r_ell, torch.where(rhat < -eps, r_hyp, r_par))


def _smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _half(om_i, om_r):
    h = om_i + om_r
    return h / torch.clamp(torch.sqrt(h[..., 0] ** 2 + h[..., 1] ** 2 + h[..., 2] ** 2),
                           min=1e-9)[..., None]


def _dots(sv, su, cu, cv, n_len, *dirs):
    return [(sv * d[..., 0] + su * cv * d[..., 1] + cu * cv * d[..., 2]) / n_len for d in dirs]


def _sum_len(om_i, om_r):
    s = om_i + om_r
    return torch.sqrt(torch.clamp(s[..., 0] ** 2 + s[..., 1] ** 2 + s[..., 2] ** 2, min=1e-12))


def _fc(P, om_i, om_r):
    dot_ir = om_i[..., 0] * om_r[..., 0] + om_i[..., 1] * om_r[..., 1] + om_i[..., 2] * om_r[..., 2]
    return P["alpha"] + von_mises(-dot_ir, P["beta"])


def filament_integrand(P, u, v, om_i, om_r):
    """Specular integrand of filament yarns, psi = 0 (irawan.cpp:390-464)."""
    umax, kappa, w, l, ss = P["umax"], P["kappa"], P["w"], P["l"], P["ss"]
    h = _half(om_i, om_r)
    hy, hz = h[..., 1], h[..., 2]
    u_of_v = torch.atan(hy / torch.clamp(hz, min=1e-6))
    valid = torch.abs(u_of_v) < umax

    su, cu = torch.sin(u_of_v), torch.cos(u_of_v)
    sv, cv = torch.sin(v), torch.cos(v)
    n_len = torch.sqrt(torch.clamp(sv * sv + su * su * cv * cv + cu * cu * cv * cv, min=1e-12))
    n_dot_i, n_dot_r = _dots(sv, su, cu, cv, n_len, om_i, om_r)

    ss_umax = (1.0 - ss) * umax
    R = radius_of_curvature(torch.minimum(torch.abs(u_of_v), ss_umax), ss_umax, kappa, w, l)
    a = 0.5 * w
    # the x component of t x h, t = (0, cos u, -sin u)
    txh_x = torch.abs(cu * hz + su * hy)
    Gu = a * (R + a * cv) / torch.clamp(_sum_len(om_i, om_r) * txh_x, min=1e-9)
    fc = _fc(P, om_i, om_r)

    A = _seeliger(n_dot_i, n_dot_r)
    As = A * (1.0 - _smoothstep((torch.abs(u_of_v) - ss_umax) / torch.clamp(ss * umax, min=1e-9)))
    A = torch.where(ss > 0.0, As, A)
    fs = Gu * fc * A * _PI * l

    delta_y = l * P["hwidth"]
    y_of_v = u_of_v * 0.5 * l / umax
    y_of_v = torch.clamp(y_of_v, 0.5 * (delta_y - l), 0.5 * (l - delta_y))
    hit = torch.abs(y_of_v - u * 0.5 * l / umax) < 0.5 * delta_y
    return torch.where(valid & hit, fs / torch.clamp(delta_y, min=1e-9), 0.0)


def staple_integrand(P, u, v, om_i, om_r):
    """Specular integrand of staple yarns, psi != 0 (irawan.cpp:482-549)."""
    umax, kappa, w, l, psi = P["umax"], P["kappa"], P["w"], P["l"], P["psi"]
    h = _half(om_i, om_r)
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]

    su, cu = torch.sin(u), torch.cos(u)
    tan_psi = torch.tan(torch.where(torch.abs(psi) > 1e-6, psi, 1e-6))
    D = (hy * cu - hz * su) / torch.clamp(
        torch.sqrt(torch.clamp(hx * hx + (hy * su + hz * cu) ** 2, min=1e-12))
        * torch.abs(tan_psi), min=1e-9) * torch.sign(tan_psi)
    acos_d = torch.acos(torch.clamp(D, -1.0, 1.0))
    v_of_u = torch.atan2(-hy * su - hz * cu, hx) + acos_d
    valid = (torch.abs(D) < 1.0) & (torch.abs(v_of_u) < _PI / 2.0)

    sv, cv = torch.sin(v_of_u), torch.cos(v_of_u)
    n_len = torch.sqrt(torch.clamp(sv * sv + su * su * cv * cv + cu * cu * cv * cv, min=1e-12))
    n_dot_i, n_dot_r, n_dot_h = _dots(sv, su, cu, cv, n_len, om_i, om_r, h)

    R = radius_of_curvature(torch.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    Gv = a * (R + a * cv) / torch.clamp(
        _sum_len(om_i, om_r) * torch.abs(n_dot_h) * torch.abs(torch.sin(psi)), min=1e-9)
    fc = _fc(P, om_i, om_r)
    A = _seeliger(n_dot_i, n_dot_r)
    fs = Gv * fc * A * 2.0 * w * umax

    delta_x = w * P["hwidth"]
    x_of_u = v_of_u * w / _PI
    x_of_u = torch.clamp(x_of_u, 0.5 * (delta_x - w), 0.5 * (w - delta_x))
    hit = torch.abs(x_of_u - v * w / _PI) < 0.5 * delta_x
    # n . h < 0 has no physical specular reflection
    valid = valid & (n_dot_h > 1e-6)
    return torch.where(valid & hit, fs / torch.clamp(delta_x, min=1e-9), 0.0)


def specular_integrand(P, om_i, om_r):
    """The staple (psi != 0) or filament integrand of each lane
    (irawan.cpp:283-290)."""
    fil = filament_integrand(P, P["u"], P["v"], om_i, om_r)
    sta = staple_integrand(P, P["u"], P["v"], om_i, om_r)
    return torch.where(torch.abs(P["psi"]) > 1e-6, sta, fil)


def lane_params(T, row, uv, rand01, with_noise):
    """uv [R, 2] and iw row [R] -> each lane's yarn segment parameters
    (irawan.cpp eval:200-279).  T maps TABLE_KEYS to the pack's tensors;
    rand01(int32, int32) -> [0, 1) is the segment hash; with_noise (the
    pack's static iw_noise) adds the period and fineness noise."""
    def g(name):
        return T[name][row]

    tw_i, th_i = g("tile_w"), g("tile_h")
    tw, th = tw_i.to(torch.float32), th_i.to(torch.float32)
    ru, rv = g("repeat_u"), g("repeat_v")

    x = uv[..., 0] * ru * tw
    y = (1.0 - uv[..., 1]) * rv * th
    # floor-mod, as the reference's int32 %
    lx = torch.remainder(torch.floor(x).to(torch.int32), torch.clamp(tw_i, min=1))
    ly = torch.remainder(torch.floor(y).to(torch.int32), torch.clamp(th_i, min=1))
    yid = T["pattern"][g("pat_ofs") + ly * tw_i + lx]

    def yv(name):
        return T[name][yid]

    weft = yv("y_type") > 0.5
    center_x = torch.floor(x / tw) * tw + yv("y_cu") * tw
    center_y = torch.floor(y / th) * th + (1.0 - yv("y_cv")) * th
    xx = x - center_x
    yy = -(y - center_y)
    # weft: the segment frame turned 90 degrees about z (irawan.cpp:243-252)
    xx, yy = torch.where(weft, -yy, xx), torch.where(weft, xx, yy)

    umax = yv("y_umax")
    if with_noise:
        period = g("period")
        pos_x = torch.abs(center_x).to(torch.int32)
        pos_y = torch.abs(center_y).to(torch.int32)
        safe_p = torch.clamp(period, min=1e-6)
        r1 = perlin1((center_x * (th * rv + rand01(pos_x, 2 * pos_y)) + center_y) / safe_p, rand01)
        r2 = perlin1((center_y * (tw * ru + rand01(pos_x, 2 * pos_y + 1)) + center_x) / safe_p,
                     rand01)
        d_u1 = torch.where(weft, g("d_weft_warp"), g("d_warp_warp"))
        d_u2 = torch.where(weft, g("d_weft_weft"), g("d_warp_weft"))
        umax_n = umax + r1 * d_u1 + r2 * d_u2
        umax = torch.where(period > 0.0, torch.clamp(umax_n, 1e-3, _PI / 2 - 1e-3), umax)

        fineness = g("fineness")
        i1 = ((center_x + xx) * fineness).to(torch.int32)
        i2 = ((center_y + yy) * fineness).to(torch.int32)
        inten = torch.clamp(-torch.log(torch.clamp(rand01(i1, i2), min=1e-10)), max=10.0)
        intensity = torch.where(fineness > 0.0, inten, 1.0)
    else:
        intensity = torch.ones_like(x)

    w_y, l_y = yv("y_w"), yv("y_l")
    return {
        "u": yy / (l_y * 0.5) * umax,
        "v": xx * _PI / w_y,
        "weft": weft,
        "psi": yv("y_psi"),
        "umax": umax,
        "kappa": yv("y_kappa"),
        "w": w_y,
        "l": l_y,
        "kd": T["y_kd"][yid],
        "ks": T["y_ks"][yid],
        "intensity": intensity,
        "alpha": g("alpha"),
        "beta": g("beta"),
        "ss": g("ss"),
        "hwidth": g("hwidth"),
        "area": torch.where(weft, g("area_weft"), g("area_warp")),
        "norm": g("norm"),
    }


def _rotate_weft(weft, v):
    """A local direction turned +90 degrees about z on weft lanes
    (irawan.cpp:247-252): (x, y) -> (-y, x)."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.where(weft, -vy, vx), torch.where(weft, vx, vy), vz], dim=-1)


def irawan_f(iw, wi, wo):
    """f(wi, wo) * cos_o (rgb), 0 outside the upper hemisphere
    (irawan.cpp eval:189-319)."""
    ci, co = wi[..., 2], wo[..., 2]
    spec = specular_integrand(iw, _rotate_weft(iw["weft"], wi), _rotate_weft(iw["weft"], wo))
    spec = spec * iw["intensity"] * iw["area"]
    f = iw["ks"] * (spec * iw["norm"])[..., None] + iw["kd"] * (1.0 / _PI)
    return torch.where(((ci > 0) & (co > 0))[..., None], f * co[..., None], 0.0)
