"""Irawan-Marschner woven cloth on the host (port of
mitsuba_tpu/bsdf/irawan.py's numpy side; reference src/bsdfs/irawan.{h,cpp},
the model of Piti Irawan's thesis "The Appearance of Woven Cloth").

Here: the weave-pattern parser (the reference's boost::spirit DSL,
irawan.h:277-401: `weave { key = value, ..., pattern {..}, yarn {..}, .. }`
with `/* */` comments and `$name` parameters from the plugin's
Properties), the built-in presets, `pack_tables` (the iw_* tables the
scene builder packs), and `compute_normalization`, which Monte-Carlos
the specular normalization at load time (irawan.cpp configure:139-173)
with numpy, through this module's numpy copy of the yarn lookup and the
specular integrands, so that its value is the reference's to the bit.
The device evaluates the same model with torch (bsdf/irawan.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# weave pattern description (irawan.h Yarn / WeavePattern)
# ---------------------------------------------------------------------------

WARP = 0
WEFT = 1


@dataclass
class Yarn:
    type: int = WARP
    psi: float = 0.0  # fiber twist angle (radians; 0 => filament yarn)
    umax: float = 0.0  # maximum inclination angle (radians)
    kappa: float = 0.0  # spine curvature
    width: float = 0.0  # width of segment rectangle (tile cells)
    length: float = 0.0  # length of segment rectangle (tile cells)
    centerU: float = 0.0  # segment center in [0,1]^2 tile space
    centerV: float = 0.0
    kd: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ks: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))


@dataclass
class WeavePattern:
    name: str = ""
    alpha: float = 0.0  # uniform scattering
    beta: float = 0.0  # forward scattering
    ss: float = 0.0  # filament smoothing
    hWidth: float = 0.0  # highlight width
    warpArea: float = 0.0
    weftArea: float = 0.0
    tileWidth: int = 0
    tileHeight: int = 0
    dWarpUmaxOverDWarp: float = 0.0  # radians
    dWarpUmaxOverDWeft: float = 0.0
    dWeftUmaxOverDWarp: float = 0.0
    dWeftUmaxOverDWeft: float = 0.0
    fineness: float = 0.0
    period: float = 0.0
    pattern: list = field(default_factory=list)  # 1-based yarn indices
    yarns: list = field(default_factory=list)

    def validate(self):
        if self.tileWidth <= 0 or self.tileHeight <= 0:
            raise ValueError("irawan: tileWidth/tileHeight must be positive")
        if len(self.pattern) != self.tileWidth * self.tileHeight:
            raise ValueError(
                "irawan: pattern has %d entries, tile is %dx%d"
                % (len(self.pattern), self.tileWidth, self.tileHeight)
            )
        if not self.yarns:
            raise ValueError("irawan: no yarns defined")
        for p in self.pattern:
            if not (0 < p <= len(self.yarns)):
                raise ValueError("irawan: pattern index %d out of range" % p)
        for y in self.yarns:
            if not (1e-4 < y.umax < np.pi / 2):
                raise ValueError("irawan: yarn umax must be in (0, 90) deg")
            if y.kappa < -1.0:
                raise ValueError("irawan: yarn kappa must be > -1")
            if y.width <= 0 or y.length <= 0:
                raise ValueError("irawan: yarn width/length must be positive")
            if y.width * np.sin(y.umax) >= y.length:
                raise ValueError("irawan: yarn needs w*sin(umax) < length")
        if not (0.0 <= self.ss < 1.0):
            raise ValueError("irawan: ss must be in [0, 1)")
        if self.hWidth <= 0:
            raise ValueError("irawan: hWidth must be positive")
        if self.warpArea <= 0 or self.weftArea <= 0:
            raise ValueError("irawan: warpArea/weftArea must be positive")


# ---------------------------------------------------------------------------
# DSL parser (irawan.h YarnGrammar / WeavePatternGrammar)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r'\s+|/\*.*?\*/'  # whitespace / comments (skipped)
    r'|(?P<str>"[^"]*")'
    r'|(?P<num>[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?)'
    r'|(?P<ident>\$?[A-Za-z_]\w*)'
    r'|(?P<punct>[{}=,])',
    re.S,
)

_DEG_YARN = {"psi", "umax"}
_DEG_WEAVE = {
    "dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
    "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft",
}


def _tokenize(text):
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(
                "irawan: parse error near %r" % text[pos:pos + 20]
            )
        pos = m.end()
        for kind in ("str", "num", "ident", "punct"):
            if m.lastgroup == kind and m.group(kind) is not None:
                toks.append((kind, m.group(kind)))
    return toks


class _Parser:
    def __init__(self, toks, props):
        self.toks = toks
        self.i = 0
        self.props = props

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, value):
        kind, v = self.next()
        if v != value:
            raise ValueError("irawan: expected %r, got %r" % (value, v))

    def number(self):
        kind, v = self.next()
        if kind == "num":
            return float(v)
        if kind == "ident" and v.startswith("$"):
            if self.props is None:
                raise ValueError("irawan: unresolved parameter %s" % v)
            return float(self.props.get_float(v[1:]))
        raise ValueError("irawan: expected number, got %r" % v)

    def spectrum(self):
        kind, v = self.peek()
        if v == "{":
            self.next()
            r = self.number()
            self.expect(",")
            g = self.number()
            self.expect(",")
            b = self.number()
            self.expect("}")
            return np.asarray([r, g, b], np.float32)
        if kind == "ident" and v.startswith("$"):
            self.next()
            if self.props is None:
                raise ValueError("irawan: unresolved parameter %s" % v)
            return np.asarray(self.props.get_spectrum(v[1:]), np.float32)
        raise ValueError("irawan: expected spectrum, got %r" % v)

    def yarn(self):
        y = Yarn()
        self.expect("{")
        while True:
            kind, key = self.next()
            if key == "}":
                break
            if key == ",":
                continue
            self.expect("=")
            if key == "type":
                _, tv = self.next()
                y.type = WARP if tv == "warp" else WEFT
            elif key in ("kd", "ks"):
                setattr(y, key, self.spectrum())
            elif key in _DEG_YARN:
                setattr(y, key, self.number() * np.pi / 180.0)
            elif key in ("kappa", "width", "length", "centerU", "centerV"):
                setattr(y, key, self.number())
            else:
                raise ValueError("irawan: unknown yarn key %r" % key)
        return y

    def weave(self):
        w = WeavePattern()
        self.expect("weave")
        self.expect("{")
        while True:
            kind, key = self.next()
            if key == "}":
                break
            if key == ",":
                continue
            if key == "yarn":
                w.yarns.append(self.yarn())
                continue
            if key == "pattern":
                self.expect("{")
                while True:
                    k2, v2 = self.next()
                    if v2 == "}":
                        break
                    if v2 == ",":
                        continue
                    w.pattern.append(int(float(v2)))
                continue
            self.expect("=")
            if key == "name":
                _, sv = self.next()
                w.name = sv.strip('"')
            elif key in ("tileWidth", "tileHeight"):
                setattr(w, key, int(self.number()))
            elif key in _DEG_WEAVE:
                setattr(w, key, self.number() * np.pi / 180.0)
            elif key in (
                "alpha", "beta", "ss", "hWidth", "warpArea", "weftArea",
                "fineness", "period",
            ):
                setattr(w, key, self.number())
            else:
                raise ValueError("irawan: unknown weave key %r" % key)
        return w


def parse_weave(text, props=None):
    """Parse a weave-pattern description; `props` (a Properties) resolves
    `$name` placeholders (irawan.h YarnGrammar identifier rule)."""
    p = _Parser(_tokenize(text), props)
    w = p.weave()
    w.validate()
    return w


# A simple plain weave constructed from the model's geometry (not taken
# from the reference — the reference ships pattern files with example
# scenes, not in its repository).  Warp covers cells (0,0)/(1,1), weft
# the other two; filament yarns (psi = 0) with a moderate crimp.
PRESETS = {
    "plain": """
        weave {
            name = "simple plain weave",
            tileWidth = 2, tileHeight = 2,
            alpha = 0.05, beta = 4.0, ss = 0.3, hWidth = 0.6,
            warpArea = 0.5, weftArea = 0.5,
            pattern { 1, 3, 4, 2 },
            yarn { type = warp, umax = 35, width = 1, length = 2,
                   centerU = 0.25, centerV = 0.75,
                   kd = { 0.3, 0.3, 0.34 }, ks = { 0.4, 0.4, 0.44 } },
            yarn { type = warp, umax = 35, width = 1, length = 2,
                   centerU = 0.75, centerV = 0.25,
                   kd = { 0.3, 0.3, 0.34 }, ks = { 0.4, 0.4, 0.44 } },
            yarn { type = weft, umax = 35, width = 1, length = 2,
                   centerU = 0.75, centerV = 0.75,
                   kd = { 0.3, 0.3, 0.34 }, ks = { 0.4, 0.4, 0.44 } },
            yarn { type = weft, umax = 35, width = 1, length = 2,
                   centerU = 0.25, centerV = 0.25,
                   kd = { 0.3, 0.3, 0.34 }, ks = { 0.4, 0.4, 0.44 } }
        }
    """,
}


# ---------------------------------------------------------------------------
# packed tables (device layout)
# ---------------------------------------------------------------------------

# per-material scalar columns (all float32 except the int columns)
TABLE_KEYS = (
    "alpha", "beta", "ss", "hwidth", "area_warp", "area_weft",
    "repeat_u", "repeat_v", "d_warp_warp", "d_warp_weft",
    "d_weft_warp", "d_weft_weft", "fineness", "period", "norm",
    "tile_w", "tile_h", "pat_ofs",  # int32
    "pattern",  # flat int32: GLOBAL yarn row per cell
    "y_type", "y_psi", "y_umax", "y_kappa", "y_w", "y_l",
    "y_cu", "y_cv", "y_kd", "y_ks",
)


def pack_tables(entries):
    """entries: list of (WeavePattern, repeat_u, repeat_v, norm).
    Returns {key: np.ndarray} with the layout texture_eval expects."""
    n = len(entries)
    T = {k: np.zeros(n, np.float32) for k in TABLE_KEYS[:15]}
    T["tile_w"] = np.zeros(n, np.int32)
    T["tile_h"] = np.zeros(n, np.int32)
    T["pat_ofs"] = np.zeros(n, np.int32)
    pat, y_cols = [], {k: [] for k in TABLE_KEYS[19:]}
    y_ofs = 0
    for i, (w, ru, rv, norm) in enumerate(entries):
        area = w.warpArea + w.weftArea
        vals = dict(
            alpha=w.alpha, beta=w.beta, ss=w.ss, hwidth=w.hWidth,
            area_warp=area / w.warpArea, area_weft=area / w.weftArea,
            repeat_u=ru, repeat_v=rv,
            d_warp_warp=w.dWarpUmaxOverDWarp,
            d_warp_weft=w.dWarpUmaxOverDWeft,
            d_weft_warp=w.dWeftUmaxOverDWarp,
            d_weft_weft=w.dWeftUmaxOverDWeft,
            fineness=w.fineness, period=w.period, norm=norm,
        )
        for k, v in vals.items():
            T[k][i] = v
        T["tile_w"][i] = w.tileWidth
        T["tile_h"][i] = w.tileHeight
        T["pat_ofs"][i] = len(pat)
        pat.extend(y_ofs + p - 1 for p in w.pattern)
        for y in w.yarns:
            y_cols["y_type"].append(float(y.type))
            y_cols["y_psi"].append(y.psi)
            y_cols["y_umax"].append(y.umax)
            y_cols["y_kappa"].append(y.kappa)
            y_cols["y_w"].append(y.width)
            y_cols["y_l"].append(y.length)
            y_cols["y_cu"].append(y.centerU)
            y_cols["y_cv"].append(y.centerV)
            y_cols["y_kd"].append(np.asarray(y.kd, np.float32))
            y_cols["y_ks"].append(np.asarray(y.ks, np.float32))
        y_ofs += len(w.yarns)
    T["pattern"] = np.asarray(pat, np.int32)
    for k in ("y_type", "y_psi", "y_umax", "y_kappa", "y_w", "y_l",
              "y_cu", "y_cv"):
        T[k] = np.asarray(y_cols[k], np.float32)
    T["y_kd"] = np.stack(y_cols["y_kd"]).astype(np.float32)
    T["y_ks"] = np.stack(y_cols["y_ks"]).astype(np.float32)
    return T


def tables_have_noise(T):
    return bool((T["period"] > 0).any() or (T["fineness"] > 0).any())


# ---------------------------------------------------------------------------
# host-side hash (reference sampleTEA, qmc.cpp) + generic 1D Perlin
# ---------------------------------------------------------------------------

def tea_float_np(v0, v1, rounds=8):
    """TEA-hashed floats in [0,1) (reference sampleTEASingle; published
    TEA constants): the host's segment hash (the device draws from the
    ChaCha counter hash of core/rng.py, stream STREAM_WEAVE)."""
    v0 = np.asarray(v0).astype(np.uint32)
    v1 = np.asarray(v1).astype(np.uint32)
    v0, v1 = np.broadcast_arrays(v0, v1)
    v0, v1 = v0.copy(), v1.copy()
    s = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(rounds):
            s = np.uint32(s + np.uint32(0x9E3779B9))
            v0 = np.uint32(v0 + (
                np.uint32((v1 << np.uint32(4)) + np.uint32(0xA341316C))
                ^ np.uint32(v1 + s)
                ^ np.uint32((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))
            ))
            v1 = np.uint32(v1 + (
                np.uint32((v0 << np.uint32(4)) + np.uint32(0xAD90777D))
                ^ np.uint32(v0 + s)
                ^ np.uint32((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))
            ))
    return (v0 >> np.uint32(8)).astype(np.float32) / np.float32(1 << 24)


def perlin1(t, rand01):
    """1D gradient (Perlin-style) noise in roughly [-1, 1]; stands in
    for the reference's Noise::perlinNoise along the x axis
    (irawan.cpp:267-272) — same smooth lattice-correlation role,
    different lattice constants."""
    i0 = np.floor(t)
    f = t - i0
    i0 = i0.astype(np.int32)
    g0 = rand01(i0, np.zeros_like(i0) + 101) * 2.0 - 1.0
    g1 = rand01(i0 + 1, np.zeros_like(i0) + 101) * 2.0 - 1.0
    fade = f * f * f * (f * (f * 6.0 - 15.0) + 10.0)
    return 2.0 * ((1.0 - fade) * g0 * f + fade * g1 * (f - 1.0))


# ---------------------------------------------------------------------------
# model math (irawan.cpp evalFilamentIntegrand / evalStapleIntegrand /
# radiusOfCurvature / vonMises / seeliger), vectorized over lanes
# ---------------------------------------------------------------------------

def von_mises(cos_x, b):
    """von Mises pdf at cos_x with concentration b (irawan.cpp:588-605;
    I0 via the Abramowitz & Stegun polynomial)."""
    ab = np.abs(b)
    t_s = ab / 3.75
    t_s = t_s * t_s
    i0_small = 1.0 + t_s * (3.5156229 + t_s * (3.0899424 + t_s * (
        1.2067492 + t_s * (0.2659732 + t_s * (0.0360768 + t_s * 0.0045813)))))
    t_l = 3.75 / np.maximum(ab, 1e-6)
    i0_large = np.exp(ab) / np.sqrt(np.maximum(ab, 1e-6)) * (
        0.39894228 + t_l * (0.01328592 + t_l * (0.00225319 + t_l * (
            -0.00157565 + t_l * (0.00916281 + t_l * (-0.02057706 + t_l * (
                0.02635537 + t_l * (-0.01647633 + t_l * 0.00392377)))))))
    )
    i0 = np.where(ab <= 3.75, i0_small, i0_large)
    return np.exp(b * cos_x) / (2.0 * np.pi * i0)


def _seeliger(c1, c2):
    """Lommel-Seeliger attenuation, albedo 1 (irawan.cpp:608-615)."""
    c1 = np.maximum(c1, 0.0)
    c2 = np.maximum(c2, 0.0)
    s = c1 + c2
    return np.where(
        (c1 > 0) & (c2 > 0), c1 * c2 / (4.0 * np.pi * np.maximum(s, 1e-12)),
        0.0,
    )


def radius_of_curvature(u, umax, kappa, w, l):
    """Spine radius of curvature (irawan.cpp:551-581; thesis §5.3) —
    the ellipse branch also covers the circle special case rhat == 1."""
    a = 0.5 * w
    tan_umax = np.tan(umax)
    rhat = 1.0 + kappa * (1.0 + 1.0 / tan_umax)
    arc = 0.5 * l - a * np.sin(umax)  # common numerator
    tan_u = np.tan(u)

    # ellipse (rhat > 0)
    rp = np.maximum(rhat, 1e-6)
    tmax_e = np.arctan(rp * tan_umax)
    bhat_e = arc / np.maximum(np.sin(tmax_e), 1e-9)
    ahat_e = bhat_e / rp
    t_e = np.arctan(rp * tan_u)
    ct, st = np.cos(t_e), np.sin(t_e)
    r_ell = (bhat_e * bhat_e * ct * ct + ahat_e * ahat_e * st * st) ** 1.5 \
        / np.maximum(ahat_e * bhat_e, 1e-12)

    # hyperbola (rhat < 0)
    rn = np.minimum(rhat, -1e-6)

    def atanh(x):
        x = np.clip(x, -1.0 + 1e-6, 1.0 - 1e-6)
        return 0.5 * np.log((1.0 + x) / (1.0 - x))

    tmax_h = -atanh(rn * tan_umax)
    bhat_h = arc / np.maximum(np.sinh(tmax_h), 1e-9)
    ahat_h = bhat_h / rn
    t_h = -atanh(rn * tan_u)
    ch, sh = np.cosh(t_h), np.sinh(t_h)
    r_hyp = -((bhat_h * bhat_h * ch * ch + ahat_h * ahat_h * sh * sh) ** 1.5) \
        / np.minimum(ahat_h * bhat_h, -1e-12)

    # parabola (rhat == 0)
    ahat_p = arc / np.maximum(2.0 * tan_umax, 1e-9)
    r_par = 2.0 * ahat_p * (1.0 + tan_u * tan_u) ** 1.5

    eps = 1e-6
    return np.where(rhat > eps, r_ell, np.where(rhat < -eps, r_hyp, r_par))


def _smoothstep(x):
    x = np.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def filament_integrand(P, u, v, om_i, om_r):
    """Specular integrand for filament yarns, psi = 0
    (irawan.cpp:390-464).  All per-lane arrays."""
    umax, kappa, w, l, ss = P["umax"], P["kappa"], P["w"], P["l"], P["ss"]
    h = om_i + om_r
    h = h / np.maximum(
        np.sqrt(h[..., 0] ** 2 + h[..., 1] ** 2 + h[..., 2] ** 2), 1e-9
    )[..., None]
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]

    u_of_v = np.arctan(hy / np.maximum(hz, 1e-6))
    valid = np.abs(u_of_v) < umax

    su, cu = np.sin(u_of_v), np.cos(u_of_v)
    sv, cv = np.sin(v), np.cos(v)
    n_len = np.sqrt(np.maximum(sv * sv + su * su * cv * cv
                               + cu * cu * cv * cv, 1e-12))
    n_dot_i = (sv * om_i[..., 0] + su * cv * om_i[..., 1]
               + cu * cv * om_i[..., 2]) / n_len
    n_dot_r = (sv * om_r[..., 0] + su * cv * om_r[..., 1]
               + cu * cv * om_r[..., 2]) / n_len

    ss_umax = (1.0 - ss) * umax
    R = radius_of_curvature(
        np.minimum(np.abs(u_of_v), ss_umax), ss_umax, kappa, w, l
    )

    a = 0.5 * w
    sum_len = np.sqrt(np.maximum(
        (om_i[..., 0] + om_r[..., 0]) ** 2
        + (om_i[..., 1] + om_r[..., 1]) ** 2
        + (om_i[..., 2] + om_r[..., 2]) ** 2, 1e-12))
    # x-component of t x h with t = (0, cos u, -sin u)
    txh_x = np.abs(cu * hz + su * hy)
    Gu = a * (R + a * cv) / np.maximum(sum_len * txh_x, 1e-9)

    dot_ir = (om_i[..., 0] * om_r[..., 0] + om_i[..., 1] * om_r[..., 1]
              + om_i[..., 2] * om_r[..., 2])
    fc = P["alpha"] + von_mises(-dot_ir, P["beta"])

    A = _seeliger(n_dot_i, n_dot_r)
    As = A * (1.0 - _smoothstep(
        (np.abs(u_of_v) - ss_umax) / np.maximum(ss * umax, 1e-9)
    ))
    A = np.where(ss > 0.0, As, A)

    fs = Gu * fc * A * np.pi * l

    delta_y = l * P["hwidth"]
    y_of_v = u_of_v * 0.5 * l / umax
    y_of_v = np.clip(y_of_v, 0.5 * (delta_y - l), 0.5 * (l - delta_y))
    hit = np.abs(y_of_v - u * 0.5 * l / umax) < 0.5 * delta_y

    return np.where(valid & hit, fs / np.maximum(delta_y, 1e-9), 0.0)


def staple_integrand(P, u, v, om_i, om_r):
    """Specular integrand for staple yarns, psi != 0
    (irawan.cpp:482-549)."""
    umax, kappa, w, l = P["umax"], P["kappa"], P["w"], P["l"]
    psi = P["psi"]
    h = om_i + om_r
    h = h / np.maximum(
        np.sqrt(h[..., 0] ** 2 + h[..., 1] ** 2 + h[..., 2] ** 2), 1e-9
    )[..., None]
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]

    su, cu = np.sin(u), np.cos(u)
    tan_psi = np.tan(np.where(np.abs(psi) > 1e-6, psi, 1e-6))
    D = (hy * cu - hz * su) / np.maximum(
        np.sqrt(np.maximum(hx * hx + (hy * su + hz * cu) ** 2, 1e-12))
        * np.abs(tan_psi), 1e-9,
    ) * np.sign(tan_psi)
    acos_d = np.arccos(np.clip(D, -1.0, 1.0))
    v_of_u = np.arctan2(-hy * su - hz * cu, hx) + acos_d
    valid = (np.abs(D) < 1.0) & (np.abs(v_of_u) < np.pi / 2.0)

    sv, cv = np.sin(v_of_u), np.cos(v_of_u)
    n_len = np.sqrt(np.maximum(sv * sv + su * su * cv * cv
                               + cu * cu * cv * cv, 1e-12))
    n_dot_i = (sv * om_i[..., 0] + su * cv * om_i[..., 1]
               + cu * cv * om_i[..., 2]) / n_len
    n_dot_r = (sv * om_r[..., 0] + su * cv * om_r[..., 1]
               + cu * cv * om_r[..., 2]) / n_len
    n_dot_h = (sv * hx + su * cv * hy + cu * cv * hz) / n_len

    R = radius_of_curvature(np.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    sum_len = np.sqrt(np.maximum(
        (om_i[..., 0] + om_r[..., 0]) ** 2
        + (om_i[..., 1] + om_r[..., 1]) ** 2
        + (om_i[..., 2] + om_r[..., 2]) ** 2, 1e-12))
    Gv = a * (R + a * cv) / np.maximum(
        sum_len * np.abs(n_dot_h) * np.abs(np.sin(psi)), 1e-9
    )

    dot_ir = (om_i[..., 0] * om_r[..., 0] + om_i[..., 1] * om_r[..., 1]
              + om_i[..., 2] * om_r[..., 2])
    fc = P["alpha"] + von_mises(-dot_ir, P["beta"])
    A = _seeliger(n_dot_i, n_dot_r)

    fs = Gv * fc * A * 2.0 * w * umax

    delta_x = w * P["hwidth"]
    x_of_u = v_of_u * w / np.pi
    x_of_u = np.clip(x_of_u, 0.5 * (delta_x - w), 0.5 * (w - delta_x))
    hit = np.abs(x_of_u - v * w / np.pi) < 0.5 * delta_x

    # n_dot_h < 0 has no physical specular reflection
    valid = valid & (n_dot_h > 1e-6)
    return np.where(valid & hit, fs / np.maximum(delta_x, 1e-9), 0.0)


def specular_integrand(P, om_i, om_r):
    """Select the staple (psi != 0) or filament integrand per lane
    (irawan.cpp:283-290)."""
    fil = filament_integrand(P, P["u"], P["v"], om_i, om_r)
    sta = staple_integrand(P, P["u"], P["v"], om_i, om_r)
    return np.where(np.abs(P["psi"]) > 1e-6, sta, fil)


# ---------------------------------------------------------------------------
# per-lane yarn lookup (irawan.cpp eval:200-279 texture stage)
# ---------------------------------------------------------------------------

def lane_params(T, row, uv, rand01, with_noise):
    """uv [R,2] + material row [R] -> per-lane yarn/segment parameters.

    `T` maps TABLE_KEYS to numpy arrays.  `rand01(i32, i32) -> [0,1)`
    supplies the deterministic segment hash."""
    def g(name):
        return T[name][row]

    tw_i, th_i = g("tile_w"), g("tile_h")
    tw, th = tw_i.astype(np.float32), th_i.astype(np.float32)
    ru, rv = g("repeat_u"), g("repeat_v")

    x = uv[..., 0] * ru * tw
    y = (1.0 - uv[..., 1]) * rv * th
    lx = np.floor(x).astype(np.int32) % np.maximum(tw_i, 1)
    ly = np.floor(y).astype(np.int32) % np.maximum(th_i, 1)
    yid = T["pattern"][g("pat_ofs") + ly * tw_i + lx]

    def yv(name):
        return T[name][yid]

    y_type = yv("y_type")
    weft = y_type > 0.5
    cu, cv_c = yv("y_cu"), yv("y_cv")
    center_x = np.floor(x / tw) * tw + cu * tw
    center_y = np.floor(y / th) * th + (1.0 - cv_c) * th
    xx = x - center_x
    yy = -(y - center_y)
    # weft: rotate the segment frame 90 deg about z (irawan.cpp:243-252)
    xx, yy = np.where(weft, -yy, xx), np.where(weft, xx, yy)

    umax = yv("y_umax")
    if with_noise:
        period = g("period")
        pos_x = np.abs(center_x).astype(np.int32)
        pos_y = np.abs(center_y).astype(np.int32)
        safe_p = np.maximum(period, 1e-6)
        r1 = perlin1(
            (center_x * (th * rv + rand01(pos_x, 2 * pos_y)) + center_y)
            / safe_p,
            rand01,
        )
        r2 = perlin1(
            (center_y * (tw * ru + rand01(pos_x, 2 * pos_y + 1)) + center_x)
            / safe_p,
            rand01,
        )
        d_u1 = np.where(weft, g("d_weft_warp"), g("d_warp_warp"))
        d_u2 = np.where(weft, g("d_weft_weft"), g("d_warp_weft"))
        umax_n = umax + r1 * d_u1 + r2 * d_u2
        umax = np.where(period > 0.0, np.clip(umax_n, 1e-3, np.pi / 2 - 1e-3),
                        umax)

        fineness = g("fineness")
        i1 = ((center_x + xx) * fineness).astype(np.int32)
        i2 = ((center_y + yy) * fineness).astype(np.int32)
        xi = rand01(i1, i2)
        inten = np.minimum(-np.log(np.maximum(xi, 1e-10)), 10.0)
        intensity = np.where(fineness > 0.0, inten, 1.0)
    else:
        intensity = np.ones_like(x)

    w_y, l_y = yv("y_w"), yv("y_l")
    return {
        "u": yy / (l_y * 0.5) * umax,
        "v": xx * np.pi / w_y,
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
        "area": np.where(weft, g("area_weft"), g("area_warp")),
        "norm": g("norm"),
    }


def _rotate_weft(weft, v):
    """Rotate a local direction +90 deg about z for weft lanes
    (irawan.cpp:247-252): (x, y) -> (-y, x)."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return np.stack(
        [np.where(weft, -vy, vx), np.where(weft, vx, vy), vz], axis=-1
    )


def irawan_f(iw, wi, wo, init=False):
    """f(wi, wo) * cos_o (rgb), zero outside the upper hemisphere
    (irawan.cpp eval:189-319).  With init=True, returns the raw
    normalization integrand (scalar; ks/kd/norm excluded) used by
    compute_normalization."""
    ci = wi[..., 2]
    co = wo[..., 2]
    om_i = _rotate_weft(iw["weft"], wi)
    om_r = _rotate_weft(iw["weft"], wo)
    spec = specular_integrand(iw, om_i, om_r)
    spec = spec * iw["intensity"] * iw["area"]
    valid = (ci > 0) & (co > 0)
    if init:
        return np.where(valid, spec, 0.0)
    f = iw["ks"] * (spec * iw["norm"])[..., None] \
        + iw["kd"] * np.float32(1.0 / np.pi)
    return np.where(valid[..., None], f * co[..., None], 0.0)


# ---------------------------------------------------------------------------
# specular normalization (irawan.cpp configure:139-173)
# ---------------------------------------------------------------------------

def compute_normalization(pattern, repeat_u, repeat_v, n=10000, seed=7):
    """Monte-Carlo the average specular response under cosine-weighted
    wi/wo over random uv, and return nSamples / (pi * sum integrand) —
    the reference's normalization so that ks directly scales an
    energy-normalized specular lobe."""
    T = pack_tables([(pattern, repeat_u, repeat_v, 1.0)])
    rng = np.random.default_rng(seed)

    def cosine_dir(u1, u2):
        r = np.sqrt(u1)
        phi = 2.0 * np.pi * u2
        z = np.sqrt(np.maximum(1.0 - u1, 0.0))
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)

    wi = cosine_dir(rng.random(n), rng.random(n)).astype(np.float32)
    wo = cosine_dir(rng.random(n), rng.random(n)).astype(np.float32)
    uv = rng.random((n, 2)).astype(np.float32)
    row = np.zeros(n, np.int32)

    iw = lane_params(T, row, uv, tea_float_np, tables_have_noise(T))
    total = float(irawan_f(iw, wi, wo, init=True).sum())
    if total <= 0.0:
        return 0.0
    return n / (total * np.pi)
