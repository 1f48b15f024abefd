"""The port's media against the reference on the same seeded numpy inputs:
the `.vol` reader, the medium tables of the pack, the phase functions,
transmittance and distance sampling, and the fiber phases and volumes
the port once refused (tests/test_torch_fiber.py holds their functions).

Tolerances:

* load_vol, the pack's medium tables and meta: equal, bit for bit (the
  bfloat16 corner rows compared as float32);
* phase eval, pdf and sample (isotropic, HG g in {-0.7, 0, 0.3},
  Rayleigh, a 3-leaf mixture): rtol 1e-5, atol 1e-6 (the Rayleigh
  inversion takes a power where the reference takes a cube root);
* transmittance (closed form, Simpson): rtol 1e-5;
* ratio tracking and sample_distance (homogeneous under each strategy,
  heterogeneous) on 4,096 lanes: the decision (is_medium; a ratio
  weight's survival) equal on at least 99.9 % of lanes, t and weight at
  rtol 1e-4 where it agrees.  XLA contracts products into FMAs and sums
  the candidates' jumps in its own order, so a lane whose acceptance
  u_acc < frac sits within a few ulp of its threshold may decide the
  other way; each such lane is printed with its margin |u_acc - frac|.
  Measured: every lane agrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.medium import eval as jme
from mitsuba_tpu.medium import plugins as jmp
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import lanes, rng
from mitsuba_tpu_torch.medium import eval as tme
from mitsuba_tpu_torch.medium import plugins as tmp
from mitsuba_tpu_torch.medium.plugins import HG, ISOTROPIC, KKAY, MICROFLAKE, RAYLEIGH
from mitsuba_tpu_torch.scene.builder import (
    MEDIA_ARRAYS,
    MEDIA_META,
    ScenePack,
    pack_from_numpy,
    pack_scene,
)
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.torch_meshes import SMOKE_XML, smoke_xml

torch.set_num_threads(1)

N = 4096
VOL = SMOKE_XML.replace("smoke.xml", "assets/smoke.vol")


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _packs(xml):
    jp = jpack_scene(jload_string(xml))
    tp = pack_scene(load_scene_string(xml), "cpu")
    return jp, tp


# five spheres, each with a null boundary and a homogeneous medium under
# another free-path strategy (tests/test_medium_strategies.py's set), and
# a mixture phase in the last; seen from outside under a constant light
_STRATS = [
    '<string name="strategy" value="balance"/>',
    '<string name="strategy" value="single"/>',
    '<string name="strategy" value="single"/><integer name="channel" value="2"/>',
    '<string name="strategy" value="manual"/><float name="samplingDensity" value="0.7"/>',
    '<string name="strategy" value="maximum"/>',
]
HOMOGENEOUS_XML = """
<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="8"/></integrator>
  <sensor type="perspective"><float name="fov" value="60"/>
    <transform name="toWorld"><lookat origin="0,0,-9" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="hdrfilm"><integer name="width" value="16"/><integer name="height" value="16"/>
      <rfilter type="gaussian"/></film></sensor>
  {spheres}
  <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""
_MIX = ('<phase type="mixturephase"><string name="weights" value="0.5 0.3 0.2"/>'
        '<phase type="hg"><float name="g" value="0.6"/></phase><phase type="rayleigh"/>'
        '<phase type="isotropic"/></phase>')


def homogeneous_xml():
    spheres = "".join(
        f'<shape type="sphere"><point name="center" x="{2.2 * (i - 2)}" y="0" z="0"/>'
        f'<float name="radius" value="1"/><bsdf type="null"/>'
        f'<medium name="interior" type="homogeneous">'
        f'<rgb name="sigmaS" value="0.6, 0.9, 0.3"/><rgb name="sigmaA" value="0.2, 0.5, 1.4"/>'
        f'{s}{_MIX if i == 4 else ""}</medium></shape>'
        for i, s in enumerate(_STRATS)
    )
    return HOMOGENEOUS_XML.format(spheres=spheres)


@pytest.fixture(scope="module")
def smoke_packs():
    return _packs(smoke_xml(16, 16))


@pytest.fixture(scope="module")
def woodcock_packs():
    """scenes/smoke.xml with method "woodcock": ratio-tracking shadows."""
    return _packs(smoke_xml(16, 16).replace('value="simpson"', 'value="woodcock"'))


@pytest.fixture(scope="module")
def hom_packs():
    return _packs(homogeneous_xml())


def test_load_vol_equals_reference():
    ref, out = jmp.load_vol(VOL), tmp.load_vol(VOL)
    assert out.grid.shape == ref.grid.shape == (48, 48, 48, 1)
    np.testing.assert_array_equal(out.grid, ref.grid)
    np.testing.assert_array_equal(out.aabb_min, ref.aabb_min)
    np.testing.assert_array_equal(out.aabb_max, ref.aabb_max)


@pytest.mark.parametrize("name", ["smoke", "smoke_woodcock", "homogeneous"])
def test_medium_tables_equal_reference(name, smoke_packs, woodcock_packs, hom_packs):
    jp, tp = {"smoke": smoke_packs, "smoke_woodcock": woodcock_packs,
              "homogeneous": hom_packs}[name]
    for k in MEDIA_ARRAYS:
        np.testing.assert_array_equal(_tnp(tp.arrays[k]), _np(jp.arrays[k]), err_msg=k)
    for k in MEDIA_META:
        assert tp.meta[k] == jp.meta[k], k
    if name.startswith("smoke"):
        assert tp.het_corners.dtype == torch.bfloat16
        assert tp.meta["n_het"] == 1 and tp.meta["phase_kinds"] == (HG,)
        assert tp.meta["het_simpson"] == (name == "smoke")
    else:
        assert tp.meta["hom_strategies"] == (0, 1, 2)
        assert (tp.sph_med_in >= 0).all() and (tp.sph_med_ex == -1).all()


def test_reference_pack_converts(smoke_packs):
    """A reference pack with media (bfloat16 corners included) converts."""
    jp, tp = smoke_packs
    conv = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    for k in MEDIA_ARRAYS:
        assert conv.arrays[k].dtype == tp.arrays[k].dtype, k
        np.testing.assert_array_equal(_tnp(conv.arrays[k]), _tnp(tp.arrays[k]), err_msg=k)


def test_het_bf16_knob(monkeypatch):
    """MTS_HET_BF16=0 keeps the float32 grid on both sides."""
    monkeypatch.setenv("MTS_HET_BF16", "0")
    jp, tp = _packs(smoke_xml(8, 8))
    assert tp.het_corners.dtype == torch.float32
    np.testing.assert_array_equal(tp.het_corners.numpy(), _np(jp.het_corners))
    np.testing.assert_array_equal(tp.het_super.numpy(), _np(jp.het_super))


@pytest.mark.parametrize("xml", [
    '<phase type="kkay"/>',
    '<phase type="microflake"/>',
    '<volume type="hgridvolume"/>',
    '<volume type="volcache"/>',
])
def test_unported_medium_plugins_raise(xml, tmp_path):
    """The plugins the port refused before the fiber phases and volumes
    were ported now load, as the reference loads them: each phase (its
    defaults) in a homogeneous medium, each volume as a heterogeneous
    medium's density (hgridvolume over smoke.vol split into 2 x 2 x 2
    blocks, volcache around smoke.vol's gridvolume)."""
    from tests.torch_meshes import fiber_assets

    name = xml.split('"')[1]
    if xml.startswith("<phase"):
        medium = f'<medium name="interior" type="homogeneous">{xml}</medium>'
    else:
        d = fiber_assets(str(tmp_path))
        inner = {
            "hgridvolume": f'<string name="filename" value="{d}/smoke.hgrid"/>'
                           '<string name="prefix" value="smoke_"/>'
                           '<string name="postfix" value=".vol"/>',
            "volcache": f'<volume type="gridvolume"><string name="filename" value="{VOL}"/>'
                        '</volume>',
        }[name]
        medium = (f'<medium name="interior" type="heterogeneous"><volume name="density" '
                  f'type="{name}">{inner}</volume></medium>')
    text = (f'<scene version="0.5.0"><sensor type="perspective"/><shape type="cube">'
            f'<bsdf type="null"/>{medium}</shape></scene>')
    t = load_scene_string(text).shapes[0].interior_medium
    j = jload_string(text).shapes[0].interior_medium
    for f in ("kind", "ks", "kd", "exponent", "knorm", "stddev", "flake_norm"):
        assert getattr(t.phase, f) == getattr(j.phase, f), f
    np.testing.assert_array_equal(t.phase.flake_sigt, j.phase.flake_sigt)
    if xml.startswith("<volume"):
        np.testing.assert_array_equal(t.density.grid, j.density.grid)
        np.testing.assert_array_equal(t.density.aabb_min, j.density.aabb_min)
        np.testing.assert_array_equal(t.density.aabb_max, j.density.aabb_max)
    else:
        assert t.phase.kind == {"kkay": KKAY, "microflake": MICROFLAKE}[name]


@pytest.mark.parametrize("kind,name", [(KKAY, "kkay"), (MICROFLAKE, "microflake")])
def test_fiber_phase_packs_refused(smoke_packs, kind, name, tmp_path):
    """A reference pack with a fiber phase, refused before the fiber
    phases were ported, converts, and its medium tables equal the port's
    own pack of the same scene (FIBER's medium on its orientation
    volume)."""
    from tests.torch_meshes import fiber_assets, fiber_xml

    xml = fiber_xml(name, fiber_assets(str(tmp_path)), "grid", 8, 8)
    jp, tp = _packs(xml)
    assert jp.meta["phase_kinds"] == (kind,)
    conv = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    for k in MEDIA_ARRAYS:
        np.testing.assert_array_equal(_tnp(conv.arrays[k]), _tnp(tp.arrays[k]), err_msg=k)


def test_media_loaded_and_attached():
    """A top-level medium referenced by a shape, and nested interior /
    exterior media, reach the shapes as in the reference."""
    xml = """<scene version="0.5.0"><sensor type="perspective"/>
      <medium type="homogeneous" id="fog"><float name="scale" value="2"/></medium>
      <shape type="sphere"><bsdf type="null"/><ref name="exterior" id="fog"/>
        <medium name="interior" type="homogeneous"><phase type="hg"/></medium></shape>
      <shape type="cube"><ref id="fog"/></shape></scene>"""
    t, j = load_scene_string(xml), jload_string(xml)
    assert set(t.media) == set(j.media) == {"fog"}
    for a, b in zip(t.shapes, j.shapes):
        for side in ("interior_medium", "exterior_medium"):
            ra, rb = getattr(a, side), getattr(b, side)
            assert (ra is None) == (rb is None), side
            if ra is not None:
                np.testing.assert_array_equal(ra.sigma_s, rb.sigma_s)
                np.testing.assert_array_equal(ra.sigma_a, rb.sigma_a)
                assert ra.phase.kind == rb.phase.kind and ra.phase.g == rb.phase.g
    assert t.shapes[0].exterior_medium is t.media["fog"]


# ---- phase functions -------------------------------------------------------

# one medium per phase: isotropic, HG at three g, Rayleigh, a 3-leaf mixture
_PHASES = [
    [(ISOTROPIC, 0.0, 1.0)], [(HG, -0.7, 1.0)], [(HG, 0.0, 1.0)], [(HG, 0.3, 1.0)],
    [(RAYLEIGH, 0.0, 1.0)], [(HG, 0.6, 0.5), (RAYLEIGH, 0.0, 0.3), (ISOTROPIC, 0.0, 0.2)],
]


class _JaxPack:
    def __init__(self, arrays, meta):
        self.__dict__.update({k: jnp.asarray(v) for k, v in arrays.items()})
        self.meta = meta


@pytest.fixture(scope="module")
def phase_packs():
    c = tmp.MAX_PHASE_COMPONENTS
    n = len(_PHASES)
    kinds = np.full((n, c), -1, np.int32)
    gs = np.zeros((n, c), np.float32)
    ws = np.zeros((n, c), np.float32)
    for i, leaves in enumerate(_PHASES):
        for ci, (k, g, w) in enumerate(leaves):
            kinds[i, ci], gs[i, ci], ws[i, ci] = k, g, w
    arrays = {"med_ph_kinds": kinds, "med_ph_gs": gs, "med_ph_ws": ws,
              "med_phase": kinds[:, 0].copy()}
    meta = {"phase_kinds": tuple(sorted({int(k) for k in kinds.ravel() if k >= 0}))}
    tp = ScenePack({k: torch.as_tensor(v) for k, v in arrays.items()}, meta)
    return _JaxPack(arrays, meta), tp


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _close(out, ref, rtol, atol=0.0):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_phase_eval_pdf_sample(phase_packs):
    jp, tp = phase_packs
    g = np.random.default_rng(3)
    med = g.integers(-1, len(_PHASES), N).astype(np.int32)
    d_in, d_out = _dirs(N, 4), _dirs(N, 5)
    u2 = g.uniform(size=(N, 2)).astype(np.float32)
    tm, ti, to = (torch.as_tensor(x) for x in (med, d_in, d_out))
    jm, ji, jo = (jnp.asarray(x) for x in (med, d_in, d_out))
    _close(tme.phase_eval(tp, tm, ti, to), jme.phase_eval(jp, jm, ji, jo), 1e-5, 1e-6)
    _close(tme.phase_pdf(tp, tm, ti, to), jme.phase_pdf(jp, jm, ji, jo), 1e-5, 1e-6)
    out = tme.phase_sample(tp, tm, ti, torch.as_tensor(u2))
    ref = jme.phase_sample(jp, jm, ji, jnp.asarray(u2))
    for a, b in zip(out, ref):
        _close(a, b, 1e-5, 1e-6)
    # each kind was drawn, and every sampled direction is a unit vector
    for i in range(len(_PHASES)):
        assert (med == i).sum() > 500
    np.testing.assert_allclose(np.linalg.norm(out[0].numpy(), axis=-1), 1.0, atol=1e-5)


def test_phase_warps():
    """square_to_phase_hg (and its pdf) and square_to_tent."""
    from mitsuba_tpu.core import warp as jwarp
    from mitsuba_tpu_torch.core import warp as twarp

    u = np.random.default_rng(6).uniform(size=(N, 2)).astype(np.float32)
    c = np.random.default_rng(7).uniform(-1, 1, N).astype(np.float32)
    for g in (-0.7, 0.0, 0.3, 0.9):
        _close(twarp.square_to_phase_hg(torch.as_tensor(u), g),
               jwarp.square_to_phase_hg(jnp.asarray(u), g), 1e-5, 1e-6)
        _close(twarp.square_to_phase_hg_pdf(torch.as_tensor(c), g),
               jwarp.square_to_phase_hg_pdf(jnp.asarray(c), g), 1e-5, 1e-6)
    _close(twarp.square_to_tent(torch.as_tensor(u)), jwarp.square_to_tent(jnp.asarray(u)),
           1e-6, 1e-7)


# ---- transmittance and distance sampling -----------------------------------

def _rays(seed, lo=(-0.6, -0.1, -0.6), hi=(0.6, 1.1, 0.6), n=N):
    """Seeded rays about the smoke's box (or the spheres, scaled)."""
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = _dirs(n, seed + 100)
    t_max = g.uniform(0.05, 2.0, n).astype(np.float32)
    u3 = g.uniform(size=(n, 3)).astype(np.float32)
    lane = np.arange(n, dtype=np.int64)
    sidx = g.integers(0, 64, n).astype(np.int64)
    return o, d, t_max, u3, lane, sidx


def _both(fn_t, fn_j, tp, jp, med, o, d, *rest, lane, sidx, slot, seed=0):
    t = fn_t(tp, torch.as_tensor(med), torch.as_tensor(o), torch.as_tensor(d),
             *(torch.as_tensor(x) for x in rest), torch.as_tensor(lane), torch.as_tensor(sidx),
             slot, seed)
    j = fn_j(jp, jnp.asarray(med), jnp.asarray(o), jnp.asarray(d),
             *(jnp.asarray(x) for x in rest), jnp.asarray(lane.astype(np.uint32)),
             jnp.asarray(sidx.astype(np.uint32)), slot, seed)
    return t, j


def _margin(tp, med, o, d, t_max, lane, sidx, slot, seed_t, ratio):
    """min |u_acc - frac| over the tracking candidates of one lane (the
    port's own run), to print beside a lane whose decision differs."""
    seen = []
    inner_d, inner_s = tme._het_density_q, tme._super_lookup

    def dens(pack, hp, q):
        out = inner_d(pack, hp, q)
        seen.append(["dens", out])
        return out

    def sup(pack, hp, q, b):
        out = inner_s(pack, hp, q, b)
        seen.append(["sig", out[0]])
        return out

    tme._het_density_q, tme._super_lookup = dens, sup
    try:
        m = torch.as_tensor(med[None])
        hp = tme._het_params(tp, m)
        tme._het_track(tp, hp, torch.as_tensor(o[None]), torch.as_tensor(d[None]),
                       torch.as_tensor(t_max[None]), torch.as_tensor(lane[None]),
                       torch.as_tensor(sidx[None]), slot, seed_t, ratio)
    finally:
        tme._het_density_q, tme._super_lookup = inner_d, inner_s
    k, n4, margins = tme.TRACK_BATCH, (tme.TRACK_BATCH + 3) // 4, []
    for step in range(len(seen) // 2):
        sig, dens_k = seen[2 * step][1], seen[2 * step + 1][1]
        u_acc = torch.cat([rng.rand4(int(lane), int(sidx), slot * tme.MAX_TRACKING_STEPS
                                     + (2 * step + 1) * n4 + j, seed_t) for j in range(n4)],
                          dim=-1)[:k]
        margins.append((u_acc - dens_k[0] / torch.clamp(sig[0], min=1e-20)).abs().min())
    return float(min(margins)) if margins else float("nan")


def _check_decisions(name, dec_t, dec_j, pairs, margin_fn):
    agree = dec_t == dec_j
    for i in np.nonzero(~agree)[0]:
        print(f"{name}: lane {i} decides {dec_t[i]} (reference {dec_j[i]}), "
              f"margin |u_acc - frac| {margin_fn(i):.3g}")
    assert agree.mean() >= 0.999, f"{name}: {agree.mean():.5f} of lanes agree"
    for out, ref in pairs:
        np.testing.assert_allclose(out[agree], ref[agree], rtol=1e-4, atol=1e-6)
    return agree


def test_simpson_transmittance(smoke_packs):
    jp, tp = smoke_packs
    o, d, t_max, _, lane, sidx = _rays(11)
    med = np.random.default_rng(12).integers(-1, 1, N).astype(np.int32)
    t, j = _both(tme.transmittance, jme.transmittance, tp, jp, med, o, d, t_max,
                 lane=lane, sidx=sidx, slot=3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
    assert (t.numpy()[med == 0] < 0.99).mean() > 0.3  # the rays do cross smoke
    np.testing.assert_array_equal(t.numpy()[med < 0], 1.0)


def test_quad_steps_knob(smoke_packs, monkeypatch):
    """MTS_QUAD_STEPS (read at import, as the reference reads it) sets
    the Simpson intervals on both sides."""
    jp, tp = smoke_packs
    monkeypatch.setattr(tme, "QUAD_STEPS", 8)
    monkeypatch.setattr(jme, "QUAD_STEPS", 8)
    o, d, t_max, _, lane, sidx = _rays(13, n=512)
    med = np.zeros(512, np.int32)
    t, j = _both(tme.transmittance, jme.transmittance, tp, jp, med, o, d, t_max,
                 lane=lane, sidx=sidx, slot=3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)


def test_ratio_tracking(woodcock_packs):
    jp, tp = woodcock_packs
    o, d, t_max, _, lane, sidx = _rays(14)
    med = np.random.default_rng(15).integers(-1, 1, N).astype(np.int32)
    t, j = _both(tme.transmittance, jme.transmittance, tp, jp, med, o, d, t_max,
                 lane=lane, sidx=sidx, slot=9)
    t, j = t.numpy(), np.asarray(j)
    seed_t = rng.stream_seed(0, rng.STREAM_MEDIUM_TRANS)
    _check_decisions("ratio tracking", t[:, 0] > 0, j[:, 0] > 0, [(t, j)],
                     lambda i: _margin(tp, med[i], o[i], d[i], t_max[i], lane[i], sidx[i],
                                       9, seed_t, True))
    assert ((t[:, 0] > 0) & (t[:, 0] < 0.99)).mean() > 0.2  # ratios, not just 0 and 1


def test_sample_distance_heterogeneous(smoke_packs):
    jp, tp = smoke_packs
    o, d, t_max, u3, lane, sidx = _rays(16)
    med = np.random.default_rng(17).integers(-1, 1, N).astype(np.int32)
    t, j = _both(tme.sample_distance, jme.sample_distance, tp, jp, med, o, d, t_max, u3,
                 lane=lane, sidx=sidx, slot=5)
    seed_t = rng.stream_seed(0, rng.STREAM_MEDIUM_DIST)
    agree = _check_decisions(
        "delta tracking", t.is_medium.numpy(), np.asarray(j.is_medium),
        [(t.t.numpy(), np.asarray(j.t)), (t.weight.numpy(), np.asarray(j.weight))],
        lambda i: _margin(tp, med[i], o[i], d[i], t_max[i], lane[i], sidx[i], 5, seed_t, False))
    hits = t.is_medium.numpy()
    assert 0.2 < hits[med == 0].mean() < 0.9 and not hits[med < 0].any()
    # the margin printed beside a disagreeing lane, on a lane that tracks
    i = int(np.nonzero(agree & hits)[0][0])
    assert 0.0 <= _margin(tp, med[i], o[i], d[i], t_max[i], lane[i], sidx[i], 5, seed_t,
                          False) < 1.0


def test_sample_distance_homogeneous(hom_packs):
    """Every strategy (one sphere each), and vacuum lanes."""
    jp, tp = hom_packs
    o, d, t_max, u3, lane, sidx = _rays(18, lo=(-5.5, -1.0, -1.0), hi=(5.5, 1.0, 1.0))
    med = np.random.default_rng(19).integers(-1, 5, N).astype(np.int32)
    t, j = _both(tme.sample_distance, jme.sample_distance, tp, jp, med, o, d, t_max * 2, u3,
                 lane=lane, sidx=sidx, slot=2)
    _check_decisions(
        "homogeneous", t.is_medium.numpy(), np.asarray(j.is_medium),
        [(t.t.numpy(), np.asarray(j.t)), (t.weight.numpy(), np.asarray(j.weight))],
        lambda i: float(abs(u3[i, 0] - tp.med_sampling_w[max(med[i], 0)])))
    for m in range(5):
        assert 0.05 < t.is_medium.numpy()[med == m].mean() < 0.95, m
    tt, tj = _both(tme.transmittance, jme.transmittance, tp, jp, med, o, d, t_max,
                   lane=lane, sidx=sidx, slot=2)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fn", ["sample_distance", "ratio"])
def test_tracking_exit_checks(smoke_packs, woodcock_packs, monkeypatch, fn):
    """The tracking loop gives the same output with its exit checked every
    iteration and every 8."""
    jp, tp = smoke_packs if fn == "sample_distance" else woodcock_packs
    o, d, t_max, u3, lane, sidx = (torch.as_tensor(x) for x in _rays(20, n=1024))
    med = torch.zeros(1024, dtype=torch.int32)
    outs = []
    for every in (1, 8):
        monkeypatch.setattr(lanes, "EXIT_CHECK_EVERY", every)
        if fn == "sample_distance":
            outs.append(tme.sample_distance(tp, med, o, d, t_max, u3, lane, sidx, 4, 0))
        else:
            outs.append([tme.transmittance(tp, med, o, d, t_max, lane, sidx, 4, 0)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
