"""The port's Veach-style MLT and ERPT (mitsuba_tpu_torch/integrator/mlt.py)
and the chain integrators' records against the reference
(mitsuba_tpu/integrator/{mlt,plugins}.py) on seeded numpy inputs: the
lens and block perturbations, `propose_veach`, the records' defaults and
property names, and the mlt and erpt renders of cbox (24x24, maxDepth 4,
as the reference's tests/test_mlt.py) and of door (16x16) against the
reference's goldens (tests/make_torch_bigmesh_golden.py).

Tolerances: the perturbed U within 2 ulps (of the largest of U before,
after and the move) where exp and log enter (the step sizes), and the lens
dims within 2.4e-7 (2 ulps of 1.0) where cos and sin enter as well (XLA's
and PyTorch's sin and cos differ in absolute terms near their zeros:
measured up to 8 ulps of a small move); bit-equal past them; a value that
wraps across 0 or 1 is compared on the circle.  The
goldens: tests/torch_meshes.py GOLDEN_GATES."""

import os

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.integrator import mlt as jm
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.integrator import mlt as tm
from mitsuba_tpu_torch.integrator import pssmlt as tp
from mitsuba_tpu_torch.integrator.pssmlt import dims_for
from tests.test_torch_pssmlt import _ulps_on_circle
from tests.torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    cbox_chain_xml,
    door_xml,
    glass_manifold_xml,
    tm_rmse,
    with_integrator,
    with_properties,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(ROOT, "tests", "golden")



def _check_perturbed(out, ref, before):
    ulps = _ulps_on_circle(out, ref, before)
    d = np.abs(out.astype(np.float64) - ref)
    lens = np.zeros(out.shape, bool)
    lens[:, :2] = True
    ok = (ulps <= 2) | (lens & (np.minimum(d, 1.0 - d) <= 2.0 ** -22))
    assert ok.all(), (ulps[~ok], d[~ok])


def _u(n, D, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, D)).astype(np.float32)


@pytest.mark.parametrize("size", [(64, 64), (256, 256), (24, 40)])
def test_perturb_lens(size):
    w, h = size
    U = _u(4096, dims_for(4), 0)
    u4 = _u(4096, 4, 1)
    ref = np.asarray(jm._perturb_lens(jnp.asarray(U), w, h, jnp.asarray(u4)))
    out = tm._perturb_lens(torch.as_tensor(U), w, h, torch.as_tensor(u4)).numpy()
    np.testing.assert_array_equal(out[:, 2:], U[:, 2:])
    _check_perturbed(out, ref, U)
    assert ((out >= 0) & (out < 1)).all()


def test_perturb_block():
    D = dims_for(6)
    U = _u(4096, D, 2)
    r = np.random.default_rng(3)
    k = r.integers(0, 6, 4096).astype(np.int32)
    u_mut, u_sign = _u(4096, 3, 4), _u(4096, 3, 5)
    ref = np.asarray(jm._perturb_block(jnp.asarray(U), jnp.asarray(k), jnp.asarray(u_mut),
                                       jnp.asarray(u_sign)))
    out = tm._perturb_block(torch.as_tensor(U), torch.as_tensor(k.astype(np.int64)),
                            torch.as_tensor(u_mut), torch.as_tensor(u_sign)).numpy()
    moved = out != U
    base = 4 + 8 * k + 3
    cols = np.arange(D)[None, :]
    assert not moved[(cols < base[:, None]) | (cols >= base[:, None] + 3)].any()
    assert _ulps_on_circle(out, ref, U).max() <= 2


@pytest.mark.parametrize("p_large", [0.2, 0.0])
def test_propose_veach(p_large):
    """Each lane's mutation (large, full small, lens, caustic, multi-chain)
    as the reference chooses and computes it, with its RNG keys."""
    n, max_depth = 2048, 4
    D = dims_for(max_depth)
    U = _u(n, D, 6)
    seed_mlt = trng.stream_seed(3, trng.STREAM_MLT)
    for k in (0, 7, 70000):
        ref, large_r = jm.propose_veach(jnp.asarray(U), k, seed_mlt, 32, 24, max_depth, p_large)
        out, large_o = tm.propose_veach(torch.as_tensor(U), k, seed_mlt, 32, 24, max_depth,
                                        p_large)
        np.testing.assert_array_equal(large_o.numpy(), np.asarray(large_r))
        _check_perturbed(out.numpy(), np.asarray(ref), U)
        assert (out.numpy() != U).any(axis=-1).all()
        assert large_o.numpy().any() == (p_large > 0)


# ---- the records ----

def test_records_and_property_names():
    """The chain integrators' records from the XML, defaults and property
    names (pLarge, not door.xml's largeStepProb: neither reads that); the
    properties that no port code reads (twoStage, the direct integrator's
    sample counts) are refused by name unless they hold their defaults."""
    door = door_xml()
    assert "largeStepProb" in door
    xmls = {
        "door": door,
        "mlt": cbox_chain_xml("mlt", luminance_samples=777),
        "erpt": cbox_chain_xml("erpt", chain_length=33),
        "manifold": glass_manifold_xml(),
        "pssmlt_props": door.replace(
            '<float name="largeStepProb" value="0.3"/>',
            '<float name="pLarge" value="0.45"/><integer name="directSamples" value="6"/>'
            '<boolean name="twoStage" value="false"/><boolean name="bidirectional" '
            'value="false"/>'),
        "direct": cbox_chain_xml("direct").replace(
            '<integer name="luminanceSamples" value="1024"/>',
            '<integer name="shadingSamples" value="1"/><integer name="bsdfSamples" value="1"/>'),
    }
    fields = ("kind", "max_depth", "rr_depth", "direct_samples", "bidirectional",
              "luminance_samples", "p_large", "chain_length", "manifold_perturbation")
    for name, xml in xmls.items():
        ref = jload_string(xml).integrator
        out = mt.load_scene_string(xml).integrator
        for f in fields:
            assert getattr(out, f) == getattr(ref, f), (name, f)
    assert jload_string(door).integrator.mutations_per_pixel == tp.MUTATIONS_PER_PIXEL
    out = {n: mt.load_scene_string(x).integrator for n, x in xmls.items()}
    assert out["door"].p_large == 0.3 and out["door"].bidirectional
    assert out["door"].luminance_samples == 100000
    assert out["pssmlt_props"].direct_samples == 6 and not out["pssmlt_props"].bidirectional
    assert out["erpt"].chain_length == 33 and out["manifold"].manifold_perturbation
    refused = {
        "twoStage": xmls["pssmlt_props"].replace('name="twoStage" value="false"',
                                                 'name="twoStage" value="true"'),
        "shadingSamples": xmls["direct"].replace('name="shadingSamples" value="1"',
                                                 'name="shadingSamples" value="3"'),
        "bsdfSamples": xmls["direct"].replace('name="bsdfSamples" value="1"',
                                              'name="bsdfSamples" value="2"'),
    }
    for name, xml in refused.items():
        with pytest.raises(NotImplementedError, match=name):
            mt.load_scene_string(xml)


# ---- one step ----

def test_cbox_one_step():
    """One mlt step (k = 6: Veach proposals, slot 6's accept draws) of 576
    chains from the same bootstrapped state on cbox at 24x24, maxDepth 4,
    the brute-force trace of the cbox golden: the proposals, the
    acceptance ratio where both traces agree (rtol 1e-4), the accept
    decisions (flips counted), the chains' next state, and the film at
    rtol 1e-4 (the splat weights carry a) but for the pixels the off
    lanes splat to.  The cbox golden's
    chains diverge (GOLDEN_GATES): this is the test that holds cbox's
    accept test."""
    from mitsuba_tpu.core import rng as jrng
    from mitsuba_tpu.integrator import pssmlt as jp
    from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
    from mitsuba_tpu.core.spectrum import luminance as jlum
    from mitsuba_tpu_torch.integrator import pssmlt as tps
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from tests.test_torch_pssmlt import TOL_LANE, _lanes_off

    xml = cbox_chain_xml("mlt")
    js, ts = jload_string(xml), mt.load_scene_string(xml)
    jpk, tpk = jpack_scene(js), pack_scene(ts, "cpu")
    n, w, h, max_depth, p_large, k = 576, 24, 24, 4, 0.2, 6
    D = dims_for(max_depth)
    jcam, tcam = js.sensor.record.pack(w, h), ts.sensor.record.pack(w, h, "cpu")
    tr_j = jax.jit(lambda u: jp.path_from_primary(jpk, js.integrator, jcam, w, h, u))

    def tr_t(u):
        return tps.path_from_primary(tpk, ts.integrator, tcam, w, h, u)

    seed_mlt = trng.stream_seed(0, trng.STREAM_MLT)
    U0, _ = tps.bootstrap_chains(tr_t, D, n, 2, 0, seed_mlt, "cpu")
    U0_j = jnp.asarray(U0.numpy())
    lanes_j = jnp.arange(n, dtype=jnp.uint32)
    # the reference's step (mitsuba_tpu/integrator/mlt.py veach_step, _mh_tail)
    U_pr, _ = jm.propose_veach(U0_j, k, seed_mlt, w, h, max_depth, p_large, lanes=lanes_j)
    pos_j, L_j = tr_j(U0_j)
    pos_pj, L_pj = tr_j(U_pr)
    I_j, I_pj = jlum(L_j), jlum(L_pj)
    a_r = jnp.clip(I_pj / jnp.maximum(I_j, 1e-12), 0.0, 1.0)
    film_r = jp._splat(jnp.zeros((h, w, 3), jnp.float32), pos_j,
                       L_j * ((1.0 - a_r) / jnp.maximum(I_j, 1e-12))[:, None], w, h)
    film_r = jp._splat(film_r, pos_pj, L_pj * (a_r / jnp.maximum(I_pj, 1e-12))[:, None], w, h)
    acc_r = np.asarray(jrng.rand4(lanes_j, k, 6, seed_mlt)[:, 1] < a_r)
    U_nr = np.where(acc_r[:, None], np.asarray(U_pr), U0.numpy())
    # the port's
    lanes = torch.arange(n)
    U_po, _ = tm.propose_veach(U0, k, seed_mlt, w, h, max_depth, p_large, lanes=lanes)
    _check_perturbed(U_po.numpy(), np.asarray(U_pr), U0.numpy())
    U_po = torch.tensor(np.asarray(U_pr))  # the same proposals on both sides
    pos_t, L_t = tr_t(U0)
    film, state, a, accept = tm._mh_tail(
        torch.zeros(h, w, 3), (U0, pos_t, L_t, tps._chain_lum(L_t)), U_po, 1.0, k, tr_t,
        seed_mlt, lanes, w, h)
    traced = ~_lanes_off(L_t.numpy(), np.asarray(L_j)) & ~_lanes_off(
        tr_t(U_po)[1].numpy(), np.asarray(L_pj))
    # measured: 1 lane of 576 off (its path diverges, ROADMAP C), 1 flip
    assert (~traced).sum() <= 3, (~traced).sum()
    a_r = np.asarray(a_r)
    np.testing.assert_allclose(a.numpy()[traced], a_r[traced], **TOL_LANE)
    flips = accept.numpy() != acc_r
    assert flips.sum() <= 3, flips.sum()
    assert 0.05 < acc_r.mean() < 0.95 and (a_r[traced] < 1).mean() > 0.05
    np.testing.assert_array_equal(state[0].numpy()[~flips], U_nr[~flips])
    # the film, but for the pixels that the off lanes' tent splats reach
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    near = np.zeros((h, w), bool)
    for x, y in np.concatenate([np.asarray(pos_j)[~traced], np.asarray(pos_pj)[~traced]]):
        near |= (np.abs(xx - x) < 1.5) & (np.abs(yy - y) < 1.5)
    assert near.mean() < 0.05
    np.testing.assert_allclose(film.numpy()[~near], np.asarray(film_r)[~near], **TOL_LANE)


# ---- renders ----

@pytest.mark.parametrize("kind,spp", [("mlt", 8), ("erpt", 1)])
def test_cbox_meets_golden(kind, spp):
    """mlt (8 mutations per pixel, 576 chains: 8 steps) and erpt (one seed
    per pixel, chains of 20 mutations) on cbox at 24x24, maxDepth 4."""
    name = f"torch_cbox_{kind}_24_{spp}.npy"
    xml = cbox_chain_xml(kind, chain_length=20 if kind == "erpt" else None)
    _meets(name, xml, spp, (24, 24, 3))


@pytest.mark.parametrize("kind,spp", [("mlt", 4), ("erpt", 1)])
def test_door_meets_golden(kind, spp):
    """mlt (4 mutations per pixel, 256 chains) and erpt (one seed per
    pixel, chains of 8 mutations) on scenes/door.xml at 16x16, maxDepth 8,
    luminanceSamples 1,024."""
    xml = with_integrator(door_xml(16, 16, luminance_samples=1024), kind)
    if kind == "erpt":
        xml = with_properties(xml, '<integer name="chainLength" value="8"/>')
    _meets(f"torch_door_{kind}_16_{spp}.npy", xml, spp, (16, 16, 3))


def _meets(name, xml, spp, shape):
    golden = np.load(os.path.join(GOLDEN, name))
    out = mt.render(mt.load_scene_string(xml), spp=spp, seed=0, device="cpu")
    assert out.shape == golden.shape == shape
    assert np.isfinite(out).all() and out.mean() > 0.02
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
