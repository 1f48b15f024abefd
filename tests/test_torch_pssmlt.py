"""The port's PSSMLT (mitsuba_tpu_torch/integrator/pssmlt.py) against the
reference (mitsuba_tpu/integrator/pssmlt.py) on seeded numpy inputs:
Kelemen's mutation, the tent splat, the bootstrap's seed resampling,
`path_from_primary` on cbox and door, the chain re-trace on door
(unidirectional, and bidirectional at maxDepth 3), one Metropolis step
from the same state, the direct component, and door's renders against the
reference's goldens (tests/make_torch_bigmesh_golden.py).

Tolerances.  The mutation: U within 2 ulps (of the largest of U before,
after and the step) where exp enters (the step size: XLA's and PyTorch's exp differ in
the last place on 9 % of the draws; measured: 0.3 % of the values differ,
by at most 2 such ulps), bit-equal past it; a value that wraps across 0
or 1 is compared on the circle.  The splat: rtol 1e-5, atol 1e-6 (the adds' order).  A traced
lane: rtol 1e-4, atol 1e-6, but for the lanes whose paths diverge in the
last places of log, cos and rsqrt (ROADMAP C, "cbox 7.8e-4 / 8.6e-4, not
0"), counted.  The step: proposals bit-equal, the acceptance ratio a at
rtol 1e-4 where the traces agree, and the accept decisions that flip
counted.  The goldens: tests/torch_meshes.py GOLDEN_GATES.

The reference traces door through its XLA BVH walk here (jitted: its
pair pipeline's interpret-mode kernels take 3-4x the compile); the port
through its pair pipeline.  door's clutter cube has a face in the floor's
plane, an exact-t tie the two break differently (ROADMAP C), but no lane
of these batches reaches it.  The goldens come from the reference's pair
pipeline."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.integrator import pssmlt as jp
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.integrator import pssmlt as tp
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    CBOX_XML,
    GOLDEN_GATES,
    ROOT,
    door_xml,
    tm_rmse,
    with_integrator,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
TOL_LANE = dict(rtol=1e-4, atol=1e-6)
N = 1024  # chains of the function-level tests
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _packs(xml):
    js, ts = jload_string(xml), mt.load_scene_string(xml)
    return js, jpack_scene(js), ts, pack_scene(ts, "cpu")



def _lanes_off(out, ref):
    """Lanes whose [N, ...] values differ beyond TOL_LANE."""
    bad = ~np.isclose(out, ref, **TOL_LANE)
    return bad.reshape(bad.shape[0], -1).any(axis=-1)


def _ulps_on_circle(out, ref, before):
    """The distance of perturbed values in [0, 1), taken across the wrap, in
    ulps of the largest operand: the value before, the value after, or the
    move (a move that differs in its last place shifts a smaller sum by
    more ulps of its own)."""
    def circ(x):
        x = np.abs(x)
        return np.minimum(x, 1.0 - x)

    out, ref, before = (x.astype(np.float64) for x in (out, ref, before))
    scale = np.maximum.reduce([np.abs(ref), np.abs(out), np.abs(before), circ(ref - before)])
    return circ(out - ref) / np.spacing(scale.astype(np.float32))


@pytest.fixture(scope="module")
def door3():
    """door at 16x16 and maxDepth 3 (the bidirectional chunk's
    compile on the reference side stays small)."""
    xml = door_xml(16, 16, luminance_samples=512).replace(
        'name="maxDepth" value="8"', 'name="maxDepth" value="3"')
    return _packs(xml)


def _traces(door3, bidirectional):
    """The chain re-trace of door3 on both sides (the reference's jitted):
    (reference, port, D, S, the port's arguments)."""
    js, jpk, ts, tpk = door3
    js.integrator.bidirectional = ts.integrator.bidirectional = bidirectional
    args_t = (tpk, ts.integrator, ts.sensor.record, ts.sensor.record.pack(16, 16, "cpu"), 16, 16)
    tr_j, D, S = jp.make_chain_trace(jpk, js.integrator, js.sensor.record,
                                     js.sensor.record.pack(16, 16), 16, 16)
    tr_t, D_t, S_t = tp.make_chain_trace(*args_t)
    assert (D_t, S_t) == (D, S)
    return jax.jit(tr_j), tr_t, D, S, args_t


@pytest.fixture(scope="module")
def uni3(door3):
    return _traces(door3, False)


# ---- the mutation and the splat ----

def test_kelemen_mutate():
    r = np.random.default_rng(0)
    n, D = 4096, 28
    U, u_mut, u_sign = (r.uniform(0, 1, (n, D)).astype(np.float32) for _ in range(3))
    U[:8, :] = np.float32(1.0 - 2 ** -24)  # next to the wrap
    U[8:16, :] = 0.0
    ref = np.asarray(jp._kelemen_mutate(*map(jnp.asarray, (U, u_mut, u_sign))))
    out = tp._kelemen_mutate(*map(torch.as_tensor, (U, u_mut, u_sign))).numpy()
    assert ((out >= 0) & (out < 1)).all()
    ulps = _ulps_on_circle(out, ref, U)
    assert ulps.max() <= 2, ulps.max()
    assert (ulps > 0).mean() < 0.01


def test_splat_edges():
    """Positions inside, on the film's edges and outside it, and
    positions a masked splat zeroed (as the chain re-trace zeroes them)."""
    r = np.random.default_rng(1)
    w, h, n = 20, 12, 5000
    pos = np.stack([r.uniform(-1.5, w + 1.5, n), r.uniform(-1.5, h + 1.5, n)], -1)
    pos = pos.astype(np.float32)
    pos[:40] = np.array([[0, 0], [w, h], [w - 0.5, h - 0.5], [0.5, 0.5]] * 10, np.float32)
    val = r.uniform(0, 2, (n, 3)).astype(np.float32)
    ok = r.uniform(size=n) > 0.2
    pos[~ok] = np.nan
    pos_j = jnp.where(jnp.asarray(ok)[:, None], jnp.asarray(pos), 0.0)
    val_j = jnp.where(jnp.asarray(ok)[:, None], jnp.asarray(val), 0.0)
    ref = np.asarray(jp._splat(jnp.zeros((h, w, 3), jnp.float32), pos_j, val_j, w, h))
    ok_t = torch.as_tensor(ok)[:, None]
    out = tp._splat(torch.zeros(h, w, 3), torch.where(ok_t, torch.as_tensor(pos), 0.0),
                    torch.where(ok_t, torch.as_tensor(val), 0.0), w, h).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out.sum(), val[ok].sum(), rtol=1e-4)


# ---- the bootstrap ----

def test_bootstrap_chains_same_luminance():
    """On one given luminance per sample (a function of U that both sides
    compute exactly), the same seeds and the same b_norm."""
    n, D, batches = 512, 12, 3
    seed_t = trng.stream_seed(5, trng.STREAM_MLT)
    seed_j = jrng.stream_seed(5, jrng.STREAM_MLT)
    assert seed_t == int(seed_j)

    def trace_j(U):
        return U[:, 0:2], jnp.stack([U[:, 3], 0.0 * U[:, 3], 0.0 * U[:, 3]], -1)

    def trace_t(U):
        return U[:, 0:2], torch.stack([U[:, 3], 0.0 * U[:, 3], 0.0 * U[:, 3]], -1)

    U_r, b_r = jp.bootstrap_chains(trace_j, D, n, batches, 5, seed_j)
    U_o, b_o = tp.bootstrap_chains(trace_t, D, n, batches, 5, seed_t, "cpu")
    assert b_o == b_r
    np.testing.assert_array_equal(U_o.numpy(), np.asarray(U_r))


def test_bootstrap_chains_on_door(uni3):
    """door's own luminances (unidirectional re-trace): b_norm at rtol
    1e-5, and the seeds chosen, with the choices that a last-place
    difference in a luminance moves counted."""
    tr_j, tr_t, D, _, _ = uni3
    assert D == jp.dims_for(3)
    seed_mlt = trng.stream_seed(0, trng.STREAM_MLT)
    U_r, b_r = jp.bootstrap_chains(tr_j, D, N, 2, 0, seed_mlt)
    U_o, b_o = tp.bootstrap_chains(tr_t, D, N, 2, 0, seed_mlt, "cpu")
    assert b_r > 0
    np.testing.assert_allclose(b_o, b_r, rtol=1e-5)
    moved = (U_o.numpy() != np.asarray(U_r)).any(axis=-1)
    assert moved.sum() <= 2, moved.sum()


# ---- path_from_primary and the chain re-trace ----

@pytest.mark.parametrize("scene", ["cbox", "door"])
def test_path_from_primary(scene):
    """16x16; U uniform; directSamples -1 (everything in the chains) and
    2 (the chains cover paths past 2 edges)."""
    if scene == "cbox":
        with open(CBOX_XML) as f:
            xml = with_integrator(f.read(), "pssmlt", max_depth=4)
        xml = xml.replace('value="512"', 'value="16"')
    else:
        xml = door_xml(16, 16)
    js, jpk, ts, tpk = _packs(xml)
    js.sensor.record.film.width = js.sensor.record.film.height = 16
    ts.sensor.record.film.width = ts.sensor.record.film.height = 16
    D = jp.dims_for(js.integrator.max_depth)
    U = np.random.default_rng(2).uniform(0, 1, (512, D)).astype(np.float32)
    for ds in (-1, 2):
        js.integrator.direct_samples = ts.integrator.direct_samples = ds
        p_r, L_r = jax.jit(lambda u: jp.path_from_primary(
            jpk, js.integrator, js.sensor.record.pack(16, 16), 16, 16, u))(jnp.asarray(U))
        stats = {"rays": 0}
        p_o, L_o = tp.path_from_primary(tpk, ts.integrator, ts.sensor.record.pack(16, 16, "cpu"),
                                        16, 16, torch.as_tensor(U), stats=stats)
        np.testing.assert_array_equal(p_o.numpy(), np.asarray(p_r))
        L_r = np.asarray(L_r)
        # cbox: 1 lane of 512 diverges (measured)
        assert _lanes_off(L_o.numpy(), L_r).sum() <= 2
        assert (L_r.max(-1) > 0).mean() > (0.3 if scene == "cbox" else 0.03)
        assert int(stats["rays"]) > 512


def test_chain_trace_unidirectional(uni3):
    tr_j, tr_t, D, S, _ = uni3
    assert (D, S) == (jp.dims_for(3), 1)
    U = np.random.default_rng(3).uniform(0, 1, (N, D)).astype(np.float32)
    p_r, v_r = tr_j(jnp.asarray(U))
    p_o, v_o = tr_t(torch.as_tensor(U))
    assert p_o.shape == (N, 1, 2) and v_o.shape == (N, 1, 3)
    np.testing.assert_array_equal(p_o.numpy(), np.asarray(p_r))
    assert _lanes_off(v_o.numpy(), np.asarray(v_r)).sum() <= 1
    assert int(tr_t.stats["rays"]) > N


def test_chain_trace_bidirectional(door3):
    """The bidirectional re-trace (maxDepth 3: 1 + 3 splats a sample):
    positions and values of every splat, masked splats zeroed; and
    `bidirectional` off selects the unidirectional technique."""
    tr_j, tr_t, D, S, args_t = _traces(door3, True)
    assert S == 4
    U = np.random.default_rng(4).uniform(0, 1, (N, D)).astype(np.float32)
    p_r, v_r = map(np.asarray, tr_j(jnp.asarray(U)))
    p_o, v_o = (x.numpy() for x in tr_t(torch.as_tensor(U)))
    assert np.isfinite(p_o).all() and np.isfinite(v_o).all()
    assert _lanes_off(v_o, v_r).sum() <= 2
    live = (v_r.max(-1) > 0) & (v_o.max(-1) > 0)
    np.testing.assert_allclose(p_o[live], p_r[live], rtol=1e-5, atol=1e-4)
    assert (v_r[:, 1:].max(-1) > 0).any(), "no light-image splat"
    assert int(tr_t.stats["rays"]) > N
    uni = dataclasses.replace(args_t[1], bidirectional=False)
    assert tp.make_chain_trace(args_t[0], uni, *args_t[2:])[1:] == (jp.dims_for(3), 1)


# ---- one Metropolis step ----

def _reference_step(trace, U_cur, pos_cur, L_cur, I_cur, k, lanes, seed_mlt, p_large, w, h):
    """The reference's step (mitsuba_tpu/integrator/pssmlt.py:449-495), from
    its own functions; returns (U_prop, L_prop, a, accept, film, the new
    U)."""
    n, D = U_cur.shape
    u_ctl = jrng.rand4(lanes, k, 1, seed_mlt)
    dim_l = (lanes[:, None] * D + jnp.arange(D, dtype=jnp.uint32)[None, :]).reshape(-1)
    um = jrng.rand4(dim_l, k, 2, seed_mlt)
    U_small = jp._kelemen_mutate(U_cur, um[:, 0].reshape(n, D), um[:, 1].reshape(n, D))
    U_prop = jnp.where((u_ctl[:, 0] < p_large)[:, None], um[:, 2].reshape(n, D), U_small)
    pos_p, L_p = trace(U_prop)
    I_p = jp._chain_lum(L_p)
    a = jnp.clip(I_p / jnp.maximum(I_cur, 1e-12), 0.0, 1.0)
    w_cur = (1.0 - a) / jnp.maximum(I_cur, 1e-12)
    w_prop = a / jnp.maximum(I_p, 1e-12)
    film = jnp.zeros((h, w, 3), jnp.float32)
    for pos, val, wgt in ((pos_cur, L_cur, w_cur), (pos_p, L_p, w_prop)):
        for s in range(pos.shape[1]):
            film = jp._splat(film, pos[:, s], val[:, s] * wgt[:, None], w, h)
    accept = u_ctl[:, 1] < a
    return U_prop, L_p, a, accept, film, jnp.where(accept[:, None], U_prop, U_cur)


def test_one_step(uni3):
    """One step of 1,024 chains from the same state (bootstrapped seeds,
    unidirectional door at maxDepth 3): the proposals, the acceptance
    ratio where both traces agree, the accept decisions (flips counted),
    the chains' next state and the film."""
    tr_j, tr_t, D, _, _ = uni3
    k = 5
    seed_mlt = trng.stream_seed(0, trng.STREAM_MLT)
    U0, _ = tp.bootstrap_chains(tr_t, D, N, 2, 0, seed_mlt, "cpu")
    U0_j = jnp.asarray(U0.numpy())
    pos_j, L_j = tr_j(U0_j)
    U_pr, L_pr, a_r, acc_r, film_r, U_nr = _reference_step(
        tr_j, U0_j, pos_j, L_j, jp._chain_lum(L_j), k, jnp.arange(N, dtype=jnp.uint32),
        seed_mlt, 0.3, 16, 16)
    pos_t, L_t = tr_t(U0)
    U_po, u_ctl = tp._propose(U0, k, torch.arange(N), seed_mlt, 0.3)
    assert _ulps_on_circle(U_po.numpy(), np.asarray(U_pr), U0.numpy()).max() <= 2
    U_po = torch.tensor(np.asarray(U_pr))  # the same proposals on both sides
    pos_p, L_p = tr_t(U_po)
    film, state, a, accept = tp._mh(torch.zeros(16, 16, 3), (U0, pos_t, L_t, tp._chain_lum(L_t)),
                                    (U_po, pos_p, L_p, tp._chain_lum(L_p)), u_ctl[:, 1], 1.0,
                                    16, 16)
    traced = ~_lanes_off(L_p.numpy(), np.asarray(L_pr)) & ~_lanes_off(L_t.numpy(),
                                                                       np.asarray(L_j))
    assert (~traced).sum() <= 2, (~traced).sum()
    a_r, acc_r = np.asarray(a_r), np.asarray(acc_r)
    np.testing.assert_allclose(a.numpy()[traced], a_r[traced], **TOL_LANE)
    flips = accept.numpy() != acc_r
    assert flips.sum() <= 2, flips.sum()
    assert 0.05 < acc_r.mean() < 0.95
    np.testing.assert_array_equal(state[0].numpy()[~flips], np.asarray(U_nr)[~flips])
    assert tm_rmse(film.numpy(), np.asarray(film_r)) < 1e-5


# ---- renders ----

def test_direct_component():
    """directSamples >= 0 adds the direct integrator's image (maxDepth 2,
    no roulette, the batched wavefront) on cbox at 16x16."""
    from mitsuba_tpu.integrator.pssmlt import add_direct_component as jadd

    with open(CBOX_XML) as f:
        xml = with_integrator(f.read(), "pssmlt", max_depth=4)
    xml = xml.replace('value="512"', 'value="16"')
    js, jpk, ts, tpk = _packs(xml)
    for s in (js, ts):
        s.sensor.record.film.width = s.sensor.record.film.height = 16
        s.integrator.direct_samples = 4
    zeros = np.zeros((16, 16, 3), np.float32)
    ref = jadd(zeros, js, jpk, js.integrator, 3)
    out = tp.add_direct_component(zeros, ts, tpk, ts.integrator, 3, "cpu")
    assert out.mean() > 0.05
    # measured 5.65e-4 (the lanes whose paths diverge, ROADMAP C)
    assert tm_rmse(out, ref) < 2e-3, tm_rmse(out, ref)
    ts.integrator.direct_samples = -1
    assert tp.add_direct_component(zeros, ts, tpk, ts.integrator, 3, "cpu") is zeros


@pytest.mark.parametrize("bidir", [True, False], ids=["bidirectional", "unidirectional"])
def test_door_meets_golden(bidir):
    """scenes/door.xml as it stands (pssmlt, maxDepth 8) at 16x16, 4
    mutations per pixel, 256 chains, luminanceSamples 1,024: the
    bidirectional technique (1 + 8 splats a sample) and the
    unidirectional one."""
    name = f"torch_door_pssmlt{'' if bidir else '_uni'}_16_4.npy"
    golden = np.load(os.path.join(GOLDEN, name))
    scene = mt.load_scene_string(door_xml(16, 16, luminance_samples=1024, bidirectional=bidir))
    out = mt.render(scene, spp=4, seed=0, device="cpu")
    assert out.shape == golden.shape == (16, 16, 3)
    assert np.isfinite(out).all() and out.mean() > 0.01
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
