"""The port's low-discrepancy samplers against the JAX package, bit for
bit (no tolerance anywhere but the renders):

* core/sobol.py: `direction_matrices`; the byte tables' `sobol_bits` /
  `sobol_01` and their per-lane `_dyn` forms (dims clipped to [0, 160))
  against the reference's 32-step loop; the Faure permutations and
  `halton_faure` for all 12 bases, with and without a rotation;
* core/rng.py: `pcg4d_mult`, `_reverse_bits`, `radical_inverse_base2`,
  `sobol_2d` and `sobol_2d_scrambled`;
* sampler/plugins.py: each of the six kinds' `pixel_sample` and
  `lens_sample`, and `ld_decision4` for decision slots 0..47 (maxDepth
  12), across the slot (39) from which dim0 + 3 passes the 160-dim table
  and the counter-hash draw is kept;
* renders: scenes/cbox.xml at 16x16, 4 spp with each of stratified,
  ldsampler, halton and hammersley against the JAX package's render at
  tests/test_golden.py's gate (tone-mapped RMSE < 5e-3).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.core import sobol as jsobol
from mitsuba_tpu.sampler import plugins as jsampler
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
import mitsuba_tpu_torch as mt
from mitsuba_tpu_torch.core import rng as trng
from mitsuba_tpu_torch.core import sobol as tsobol
from mitsuba_tpu_torch.sampler import plugins as tsampler
from tests.torch_meshes import CBOX_XML

torch.set_num_threads(1)

KINDS = {"independent": 0, "stratified": 1, "ldsampler": 2, "sobol": 3, "halton": 4,
         "hammersley": 5}


def _words(n=4096, seed=0):
    """uint32 words with the edge values 0, 1, 2^31 - 1, 2^31, 2^32 - 1."""
    w = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    return w


def _t(a):
    return torch.as_tensor(np.asarray(a, np.uint32).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_direction_matrices_equal_reference():
    out = tsobol.direction_matrices()
    assert out.shape == (160, 32) and out.dtype == np.uint32
    np.testing.assert_array_equal(out, jsobol.direction_matrices())


def test_byte_tables_are_the_loop():
    """T[d, j, b] is the reference loop's bits of the index b << 8j."""
    T = tsobol.byte_tables()
    b = np.arange(256, dtype=np.uint32)
    for j in range(4):
        ref = np.asarray(jsobol.sobol_bits(jnp.asarray(b << (8 * j)), tuple(range(160))))
        np.testing.assert_array_equal(T[:, j, :].T.astype(np.uint32), ref)


@pytest.mark.parametrize("dims", [(0,), (1,), (2, 3), (0, 1, 2, 3, 4, 5, 6, 7, 8, 9),
                                  (10, 57, 158, 159)])
def test_sobol_bits_and_01(dims):
    idx = _words()
    np.testing.assert_array_equal(_u32(tsobol.sobol_bits(_t(idx), dims)),
                                  np.asarray(jsobol.sobol_bits(jnp.asarray(idx), dims)))
    scr = _words(seed=1)[:, None] ^ np.arange(len(dims), dtype=np.uint32)
    np.testing.assert_array_equal(
        tsobol.sobol_01(_t(idx), dims, _t(scr)).numpy(),
        np.asarray(jsobol.sobol_01(jnp.asarray(idx), dims, jnp.asarray(scr))))
    np.testing.assert_array_equal(tsobol.sobol_01(_t(idx), dims).numpy(),
                                  np.asarray(jsobol.sobol_01(jnp.asarray(idx), dims)))


def test_sobol_dyn_with_clipped_dims():
    """Per-lane dimensions, including -3 and 160..200 (clipped)."""
    idx = _words()
    r = np.random.default_rng(2)
    dims = r.integers(-3, 201, (idx.size, 4)).astype(np.int32)
    dims[:8] = [[0, 1, 2, 3], [156, 157, 158, 159], [157, 158, 159, 160], [160, 161, 162, 163],
                [-1, 0, 159, 200], [4, 5, 6, 7], [152, 153, 154, 155], [155, 156, 157, 158]]
    np.testing.assert_array_equal(
        _u32(tsobol.sobol_bits_dyn(_t(idx), torch.as_tensor(dims))),
        np.asarray(jsobol.sobol_bits_dyn(jnp.asarray(idx), jnp.asarray(dims))))
    scr = _words(seed=3)[:, None] ^ np.arange(4, dtype=np.uint32)
    np.testing.assert_array_equal(
        tsobol.sobol_01_dyn(_t(idx), torch.as_tensor(dims), _t(scr)).numpy(),
        np.asarray(jsobol.sobol_01_dyn(jnp.asarray(idx), jnp.asarray(dims), jnp.asarray(scr))))


def test_faure_permutations_equal_reference():
    np.testing.assert_array_equal(tsobol.faure_permutations(), jsobol.faure_permutations())


@pytest.mark.parametrize("slot", range(12))
def test_halton_faure(slot):
    idx = _words()
    rot = np.random.default_rng(slot).random(idx.size).astype(np.float32)
    np.testing.assert_array_equal(tsobol.halton_faure(_t(idx), slot).numpy(),
                                  np.asarray(jsobol.halton_faure(jnp.asarray(idx), slot)))
    np.testing.assert_array_equal(
        tsobol.halton_faure(_t(idx), slot, torch.as_tensor(rot)).numpy(),
        np.asarray(jsobol.halton_faure(jnp.asarray(idx), slot, jnp.asarray(rot))))


def test_pcg4d_mult():
    v = np.stack([_words(seed=s) for s in range(4)], axis=-1)
    np.testing.assert_array_equal(_u32(trng.pcg4d_mult(_t(v))),
                                  np.asarray(jrng.pcg4d_mult(jnp.asarray(v))))


def test_reverse_bits_and_radical_inverse():
    w = _words()
    np.testing.assert_array_equal(_u32(trng._reverse_bits(_t(w))),
                                  np.asarray(jrng._reverse_bits(jnp.asarray(w))))
    np.testing.assert_array_equal(trng.radical_inverse_base2(_t(w)).numpy(),
                                  np.asarray(jrng.radical_inverse_base2(jnp.asarray(w))))


def test_sobol_2d_scrambled():
    idx, sx, sy = _words(seed=0), _words(seed=1), _words(seed=2)
    out = trng.sobol_2d_scrambled(_t(idx), _t(sx), _t(sy)).numpy()
    ref = np.asarray(jrng.sobol_2d_scrambled(jnp.asarray(idx), jnp.asarray(sx), jnp.asarray(sy)))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("scramble", [(0, 0), (0x1234567, 0xFEDCBA98)])
def test_sobol_2d(scramble):
    idx = _words()
    np.testing.assert_array_equal(trng.sobol_2d(_t(idx), *scramble).numpy(),
                                  np.asarray(jrng.sobol_2d(jnp.asarray(idx), *scramble)))


def _records(kind, seed=5):
    return (tsampler.SamplerRecord(kind=kind, sample_count=16, seed=seed),
            jsampler.SamplerRecord(kind=kind, sample_count=16, seed=seed))


def _lanes(n=4096):
    r = np.random.default_rng(7)
    lane = r.integers(0, 512 * 512, n).astype(np.uint32)
    sidx = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    sidx[: n // 2] = np.arange(n // 2) % 300  # small sample numbers, as in a render
    return lane, sidx


@pytest.mark.parametrize("spp", [16, 7, 1])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pixel_sample(kind, spp):
    t, j = _records(KINDS[kind])
    lane, sidx = _lanes()
    out = t.pixel_sample(_t(lane), _t(sidx), spp).numpy()
    ref = np.asarray(j.pixel_sample(jnp.asarray(lane), jnp.asarray(sidx), spp))
    assert out.dtype == np.float32 and out.shape == (lane.size, 2)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_lens_sample(kind):
    t, j = _records(KINDS[kind])
    lane, sidx = _lanes()
    np.testing.assert_array_equal(
        t.lens_sample(_t(lane), _t(sidx)).numpy(),
        np.asarray(j.lens_sample(jnp.asarray(lane), jnp.asarray(sidx))))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_ld_decision4(kind):
    """dslot 0..47 per lane (maxDepth 12, 4 slots per bounce), the
    integrator's seed beside the sampler's."""
    t, j = _records(KINDS[kind], seed=3)
    lane, sidx = _lanes()
    dslot = (np.arange(lane.size) % 48).astype(np.int32)
    fallback = np.random.default_rng(9).random((lane.size, 4)).astype(np.float32)
    out = tsampler.ld_decision4(t, _t(lane), _t(sidx), torch.as_tensor(dslot),
                                torch.as_tensor(fallback), 11).numpy()
    ref = np.asarray(jsampler.ld_decision4(j, jnp.asarray(lane), jnp.asarray(sidx),
                                           jnp.asarray(dslot), jnp.asarray(fallback), 11))
    np.testing.assert_array_equal(out, ref)
    kept = (out == fallback).all(axis=-1)
    if KINDS[kind] in (2, 3):
        assert kept[dslot >= 39].all() and not kept[dslot < 39].any()
    else:
        assert kept.all()


def test_ld_decision4_scalar_slot():
    """A scalar slot, as the plain wavefront passes it."""
    t, j = _records(3)
    lane, sidx = _lanes()
    fallback = np.zeros((lane.size, 4), np.float32)
    for dslot in (0, 38, 39):
        out = tsampler.ld_decision4(t, _t(lane), _t(sidx), dslot, torch.as_tensor(fallback), 0)
        ref = jsampler.ld_decision4(j, jnp.asarray(lane), jnp.asarray(sidx), dslot,
                                    jnp.asarray(fallback), 0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _cbox(sampler, size=16):
    with open(CBOX_XML) as f:
        xml = f.read()
    xml = xml.replace('<sampler type="independent">', f'<sampler type="{sampler}">')
    xml = xml.replace('name="width" value="512"', f'name="width" value="{size}"')
    return xml.replace('name="height" value="512"', f'name="height" value="{size}"')


@pytest.mark.parametrize("sampler", ["stratified", "ldsampler", "halton", "hammersley"])
def test_cbox_render_with_sampler(sampler):
    xml = _cbox(sampler)
    assert f'<sampler type="{sampler}">' in xml and 'value="16"' in xml
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=4, seed=0), np.float32)
    assert np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img / (1 + img) - ref / (1 + ref)) ** 2)))
    assert rmse < 5e-3, rmse
