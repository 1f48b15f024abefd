"""The port's adaptive sampling (mitsuba_tpu_torch/integrator/adaptive.py),
multichannel stack and meta-integrator forwarding (renderer.py) against
the reference (mitsuba_tpu/integrator/adaptive.py, renderer.py), on
scenes/cbox.xml at 24x24.

The reference's refinement round is a closure of render_adaptive
(adaptive.py:83-115); `_reference_round` below restates its lines in JAX
to hold the port's error map and pixel picks to them.

Tolerances:

* the error CDF on seeded random buffers: rtol 1e-6 of its total (float32
  prefix sums in another order);
* the pixel picks and sample indices from one CDF: equal;
* the base passes alone (maxError 10: no pixel is refined): rtol 1e-4,
  atol 1e-6 on 97 % of the pixels (cbox's paths diverge on a last place,
  ROADMAP C: 6 of 576 pixels at maxDepth 4, measured; at maxDepth 2 one
  NEE shadow ray that grazes an edge, 1 lane of 1,152);
* the golden: GOLDEN_GATES (one such lane moves every later round's picks);
* multichannel: each 3-channel group the port's own render of that
  nested integrator, bit for bit, and the reference's group at 5e-3
  (tests/test_golden.py's gate; cbox's paths diverge on a last place,
  ROADMAP C).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import rng as jrng
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.film.film import new_film
from mitsuba_tpu_torch.integrator import adaptive as tad
from mitsuba_tpu_torch.renderer import make_render_pass
from mitsuba_tpu_torch.scene.builder import pack_scene
from tests.torch_meshes import (
    GOLDEN_GATES,
    NESTED_DIRECT,
    NESTED_PATH,
    ROOT,
    cbox_meta_xml,
    cbox_xml,
    tm_rmse,
    with_properties,
)

torch.set_num_threads(1)

LUM = jnp.asarray([0.212671, 0.715160, 0.072169], jnp.float32)


def _reference_round(sum_l, count, a, b, half, max_error, it, seed):
    """The reference's refinement round up to its trace (adaptive.py:88-112):
    (cdf, px, sidx)."""
    n_px = sum_l.shape[0]
    lane = jnp.arange(n_px, dtype=jnp.uint32)
    lum_m = (sum_l / count[:, None]) @ LUM
    err = jnp.abs((a - b) @ LUM) / (2.0 * half)
    rel = err / jnp.maximum(lum_m, 1e-3)
    cdf = jnp.cumsum(jnp.where(rel > max_error, rel, 0.0))
    u = jrng.rand1(lane, jnp.uint32(it), 4021, jrng.stream_seed(seed, jrng.STREAM_CAMERA))
    pos = (lane.astype(jnp.float32) + u) / n_px * cdf[-1]
    px = jnp.clip(jnp.searchsorted(cdf, pos, side="right"), 0, n_px - 1).astype(jnp.uint32)
    order = jnp.argsort(px)
    px_s = px[order]
    first = jnp.searchsorted(px_s, px_s, side="left")
    rank = jnp.zeros((n_px,), jnp.int32).at[order].set((jnp.arange(n_px) - first).astype(jnp.int32))
    sidx = count[px.astype(jnp.int32)].astype(jnp.uint32) + rank.astype(jnp.uint32)
    return np.asarray(cdf), np.asarray(px), np.asarray(sidx)


@pytest.mark.parametrize("max_error", [0.05, 0.2])
def test_round(max_error):
    """One round's error CDF, pixel picks and sample indices on random
    half buffers of 576 pixels, 8 samples each."""
    r = np.random.default_rng(21)
    n, half = 576, 4
    sum_l = (r.gamma(0.5, 0.3, (n, 3)) * 8).astype(np.float32)
    a = (sum_l * r.uniform(0.3, 0.7, (n, 1))).astype(np.float32)
    b = (sum_l - a).astype(np.float32)
    count = np.full(n, 8.0, np.float32)
    cdf, px, sidx = _reference_round(*map(jnp.asarray, (sum_l, count, a, b)), half, max_error,
                                     1003, 7)
    got = tad.error_cdf(*map(torch.tensor, (sum_l, count, a, b)), half, max_error).numpy()
    np.testing.assert_allclose(got, cdf, rtol=0, atol=1e-6 * cdf[-1])
    t_px, t_sidx = tad.refine_targets(torch.tensor(cdf), torch.tensor(count), 1003, 7)
    np.testing.assert_array_equal(t_px.numpy(), px.astype(np.int64))
    np.testing.assert_array_equal(t_sidx.numpy(), sidx.astype(np.int64))
    assert 50 < len(np.unique(px)) < n


def test_base_passes():
    """With maxError 10 no pixel is refined: the image is the two half
    buffers' mean, each half `path` at maxDepth 4."""
    xml = cbox_meta_xml("adaptive", NESTED_PATH, props='<float name="maxError" value="10"/>')
    out = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=4, seed=0))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-6).all(-1)
    assert close.mean() > 0.97, close.mean()
    assert tad.render_adaptive.last_stats["rounds"] == 1


def test_meets_golden():
    """cbox under adaptive over `path` at maxDepth 4, 24x24, 4 spp (16
    refinement rounds), seed 0, through `render`, against the reference's
    render."""
    name = "torch_cbox_adaptive_24_4.npy"
    golden = np.load(os.path.join(ROOT, "tests", "golden", name))
    out = mt.render(mt.load_scene_string(cbox_meta_xml("adaptive", NESTED_PATH)), spp=4, seed=0,
                    device="cpu")
    assert out.shape == golden.shape and np.isfinite(out).all()
    assert tm_rmse(out, golden) < GOLDEN_GATES[name], tm_rmse(out, golden)
    assert tad.render_adaptive.last_stats["rounds"] == 16


FIELD = '<integrator type="field"><string name="field" value="albedo"/></integrator>'


def test_multichannel():
    """multichannel over path, direct and the albedo field: [24, 24, 9]."""
    xml = cbox_meta_xml("multichannel", NESTED_PATH + NESTED_DIRECT + FIELD)
    out = mt.render(mt.load_scene_string(xml), spp=2, seed=0, device="cpu")
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=2, seed=0))
    assert out.shape == ref.shape == (24, 24, 9)
    alone = (cbox_xml("path", 24, 24, max_depth=4), cbox_xml("direct", 24, 24),
             with_properties(cbox_xml("field", 24, 24), '<string name="field" value="albedo"/>'))
    for g, xml_g in enumerate(alone):
        img = mt.render(mt.load_scene_string(xml_g), spp=2, seed=0, device="cpu")
        np.testing.assert_array_equal(out[..., 3 * g:3 * g + 3], img)
        assert tm_rmse(out[..., 3 * g:3 * g + 3], ref[..., 3 * g:3 * g + 3]) < 5e-3


@pytest.mark.parametrize("kind", ["adaptive", "irrcache", "multichannel"])
def test_render_pass_forwards(kind):
    """A render pass of a meta-integrator is its nested integrator's, and
    `path` without one (reference renderer.py:60-67)."""
    def one_pass(xml):
        s = mt.load_scene_string(xml)
        sen = s.sensor.record
        rp = make_render_pass(pack_scene(s, "cpu"), s.integrator, sen, sen.film, sen.sampler, 2,
                              torch.device("cpu"))
        return rp(new_film(8, 8, torch.device("cpu")), 0, 0)[0].numpy()

    nested = one_pass(cbox_meta_xml(kind, NESTED_DIRECT, 8, 8))
    np.testing.assert_array_equal(nested, one_pass(cbox_xml("direct", 8, 8)))
    # without a nested integrator: `path` at its defaults (maxDepth -1)
    bare = one_pass(cbox_xml(kind, 8, 8))
    np.testing.assert_array_equal(bare, one_pass(cbox_xml("path", 8, 8, max_depth=-1)))
