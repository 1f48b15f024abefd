"""The delta emitters of the port (`point`, `spot`, `directional`,
`collimated`) against the reference: their records and pack rows, the
cone warps, sample_direct's four delta arms, and path and volpath
renders under a spot and a point light.

Function-level tolerance: rtol 1e-5, atol 1e-6 (float32 transcendental
functions differ between XLA and PyTorch in the last places); integer and
boolean outputs must be equal.  Renders: tone-mapped RMSE < 5e-3, the
gate of tests/test_golden.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu.emitter import eval as jem
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.core import warp as twarp
from mitsuba_tpu_torch.emitter import eval as tem
from mitsuba_tpu_torch.emitter.plugins import COLLIMATED, DIRECTIONAL, POINT, SPOT
from mitsuba_tpu_torch.scene.builder import SLICE_ARRAYS, SLICE_META, pack_scene
from tests.torch_meshes import DELTA_EMITTERS, bdpt_media_xml, delta_mix_xml, two_wall_xml

torch.set_num_threads(1)

N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(out, ref, **kw):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **{**TOL, **kw})


def _tm_rmse(a, b):
    return float(np.sqrt(np.mean((a / (1 + a) - b / (1 + b)) ** 2)))


@pytest.fixture(scope="module")
def mix():
    xml = delta_mix_xml()
    return jpack_scene(jload_string(xml)), pack_scene(mt.load_scene_string(xml), "cpu")


@pytest.mark.parametrize("kind", list(DELTA_EMITTERS))
def test_pack_equals_reference(kind):
    """Each delta light's rows (em_rgb, em_pos, em_dir and spot's cone
    cosines) and the scene's bounding sphere, exactly."""
    xml = two_wall_xml(kind)
    jp = jpack_scene(jload_string(xml))
    tp = pack_scene(mt.load_scene_string(xml), "cpu")
    for k in SLICE_ARRAYS:
        out = tp.arrays[k].numpy()
        assert out.dtype == np.asarray(jp.arrays[k]).dtype, k
        np.testing.assert_array_equal(out, np.asarray(jp.arrays[k]), err_msg=k)
    for k in SLICE_META:
        assert tp.meta[k] == jp.meta[k], k
    assert tp.meta["has_delta_emitters"]


def test_mixed_pack_equals_reference(mix):
    jp, tp = mix
    for k in ("em_kind", "em_rgb", "em_pos", "em_dir", "em_cos_cutoff", "em_cos_beam",
              "emitter_pmf", "emitter_cdf", "em_area", "em_tri_lo", "em_tri_hi"):
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]), err_msg=k)
    assert tp.meta["emitter_kinds"] == jp.meta["emitter_kinds"] == (0, POINT, SPOT, DIRECTIONAL,
                                                                     COLLIMATED)


def test_uniform_cone():
    r = np.random.default_rng(0)
    u = r.uniform(0, 1, (N, 2)).astype(np.float32)
    cc = r.uniform(-0.5, 0.999, N).astype(np.float32)
    _close(twarp.square_to_uniform_cone(torch.as_tensor(u), torch.as_tensor(cc)),
           jwarp.square_to_uniform_cone(jnp.asarray(u), jnp.asarray(cc)))
    _close(twarp.square_to_uniform_cone_pdf(torch.as_tensor(cc)),
           jwarp.square_to_uniform_cone_pdf(jnp.asarray(cc)))
    _close(twarp.square_to_uniform_disk(torch.as_tensor(u)),
           jwarp.square_to_uniform_disk(jnp.asarray(u)))


def test_sample_direct_delta_arms(mix):
    """sample_direct on the five-emitter scene: every lane picks an emitter
    by u[0], so the point, spot, directional and collimated arms (and the
    area arm) each take a share of the lanes."""
    jp, tp = mix
    r = np.random.default_rng(1)
    p_ref = r.uniform([-2, 0, -2], [2, 2, 2], (N, 3)).astype(np.float32)
    u3 = r.uniform(0, 1, (N, 3)).astype(np.float32)
    ref = jem.sample_direct(jp, jnp.asarray(p_ref), jnp.asarray(u3))
    out = tem.sample_direct(tp, torch.as_tensor(p_ref), torch.as_tensor(u3))
    kind = np.asarray(ref.kind)
    np.testing.assert_array_equal(out.kind.numpy(), kind)
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))
    for k in ("d", "dist", "pdf", "value", "n"):
        _close(getattr(out, k), getattr(ref, k), err_msg=k)
    for kd in (POINT, SPOT, DIRECTIONAL, COLLIMATED):
        assert (kind == kd).sum() > N // 20, kd
    # the spot's cone cuts some lanes off; the collimated beam is never
    # sampled (reference collimated.cpp)
    val = out.value.numpy().max(-1)
    assert (val[kind == SPOT] == 0).any() and (val[kind == SPOT] > 0).any()
    assert (val[kind == COLLIMATED] == 0).all()
    assert out.delta.numpy()[(kind != 0) & (kind != COLLIMATED)].all()


def test_spot_falloff():
    r = np.random.default_rng(2)
    cos_f = r.uniform(0.5, 1, N).astype(np.float32)
    cc = np.full(N, np.cos(np.deg2rad(40)), np.float32)
    cb = np.full(N, np.cos(np.deg2rad(25)), np.float32)
    from mitsuba_tpu.integrator.bdpt import _spot_falloff

    _close(tem.spot_falloff(*map(torch.as_tensor, (cos_f, cc, cb))),
           _spot_falloff(*map(jnp.asarray, (cos_f, cc, cb))))


RENDERS = {
    "spot-path": two_wall_xml("spot", "path", spp=8),
    "point-path": two_wall_xml("point", "path", spp=8),
    "directional-volpath": two_wall_xml("directional", "volpath", spp=8),
    "collimated-path": two_wall_xml("collimated", "path", spp=8),
    "mix-path": delta_mix_xml("path", spp=8),
    "spot-volpath-media": bdpt_media_xml("volpath", max_depth=4, spp=4, extra="spot"),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_render_matches_reference(name):
    """The path tracer (and volpath, with and without media) under delta
    lights renders the reference's picture; a collimated beam stays
    invisible to it (tests/test_emission_kinds.py:108)."""
    xml = RENDERS[name]
    ref = np.asarray(mitsuba_tpu.render(jload_string(xml), spp=None, seed=0))
    out = mt.render(mt.load_scene_string(xml), seed=0, device="cpu")
    assert out.shape == ref.shape
    assert _tm_rmse(out, ref) < 5e-3, _tm_rmse(out, ref)
    if name.startswith("collimated"):
        assert out.max() == 0.0 == ref.max()
    else:
        assert out.mean() > 0
