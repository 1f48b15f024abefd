"""The port's shading modules against the reference on seeded numpy
inputs: warps, shading frame and parameters, the diffuse BSDF, area-light
sampling, and camera rays with gaussian filter importance sampling.

Tolerance: rtol = atol = 1e-5 (float32 transcendental functions and
summation order differ between XLA and PyTorch in the last places);
integer and boolean outputs must be equal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdf import eval as jbsdf
from mitsuba_tpu.core import math as jmm
from mitsuba_tpu.core import warp as jwarp
from mitsuba_tpu.emitter import eval as jem
from mitsuba_tpu.film import film as jfilm
from mitsuba_tpu.film.plugins import filter_importance_sample as jfis
from mitsuba_tpu.scene import texture_eval as jtex
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene as jload
from mitsuba_tpu.sensor.plugins import generate_rays as jgen
from mitsuba_tpu_torch.bsdf import eval as tbsdf
from mitsuba_tpu_torch.core import math as tmm
from mitsuba_tpu_torch.core import warp as twarp
from mitsuba_tpu_torch.emitter import eval as tem
from mitsuba_tpu_torch.film import film as tfilm
from mitsuba_tpu_torch.film.plugins import filter_importance_sample as tfis
from mitsuba_tpu_torch.scene import texture_eval as ttex
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene
from mitsuba_tpu_torch.sensor.plugins import generate_rays as tgen

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox.xml")
N = 4096
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def packs():
    return jpack_scene(jload(CBOX)), pack_scene(load_scene(CBOX), "cpu")


def _u(k, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (N, k)).astype(np.float32)


def _dirs(seed, upper=None):
    d = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if upper is not None:
        d[:, 2] = np.where(np.arange(N) % 5 == 0, -np.abs(d[:, 2]), np.abs(d[:, 2]))
    return d


def _close(out, ref, **kw):
    np.testing.assert_allclose(
        out.numpy() if isinstance(out, torch.Tensor) else out,
        np.asarray(ref), **{**TOL, **kw},
    )


@pytest.mark.parametrize(
    "name",
    ["square_to_cosine_hemisphere", "square_to_uniform_disk_concentric",
     "square_to_uniform_triangle", "square_to_std_normal"],
)
def test_warps(name):
    u = _u(2, 1)
    u[:8] = [[0, 0], [0.5, 0.5], [1e-7, 0.5], [0.5, 0.99999994],
             [0.25, 0.75], [0.999, 0.001], [0.5, 0], [0, 0.5]]
    _close(getattr(twarp, name)(torch.as_tensor(u)), getattr(jwarp, name)(jnp.asarray(u)))


def test_cosine_hemisphere_pdf():
    d = _dirs(2, upper=True)
    _close(twarp.square_to_cosine_hemisphere_pdf(torch.as_tensor(d)),
           jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(d)))


def test_frame_round_trip_matches_reference():
    n = _dirs(3)
    v = _dirs(4)
    jf = jmm.Frame.from_normal(jnp.asarray(n))
    tf = tmm.Frame.from_normal(torch.as_tensor(n))
    for a, b in ((tf.s, jf.s), (tf.t, jf.t)):
        _close(a, b)
    _close(tf.to_local(torch.as_tensor(v)), jf.to_local(jnp.asarray(v)))
    _close(tf.to_world(torch.as_tensor(v)), jf.to_world(jnp.asarray(v)))
    _close(tmm.normalize(torch.as_tensor(v * 3)), jmm.normalize(jnp.asarray(v * 3)))


def _its_like(n_dirs_seed, mat):
    """Minimal interaction stand-ins carrying what shading reads."""
    from types import SimpleNamespace

    ns = _dirs(n_dirs_seed)
    j, t = SimpleNamespace(), SimpleNamespace()
    j.ns, t.ns = jnp.asarray(ns), torch.as_tensor(ns)
    j.mat, t.mat = jnp.asarray(mat), torch.as_tensor(mat)
    j.uv, t.uv = jnp.zeros((N, 2)), torch.zeros(N, 2)
    return j, t


def test_shading_params_and_frame(packs):
    jp, tp = packs
    mat = np.random.default_rng(5).integers(-1, 4, N).astype(np.int32)
    j_its, t_its = _its_like(6, mat)
    jsp = jtex.shading_params(jp, j_its.mat, j_its.uv, jtex.mip_footprint(jp, j_its))
    tsp = ttex.shading_params(tp, t_its.mat, t_its.uv, ttex.mip_footprint(tp, t_its))
    for k in ("type", "cA", "twosided"):
        np.testing.assert_array_equal(tsp[k].numpy(), np.asarray(jsp[k]), err_msg=k)
    jf, tf = jtex.shading_frame(jp, j_its), ttex.shading_frame(tp, t_its)
    _close(tf.s, jf.s)
    _close(tf.t, jf.t)


def _sp_pair(packs, seed):
    jp, tp = packs
    mat = np.random.default_rng(seed).integers(0, 4, N).astype(np.int32)
    jsp = jtex.shading_params(jp, jnp.asarray(mat), jnp.zeros((N, 2)))
    tsp = ttex.shading_params(tp, torch.as_tensor(mat), torch.zeros(N, 2))
    return jp.meta["present_types"], jsp, tsp


@pytest.mark.parametrize("fn", ["bsdf_eval", "bsdf_pdf"])
def test_diffuse_eval_pdf(packs, fn):
    present, jsp, tsp = _sp_pair(packs, 7)
    wi, wo = _dirs(8, upper=True), _dirs(9, upper=True)
    ref = getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), present)
    out = getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), present)
    _close(out, ref)


def test_diffuse_sample(packs):
    present, jsp, tsp = _sp_pair(packs, 10)
    wi, u = _dirs(11, upper=True), _u(3, 12)
    ref = jbsdf.bsdf_sample(jsp, jnp.asarray(wi), jnp.asarray(u[:, :2]),
                            jnp.asarray(u[:, 2]), present)
    out = tbsdf.bsdf_sample(tsp, torch.as_tensor(wi), torch.as_tensor(u[:, :2]),
                            torch.as_tensor(u[:, 2]), present)
    for k in ("wo", "weight", "pdf", "eta"):
        _close(getattr(out, k), getattr(ref, k))
    np.testing.assert_array_equal(out.delta.numpy(), np.asarray(ref.delta))


def test_twosided_flip_matches_reference(packs):
    """Two-sided rows mirror the frame for back-side lanes."""
    present, jsp, tsp = _sp_pair(packs, 13)
    jsp = {**jsp, "twosided": jnp.ones(N)}
    tsp = {**tsp, "twosided": torch.ones(N)}
    wi, wo = _dirs(14, upper=True), _dirs(15, upper=True)
    for fn in ("bsdf_eval", "bsdf_pdf"):
        _close(getattr(tbsdf, fn)(tsp, torch.as_tensor(wi), torch.as_tensor(wo), present),
               getattr(jbsdf, fn)(jsp, jnp.asarray(wi), jnp.asarray(wo), present))


def test_unported_bsdf_type_raises(packs):
    present, _, tsp = _sp_pair(packs, 16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        # 13, the mixture's type number, which no row holds (irawan, 17, is
        # evaluated since the texture slice)
        tbsdf.bsdf_eval(tsp, torch.zeros(N, 3), torch.zeros(N, 3), (0, 13))


def test_sample_direct_area(packs):
    jp, tp = packs
    p_ref = np.random.default_rng(17).uniform([1, 1, 1], [555, 547, 558], (N, 3)).astype(np.float32)
    u3 = _u(3, 18)
    ref = jem.sample_direct(jp, jnp.asarray(p_ref), jnp.asarray(u3))
    out = tem.sample_direct(tp, torch.as_tensor(p_ref), torch.as_tensor(u3))
    for k in ("d", "dist", "pdf", "value", "n"):
        _close(getattr(out, k), getattr(ref, k), err_msg=k)
    for k in ("delta", "kind"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), np.asarray(getattr(ref, k)))
    assert (out.value.numpy().max(-1) > 0).mean() > 0.5


def test_pdf_direct_area(packs):
    jp, tp = packs
    r = np.random.default_rng(19)
    emit = r.integers(-1, 1, N).astype(np.int32)
    dist = r.uniform(1, 800, N).astype(np.float32)
    cos_l = r.uniform(-0.2, 1, N).astype(np.float32)
    ref = jem.pdf_direct_area(jp, jnp.asarray(emit), jnp.asarray(dist), jnp.asarray(cos_l))
    out = tem.pdf_direct_area(tp, torch.as_tensor(emit), torch.as_tensor(dist), torch.as_tensor(cos_l))
    _close(out, ref)


def test_searchsorted_segment():
    r = np.random.default_rng(20)
    cdf = np.concatenate([np.cumsum(w) / np.sum(w) for w in (r.uniform(0, 1, 5), r.uniform(0, 1, 7))]).astype(np.float32)
    lo = r.choice([0, 5], N).astype(np.int32)
    hi = np.where(lo == 0, 5, 12).astype(np.int32)
    u = r.uniform(0, 1, N).astype(np.float32)
    ref = jem._searchsorted_segment(jnp.asarray(cdf), jnp.asarray(u), jnp.asarray(lo), jnp.asarray(hi))
    out = tem._searchsorted_segment(torch.as_tensor(cdf), torch.as_tensor(u),
                                    torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_rays_with_fis():
    js, ts = jload(CBOX), load_scene(CBOX)
    w, h = 96, 64
    lane = np.arange(N, dtype=np.uint32) * 3 % (w * h)
    sidx = np.arange(N, dtype=np.uint32) % 7 + 2**31
    u2j = js.sensor.record.sampler.pixel_sample(jnp.asarray(lane), jnp.asarray(sidx), 16)
    u2t = ts.sensor.record.sampler.pixel_sample(
        torch.as_tensor(lane.astype(np.int64)), torch.as_tensor(sidx.astype(np.int64)), 16)
    np.testing.assert_array_equal(u2t.numpy(), np.asarray(u2j))
    jit_j = jfis(js.sensor.record.film.rfilter, u2j)
    jit_t = tfis(ts.sensor.record.film.rfilter, u2t)
    _close(jit_t, jit_j)
    x = (lane % w).astype(np.float32) + np.asarray(jit_j)[:, 0]
    y = (lane // w).astype(np.float32) + np.asarray(jit_j)[:, 1]
    pos = np.stack([x / w, y / h], -1).astype(np.float32)
    oj, dj = jgen(js.sensor.record.pack(w, h), jnp.asarray(pos), jnp.zeros((N, 2)))
    ot, dt = tgen(ts.sensor.record.pack(w, h, "cpu"), torch.as_tensor(pos), torch.zeros(N, 2))
    _close(ot, oj)
    _close(dt, dj)


def test_develop_matches_reference():
    film = np.random.default_rng(21).uniform(0, 3, (16, 8, 4)).astype(np.float32)
    film[0, :, 3] = 0.0
    _close(tfilm.develop(torch.as_tensor(film)), jfilm.develop(jnp.asarray(film)))
    assert tfilm.new_film(4, 5, "cpu").shape == (4, 5, 4)


def test_sampler_draws_bit_exact():
    """pixel_sample, lens_sample and the integrator decision draw of the
    independent sampler are the reference's numbers exactly."""
    from mitsuba_tpu.core import rng as jrng
    from mitsuba_tpu.sampler.plugins import ld_decision4 as jld
    from mitsuba_tpu_torch.core import rng as trng
    from mitsuba_tpu_torch.sampler.plugins import ld_decision4 as tld

    js, ts = jload(CBOX).sensor.record.sampler, load_scene(CBOX).sensor.record.sampler
    lane = np.arange(N, dtype=np.uint32) * 11
    sidx = np.arange(N, dtype=np.uint32) % 5 + 2**31 - 2
    lj, sj = jnp.asarray(lane), jnp.asarray(sidx)
    lt, st = torch.as_tensor(lane.astype(np.int64)), torch.as_tensor(sidx.astype(np.int64))
    np.testing.assert_array_equal(ts.lens_sample(lt, st).numpy(), np.asarray(js.lens_sample(lj, sj)))
    np.testing.assert_array_equal(ts.pixel_sample(lt, st, 16).numpy(),
                                  np.asarray(js.pixel_sample(lj, sj, 16)))
    dslot = (np.arange(N) % 16 * 4 + 2).astype(np.int32)
    ref = jld(js, lj, sj, jnp.asarray(dslot), jrng.rand4(lj, sj, jnp.asarray(dslot), 7), 7)
    out = tld(ts, lt, st, torch.as_tensor(dslot), trng.rand4(lt, st, torch.as_tensor(dslot), 7), 7)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sample_direct_two_emitters():
    """Emitter selection by the PMF (sampling weights 3:1) and per-emitter
    triangle CDFs, against the reference."""
    from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
    from mitsuba_tpu_torch.scene.xml_loader import load_scene_string

    from test_torch_scene import TWO_LIGHTS

    jp = jpack_scene(jload_string(TWO_LIGHTS))
    tp = pack_scene(load_scene_string(TWO_LIGHTS), "cpu")
    assert tp.meta["n_emitters"] == 2
    p_ref = np.random.default_rng(22).uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    p_ref[:, 1] = np.abs(p_ref[:, 1])
    u3 = _u(3, 23)
    ref = jem.sample_direct(jp, jnp.asarray(p_ref), jnp.asarray(u3))
    out = tem.sample_direct(tp, torch.as_tensor(p_ref), torch.as_tensor(u3))
    for k in ("d", "dist", "pdf", "value", "n"):
        _close(getattr(out, k), getattr(ref, k), err_msg=k)
    emit = np.random.default_rng(24).integers(-1, 2, N).astype(np.int32)
    dist = np.random.default_rng(25).uniform(0.5, 5, N).astype(np.float32)
    cos_l = np.random.default_rng(26).uniform(-0.1, 1, N).astype(np.float32)
    _close(tem.pdf_direct_area(tp, torch.as_tensor(emit), torch.as_tensor(dist), torch.as_tensor(cos_l)),
           jem.pdf_direct_area(jp, jnp.asarray(emit), jnp.asarray(dist), jnp.asarray(cos_l)))
