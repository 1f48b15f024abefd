"""The port's numerics (mitsuba_tpu_torch/core/numerics.py) and logging
(core/logging.py) against the JAX package's on the same numpy-seeded
inputs: quadrature, Brent's method, the natural cubic spline (its
evaluator on numpy arrays and on torch tensors, against the reference's
on numpy and on jnp arrays), spherical harmonics, the SH sampler and the
von Mises-Fisher functions equal; the logger's lines and the statistics
counters equal."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from mitsuba_tpu.core import logging as jlogging
from mitsuba_tpu.core import numerics as jnum
from mitsuba_tpu_torch.core import logging as tlogging
from mitsuba_tpu_torch.core import numerics as tnum

RNG = np.random.default_rng(0)


def test_quadrature_equal():
    for n in (3, 16, 64):
        for x, y in zip(tnum.gauss_legendre(n), jnum.gauss_legendre(n)):
            np.testing.assert_array_equal(x, y)
    f = lambda x: np.exp(-x) * np.sin(3 * x)  # noqa: E731
    assert tnum.integrate_gl(f, 0.0, 2.0, 48) == jnum.integrate_gl(f, 0.0, 2.0, 48)
    assert tnum.integrate_simpson(f, 0.0, 2.0, 100) == jnum.integrate_simpson(f, 0.0, 2.0, 100)


@pytest.mark.parametrize("f,a,b", [(lambda x: x ** 3 - 2 * x - 5, 2.0, 3.0),
                                   (np.cos, 0.0, 3.0), (lambda x: np.exp(x) - 10.0, 0.0, 5.0)])
def test_brent_equal(f, a, b):
    assert tnum.brent(f, a, b) == jnum.brent(f, a, b)
    with pytest.raises(ValueError, match="bracketed"):
        tnum.brent(lambda x: x * x + 1.0, -1.0, 1.0)


def test_spline_equal():
    x = np.sort(RNG.uniform(0.0, 4.0, 12))
    y = np.sin(x) + 0.1 * RNG.normal(size=12)
    m = tnum.spline_coeffs(x, y)
    np.testing.assert_array_equal(m, jnum.spline_coeffs(x, y))
    xq = RNG.uniform(-0.5, 4.5, 257)
    # numpy in, numpy float64 out: the natural spline (scipy's, extended
    # by its end pieces); the reference's evaluator sends a numpy 2 array
    # (which has a .device) through jnp in float32 (ROADMAP C9)
    ours = tnum.spline_eval(x, y, m, xq)
    assert isinstance(ours, np.ndarray) and ours.dtype == np.float64
    np.testing.assert_allclose(ours, CubicSpline(x, y, bc_type="natural")(xq), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(ours, np.asarray(jnum.spline_eval(x, y, m, xq)), rtol=1e-5,
                               atol=1e-5)
    # on tensors (the table goes to the tensor's device and float32),
    # against the reference's evaluator on jnp float32 arrays
    xq32 = xq.astype(np.float32)
    ours = tnum.spline_eval(x, y, m, torch.as_tensor(xq32))
    ref = np.asarray(jnum.spline_eval(x, y, m, jnp.asarray(xq32)))
    assert torch.is_tensor(ours) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("l_max", [0, 2, 5, 9])
def test_sh_equal(l_max):
    d = RNG.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = (0.0, 0.0, 1.0)  # a pole
    np.testing.assert_array_equal(tnum.sh_eval(l_max, d), jnum.sh_eval(l_max, d))
    f = lambda v: np.maximum(v[:, 2], 0.0) + 0.3 * v[:, 0] ** 2  # noqa: E731
    np.testing.assert_array_equal(tnum.sh_project(l_max, f, 2000, seed=4),
                                  jnum.sh_project(l_max, f, 2000, seed=4))


def test_sh_sampler_equal():
    coeffs = jnum.sh_project(3, lambda v: np.exp(2.0 * v[:, 2]), 4000, seed=1)
    ours, ref = tnum.SHSampler(coeffs, depth=4), jnum.SHSampler(coeffs, depth=4)
    assert ours.total == ref.total
    u = RNG.uniform(size=(500, 2))
    for a, b in zip(ours.sample(u), ref.sample(u)):
        np.testing.assert_array_equal(a, b)
    d = ours.sample(u)[0]
    np.testing.assert_array_equal(ours.pdf(d), ref.pdf(d))


@pytest.mark.parametrize("kappa", [0.0, 0.5, 7.0, 300.0])
def test_vmf_equal(kappa):
    c = RNG.uniform(-1.0, 1.0, 100)
    np.testing.assert_array_equal(tnum.vmf_pdf(kappa, c), jnum.vmf_pdf(kappa, c))
    u = RNG.uniform(size=(100, 2))
    np.testing.assert_array_equal(tnum.vmf_sample(kappa, u), jnum.vmf_sample(kappa, u))
    for mc in (0.0, 0.3, 0.95, 1.0):
        assert tnum.vmf_fit(mc) == jnum.vmf_fit(mc)


def _capture(mod):
    buf = []

    class Cap(mod.Appender):
        def append(self, level, text):
            buf.append((level, text))

    lg = mod.Logger(level=mod.EDebug)
    lg.clear_appenders()
    lg.add_appender(Cap())
    lg.trace("hidden %d", 0)
    lg.debug("debug %d", 1)
    lg.info("shown %s", "two")
    lg.warn("careful")
    lg.error("bad %.2f", 3.14159)
    return [(level, re.sub(r"^\s*[\d.]+s ", "", text)) for level, text in buf]


def test_logger_equal(tmp_path):
    assert _capture(tlogging) == _capture(jlogging)
    assert [lv for lv, _ in _capture(tlogging)] == [1, 2, 3, 4]
    path = str(tmp_path / "log.txt")
    for mod in (tlogging, jlogging):
        lg = mod.Logger(level=mod.EWarn)
        lg.clear_appenders()
        lg.add_appender(mod.StreamAppender(path=path))
        lg.info("not written")
        lg.warn("written by %s", mod.__name__.split(".")[0])
    lines = [re.sub(r"^\s*[\d.]+s ", "", t) for t in open(path).read().splitlines()]
    assert lines == ["WARN  written by mitsuba_tpu_torch", "WARN  written by mitsuba_tpu"]


def test_counters_equal(monkeypatch):
    # a registry of this test's counters alone: a render earlier in the
    # same process leaves "Samples rendered" in one package's registry
    for mod in (tlogging, jlogging):
        monkeypatch.setattr(mod, "_registry", {})
        mod.reset_statistics()
        mod.counter("Rays traced").add(1e6).add(2e6)
        mod.counter("Cache hits").add(30).add_base(40)
        mod.counter("Tiny").add(12.5)
    assert tlogging.stats_summary() == jlogging.stats_summary()
    assert "3M" in tlogging.stats_summary() and "75.00%" in tlogging.stats_summary()
    assert {k: (c.value, c.base) for k, c in tlogging.all_counters().items()
            if k in ("Rays traced", "Cache hits", "Tiny")} == {
        k: (c.value, c.base) for k, c in jlogging.all_counters().items()
        if k in ("Rays traced", "Cache hits", "Tiny")}
    tlogging.reset_statistics()
    assert tlogging.counter("Rays traced").value == 0.0
