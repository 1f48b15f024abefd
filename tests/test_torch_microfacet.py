"""The port's microfacet distributions (bsdf/microfacet.py) against the
reference on seeded numpy inputs, for Beckmann, GGX and Phong, isotropic
and anisotropic, with wi above and below the surface; and the port's own
samplers by chi-square (tests/chi2.py).

Tolerances (measured on 20,000 lanes per case: the largest differences
were 1.5e-5 relative in D and the pdfs, 4.6e-6 absolute in a classically
sampled normal and 5.6e-5 absolute in a visible Beckmann normal):

* D, G1, G and the pdfs: rtol = 1e-4, atol = 1e-6;
* sample_m_all: atol = 2e-5 on the unit normal;
* sample_m_visible / sample_m: atol = 2e-4 on the unit normal (the
  Beckmann sampler runs Newton steps on erf, seeded by erfinv, whose last
  places differ between XLA and PyTorch);
* the chi-square tests at the reference's significance, 1e-3.

The dispatchers sample_m and pdf_m are also held to the reference under
its non-default settings, MTS_VNDF=0 (classic sampling) and
MTS_BECK_NEWTON_ITERS=3, at the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.bsdf import microfacet as jmf
from mitsuba_tpu_torch.bsdf import microfacet as tmf
from tests.chi2 import chi2_test

torch.set_num_threads(1)

N = 8192
VAL = dict(rtol=1e-4, atol=1e-6)
DISTS = {"beckmann": tmf.BECKMANN, "ggx": tmf.GGX, "phong": tmf.PHONG}
ALPHAS = {"iso": (0.3, 0.3), "aniso": (0.1, 0.4), "smooth": (0.02, 0.02)}
CASES = [(d, a) for d in DISTS for a in ALPHAS]


def _dirs(seed, below=0.3):
    """Unit directions, a share `below` of them under the surface."""
    d = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    d[: int(N * below), 2] *= -1.0
    return d


def _args(dist, alphas):
    au, av = ALPHAS[alphas]
    return (np.full(N, DISTS[dist], np.int32), np.full(N, au, np.float32),
            np.full(N, av, np.float32))


def _both(fn, *args, **kw):
    ref = np.asarray(getattr(jmf, fn)(*[jnp.asarray(a) for a in args], **kw))
    out = getattr(tmf, fn)(*[torch.as_tensor(a) for a in args], **kw).numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    return out, ref


@pytest.mark.parametrize("dist,alphas", CASES)
def test_distribution_and_masking(dist, alphas):
    args = _args(dist, alphas)
    wi, wo, m = _dirs(1), _dirs(2), _dirs(3, below=0.1)
    np.testing.assert_allclose(*_both("microfacet_D", *args, m), **VAL)
    np.testing.assert_allclose(*_both("smith_g1", *args, wi, m), **VAL)
    np.testing.assert_allclose(*_both("smith_g", *args, wi, wo, m), **VAL)


@pytest.mark.parametrize("dist,alphas", CASES)
def test_classic_sampling(dist, alphas):
    args = _args(dist, alphas)
    u = np.random.default_rng(4).uniform(0, 1, (N, 2)).astype(np.float32)
    u[:4] = [[0, 0], [0.99999994, 0.5], [0.5, 0.99999994], [1e-7, 0.25]]
    np.testing.assert_allclose(*_both("sample_m_all", *args, u), rtol=0, atol=2e-5)
    np.testing.assert_allclose(*_both("pdf_m_all", *args, _dirs(5, below=0.1)), **VAL)


@pytest.mark.parametrize("dist,alphas", CASES)
def test_visible_sampling(dist, alphas):
    """Visible normals and their pdf, wi on both sides; also through the
    static `dists` of a scene and the default dispatchers."""
    args = _args(dist, alphas)
    wi = _dirs(6)
    u = np.random.default_rng(7).uniform(0, 1, (N, 2)).astype(np.float32)
    out, ref = _both("sample_m_visible", *args, wi, u)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4)
    assert (out[:, 2] > 0).all()
    np.testing.assert_allclose(
        *_both("sample_m_visible", *args, wi, u, dists=(DISTS[dist],)), rtol=0, atol=2e-4
    )
    np.testing.assert_allclose(*_both("sample_m", *args, wi, u), rtol=0, atol=2e-4)
    for fn in ("pdf_m_visible", "pdf_m"):
        np.testing.assert_allclose(*_both(fn, *args, wi, _dirs(8, below=0.1)), **VAL)


def test_mixed_distributions_per_lane():
    """Lanes of all three families in one call select per lane; the
    static `dists` tuple never enters a per-lane select."""
    r = np.random.default_rng(9)
    dist = r.integers(0, 3, N).astype(np.int32)
    au = r.uniform(0.02, 0.8, N).astype(np.float32)
    av = r.uniform(0.02, 0.8, N).astype(np.float32)
    wi = _dirs(10)
    u = r.uniform(0, 1, (N, 2)).astype(np.float32)
    for dists in (None, (0, 1), (0, 1, 2), ()):
        out, ref = _both("sample_m_visible", dist, au, av, wi, u, dists=dists)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-4, err_msg=str(dists))
    np.testing.assert_allclose(*_both("pdf_m_visible", dist, au, av, wi, _dirs(11)), **VAL)


def test_beckmann_slope_inversion():
    ct = np.random.default_rng(12).uniform(0.02, 1.0, N).astype(np.float32)
    u = np.random.default_rng(13).uniform(0, 1, N).astype(np.float32)
    np.testing.assert_allclose(*_both("_beckmann_visible_slope_x", ct, u), rtol=0, atol=2e-4)


SETTINGS = {"classic": (False, 8), "newton3": (True, 3)}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("dist", sorted(DISTS))
def test_dispatchers_under_settings(monkeypatch, setting, dist):
    """sample_m and pdf_m under the reference's non-default settings
    (MTS_VNDF=0: classic sampling; MTS_BECK_NEWTON_ITERS=3), set on both
    packages as their imports would set them."""
    vndf, iters = SETTINGS[setting]
    for mod in (jmf, tmf):
        monkeypatch.setattr(mod, "USE_VNDF", vndf)
        monkeypatch.setattr(mod, "_BECK_ITERS", iters)
    args = _args(dist, "aniso")
    wi = _dirs(14)
    u = np.random.default_rng(15).uniform(0, 1, (N, 2)).astype(np.float32)
    out, ref = _both("sample_m", *args, wi, u)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5 if not vndf else 2e-4)
    np.testing.assert_allclose(*_both("pdf_m", *args, wi, _dirs(16, below=0.1)), **VAL)
    if not vndf:  # classic sampling ignores wi
        np.testing.assert_array_equal(out, tmf.sample_m_all(*map(torch.as_tensor, args),
                                                            torch.as_tensor(u)).numpy())


@pytest.mark.parametrize("env,expect", [({}, (True, 8)),
                                        ({"MTS_VNDF": "0", "MTS_BECK_NEWTON_ITERS": "3"},
                                         (False, 3))])
def test_settings_read_at_import(env, expect):
    """The port reads MTS_VNDF and MTS_BECK_NEWTON_ITERS at import, as the
    reference does."""
    import os
    import subprocess
    import sys

    base = {k: v for k, v in os.environ.items() if k not in ("MTS_VNDF", "MTS_BECK_NEWTON_ITERS")}
    code = ("from mitsuba_tpu_torch.bsdf import microfacet as m; "
            "print(m.USE_VNDF, m._BECK_ITERS)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env={**base, **env}, cwd=root,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.split() == [str(expect[0]), str(expect[1])]


def test_roughness_projection_is_identity():
    a = torch.linspace(0.01, 1.0, 7)
    assert torch.equal(tmf.project_roughness_to_alpha(a), a)


CHI2_CASES = [
    (tmf.BECKMANN, 0.3, 0.3, 30, "visible"),
    (tmf.BECKMANN, 0.1, 0.4, 75, "visible"),
    (tmf.GGX, 0.3, 0.3, 30, "visible"),
    (tmf.GGX, 0.5, 0.05, 89, "visible"),
    (tmf.BECKMANN, 0.3, 0.3, 150, "visible"),  # wi below: flipped inside
    (tmf.GGX, 0.25, 0.25, 140, "visible"),
    (tmf.PHONG, 0.3, 0.3, 30, "visible"),  # classic sampling for Phong
    (tmf.BECKMANN, 0.2, 0.5, 0, "all"),
    (tmf.GGX, 0.2, 0.5, 0, "all"),
]


@pytest.mark.parametrize("dist,au,av,ti,kind", CHI2_CASES)
def test_port_samplers_chi2(dist, au, av, ti, kind):
    t = np.radians(ti)
    w = np.array([np.sin(t), 0.1, np.cos(t)])
    wi = torch.as_tensor(w / np.linalg.norm(w), dtype=torch.float32)

    def lanes(n):
        return (torch.full((n,), dist), torch.full((n,), au), torch.full((n,), av),
                wi.expand(n, 3))

    def sample_fn(u2):
        u2 = torch.as_tensor(np.array(u2))
        d, a, b, w_ = lanes(u2.shape[0])
        if kind == "all":
            return tmf.sample_m_all(d, a, b, u2).numpy()
        return tmf.sample_m_visible(d, a, b, w_, u2).numpy()

    def pdf_fn(m):
        m = torch.as_tensor(np.array(m))
        d, a, b, w_ = lanes(m.shape[0])
        if kind == "all":
            return tmf.pdf_m_all(d, a, b, m).numpy()
        return tmf.pdf_m_visible(d, a, b, w_, m).numpy()

    passed, _, msg = chi2_test(sample_fn, pdf_fn, n_samples=300_000, pdf_sub=32)
    assert passed, f"dist={dist} au={au} av={av} ti={ti} {kind}: {msg}"
