"""The port's brute-force intersection (plain K1/K2 and the hit record
built on them) against the reference: the TPU kernels
`closest_hit_v2`/`any_hit_v2` run in Pallas interpret mode, and the XLA
brute force `_brute_force`/`_brute_force_any`.

Tolerances: prim and occlusion must be equal; t is held at rtol 1e-4
(the tolerance of tests/test_intersect.py); normals, uv and
barycentrics at rtol = atol = 1e-5, hit positions at 1e-5 relative to
the world-space terms they are summed from."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.accel import pallas_kernels as jpk
from mitsuba_tpu.scene.builder import ScenePack as JPack
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene as jload
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.accel import pallas_kernels as tpk
from mitsuba_tpu_torch.scene.builder import pack_from_numpy

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox.xml")


def _cbox():
    jp = jpack_scene(jload(CBOX))
    rng = np.random.default_rng(11)
    n = 1000
    o = rng.uniform([10, 10, -800], [546, 538, 550], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jp, o, d, np.full(n, 400.0, np.float32)


def _random300():
    rng = np.random.default_rng(0)
    t = 300
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (t, 3)).astype(np.float32)
    n = np.cross(e1, e2)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ns = [n + rng.normal(0, 0.1, (t, 3)).astype(np.float32) for _ in range(3)]

    def pad(a, fill=0):
        return np.concatenate([a, np.full((8,) + a.shape[1:], fill, a.dtype)])

    arrays = {
        "tri_v0": pad(v0, 1e30), "tri_e1": pad(e1), "tri_e2": pad(e2),
        "tri_n0": pad(ns[0]), "tri_n1": pad(ns[1]), "tri_n2": pad(ns[2]),
        "tri_uv0": pad(rng.uniform(0, 1, (t, 2)).astype(np.float32)),
        "tri_uv1": pad(rng.uniform(0, 1, (t, 2)).astype(np.float32)),
        "tri_uv2": pad(rng.uniform(0, 1, (t, 2)).astype(np.float32)),
        "tri_mat": pad(rng.integers(0, 4, t).astype(np.int32)),
        "tri_emit": pad(rng.integers(-1, 2, t).astype(np.int32), -1),
        "tri_s": jpk.pack_triangles_sublane(v0, e1, e2, t),
    }
    meta = {"n_tris": t, "n_static_tris": t, "n_spheres": 0, "use_bvh": False}
    jp = JPack({k: jnp.asarray(v) for k, v in arrays.items()}, meta)
    n_rays = 1000
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jp, o, d, np.full(n_rays, 1.5, np.float32)


SCENES = {"cbox": _cbox, "random300": _random300}


@pytest.fixture(params=sorted(SCENES))
def scene(request):
    jp, o, d, t_shadow = SCENES[request.param]()
    tp = pack_from_numpy(
        {k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu"
    )
    return jp, tp, o, d, t_shadow


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the reference's Pallas TPU kernels in interpret mode."""
    monkeypatch.setattr(
        jpk.pl, "pallas_call",
        functools.partial(jpk.pl.pallas_call, interpret=True),
    )


def _closest_port(tp, o, d):
    t, prim = tpk.closest_hit_plain(
        torch.as_tensor(o), torch.as_tensor(d),
        torch.full((len(o),), 1e30), tp.tri_s,
    )
    return t.numpy(), prim.numpy()


def _check_closest(t_ref, p_ref, t, p):
    np.testing.assert_array_equal(p, p_ref)
    hit = p >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-4)


def test_closest_vs_tpu_kernel(scene, interpret_pallas):
    """prim equals the TPU kernel's, except on rays where the reference's
    own two versions (kernel and XLA brute force) round a near-tie
    differently; there it equals the brute force's."""
    jp, tp, o, d, _ = scene
    t_ref, p_ref = (np.asarray(x) for x in jpk.closest_hit_v2(
        jnp.asarray(o), jnp.asarray(d), jnp.full(len(o), 1e30), jp.tri_s
    ))
    _, p_bf, _, _ = jis._brute_force(jp, jnp.asarray(o), jnp.asarray(d), jnp.inf)
    p_bf = np.asarray(p_bf)
    t, p = _closest_port(tp, o, d)
    ref_tie = p_ref != p_bf
    assert ref_tie.sum() <= 2
    np.testing.assert_array_equal(p[~ref_tie], p_ref[~ref_tie])
    np.testing.assert_array_equal(p[ref_tie], p_bf[ref_tie])
    hit = p >= 0
    assert hit.sum() > 50
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-4)


def test_closest_vs_xla_brute_force(scene):
    jp, tp, o, d, _ = scene
    t_ref, p_ref, _, _ = jis._brute_force(jp, jnp.asarray(o), jnp.asarray(d), jnp.inf)
    _check_closest(np.asarray(t_ref), np.asarray(p_ref), *_closest_port(tp, o, d))


def test_any_vs_tpu_kernel_and_xla(scene, interpret_pallas):
    jp, tp, o, d, t_shadow = scene
    occ = tpk.any_hit_plain(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_shadow), tp.tri_s
    ).numpy()
    ref_k = np.asarray(jpk.any_hit_v2(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_shadow), jp.tri_s
    ))
    ref_x = np.asarray(jis._brute_force_any(
        jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_shadow)
    ))
    assert 20 < occ.sum() < len(occ) - 20
    np.testing.assert_array_equal(occ, ref_k)
    np.testing.assert_array_equal(occ, ref_x)


def test_port_brute_force_matches_xla(scene):
    """The port's `_brute_force`/`_brute_force_any` (hit record incl. the
    recomputed winner u, v) against the reference's."""
    jp, tp, o, d, t_shadow = scene
    ref = [np.asarray(x) for x in jis._brute_force(
        jp, jnp.asarray(o), jnp.asarray(d), jnp.inf)]
    out = [x.numpy() for x in tis._brute_force(
        tp, torch.as_tensor(o), torch.as_tensor(d), float("inf"))]
    np.testing.assert_array_equal(out[1], ref[1])
    hit = ref[1] >= 0
    np.testing.assert_array_equal(np.isinf(out[0]), ~hit)
    for i in (0, 2, 3):  # t, u, v
        np.testing.assert_allclose(out[i][hit], ref[i][hit], rtol=1e-4, atol=1e-5)
    occ = tis._brute_force_any(
        tp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_shadow)
    ).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jis._brute_force_any(
        jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_shadow))))


def test_fill_interaction_matches(scene):
    jp, tp, o, d, _ = scene
    jh = jis.intersect(jp, jnp.asarray(o), jnp.asarray(d))
    ji = jis.fill_interaction(jp, jnp.asarray(o), jnp.asarray(d), jh)
    th = tis.intersect(tp, torch.as_tensor(o), torch.as_tensor(d))
    ti = tis.fill_interaction(tp, torch.as_tensor(o), torch.as_tensor(d), th)
    valid = np.asarray(ji.valid)
    np.testing.assert_array_equal(ti.valid.numpy(), valid)
    np.testing.assert_array_equal(ti.prim.numpy(), np.asarray(ji.prim))
    for name in ("mat", "emit"):
        np.testing.assert_array_equal(
            getattr(ti, name).numpy()[valid], np.asarray(getattr(ji, name))[valid]
        )
    # p = o + t d: held at 1e-5 relative to the terms it is summed from
    # (a coordinate near 0 can come from cancelling ~500-unit terms)
    p_err = np.abs(ti.p.numpy()[valid] - np.asarray(ji.p)[valid])
    scale = (np.abs(o) + np.abs(np.asarray(ji.t)[:, None] * d))[valid]
    assert (p_err <= 1e-5 * scale + 1e-5).all(), p_err.max()
    for name in ("ng", "ns", "uv", "bary"):
        np.testing.assert_allclose(
            getattr(ti, name).numpy()[valid],
            np.asarray(getattr(ji, name))[valid],
            rtol=1e-5, atol=1e-5, err_msg=name,
        )
    np.testing.assert_array_equal(ti.wi_world.numpy(), -d)


def test_occluded_matches(scene):
    jp, tp, o, d, t_shadow = scene
    ref = np.asarray(jis.occluded(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_shadow)))
    out = tis.occluded(tp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_shadow))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_wrapper_on_cpu_runs_plain_version():
    jp, o, d, t_shadow = _random300()
    tri_s = torch.tensor(np.asarray(jp.tri_s))
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    before = (tpk.closest_hit_v2.launches, tpk.any_hit_v2.launches)
    t1, p1 = tpk.closest_hit_v2(o, d, 1e30, tri_s)
    t2, p2 = tpk.closest_hit_plain(o, d, torch.full((len(o),), 1e30), tri_s)
    assert torch.equal(t1, t2) and torch.equal(p1, p2)
    occ = tpk.any_hit_v2(o, d, torch.as_tensor(t_shadow), tri_s)
    assert torch.equal(occ, tpk.any_hit_plain(o, d, torch.as_tensor(t_shadow), tri_s))
    # no kernel ran, so the launch counters did not move
    assert (tpk.closest_hit_v2.launches, tpk.any_hit_v2.launches) == before


def test_plain_chunking_is_invisible(monkeypatch):
    """Splitting the rays into chunks does not change any result."""
    jp, o, d, _ = _random300()
    tri_s = torch.tensor(np.asarray(jp.tri_s))
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.full((len(o),), 1e30), tri_s)
    whole = tpk.closest_hit_plain(*args)
    monkeypatch.setattr(tpk, "PLAIN_RAY_CHUNK", 97)
    chunked = tpk.closest_hit_plain(*args)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "tri_rows"],
)
def test_wrapper_rejects_bad_input(bad):
    o = torch.zeros(4, 3)
    d = torch.ones(4, 3)
    tri_s = torch.zeros(9, 8)
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        d = torch.ones(4, 2)
    else:
        tri_s = torch.zeros(8, 8)
    with pytest.raises((TypeError, ValueError)):
        tpk.closest_hit_v2(o, d, 1e30, tri_s)
    with pytest.raises((TypeError, ValueError)):
        tpk.any_hit_v2(o, d, 1e30, tri_s)


def test_tri_s_layout_matches_reference():
    jp, _, _, _ = _random300()
    v0, e1, e2 = (np.asarray(jp.arrays[k])[:300] for k in ("tri_v0", "tri_e1", "tri_e2"))
    for n in (0, 1, 8, 9, 300):
        np.testing.assert_array_equal(
            tpk.pack_triangles_sublane(v0, e1, e2, n),
            jpk.pack_triangles_sublane(v0, e1, e2, n),
        )
