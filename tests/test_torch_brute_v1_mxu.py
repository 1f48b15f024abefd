"""The port's K11 (brute force on the transposed pack `tri_t`) and K12
(the bilinear Moller-Trumbore on `build_mt_matrix`'s operand): their plain
PyTorch versions against the reference's Pallas kernels `closest_hit` /
`any_hit` and `closest_hit_mxu` / `any_hit_mxu` in interpret mode, and the
port's packers against the reference's.

Inputs, made with numpy from a seed: the Cornell box's pack (36
triangles, t_max inf and 400), a 300-triangle random set and a
1,000-triangle one (Tp = 1,024 > 512: K11 has no triangle cap), each with
1,000 rays and t_max inf and 1.5.

Tolerances: the packers (`pack_triangles_transposed`, `build_mt_matrix`,
`pack_scene(...).tri_t`) are exactly equal.  Occlusion is equal.  prim is
equal, except on a near-tie: a ray whose two triangles, judged in
float64, lie at t within 1e-5 relative of each other or hit within 1e-5
of an edge in barycentrics (one cbox ray of the 1,000 is such a tie
between two halves of a wall in K11).  Such rays are at most 1 % of the
rays.  t is held at rtol 1e-5: XLA on the CPU may contract the products
into fused multiply-adds and sum K12's 16 products in another order than
the port's fixed one; for K12 also at 1e-6 relative to the terms t is
summed from (sum |f_k m_k| of t_num over |det|: a ray that starts near a
cbox wall, 550 units from the origin, cancels most of t_num).  The same holds for the ray features,
at 1e-6 relative to their largest term.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import pallas_kernels as jpk
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene as jload
from mitsuba_tpu_torch.accel import pallas_kernels as tpk
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene

torch.set_num_threads(1)

CBOX = os.path.join(os.path.dirname(__file__), "..", "scenes", "cbox.xml")
N_RAYS = 1000
INF = float("inf")


def _random_tris(n_tris, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N_RAYS, 3)).astype(np.float32)
    return v0, e1, e2, o, rng


def _dirs(rng):
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(v0, e1, e2, o, d, t_short, reference tri_t, port tri_t): numpy,
    except the port's tri_t."""
    if name == "cbox":
        jp = jpack_scene(jload(CBOX))
        tp = pack_scene(load_scene(CBOX), "cpu")
        n = jp.meta["n_static_tris"]
        v0, e1, e2 = (np.asarray(jp.arrays[k])[:n] for k in ("tri_v0", "tri_e1", "tri_e2"))
        rng = np.random.default_rng(11)
        o = rng.uniform([10, 10, -800], [546, 538, 550], (N_RAYS, 3)).astype(np.float32)
        return v0, e1, e2, o, _dirs(rng), 400.0, np.asarray(jp.tri_t), tp.tri_t
    n = {"random300": 300, "random1000": 1000}[name]
    v0, e1, e2, o, rng = _random_tris(n, {"random300": 0, "random1000": 5}[name])
    tri_t = jpk.pack_triangles_transposed(v0, e1, e2, n)
    return (v0, e1, e2, o, _dirs(rng), 1.5, tri_t,
            torch.as_tensor(tpk.pack_triangles_transposed(v0, e1, e2, n)))


SCENES = ("cbox", "random300", "random1000")


@pytest.fixture(params=[(s, short) for s in SCENES for short in (False, True)],
                ids=lambda p: f"{p[0]}-{'short' if p[1] else 'inf'}")
def case(request):
    name, short = request.param
    v0, e1, e2, o, d, t_short, jtri, ttri = _scene(name)
    return v0, e1, e2, o, d, t_short if short else INF, jtri, ttri


def _torch(o, d):
    return torch.as_tensor(o), torch.as_tensor(d)


def _mt64(o, d, v0, e1, e2):
    """float64 Moller-Trumbore of rays [R,3] against one triangle each
    -> (t, u, v, hit)."""
    o, d, v0, e1, e2 = (np.asarray(x, np.float64) for x in (o, d, v0, e1, e2))
    p = np.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = 1.0 / np.where(det == 0, 1.0, det)
    tv = o - v0
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return t, u, v, (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)


def _near_ties(o, d, v0, e1, e2, p_ref, p_out):
    """Rays where p_ref and p_out differ; asserts each is a near-tie in
    float64 (see the module docstring) and returns their count."""
    idx = np.nonzero(p_ref != p_out)[0]
    for i in idx:
        sides = [p for p in (p_ref[i], p_out[i]) if p >= 0]
        judged = [_mt64(o[i:i + 1], d[i:i + 1], v0[p:p + 1], e1[p:p + 1], e2[p:p + 1])
                  for p in sides]
        ts = [float(j[0][0]) for j in judged]
        edge = min(min(abs(float(j[1][0])), abs(float(j[2][0])),
                       abs(1 - float(j[1][0]) - float(j[2][0]))) for j in judged)
        tie = len(ts) == 2 and abs(ts[0] - ts[1]) <= 1e-5 * max(abs(ts[0]), abs(ts[1]))
        assert tie or edge <= 1e-5, (i, p_ref[i], p_out[i], ts, edge)
    return len(idx)


def _t_terms(o, d, mt, prim):
    """Per ray, sum |f_k m_k| of t_num over |det| of triangle prim (>= 0)
    in float64: the size of the terms K12's t is summed from."""
    f = tpk.ray_features(*_torch(o, d)).numpy().astype(np.float64)[:, :tpk.MT_ROWS]
    n = mt.shape[1] // 4
    m = mt.astype(np.float64)[:tpk.MT_ROWS]
    det = (f * m[:, prim].T).sum(-1)
    return (np.abs(f) * np.abs(m[:, 3 * n + prim].T)).sum(-1) / np.abs(det)


def _check_closest(ref, out, t_max, tris, o, d, mt=None):
    t_ref, p_ref = (np.asarray(x) for x in ref)
    t_out, p_out = (x.numpy() for x in out)
    assert _near_ties(o, d, *tris, p_ref, p_out) <= N_RAYS // 100
    same = p_out == p_ref
    hit = same & (p_out >= 0)
    assert hit.sum() > 20
    atol = 0.0 if mt is None else 1e-6 * _t_terms(o[hit], d[hit], mt, p_out[hit])
    assert (np.abs(t_out[hit] - t_ref[hit]) <= 1e-5 * np.abs(t_ref[hit]) + atol).all()
    miss = same & (p_out < 0)
    np.testing.assert_array_equal(t_out[miss], np.full(miss.sum(), t_max, np.float32))


def test_packers_match_reference():
    v0, e1, e2, _, _ = _random_tris(1000, 5)
    for n in (0, 1, 127, 128, 129, 300, 1000):
        np.testing.assert_array_equal(
            tpk.pack_triangles_transposed(v0, e1, e2, n),
            jpk.pack_triangles_transposed(v0, e1, e2, n), err_msg=str(n))
        np.testing.assert_array_equal(
            tpk.build_mt_matrix(v0, e1, e2, n), jpk.build_mt_matrix(v0, e1, e2, n),
            err_msg=str(n))


def test_pack_scene_tri_t_matches_reference():
    _, _, _, _, _, _, jtri, ttri = _scene("cbox")
    assert ttri.dtype == torch.float32 and tuple(ttri.shape) == (9, 128)
    np.testing.assert_array_equal(ttri.numpy(), jtri)


def test_ray_features_match_reference():
    _, _, _, o, d, _, _, _ = _scene("cbox")
    ref = np.asarray(jpk._ray_features(jnp.asarray(o), jnp.asarray(d)))
    out = tpk.ray_features(*_torch(o, d)).numpy()
    assert out.shape == (N_RAYS, 16) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, :3], d)
    np.testing.assert_array_equal(out[:, 6:9], o)
    np.testing.assert_array_equal(out[:, 9:], np.eye(1, 7, 0, np.float32).repeat(N_RAYS, 0))
    scale = np.abs(o).max() * np.abs(d).max()
    np.testing.assert_allclose(out[:, 3:6], ref[:, 3:6], rtol=0, atol=1e-6 * scale)


def test_v1_closest_matches_reference(case):
    v0, e1, e2, o, d, t_max, jtri, ttri = case
    ref = jpk.closest_hit(jnp.asarray(o), jnp.asarray(d), t_max, jnp.asarray(jtri),
                          interpret=True)
    out = tpk.closest_hit_v1_plain(*_torch(o, d), torch.full((N_RAYS,), t_max), ttri)
    _check_closest(ref, out, t_max, (v0, e1, e2), o, d)


def test_v1_any_matches_reference(case):
    v0, e1, e2, o, d, t_max, jtri, ttri = case
    ref = np.asarray(jpk.any_hit(jnp.asarray(o), jnp.asarray(d), t_max, jnp.asarray(jtri),
                                 interpret=True))
    out = tpk.any_hit_v1_plain(*_torch(o, d), torch.full((N_RAYS,), t_max), ttri).numpy()
    assert 10 < ref.sum()
    np.testing.assert_array_equal(out, ref)


def test_mxu_closest_matches_reference(case):
    v0, e1, e2, o, d, t_max, _, _ = case
    mt = tpk.build_mt_matrix(v0, e1, e2, len(v0))
    ref = jpk.closest_hit_mxu(jnp.asarray(o), jnp.asarray(d), t_max,
                              jnp.asarray(jpk.build_mt_matrix(v0, e1, e2, len(v0))),
                              interpret=True)
    out = tpk.closest_hit_mxu_plain(*_torch(o, d), torch.full((N_RAYS,), t_max),
                                    torch.as_tensor(mt))
    _check_closest(ref, out, t_max, (v0, e1, e2), o, d, mt)


def test_mxu_any_matches_reference(case):
    v0, e1, e2, o, d, t_max, _, _ = case
    n = len(v0)
    ref = np.asarray(jpk.any_hit_mxu(jnp.asarray(o), jnp.asarray(d), t_max,
                                     jnp.asarray(jpk.build_mt_matrix(v0, e1, e2, n)),
                                     interpret=True))
    out = tpk.any_hit_mxu_plain(*_torch(o, d), torch.full((N_RAYS,), t_max),
                                torch.as_tensor(tpk.build_mt_matrix(v0, e1, e2, n))).numpy()
    assert 10 < ref.sum()
    np.testing.assert_array_equal(out, ref)


def test_v1_and_mxu_agree_with_k1():
    """K11 computes K1's function on another layout: equal to K1's plain
    version on the sublane pack; K12 finds the same hits."""
    v0, e1, e2, o, d, _, _, ttri = _scene("random300")
    o, d = _torch(o, d)
    tm = torch.full((N_RAYS,), INF)
    tri_s = torch.as_tensor(tpk.pack_triangles_sublane(v0, e1, e2, 300))
    k1 = tpk.closest_hit_plain(o, d, tm, tri_s)
    k11 = tpk.closest_hit_v1_plain(o, d, tm, ttri)
    assert torch.equal(k1[0], k11[0]) and torch.equal(k1[1], k11[1])
    k12 = tpk.closest_hit_mxu_plain(o, d, tm, torch.as_tensor(tpk.build_mt_matrix(v0, e1, e2, 300)))
    assert torch.equal(k12[1], k1[1])
    torch.testing.assert_close(k12[0], k1[0], rtol=1e-5, atol=0)


def test_wrappers_on_cpu_run_plain_versions():
    v0, e1, e2, o, d, _, _, ttri = _scene("random1000")
    o, d = _torch(o, d)
    mt = torch.as_tensor(tpk.build_mt_matrix(v0, e1, e2, 1000))
    tm = torch.full((N_RAYS,), 1.5)
    fns = (tpk.closest_hit, tpk.any_hit, tpk.closest_hit_mxu, tpk.any_hit_mxu)
    before = [f.launches for f in fns]
    for t_max in (1.5, tm, INF):  # scalar, [R], inf
        tm_r = torch.as_tensor(t_max, dtype=torch.float32).expand(N_RAYS)
        a, b = tpk.closest_hit(o, d, t_max, ttri), tpk.closest_hit_v1_plain(o, d, tm_r, ttri)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert torch.equal(tpk.any_hit(o, d, t_max, ttri), tpk.any_hit_v1_plain(o, d, tm_r, ttri))
        a, b = tpk.closest_hit_mxu(o, d, t_max, mt), tpk.closest_hit_mxu_plain(o, d, tm_r, mt)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert torch.equal(tpk.any_hit_mxu(o, d, t_max, mt), tpk.any_hit_mxu_plain(o, d, tm_r, mt))
    # no kernel ran, so the launch counters did not move
    assert [f.launches for f in fns] == before


def test_plain_chunking_is_invisible(monkeypatch):
    """Splitting the rays into chunks changes no result."""
    v0, e1, e2, o, d, _, _, ttri = _scene("random1000")
    args = (*_torch(o, d), torch.full((N_RAYS,), INF))
    mt = torch.as_tensor(tpk.build_mt_matrix(v0, e1, e2, 1000))
    whole = (tpk.closest_hit_v1_plain(*args, ttri), tpk.closest_hit_mxu_plain(*args, mt),
             tpk.any_hit_mxu_plain(*args, mt))
    monkeypatch.setattr(tpk, "PLAIN_RAY_CHUNK", 97)
    chunked = (tpk.closest_hit_v1_plain(*args, ttri), tpk.closest_hit_mxu_plain(*args, mt),
               tpk.any_hit_mxu_plain(*args, mt))
    for a, b in zip(whole[:2], chunked[:2]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(whole[2], chunked[2])


@pytest.mark.parametrize("bad", ["dtype", "shape", "tri_rows", "tri_cols", "mt_cols"])
def test_wrappers_reject_bad_input(bad):
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    tri_t, mt = torch.zeros(9, 128), torch.zeros(16, 512)
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        d = torch.ones(4, 2)
    elif bad == "tri_rows":
        tri_t, mt = torch.zeros(8, 128), torch.zeros(15, 512)
    elif bad == "tri_cols":
        tri_t = torch.zeros(9, 100)
    else:
        mt = torch.zeros(16, 128)
    for fn, tri in ((tpk.closest_hit, tri_t), (tpk.any_hit, tri_t),
                    (tpk.closest_hit_mxu, mt), (tpk.any_hit_mxu, mt)):
        if (bad == "tri_cols" and tri is mt) or (bad == "mt_cols" and tri is tri_t):
            continue
        with pytest.raises((TypeError, ValueError)):
            fn(o, d, 1.0, tri)
