"""K1/K2 (`closest_hit_v2` / `any_hit_v2` on the sublane pack `tri_s`):
the column count of the port's kernel and its plain versions against the
reference's Pallas kernels in interpret mode.

The kernel (`csrc/brute_tiled.cu` `brute_kernel`) tests only the live
columns of a pack: up to the last column whose edges are not all zero
(`pallas_kernels.live_columns`).  A column with zero edges has det = 0 and
is never hit, so the plain versions restricted to the live columns must
equal the plain versions on all Tp columns, for any pack: the packs'
trailing padding, a degenerate last triangle, and interior zero columns,
which stay counted.

Inputs, made with numpy from a seed: random sets of 1, 7, 8, 36, 300 and
512 triangles with random rays, half of them aimed at the triangles; the Cornell box with its camera rays, and
with rays aimed at points of the diagonals its wall and box rectangles
share between their two triangles (ties in exact arithmetic); a 36-triangle
set with an interior and a trailing zero-edge column.  t_max finite and
1e30 (how accel/intersect.py passes an infinite one).

Tolerances: against the plain versions on all columns, equality.  Against
the reference: prim and occlusion equal, t within rtol 1e-4 (the port's
gate for hits, tests/test_pairs.py).  On the rays aimed at the diagonals,
which pass on or within rounding of an edge, the reference runs in a
Python process whose XLA is kept to the AVX instruction set
(`--xla_cpu_max_isa=AVX`): XLA on the CPU otherwise contracts products and
sums into fused multiply-adds, which the port never does, and rounds some
of those rays onto the other side of an edge (test_diagonals_with_fma
counts them).
"""

import functools
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import pallas_kernels as jpk
from mitsuba_tpu_torch.accel import pallas_kernels as tpk
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene
from mitsuba_tpu_torch.sensor.plugins import generate_rays

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CBOX = os.path.join(ROOT, "scenes", "cbox.xml")
N_RAYS = 500
RES = 24  # cbox camera rays: RES x RES


def _random(n_tris, seed=None):
    rng = np.random.default_rng(n_tris if seed is None else seed)
    v0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    # half of the rays aimed at a point of a triangle's parallelogram
    k = rng.integers(0, n_tris, N_RAYS // 2)
    ab = rng.uniform(0, 1, (N_RAYS // 2, 2, 1)).astype(np.float32)
    d[:N_RAYS // 2] = v0[k] + ab[:, 0] * e1[k] + ab[:, 1] * e2[k] - o[:N_RAYS // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_fin = rng.uniform(0.2, 3, N_RAYS).astype(np.float32)
    return (v0, e1, e2), n_tris, o, d, t_fin


@functools.lru_cache(maxsize=None)
def _cbox_pack():
    scene = load_scene(CBOX)
    scene.sensor.record.film.width = scene.sensor.record.film.height = RES
    return scene, pack_scene(scene, "cpu")


def _cbox_tris(pack):
    n = int((pack.tri_s[0] < 1e29).sum())  # padding holds v0 = 1e30
    return tuple(pack.arrays[k][:n].numpy() for k in ("tri_v0", "tri_e1", "tri_e2")), n


def _cbox_camera():
    scene, pack = _cbox_pack()
    rec = scene.sensor.record
    cam = rec.pack(RES, RES, "cpu")
    ys, xs = torch.meshgrid(torch.arange(RES, dtype=torch.float32),
                            torch.arange(RES, dtype=torch.float32), indexing="ij")
    pos01 = torch.stack([(xs.reshape(-1) + 0.5) / RES, (ys.reshape(-1) + 0.5) / RES], -1)
    o, d = generate_rays(cam, pos01, torch.zeros_like(pos01))
    rng = np.random.default_rng(3)
    tris, n = _cbox_tris(pack)
    t_fin = rng.uniform(200, 1500, len(o)).astype(np.float32)
    return tris, n, o.numpy(), d.numpy(), t_fin


def _cbox_diagonals():
    """Rays from random points in the box aimed at points of each shared
    edge of two consecutive triangles (the diagonal of a rectangle)."""
    _, pack = _cbox_pack()
    (v0, e1, e2), n = _cbox_tris(pack)
    verts = np.stack([v0, v0 + e1, v0 + e2], 1)  # [n, 3, 3]
    rng = np.random.default_rng(5)
    targets = []
    for k in range(n - 1):
        shared = [p for p in verts[k] if np.any(np.all(np.isclose(verts[k + 1], p), -1))]
        if len(shared) == 2:
            s = rng.uniform(0.05, 0.95, (24, 1)).astype(np.float32)
            targets.append(shared[0] + s * (shared[1] - shared[0]))
    targets = np.concatenate(targets).astype(np.float32)
    o = rng.uniform([20, 20, 20], [530, 530, 530], targets.shape).astype(np.float32)
    d = targets - o
    t_fin = np.linalg.norm(d, axis=-1).astype(np.float32) * 1.5
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return (v0, e1, e2), n, o, d, t_fin


def _zero_columns():
    """36 triangles; triangle 10 and the last have zero edges."""
    (v0, e1, e2), n, o, d, t_fin = _random(36, seed=7)
    for j in (10, n - 1):
        e1[j] = 0.0
        e2[j] = -0.0
    return (v0, e1, e2), n, o, d, t_fin


SCENES = {
    **{f"random{n}": functools.partial(_random, n) for n in (1, 7, 8, 36, 300, 512)},
    "cbox_camera": _cbox_camera,
    "cbox_diagonals": _cbox_diagonals,
    "zero_columns": _zero_columns,
}
# live columns: the real triangles with an edge, past any padding
LIVE = {"random1": 1, "random7": 7, "random8": 8, "random36": 36, "random300": 300,
        "random512": 512, "cbox_camera": 36, "cbox_diagonals": 36, "zero_columns": 35}


@functools.lru_cache(maxsize=None)
def _scene(name):
    tris, n, o, d, t_fin = SCENES[name]()
    tri_s = tpk.pack_triangles_sublane(*tris, n)
    return tri_s, o, d, t_fin


def _t_max(name, kind):
    _, o, _, t_fin = _scene(name)
    return t_fin if kind == "finite" else np.full(len(o), 1e30, np.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the reference's Pallas TPU kernels in interpret mode."""
    monkeypatch.setattr(
        jpk.pl, "pallas_call",
        functools.partial(jpk.pl.pallas_call, interpret=True),
    )


def _plain(tri_s, o, d, t_max, cols=None):
    """Plain K1/K2 of the port on the columns `cols` of tri_s (all when
    None), prims numbered as in tri_s."""
    tri = torch.as_tensor(tri_s)
    if cols is not None:
        tri = tri[:, cols]
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max), tri)
    (t, p), occ = tpk.closest_hit_plain(*args), tpk.any_hit_plain(*args)
    if cols is not None:
        p = torch.where(p >= 0, cols[p.long().clamp(min=0)], -1).to(torch.int32)
    return (t, p), occ


def _port(name, kind, live=False):
    """Plain K1/K2 of the port on tri_s, on its live columns if `live`."""
    tri_s, o, d, _ = _scene(name)
    cols = tpk.live_columns(torch.as_tensor(tri_s)) if live else None
    return _plain(tri_s, o, d, _t_max(name, kind), cols)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_live_columns(name):
    """The kernel's column count: the real triangles that have an edge,
    never the padding; an interior zero column stays counted."""
    tri_s, _, _, _ = _scene(name)
    assert tri_s.shape[1] % tpk.V2_TRI_SUB == 0
    cols = tpk.live_columns(torch.as_tensor(tri_s))
    assert torch.equal(cols, torch.arange(LIVE[name]))


@pytest.mark.parametrize("kind", ["finite", "far"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_live_columns_change_nothing(name, kind):
    """Plain K1/K2 on the live columns equal plain K1/K2 on all columns."""
    (t_all, p_all), occ_all = _port(name, kind)
    (t_live, p_live), occ_live = _port(name, kind, live=True)
    assert torch.equal(p_live, p_all)
    assert torch.equal(t_live, t_all)
    assert torch.equal(occ_live, occ_all)
    assert int((p_all >= 0).sum()) > 0 and 0 < int(occ_all.sum()) < len(occ_all)


def _hits64(o, d, tri_s, t_max):
    """Moller-Trumbore in float64 on tri_s's float32 values: (t, edge) [R,
    Tp], edge the least barycentric (min of u, v, 1 - u - v; negative
    outside), t inf where |det| <= 1e-12 or t is not in (1e-4, t_max)."""
    o, d, t_max = (np.asarray(x, np.float64) for x in (o, d, t_max))
    tri = np.asarray(tri_s, np.float64).T  # [Tp, 9]
    v0, e1, e2 = (tri[None, :, 3 * k:3 * k + 3] for k in range(3))
    p = np.cross(d[:, None], e2)
    det = (e1 * p).sum(-1)
    inv = 1.0 / np.where(det == 0, 1.0, det)
    tv = o[:, None] - v0
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1)
    v = (d[:, None] * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    ok = (np.abs(det) > 1e-12) & (t > 1e-4) & (t < t_max[:, None])
    return np.where(ok, t, np.inf), np.minimum(np.minimum(u, v), 1 - u - v)


_REFERENCE = """
import functools, sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from mitsuba_tpu.accel import pallas_kernels as jpk
jpk.pl.pallas_call = functools.partial(jpk.pl.pallas_call, interpret=True)
a = np.load(sys.argv[2])
args = [jax.numpy.asarray(a[k]) for k in ("o", "d", "t_max", "tri_s")]
t, p = jpk.closest_hit_v2(*args)
np.savez(sys.argv[3], t=np.asarray(t), p=np.asarray(p), occ=np.asarray(jpk.any_hit_v2(*args)))
"""


def _reference_without_fma(o, d, t_max, tri_s):
    """The reference's closest_hit_v2 / any_hit_v2 in interpret mode, run
    in a Python process whose XLA may use no instruction set past AVX, so
    that it has no fused multiply-add to contract a product and a sum
    into.  Returns (t, prim, occ) numpy."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX").strip()
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, o=o, d=d, t_max=t_max, tri_s=tri_s)
        subprocess.run([sys.executable, "-c", _REFERENCE, ROOT, inp, out],
                       check=True, env=env, timeout=600)
        res = np.load(out)
        return res["t"], res["p"], res["occ"]


def _reference(name, kind):
    """The reference's closest_hit_v2 / any_hit_v2 (Pallas, interpret
    mode) on the whole pack, in this process: (t, prim, occ) numpy."""
    tri_s, o, d, _ = _scene(name)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(_t_max(name, kind)), jnp.asarray(tri_s))
    t, p = jpk.closest_hit_v2(*args)
    return np.asarray(t), np.asarray(p), np.asarray(jpk.any_hit_v2(*args))


@pytest.mark.parametrize("kind", ["finite", "far"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_live_columns_vs_reference(name, kind, interpret_pallas):
    """Plain K1/K2 on the live columns against the reference's
    closest_hit_v2 / any_hit_v2 (Pallas, interpret mode) on the whole
    pack: prim and occlusion equal on every ray.  The rays aimed at the
    cbox diagonals pass on or within rounding of an edge, where a fused
    multiply-add changes the hit; for them the reference runs where XLA
    has none (`_reference_without_fma`)."""
    tri_s, o, d, _ = _scene(name)
    (t, p), occ = _port(name, kind, live=True)
    if name == "cbox_diagonals":
        t_ref, p_ref, occ_ref = _reference_without_fma(o, d, _t_max(name, kind), tri_s)
    else:
        t_ref, p_ref, occ_ref = _reference(name, kind)
    np.testing.assert_array_equal(p.numpy(), p_ref)
    np.testing.assert_array_equal(occ.numpy(), occ_ref)
    hit = p_ref >= 0
    assert hit.sum() > 0
    np.testing.assert_allclose(t.numpy()[hit], t_ref[hit], rtol=1e-4)


# rays of cbox_diagonals (of 480) on which the reference, with XLA free to
# fuse multiply-adds on an x86-64 CPU with FMA, differs from the port in
# prim or occlusion
DIAGONALS_FMA_DIFFER = {"finite": 50, "far": 49}


@pytest.mark.parametrize("kind", ["finite", "far"])
def test_diagonals_with_fma(kind, interpret_pallas):
    """Where XLA contracts into fused multiply-adds (this process), the
    reference differs from the port on at most the recorded count of the
    diagonal rays, and each of them passes within 1e-5 of the edge of a
    triangle it may hit (float64 barycentrics, `_hits64`): rounding at an
    edge, which test_live_columns_vs_reference shows is the port's
    rounding without the fused operations."""
    tri_s, o, d, _ = _scene("cbox_diagonals")
    t_max = _t_max("cbox_diagonals", kind)
    (_, p), occ = _port("cbox_diagonals", kind, live=True)
    _, p_ref, occ_ref = _reference("cbox_diagonals", kind)
    differ = (p.numpy() != p_ref) | (occ.numpy() != occ_ref)
    assert differ.sum() <= DIAGONALS_FMA_DIFFER[kind]
    t64, edge = _hits64(o[differ], d[differ], tri_s, t_max[differ])
    near_edge = np.isfinite(t64) & (np.abs(edge) <= 1e-5)
    assert near_edge.any(axis=1).all()


@pytest.mark.parametrize("kind", ["finite", "far"])
def test_diagonal_ties(kind):
    """The diagonal rays hold the first-index tie-break: at least 50 of
    them hit two or more triangles at one float32 t (the smallest), in
    float64 each of those triangles is hit within 1e-5 of its edges at a
    t within 1e-6 of the least, so the tie is geometric, and K1's prim is
    the first of them."""
    tri_s, o, d, _ = _scene("cbox_diagonals")
    t_max = _t_max("cbox_diagonals", kind)
    (_, p), _ = _port("cbox_diagonals", kind, live=True)
    t32, hit = tpk._mt_hit(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tri_s),
                           torch.as_tensor(t_max))
    t32 = torch.where(hit, t32, torch.inf).numpy()
    tmin = t32.min(axis=1, keepdims=True)
    at_min = (t32 == tmin) & np.isfinite(tmin)
    ties = at_min.sum(axis=1) >= 2
    assert ties.sum() >= 50
    t64, edge = _hits64(o[ties], d[ties], tri_s, t_max[ties])
    t64 = np.where(edge >= -1e-5, t64, np.inf)
    near64 = np.abs(t64 - t64.min(axis=1, keepdims=True)) <= 1e-6 * t64.min(axis=1, keepdims=True)
    assert (near64 | ~at_min[ties]).all()
    np.testing.assert_array_equal(p.numpy()[ties], at_min[ties].argmax(axis=1))


@pytest.mark.parametrize("n_tris,zero,n_live", [
    (1000, range(520, 1000), 520),             # the second chunk's live columns end early
    (700, range(300, 700), 300),               # no live column in the second chunk
    (1000, [511, *range(600, 1000)], 599),     # both chunks end early
    (1040, [3, 600], 1040),                    # interior zero columns in each chunk
])
def test_live_columns_by_chunk(n_tris, zero, n_live):
    """Past V2_CHUNK triangles the kernel stages the pack chunk by chunk
    and tests each chunk up to its own last live column: live_columns
    models that, and plain K1/K2 on those columns equal them on all."""
    (v0, e1, e2), n, o, d, t_fin = _random(n_tris)
    for j in zero:
        e1[j], e2[j] = 0.0, -0.0
    tri_s = tpk.pack_triangles_sublane(v0, e1, e2, n)
    cols = tpk.live_columns(torch.as_tensor(tri_s))
    assert cols.numel() == n_live
    live = np.zeros(tri_s.shape[1], bool)
    live[cols.numpy()] = True
    for c0 in range(0, tri_s.shape[1], tpk.V2_CHUNK):
        chunk = live[c0:c0 + tpk.V2_CHUNK]
        k = chunk.sum()
        assert chunk[:k].all()  # a prefix of the chunk
        assert (k == 0 or (tri_s[3:9, c0 + k - 1] != 0).any()) and (tri_s[3:9, c0 + k:c0 + tpk.V2_CHUNK] == 0).all()
    (t_all, p_all), occ_all = _plain(tri_s, o, d, t_fin)
    (t_live, p_live), occ_live = _plain(tri_s, o, d, t_fin, cols)
    assert torch.equal(p_live, p_all) and torch.equal(t_live, t_all)
    assert torch.equal(occ_live, occ_all)
    assert int((p_all >= 0).sum()) > 0
    assert bool((p_all >= tpk.V2_CHUNK).any()) == bool((cols >= tpk.V2_CHUNK).any())


def test_wrappers_on_cpu():
    """On the CPU the wrappers run the plain versions: equal results, any
    hit as torch.bool, and no launch counted; t_max as a contiguous float32
    [R] tensor is used as it is, and a scalar, float64 or strided one gives
    the same results."""
    tri_s, o, d, t_fin = _scene("random300")
    o, d, tri = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tri_s)
    t_max = torch.as_tensor(t_fin)
    before = (tpk.closest_hit_v2.launches, tpk.any_hit_v2.launches)
    assert tpk._prepare(o, d, t_max, tri)[2] is t_max
    ref_c = tpk.closest_hit_plain(o, d, t_max, tri)
    ref_a = tpk.any_hit_plain(o, d, t_max, tri)
    wide = torch.stack([t_max, t_max], 1)
    for tm in (t_max, t_max.double(), wide[:, 0]):
        t, p = tpk.closest_hit_v2(o, d, tm, tri)
        occ = tpk.any_hit_v2(o, d, tm, tri)
        assert occ.dtype == torch.bool
        assert torch.equal(t, ref_c[0]) and torch.equal(p, ref_c[1]) and torch.equal(occ, ref_a)
    far = torch.full((len(o),), 1.5)
    assert torch.equal(tpk.any_hit_v2(o, d, 1.5, tri), tpk.any_hit_plain(o, d, far, tri))
    assert (tpk.closest_hit_v2.launches, tpk.any_hit_v2.launches) == before
