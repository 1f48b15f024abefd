"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Needs a GPU and nvcc; marked `cuda` and skipped elsewhere.  This
file imports no JAX, so on a machine without JAX it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: the kernels are built without FMA contraction and evaluate
the plain versions' expressions in the same order (K12 sums each dot of
its bilinear form in the plain version's row order), so cluster lists,
prim, occlusion, t, u and v must be equal.
"""

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.accel import pairs
from mitsuba_tpu_torch.accel import pallas_bvh as pb
from mitsuba_tpu_torch.accel import pallas_kernels as pk
from mitsuba_tpu_torch.scene.builder import pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from torch_meshes import (
    bitmap_xml,
    bump_xml,
    bunny_scene_xml,
    bunny_standin,
    cloth_xml,
    geom_xml,
    textured_xml,
    write_ply,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_scene(dev, n_tris, n_rays, seed):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = r.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    e2 = r.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    tri_s = torch.as_tensor(pk.pack_triangles_sublane(v0, e1, e2, n_tris), device=dev)
    o = torch.as_tensor(r.uniform(-2, 2, (n_rays, 3)).astype(np.float32), device=dev)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = torch.as_tensor(r.uniform(0.2, 3, n_rays).astype(np.float32), device=dev)
    return o, torch.as_tensor(d, device=dev), t_max, tri_s


@pytest.mark.parametrize("n_rays", [70_001, 1, 255, 257, 262_145])
@pytest.mark.parametrize("n_tris", [1, 36, 300, 512, 1000])
def test_kernels_equal_plain(dev, n_tris, n_rays):
    """K1/K2 on tri_s, within one staged chunk and past it (no cap), at
    ragged ray counts; K2 returns torch.bool, and K11 (v1_kernel on tri_t)
    equals K1/K2."""
    o, d, t_max, tri_s = _random_scene(dev, n_tris, n_rays, n_tris)
    tri_t, _ = _tiled_operands(dev, n_tris, n_tris)
    for tm in (t_max, torch.full_like(t_max, 1e30)):
        t1, p1 = pk.closest_hit_v2(o, d, tm, tri_s)
        t2, p2 = pk.closest_hit_plain(o, d, tm, tri_s)
        assert torch.equal(p1, p2)
        assert torch.equal(t1, t2)
        occ = pk.any_hit_v2(o, d, tm, tri_s)
        assert occ.dtype == torch.bool
        assert torch.equal(occ, pk.any_hit_plain(o, d, tm, tri_s))
        _equal(pk.closest_hit(o, d, tm, tri_t), (t1, p1))
        assert torch.equal(pk.any_hit(o, d, tm, tri_t), occ)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_tris,zero", [
    (36, (10, 11, 35)),                  # interior columns and the last one
    (36, tuple(range(36))),              # no live column
    (1000, tuple(range(520, 1000))),     # the second chunk's live columns end early
    (700, tuple(range(300, 700))),       # no live column in the second chunk
])
def test_kernels_zero_columns_and_ties(dev, n_tris, zero):
    """K1/K2 equal plain on packs with zero-edge columns (the kernel tests
    each chunk up to its last live column, pk.live_columns) and with each
    triangle twice (exact ties: the first index wins), half of the rays
    aimed at the triangles."""
    r = np.random.default_rng(n_tris + len(zero))
    n = n_tris // 2
    v0 = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = r.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    e2 = r.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    v0, e1, e2 = (np.repeat(a, 2, axis=0) for a in (v0, e1, e2))
    n_rays = 20_001
    o = r.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    k = r.integers(0, n_tris, n_rays)
    d = v0[k] + r.uniform(0, 0.5, (n_rays, 1)) * e1[k] + r.uniform(0, 0.5, (n_rays, 1)) * e2[k] - o
    d[::2] = r.normal(size=(len(d[::2]), 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    for j in zero:
        e1[j], e2[j] = 0.0, -0.0
    tri_s = torch.as_tensor(pk.pack_triangles_sublane(v0, e1, e2, n_tris), device=dev)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    t_max = torch.as_tensor(r.uniform(0.2, 3, n_rays).astype(np.float32), device=dev)
    for tm in (t_max, torch.full_like(t_max, 1e30)):
        t1, p1 = pk.closest_hit_v2(o, d, tm, tri_s)
        t2, p2 = pk.closest_hit_plain(o, d, tm, tri_s)
        assert torch.equal(p1, p2) and torch.equal(t1, t2)
        assert torch.equal(pk.any_hit_v2(o, d, tm, tri_s), pk.any_hit_plain(o, d, tm, tri_s))
    if len(zero) < n_tris:
        assert bool((p1 >= 0).any()) and bool((p1 % 2 == 0)[p1 >= 0].all())  # ties: first index
    else:
        assert bool((p1 < 0).all())
    torch.cuda.synchronize()


@pytest.mark.parametrize("scale", [1e-5, 1e12, 7e18, 3e19, 1e30])
def test_kernels_extreme_scales(dev, scale):
    """K1/K2 equal plain with the edges scaled: det about 1e-12 (1e-5),
    ordinary (1e12), near 2^126 where some rays leave the kernel's fast
    reciprocal for IEEE division (7e18), past 2^126 (3e19) and infinite
    (1e30)."""
    o, d, t_max, tri_s = _random_scene(dev, 300, 50_001, 3)
    tri = tri_s.clone()
    tri[3:9] *= scale
    hits = 0
    for tm in (t_max, torch.full_like(t_max, 1e30)):
        t1, p1 = pk.closest_hit_v2(o, d, tm, tri)
        t2, p2 = pk.closest_hit_plain(o, d, tm, tri)
        assert torch.equal(p1, p2) and torch.equal(t1, t2)
        assert torch.equal(pk.any_hit_v2(o, d, tm, tri), pk.any_hit_plain(o, d, tm, tri))
        hits += int((p1 >= 0).sum())
    assert hits > 0 or scale in (1e-5, 1e30)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n_tris", [36, 1000])
def test_kernels_rays_that_cannot_hit(dev, n_tris):
    """K1/K2 equal plain where rays cannot hit, mixed into the warps: an
    origin or direction with an infinite or NaN component, t_max NaN, 0,
    negative or 1e-4 (the kernel settles these rays without a test, and
    K2 packs the others into its first threads); a block with none, some
    and all such rays."""
    o, d, t_max, tri_s = _random_scene(dev, n_tris, 3 * 256 + 77, 11)
    r = np.random.default_rng(5)
    bad = torch.as_tensor(r.random(o.shape[0]) < 0.5, device=dev)
    bad[:256] = False
    bad[256:512] = True
    kinds = torch.as_tensor(r.integers(0, 8, o.shape[0]), device=dev)
    inf, nan = float("inf"), float("nan")
    o, d, t_max = o.clone(), d.clone(), t_max.clone()
    comp = torch.as_tensor(r.integers(0, 3, o.shape[0]), device=dev)
    rows = torch.arange(o.shape[0], device=dev)
    for k, (arr, val) in enumerate(((o, inf), (o, nan), (d, -inf), (d, nan))):
        sel = bad & (kinds == k)
        arr[rows[sel], comp[sel]] = val
    for k, val in zip(range(4, 8), (nan, 0.0, -1.0, 1e-4)):
        t_max[bad & (kinds == k)] = val
    t1, p1 = pk.closest_hit_v2(o, d, t_max, tri_s)
    t2, p2 = pk.closest_hit_plain(o, d, t_max, tri_s)
    assert torch.equal(p1, p2)
    assert torch.equal(t1.isnan(), t2.isnan())
    assert torch.equal(t1[~t1.isnan()], t2[~t2.isnan()])
    assert bool((p1[bad] < 0).all()) and bool((p1[~bad] >= 0).any())
    occ = pk.any_hit_v2(o, d, t_max, tri_s)
    assert torch.equal(occ, pk.any_hit_plain(o, d, t_max, tri_s))
    assert not bool(occ[bad].any()) and bool(occ[~bad].any())
    torch.cuda.synchronize()


def test_launch_counters(dev):
    """One launch counted per wrapper call on the card, none for the plain
    versions."""
    o, d, t_max, tri_s = _random_scene(dev, 8, 100, 0)
    c0, a0 = pk.closest_hit_v2.launches, pk.any_hit_v2.launches
    pk.closest_hit_v2(o, d, t_max, tri_s)
    pk.any_hit_v2(o, d, t_max, tri_s)
    pk.any_hit_v2(o, d, t_max, tri_s)
    pk.closest_hit_plain(o, d, t_max, tri_s)
    pk.any_hit_plain(o, d, t_max, tri_s)
    assert (pk.closest_hit_v2.launches - c0, pk.any_hit_v2.launches - a0) == (1, 2)


def test_empty_ray_batch(dev):
    o, d, t_max, tri_s = _random_scene(dev, 8, 0, 0)
    t, p = pk.closest_hit_v2(o, d, t_max, tri_s)
    assert t.shape == (0,) and p.shape == (0,)


def _tiled_operands(dev, n_tris, seed):
    """tri_t and mt_matrix of the random set _random_scene(dev, n_tris, ..,
    seed) draws."""
    r = np.random.default_rng(seed)
    v0 = r.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = r.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    e2 = r.uniform(-0.2, 0.2, (n_tris, 3)).astype(np.float32)
    return (torch.as_tensor(pk.pack_triangles_transposed(v0, e1, e2, n_tris), device=dev),
            torch.as_tensor(pk.build_mt_matrix(v0, e1, e2, n_tris), device=dev))


@pytest.mark.parametrize("n_tris", [1, 100, 300, 1000])
def test_tiled_kernels_equal_plain(dev, n_tris):
    """K11 and K12 at a ragged ray count, at Tp = 128 and past 512 (no
    triangle cap), with t_max finite, inf and a scalar."""
    o, d, t_max, _ = _random_scene(dev, n_tris, 70_001, n_tris)
    tri_t, mt = _tiled_operands(dev, n_tris, n_tris)
    inf = torch.full_like(t_max, float("inf"))
    for tm in (t_max, inf, 1.5):
        tm_r = torch.as_tensor(tm, dtype=torch.float32, device=dev).expand(o.shape[0]).contiguous()
        for kern, plain, tri in ((pk.closest_hit, pk.closest_hit_v1_plain, tri_t),
                                 (pk.closest_hit_mxu, pk.closest_hit_mxu_plain, mt)):
            _equal(kern(o, d, tm, tri), plain(o, d, tm_r, tri))
        assert torch.equal(pk.any_hit(o, d, tm, tri_t), pk.any_hit_v1_plain(o, d, tm_r, tri_t))
        assert torch.equal(pk.any_hit_mxu(o, d, tm, mt), pk.any_hit_mxu_plain(o, d, tm_r, mt))
    # K11 computes K1's function on another padding of the same triangles
    tri_s = torch.as_tensor(pk.pack_triangles_sublane(
        *(tri_t[k * 3:k * 3 + 3, :n_tris].T.cpu().numpy() for k in range(3)), n_tris), device=dev)
    _equal(pk.closest_hit(o, d, t_max, tri_t), pk.closest_hit_v2(o, d, t_max, tri_s))
    torch.cuda.synchronize()


def test_tiled_launch_counters(dev):
    o, d, t_max, _ = _random_scene(dev, 8, 100, 0)
    tri_t, mt = _tiled_operands(dev, 8, 0)
    fns = (pk.closest_hit, pk.any_hit, pk.closest_hit_mxu, pk.any_hit_mxu)
    before = [f.launches for f in fns]
    pk.closest_hit(o, d, t_max, tri_t)
    pk.any_hit(o, d, t_max, tri_t)
    pk.any_hit(o, d, t_max, tri_t)
    pk.closest_hit_mxu(o, d, t_max, mt)
    pk.any_hit_mxu(o, d, t_max, mt)
    pk.closest_hit_v1_plain(o, d, t_max, tri_t)
    pk.any_hit_mxu_plain(o, d, t_max, mt)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 2, 1, 1]


def _cannot_hit(o, d, t_max, seed):
    """Copies of o, d, t_max where about half of the rays (none of the
    first 256, all of the next 256) cannot hit: an origin or direction
    component infinite or NaN, o x d overflowing to inf (o and d finite),
    t_max NaN, 0, negative or RAY_EPS.  Returns them, the bool mask and
    the rays of that mask whose o x d overflows (Moller-Trumbore, which
    forms no o x d, may hit those)."""
    r = np.random.default_rng(seed)
    n = o.shape[0]
    bad = torch.as_tensor(r.random(n) < 0.5, device=o.device)
    bad[:256] = False
    bad[256:512] = True
    kinds = torch.as_tensor(r.integers(0, 9, n), device=o.device)
    comp = torch.as_tensor(r.integers(0, 3, n), device=o.device)
    rows = torch.arange(n, device=o.device)
    o, d, t_max = o.clone(), d.clone(), t_max.clone()
    inf, nan = float("inf"), float("nan")
    for k, (arr, val) in enumerate(((o, inf), (o, nan), (d, -inf), (d, nan))):
        sel = bad & (kinds == k)
        arr[rows[sel], comp[sel]] = val
    sel = bad & (kinds == 4)  # finite, but o x d overflows
    o[sel] = torch.tensor([3e38, -3e38, 1e38], device=o.device)
    d[sel] = torch.tensor([0.6, 0.8, -0.5], device=o.device)
    for k, val in zip(range(5, 9), (nan, 0.0, -1.0, 1e-4)):
        t_max[bad & (kinds == k)] = val
    return o, d, t_max, bad, bad & (kinds == 4)


def _far(t_max, far):
    """t_max with every limit that leaves a hit possible (above RAY_EPS)
    set to far."""
    return torch.where(t_max > pk.RAY_EPS, torch.full_like(t_max, far), t_max)


def _same(a, b):
    """Outputs (t, prim) equal, t bit for bit where it is not NaN."""
    (t1, p1), (t2, p2) = a, b
    assert torch.equal(p1, p2)
    assert torch.equal(t1.isnan(), t2.isnan())
    assert torch.equal(t1[~t1.isnan()], t2[~t2.isnan()])


@pytest.mark.parametrize("n_tris", [36, 300, 1000])
def test_k11_equals_k1_in_both_packs(dev, n_tris):
    """K11 runs K1/K2's kernel: on tri_t it equals K1/K2 on tri_s and on
    tri_t, with rays that cannot hit mixed in, within one staged chunk and
    past it."""
    o, d, t_max, tri_s = _random_scene(dev, n_tris, 3 * 256 + 77, n_tris)
    tri_t, _ = _tiled_operands(dev, n_tris, n_tris)
    o, d, t_max, bad, overflow = _cannot_hit(o, d, t_max, n_tris)
    bad &= ~overflow
    for tm in (t_max, _far(t_max, 1e30)):
        k11 = pk.closest_hit(o, d, tm, tri_t)
        for tri in (tri_s, tri_t):
            _same(pk.closest_hit_v2(o, d, tm, tri), k11)
            assert torch.equal(pk.any_hit_v2(o, d, tm, tri), pk.any_hit(o, d, tm, tri_t))
        _same(k11, pk.closest_hit_v1_plain(o, d, tm, tri_t))
        assert bool((k11[1] >= 0).any()) and not bool((k11[1][bad] >= 0).any())
    torch.cuda.synchronize()


def _planted(mt, seed):
    """A copy of mt [16, 4 Tp] with a nonzero planted in each structural
    zero (rows 0-9 outside MXU_NONZERO) of a few columns each, so that
    those columns are flagged; returns it and the flagged columns."""
    r = np.random.default_rng(seed)
    mt = mt.clone()
    n = mt.shape[1] // 4
    zeros = np.argwhere(~pk.MXU_NONZERO)
    cols = r.choice(n, size=min(n, len(zeros)), replace=False)
    for (row, blk), col in zip(zeros, cols):
        mt[row, blk * n + col] = float(r.uniform(-0.05, 0.05))
    return mt, torch.as_tensor(np.sort(cols), device=mt.device)


@pytest.mark.parametrize("n_tris", [100, 300, 1000])
def test_mxu_equal_plain_planted_and_cannot_hit(dev, n_tris):
    """K12 equal to plain (prim and occlusion equal, t bit for bit) at Tp
    = 128, 384 and 1,024: on build_mt_matrix's operand, and on it with a
    nonzero planted in each structural zero of some columns (flagged: the
    full ten-row sums), with rays that cannot hit mixed in (non-finite
    features, o x d overflowing, NaN or tiny t_max)."""
    o, d, t_max, _ = _random_scene(dev, n_tris, 3 * 256 + 77, n_tris)
    _, mt = _tiled_operands(dev, n_tris, n_tris)
    o, d, t_max, bad, _ = _cannot_hit(o, d, t_max, n_tris + 1)
    assert not bool(pk.mxu_can_hit(o, d, t_max)[bad].any())
    planted, cols = _planted(mt, n_tris)
    assert not bool(pk.mxu_flags(mt).any())
    assert torch.equal(torch.nonzero(pk.mxu_flags(planted))[:, 0], cols)
    hits = 0
    for m in (mt, planted):
        for tm in (t_max, _far(t_max, float("inf"))):
            t1, p1 = pk.closest_hit_mxu(o, d, tm, m)
            _same((t1, p1), pk.closest_hit_mxu_plain(o, d, tm, m))
            occ = pk.any_hit_mxu(o, d, tm, m)
            assert occ.dtype == torch.bool
            assert torch.equal(occ, pk.any_hit_mxu_plain(o, d, tm, m))
            assert not bool(occ[bad].any()) and not bool((p1[bad] >= 0).any())
            hits += int((p1 >= 0).sum())
    assert hits > 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("scale,d_scale", [
    (1e-5, 1.0), (1e12, 1.0), (1e30, 1.0), (1e4, 1e34), (1e4, 1e35), (1e4, 1e36)])
def test_mxu_extreme_scales(dev, scale, d_scale):
    """K12 equal plain with the operand and the directions scaled: det
    about 1e-12 (1e-5), large (1e12, 1e30), and with directions of 1e34 to
    1e36 near 2^126 (rays whose bound cannot prove the fast reciprocal
    exact take IEEE division) and past it (infinite det)."""
    o, d, t_max, _ = _random_scene(dev, 300, 50_001, 3)
    _, mt = _tiled_operands(dev, 300, 3)
    mt, d = mt * scale, d * d_scale
    hits = 0
    for tm in (t_max, torch.full_like(t_max, float("inf"))):
        out = pk.closest_hit_mxu(o, d, tm, mt)
        _equal(out, pk.closest_hit_mxu_plain(o, d, tm, mt))
        assert torch.equal(pk.any_hit_mxu(o, d, tm, mt), pk.any_hit_mxu_plain(o, d, tm, mt))
        hits += int((out[1] >= 0).sum())
    assert hits > 0 or d_scale > 1 or scale == 1e-5
    torch.cuda.synchronize()


def test_k11_k12_one_kernel_per_call(dev):
    """Each K11/K12 wrapper call runs one kernel on the card and nothing
    else: no feature kernels, no `occ > 0` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    o, d, t_max, _ = _random_scene(dev, 300, 10_000, 1)
    tri_t, mt = _tiled_operands(dev, 300, 1)
    for fn, tri in ((pk.closest_hit, tri_t), (pk.any_hit, tri_t),
                    (pk.closest_hit_mxu, mt), (pk.any_hit_mxu, mt)):
        fn(o, d, t_max, tri)  # warm-up: the library is built and loaded
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(o, d, t_max, tri)
            torch.cuda.synchronize()
        on_card = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(on_card) == 1 and on_card[0][1] == 1, (fn.__name__, on_card)
        assert ("mxu_kernel" if "mxu" in fn.__name__ else "brute_kernel") in on_card[0][0]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A 16k-triangle stand-in mesh packed on the card, with 128x128
    camera rays and as many random rays around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import camera_rays

    path = str(tmp_path_factory.mktemp("mesh") / "m.ply")
    write_ply(path, *bunny_standin(seed=1, n_phi=128, n_theta=64))
    scene = load_scene_string(bunny_scene_xml(path, 128, 128))
    dev = torch.device("cuda")
    pack = pack_scene(scene, dev)
    o_c, d_c = camera_rays(scene, dev)
    r = np.random.default_rng(3)
    n = o_c.shape[0]
    o_r = (np.array([-0.02, 0.1, 0.0]) + r.uniform(-0.15, 0.15, (n, 3))).astype(np.float32)
    d_r = r.normal(size=(n, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o = torch.cat([o_c, torch.as_tensor(o_r, device=dev)])
    d = torch.cat([d_c, torch.as_tensor(d_r, device=dev)])
    t_any = torch.as_tensor(r.uniform(0.0, 0.3, 2 * n).astype(np.float32), device=dev)
    return pack, o.contiguous(), d.contiguous(), t_any


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_cluster_kernels_equal_plain(mesh, k):
    pack, o, d, t_any = mesh
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    t_big = torch.full_like(t_any, pairs.BIG)
    tabs = (pack.cl_cnt, pairs._tri_rows(pack))
    for tm in (t_big, t_any):
        cull = pairs.dense_cull(o, d, tm, pack.cl_mbox, c, k)
        _equal(cull, pairs.dense_cull_plain(o, d, tm, pack.cl_mbox, c, k))
        args = (o, d, tm, cull[0], pack.cl_tri, pack.cl_pad2prim, c, tc)
        _equal(pairs.pair_hit_closest(*args, *tabs), pairs.pair_hit_closest_plain(*args))
        args = (o, d, tm, cull[0], pack.cl_tri, c, tc)
        assert torch.equal(pairs.pair_hit_any(*args, *tabs), pairs.pair_hit_any_plain(*args))
    sub = slice(0, None, 8)  # the plain traversal is slow; every 8th ray
    for tm in (t_big, t_any):
        args = (o[sub].contiguous(), d[sub].contiguous(), tm[sub].contiguous(),
                pack.cl_box, pack.cl_tri, tc)
        _equal(pb.cluster_traverse_closest(*args), pb.cluster_traverse_closest_plain(*args))
        assert torch.equal(pb.cluster_traverse_any(*args), pb.cluster_traverse_any_plain(*args))
    torch.cuda.synchronize()


def _cull_boxes(dev, c, seed):
    """c cluster boxes as cl_mbox rows (lo xyz, hi xyz) along a random
    walk, so that neighbouring ids lie close as the BVH's treelet order
    puts them, with flat boxes (one extent 0) and a point box; and 4,096
    rays: from outside toward the boxes, random, axis-parallel (one or two
    zero direction components) and from inside boxes."""
    r = np.random.default_rng(seed)
    cen = np.cumsum(r.normal(scale=0.3, size=(c, 3)), axis=0)
    half = r.uniform(0.02, 0.4, (c, 3))
    half[1::5, r.integers(0, 3)] = 0.0
    half[c // 2 if c > 2 else 0:c > 2] = 0.0
    mbox = np.concatenate([cen - half, cen + half], 1).astype(np.float32)
    n = 1024
    o_out = cen.mean(0) + 20 * r.normal(size=(n, 3))
    d_out = cen[r.integers(0, c, n)] - o_out
    o_rnd = r.uniform(cen.min(0) - 1, cen.max(0) + 1, (n, 3))
    d_rnd = r.normal(size=(n, 3))
    o_ax = r.uniform(cen.min(0) - 1, cen.max(0) + 1, (n, 3))
    d_ax = r.normal(size=(n, 3))
    d_ax[: n // 2, r.integers(0, 3)] = 0.0
    d_ax[n // 2:, :2] = 0.0
    o_in = cen[r.integers(0, c, n)] + r.uniform(-0.01, 0.01, (n, 3))
    d_in = r.normal(size=(n, 3))
    o = np.concatenate([o_out, o_rnd, o_ax, o_in]).astype(np.float32)
    d = np.concatenate([d_out, d_rnd, d_ax, d_in])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = r.uniform(0.0, 10.0, 4 * n).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (mbox, o, d, t_max)]


@pytest.mark.parametrize("c", [1, 15, 16, 17, 773, 1890])
def test_dense_cull_groups_equal_plain(dev, c):
    """K3 (groups of 16 clusters first) at one cluster, partial and whole
    last groups, the 69k stand-in's 773 and the dense-cull bound's 1,890
    (past 48 KB of shared memory), every K up to 8, t_max random, tiny and
    BIG."""
    mbox, o, d, t_max = _cull_boxes(dev, c, c)
    for tm in (t_max, torch.full_like(t_max, 1e-6), torch.full_like(t_max, pairs.BIG)):
        for k in range(1, min(8, c) + 1):
            _equal(pairs.dense_cull(o, d, tm, mbox, c, k), pairs.dense_cull_plain(o, d, tm, mbox, c, k))
    cull = pairs.dense_cull(o, d, t_max, mbox, c, 1)
    assert (cull[0] < c).any() and (c == 1 or (cull[2] > 1).any())
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [0, 1, 31, 33, 262_144])
def test_pair_kernels_edges(mesh, n):
    """K4 on batches of none, one, fewer and more rays than a warp has
    lanes, and 262,144 (the mesh's rays repeated): on the cull's lists, on
    all-empty lists, with t_max BIG, random and <= 0; clusters with
    cl_cnt < Tc."""
    pack, o, d, t_any = mesh
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    assert bool((pack.cl_cnt < tc).any())
    idx = torch.arange(n, device=o.device) % o.shape[0]
    o_n, d_n, t_n = o[idx].contiguous(), d[idx].contiguous(), t_any[idx].contiguous()
    t_big = torch.full_like(t_n, pairs.BIG)
    t_le0 = torch.where(idx % 3 == 0, 0.0, -t_n)
    tabs = (pack.cl_cnt, pairs._tri_rows(pack))
    cids = pairs.dense_cull(o_n, d_n, t_big, pack.cl_mbox, c, 3)[0]
    for lists in (cids, torch.full_like(cids, c)):
        for tm in (t_big, t_n, t_le0):
            args = (o_n, d_n, tm, lists, pack.cl_tri, pack.cl_pad2prim, c, tc)
            out = pairs.pair_hit_closest(*args, *tabs)
            assert out[0].shape == (n, 3)
            _equal(out, pairs.pair_hit_closest_plain(*args))
            args = (o_n, d_n, tm, lists, pack.cl_tri, c, tc)
            assert torch.equal(pairs.pair_hit_any(*args, *tabs), pairs.pair_hit_any_plain(*args))
    torch.cuda.synchronize()


def test_tri_rows_on_the_bigmesh_path(mesh):
    """A pack without cl_tri_rows gets it on its first K4 call through
    pair_closest (below DENSE_C), and keeps it."""
    pack, o, d, t_any = mesh
    fresh = type(pack)({k: v for k, v in pack.arrays.items() if k != "cl_tri_rows"}, pack.meta)
    before = pairs.pair_hit_closest.launches
    pairs.pair_closest(fresh, o, d, float("inf"))
    assert pairs.pair_hit_closest.launches == before + 1
    rows = fresh.arrays["cl_tri_rows"]
    assert rows.is_contiguous() and torch.equal(rows, fresh.cl_tri.T)
    pairs.pair_any(fresh, o, d, t_any)
    assert fresh.arrays["cl_tri_rows"] is rows


def test_traverse_stats_equal_stream(mesh):
    """K7/K8 (boxes in shared memory) equal the plain walk, and their
    stats equal K9/K10's (boxes from L2) on the same inputs: one walk, the
    same windows."""
    pack, o, d, t_any = mesh
    sub = slice(0, None, 8)
    for tm in (torch.full_like(t_any, pairs.BIG), t_any):
        args = (o[sub].contiguous(), d[sub].contiguous(), tm[sub].contiguous(),
                pack.cl_box, pack.cl_tri, pack.meta["cluster_tc"])
        st7, st9 = (torch.zeros(args[0].shape[0], 2, dtype=torch.int32, device=o.device)
                    for _ in range(2))
        k7 = pb.cluster_traverse_closest(*args, stats=st7)
        _equal(k7, pb.cluster_traverse_closest_plain(*args))
        _equal(k7, pb.cluster_stream_closest(*args, stats=st9))
        assert torch.equal(st7, st9) and int(st7[:, 0].max()) > 0
        k8 = pb.cluster_traverse_any(*args, stats=st7)
        assert torch.equal(k8, pb.cluster_traverse_any_plain(*args))
        assert torch.equal(k8, pb.cluster_stream_any(*args, stats=st9))
        assert torch.equal(st7, st9)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [0, 1, 9, 31, 33])
def test_traverse_small_batches(mesh, n):
    """K7/K8 on batches of fewer rays than a block has warps, one more
    (two blocks), fewer and more than a warp has lanes, and none."""
    pack, o, d, t_any = mesh
    for tm in (torch.full_like(t_any, pairs.BIG), t_any):
        args = (o[-n:][:n].contiguous(), d[-n:][:n].contiguous(), tm[-n:][:n].contiguous(),
                pack.cl_box, pack.cl_tri, pack.meta["cluster_tc"])
        out = pb.cluster_traverse_closest(*args)
        assert out[0].shape == (n,)
        _equal(out, pb.cluster_traverse_closest_plain(*args))
        assert torch.equal(pb.cluster_traverse_any(*args), pb.cluster_traverse_any_plain(*args))
    torch.cuda.synchronize()


def test_pair_pipeline_on_card_equals_cpu(mesh):
    """pair_closest / pair_any through the kernels equal the plain
    versions on the CPU, overflow fallback included."""
    pack, o, d, t_any = mesh
    cpu = type(pack)({k: v.cpu() for k, v in pack.arrays.items()}, pack.meta)
    for k in (3, 1):
        pairs.K, natural = k, pairs.K
        try:
            gpu_hit = pairs.pair_closest(pack, o, d, float("inf"))
            cpu_hit = pairs.pair_closest(cpu, o.cpu(), d.cpu(), float("inf"))
            _equal([x.cpu() for x in gpu_hit], cpu_hit)
            assert torch.equal(pairs.pair_any(pack, o, d, t_any).cpu(),
                               pairs.pair_any(cpu, o.cpu(), d.cpu(), t_any.cpu()))
        finally:
            pairs.K = natural


def test_cluster_launch_counters(mesh):
    pack, o, d, t_any = mesh
    fns = (pairs.dense_cull, pairs.pair_hit_closest, pairs.pair_hit_any,
           pb.cluster_traverse_closest, pb.cluster_traverse_any)
    before = [f.launches for f in fns]
    pairs.pair_closest(pack, o, d, float("inf"))
    pairs.pair_any(pack, o, d, t_any)
    pb.cluster_closest(pack, o[:100], d[:100], float("inf"))
    pb.cluster_any(pack, o[:100], d[:100], t_any[:100])
    pb.cluster_traverse_closest_plain(o[:10], d[:10], t_any[:10], pack.cl_box,
                                      pack.cl_tri, pack.meta["cluster_tc"])
    after = [f.launches - b for f, b in zip(fns, before)]
    assert after[0] == 2 and after[1] == after[2] == 1
    assert after[3] >= 1 and after[4] >= 1


@pytest.fixture(scope="module", params=["small", "band"])
def dense_mesh(request, tmp_path_factory):
    """Stand-in meshes for the dense-mesh kernels: 16k triangles (~180
    clusters) and 134,688 triangles (1,529 clusters: the band between the
    reference's VMEM-resident tiles and its dense-cull bound), packed on
    the card, with 128x128 camera rays and as many random rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import camera_rays

    n_phi, n_theta = {"small": (128, 64), "band": (368, 184)}[request.param]
    path = str(tmp_path_factory.mktemp("dense") / "m.ply")
    write_ply(path, *bunny_standin(seed=2, n_phi=n_phi, n_theta=n_theta))
    scene = load_scene_string(bunny_scene_xml(path, 128, 128))
    dev = torch.device("cuda")
    pack = pack_scene(scene, dev)
    if request.param == "band":
        assert 1365 < pack.meta["n_clusters"] <= pairs.DENSE_C
    o_c, d_c = camera_rays(scene, dev)
    r = np.random.default_rng(4)
    n = o_c.shape[0]
    o_r = (np.array([-0.02, 0.1, 0.0]) + r.uniform(-0.15, 0.15, (n, 3))).astype(np.float32)
    d_r = r.normal(size=(n, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o = torch.cat([o_c, torch.as_tensor(o_r, device=dev)])
    d = torch.cat([d_c, torch.as_tensor(d_r, device=dev)])
    t_any = torch.as_tensor(r.uniform(0.0, 0.3, 2 * n).astype(np.float32), device=dev)
    return pack, o.contiguous(), d.contiguous(), t_any


@pytest.mark.parametrize("k,ks", [(3, 8), (1, 1), (8, 2)])
def test_dense_kernels_equal_plain(dense_mesh, k, ks):
    """K5 and K6 (closest, any) against their plain versions."""
    pack, o, d, t_any = dense_mesh
    m = pack.meta
    c, tc, s = m["n_clusters"], m["cluster_tc"], m["n_supers"]
    t_big = torch.full_like(t_any, pairs.BIG)
    for tm in (t_big, t_any):
        args = (o, d, tm, pack.cl_sup, pack.cl_mbox, s, c, ks, k)
        cull = pairs.two_level_cull(*args)
        _equal(cull, pairs.two_level_cull_plain(*args))
        assert (cull[0] < c).any()
        queue = pairs.pair_queue(cull[0])
        args = (o, d, tm, *queue, k, pack.cl_tri, pack.cl_pad2prim, c, tc)
        _equal(pairs.window_hit_closest(*args, pack.cl_cnt, pairs._tri_rows(pack)),
               pairs.window_hit_closest_plain(*args))
        args = (o, d, tm, *queue, k, pack.cl_tri, c, tc)
        assert torch.equal(pairs.window_hit_any(*args, pack.cl_cnt, pairs._tri_rows(pack)),
                           pairs.window_hit_any_plain(*args))
    torch.cuda.synchronize()


def _synthetic_dense(dev, seed, n_rays):
    """Hand-made dense-mesh tables (Tc = 128, 768 clusters, 48 supers of
    G = 16) that trap K5 and K6: cluster 0 holds one triangle, cluster 1
    exactly Tc, cluster 2 none (cl_cnt 0), the rest 1..Tc with some zero
    e2 columns inside; super 5 repeats super 4's boxes (equal entries at
    both levels: the tie order); supers 32..47 (the third group of 16) lie
    100 units behind the others, except super 40, so that rays aimed at
    super 40 hit one super of an otherwise far group.  Rays: a third from a
    camera toward the grid, a third random (an incoherent queue: many runs
    per window), a third aimed at super 40; n_rays need not fill windows
    of 256 pairs, and rays that miss leave empty slots in the queue."""
    from mitsuba_tpu_torch.scene.builder import cluster_columns

    r = np.random.default_rng(seed)
    tc, g, s = 128, 16, 48
    c = s * g
    sup_xyz = np.stack([np.arange(s) % 8 * 2.0, np.arange(s) // 8 * 2.0, np.zeros(s)], 1)
    far = (np.arange(s) >= 32) & (np.arange(s) != 40)
    sup_xyz[far, 2] += 100.0
    sub = np.stack([np.arange(g) % 4 * 0.4, np.arange(g) // 4 * 0.4, np.zeros(g)], 1)
    n_tri = r.integers(1, tc + 1, c)
    n_tri[:3] = (1, tc, 0)
    tri = np.zeros((9, c * tc), np.float32)
    tri[0:3] = 1e30
    lo, hi = np.zeros((c, 3), np.float32), np.zeros((c, 3), np.float32)
    for k in range(c):
        sk = 4 if k // g == 5 else k // g  # super 5 copies super 4
        kr = np.random.default_rng((seed, sk, k % g))
        n = n_tri[k] if k // g != 5 else n_tri[4 * g + k % g]
        cen = sup_xyz[sk] + sub[k % g]
        v0 = cen + kr.uniform(-0.15, 0.15, (n, 3))
        e1, e2 = kr.uniform(-0.1, 0.1, (n, 3)), kr.uniform(-0.1, 0.1, (n, 3))
        e2[3::5] = 0.0  # zero e2 columns inside the tile
        tri[:, k * tc:k * tc + n] = np.concatenate([v0, e1, e2], 1).T
        pts = np.concatenate([v0, v0 + e1, v0 + e2]) if n else cen[None]
        lo[k], hi[k] = pts.min(0), pts.max(0)
    mbox = np.concatenate([lo, hi], 1).astype(np.float32).reshape(s, g * 6)
    sup = np.zeros((8, s), np.float32)
    sup[0:3] = lo.reshape(s, g, 3).min(1).T
    sup[3:6] = hi.reshape(s, g, 3).max(1).T
    m = n_rays // 3
    cam = np.tile([7.0, 5.0, -20.0], (m, 1))
    d_cam = np.stack([r.uniform(-1, 15, m), r.uniform(-1, 11, m), np.zeros(m)], 1) - cam
    o_rnd = r.uniform([-1, -1, -1], [15, 11, 1], (m, 3))
    d_rnd = r.normal(size=(m, 3))
    n40 = n_rays - 2 * m
    o40 = np.tile([8.6, 10.6, -20.0], (n40, 1))
    d40 = sup_xyz[40] + r.uniform(0.0, 1.4, (n40, 3)) * [1, 1, 0] - o40
    o = np.concatenate([cam, o_rnd, o40]).astype(np.float32)
    d = np.concatenate([d_cam, d_rnd, d40])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_any = r.uniform(0.0, 25.0, n_rays).astype(np.float32)
    pad2prim = np.arange(c * tc, dtype=np.int32)
    tabs = dict(cl_sup=sup, cl_mbox=mbox, cl_tri=tri, cl_pad2prim=pad2prim,
                cl_cnt=cluster_columns(tri, tc), cl_tri_rows=np.ascontiguousarray(tri.T))
    tabs = {k: torch.as_tensor(v, device=dev) for k, v in tabs.items()}
    return (torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev),
            torch.as_tensor(t_any, device=dev), tabs, s, c, tc)


@pytest.mark.parametrize("n_rays", [3001, 517, 40])
@pytest.mark.parametrize("k,ks", [(3, 8), (1, 1), (8, 2)])
def test_dense_kernels_synthetic(dev, n_rays, k, ks):
    """K5 and K6 equal their plain versions on _synthetic_dense.  At 3,001
    rays K6 meets runs of at least 16 entries (each lane takes a pair) and
    shorter ones (the lanes split each pair's columns); at 40 rays nearly
    every run is short."""
    o, d, t_any, tabs, s, c, tc = _synthetic_dense(dev, 1, n_rays)
    assert tabs["cl_cnt"][:3].tolist() == [4, tc, 0]
    t_big = torch.full_like(t_any, pairs.BIG)
    for tm in (t_big, t_any):
        args = (o, d, tm, tabs["cl_sup"], tabs["cl_mbox"], s, c, ks, k)
        cull = pairs.two_level_cull(*args)
        _equal(cull, pairs.two_level_cull_plain(*args))
        cid_q, pair_q = pairs.pair_queue(cull[0])
        valid = cid_q < c
        assert valid.any() and not valid.all() and cid_q.numel() % 256
        if n_rays == 3001 and tm is t_big:
            runs = torch.unique_consecutive(cid_q[valid], return_counts=True)[1]
            assert runs.max() >= 16 and runs.min() < 16
        args = (o, d, tm, cid_q, pair_q, k, tabs["cl_tri"], tabs["cl_pad2prim"], c, tc)
        closest = pairs.window_hit_closest(*args, tabs["cl_cnt"], tabs["cl_tri_rows"])
        _equal(closest, pairs.window_hit_closest_plain(*args))
        args = (o, d, tm, cid_q, pair_q, k, tabs["cl_tri"], c, tc)
        assert torch.equal(pairs.window_hit_any(*args, tabs["cl_cnt"], tabs["cl_tri_rows"]),
                           pairs.window_hit_any_plain(*args))
        if tm is t_big:
            assert (closest[1] >= 0).any()
            # super 40 kept for the rays aimed at it, from the far group
            assert ((cull[0][2 * (n_rays // 3):] // 16) == 40).any()
    torch.cuda.synchronize()


def test_dense_kernels_no_rays(dev):
    """K5 and K6 on R = 0 launch nothing and return empty outputs."""
    o, d, t_any, tabs, s, c, tc = _synthetic_dense(dev, 2, 3)
    o, d, t_any = o[:0], d[:0], t_any[:0]
    cull = pairs.two_level_cull(o, d, t_any, tabs["cl_sup"], tabs["cl_mbox"], s, c, 8, 3)
    assert [x.shape[0] for x in cull] == [0] * 6
    cid_q, pair_q = pairs.pair_queue(cull[0])
    out = pairs.window_hit_closest(o, d, t_any, cid_q, pair_q, 3, tabs["cl_tri"],
                                   tabs["cl_pad2prim"], c, tc, tabs["cl_cnt"], tabs["cl_tri_rows"])
    assert out[0].shape == (0, 3)
    occ = pairs.window_hit_any(o, d, t_any, cid_q, pair_q, 3, tabs["cl_tri"], c, tc, tabs["cl_cnt"],
                               tabs["cl_tri_rows"])
    assert occ.shape == (0, 3)
    torch.cuda.synchronize()


def test_stream_kernels_equal_plain(dense_mesh):
    """K9/K10 against their plain versions (every 8th ray: the plain walk
    is slow) and against K7/K8, which compute the same walk."""
    pack, o, d, t_any = dense_mesh
    tc = pack.meta["cluster_tc"]
    sub = slice(0, None, 8)
    for tm in (torch.full_like(t_any, pairs.BIG), t_any):
        args = (o[sub].contiguous(), d[sub].contiguous(), tm[sub].contiguous(),
                pack.cl_box, pack.cl_tri, tc)
        k9 = pb.cluster_stream_closest(*args)
        _equal(k9, pb.cluster_stream_closest_plain(*args))
        _equal(k9, pb.cluster_traverse_closest(*args))
        k10 = pb.cluster_stream_any(*args)
        assert torch.equal(k10, pb.cluster_stream_any_plain(*args))
        assert torch.equal(k10, pb.cluster_traverse_any(*args))
    torch.cuda.synchronize()


def _window_trap(dev, seed):
    """Cluster tables that trap the K9 window (32 entries, lane lists of
    8): 80 clusters share one box, so every ray meets 80 equal entries,
    ordered by cid, across more than two windows; 50 of them lie 32 cids
    apart (all in one lane's list, which overflows) and 30 more likewise;
    clusters 5 and 37 (both shared) hold the same large triangle, a tie
    in t that the first visited wins.  The other 1,520 clusters have scattered
    boxes.  Rays: 4,096 from a sphere of radius 4 toward the shared box,
    and 4,096 starting inside it (entry 0 for all of them)."""
    r = np.random.default_rng(seed)
    c, tc = 1600, 128
    shared = np.r_[32 * np.arange(50) + 5, 32 * np.arange(30) + 17]
    lo = r.uniform(-3, 2.5, (c, 3))
    hi = lo + r.uniform(0.2, 1.0, (c, 3))
    lo[shared], hi[shared] = -1.0, 1.0
    n_tri = np.where(np.isin(np.arange(c), shared), 4, r.integers(0, 6, c))
    tri = np.zeros((9, c * tc), np.float32)
    tri[0:3] = 1e30
    for k in range(c):
        for j in range(n_tri[k]):
            tri[:, k * tc + j] = np.r_[r.uniform(lo[k], hi[k]), r.uniform(-0.4, 0.4, 6)]
    tri[:, 5 * tc] = [-1, -1, 0, 2, 0, 0, 0, 2, 0]  # large, so that it wins often
    tri[:, 37 * tc] = tri[:, 5 * tc]
    box = np.zeros((8, c), np.float32)
    box[0:3], box[3:6] = lo.T, hi.T
    n = 4096
    u = r.normal(size=(n, 3))
    o_out = 4 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d_out = r.uniform(-0.8, 0.8, (n, 3)) - o_out
    o_in = r.uniform(-0.9, 0.9, (n, 3))
    d_in = r.normal(size=(n, 3))
    o = np.concatenate([o_out, o_in]).astype(np.float32)
    d = np.concatenate([d_out, d_in])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_any = r.uniform(0.0, 3.0, 2 * n).astype(np.float32)
    return [torch.as_tensor(x, device=dev) for x in (o, d, t_any, box, tri)] + [tc]


def test_stream_window_trap(dev):
    """K9/K10 and K7/K8 against their plain versions on _window_trap (1,600
    clusters, under K7/K8's cap): rays that visit more than two windows of
    clusters and meet equal entries at every window boundary."""
    o, d, t_any, box, tri, tc = _window_trap(dev, 7)
    t_big = torch.full_like(t_any, pairs.BIG)
    st = torch.zeros(o.shape[0], 2, dtype=torch.int32, device=dev)
    st7 = torch.zeros_like(st)
    for tm in (t_big, t_any):
        args = (o, d, tm, box, tri, tc)
        k9 = pb.cluster_stream_closest(*args, stats=st)
        _equal(k9, pb.cluster_stream_closest_plain(*args))
        k7 = pb.cluster_traverse_closest(*args, stats=st7)
        _equal(k9, k7)
        assert torch.equal(st7, st)
        if tm is t_big:
            for s, k in ((st, k9), (st7, k7)):
                assert int(s[:, 0].max()) > 64 and int(s[:, 1].max()) > 2
                # the tied triangle goes to the first cluster visited
                assert bool((k[1] == 5 * tc).any()) and not bool((k[1] == 37 * tc).any())
        k10 = pb.cluster_stream_any(*args)
        assert torch.equal(k10, pb.cluster_stream_any_plain(*args))
        assert torch.equal(k10, pb.cluster_traverse_any(*args))
    torch.cuda.synchronize()


def test_dense_pipeline_on_card_equals_cpu(dense_mesh):
    """pair_closest / pair_any past DENSE_C with the streamed fallback,
    through the kernels, equal the plain versions on the CPU, and launch
    K5, K6, K9 and K10 (K = KS = 1 forces the fallback)."""
    pack, o, d, t_any = dense_mesh
    meta = {**pack.meta, "cluster_vmem_ok": False}
    gpu = type(pack)(pack.arrays, meta)
    cpu = type(pack)({k: v.cpu() for k, v in pack.arrays.items()}, meta)
    fns = (pairs.two_level_cull, pairs.window_hit_closest, pairs.window_hit_any,
           pb.cluster_stream_closest, pb.cluster_stream_any, pairs.dense_cull,
           pb.cluster_traverse_closest)
    natural = pairs.DENSE_C, pairs.K, pairs.KS
    try:
        pairs.DENSE_C, pairs.K, pairs.KS = 0, 1, 1
        before = [f.launches for f in fns]
        gpu_hit = pairs.pair_closest(gpu, o, d, float("inf"))
        gpu_occ = pairs.pair_any(gpu, o, d, t_any)
        after = [f.launches - b for f, b in zip(fns, before)]
        _equal([x.cpu() for x in gpu_hit], pairs.pair_closest(cpu, o.cpu(), d.cpu(), float("inf")))
        assert torch.equal(gpu_occ.cpu(), pairs.pair_any(cpu, o.cpu(), d.cpu(), t_any.cpu()))
    finally:
        pairs.DENSE_C, pairs.K, pairs.KS = natural
    assert after == [2, 1, 1, 1, 1, 0, 0]


def test_stream_limits_raise(dense_mesh):
    pack, o, d, t_any = dense_mesh
    m = pack.meta
    _, max_ks, max_k, _ = pb.stream_limits()
    with pytest.raises(ValueError, match="at most"):
        pairs.two_level_cull(o, d, t_any, pack.cl_sup, pack.cl_mbox, m["n_supers"],
                             m["n_clusters"], min(max_ks + 1, m["n_supers"]), max_k + 1)


def test_cluster_limits_raise(mesh):
    pack, o, d, t_any = mesh
    max_c, max_k, _ = pb.kernel_limits()
    with pytest.raises(ValueError, match="at most"):
        pairs.dense_cull(o, d, t_any, torch.zeros(max_c + 8, 6, device=o.device), max_c + 1, 3)
    with pytest.raises(ValueError, match="at most"):
        pairs.dense_cull(o, d, t_any, pack.cl_mbox, pack.meta["n_clusters"], max_k + 1)


@pytest.fixture(scope="module")
def matpreview():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_meshes import matpreview_const_xml

    xml = matpreview_const_xml(32, 32)
    return xml, pack_scene(load_scene_string(xml), torch.device("cuda"))


@pytest.mark.parametrize("n_rays", [1, 257, 70_001])
def test_matpreview_brute_equal_plain(matpreview, n_rays):
    """K1/K2 on the matpreview variant's two-triangle tri_s, rays aimed at
    its ground from above and from below it, t_max 1e30 and finite."""
    _, pack = matpreview
    dev = pack.tri_s.device
    r = np.random.default_rng(n_rays)
    o = torch.as_tensor(r.uniform([-6, -1, -6], [6, 3, 6], (n_rays, 3)).astype(np.float32),
                        device=dev)
    target = torch.as_tensor(r.uniform([-9, 0, -9], [9, 0, 9], (n_rays, 3)).astype(np.float32),
                             device=dev)
    d = torch.nn.functional.normalize(target - o, dim=1).contiguous()
    for tm in (torch.full((n_rays,), 1e30, device=dev),
               torch.as_tensor(r.uniform(0.1, 8, n_rays).astype(np.float32), device=dev)):
        t1, p1 = pk.closest_hit_v2(o, d, tm, pack.tri_s)
        t2, p2 = pk.closest_hit_plain(o, d, tm, pack.tri_s)
        assert torch.equal(p1, p2) and torch.equal(t1, t2)
        assert torch.equal(pk.any_hit_v2(o, d, tm, pack.tri_s),
                           pk.any_hit_plain(o, d, tm, pack.tri_s))
    if n_rays > 1:
        assert bool((p1 >= 0).any()) and bool((p1 < 0).any())


def test_matpreview_render_on_card_matches_cpu(matpreview):
    """The variant rendered on the card through K1/K2 against the same
    render on the CPU through their plain versions (same random numbers;
    float32 last places differ between the devices' math libraries)."""
    import mitsuba_tpu_torch as mt

    xml, _ = matpreview
    scene = mt.load_scene_string(xml)
    pk.closest_hit_v2.launches = pk.any_hit_v2.launches = 0
    card = mt.render(scene, spp=4, seed=0)
    assert pk.closest_hit_v2.launches > 0 and pk.any_hit_v2.launches > 0
    cpu = mt.render(scene, spp=4, seed=0, device="cpu")
    assert np.isfinite(card).all()
    rmse = float(np.sqrt(np.mean((card / (1 + card) - cpu / (1 + cpu)) ** 2)))
    assert rmse < 5e-3, rmse


@pytest.fixture(scope="module")
def matpreview_real():
    """scenes/matpreview.xml as it stands (envmap, sobol) at 64x64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba_tpu_torch as mt
    from torch_meshes import MATPREVIEW_XML

    scene = mt.load_scene(MATPREVIEW_XML)
    scene.sensor.record.film.width = scene.sensor.record.film.height = 64
    return scene, pack_scene(scene, torch.device("cuda"))


def test_real_matpreview_golden_on_card(matpreview_real):
    """The reference's own golden (sobol, envmap, VNDF) at
    tests/test_golden.py's gate, through K1/K2 on the card."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import ROOT

    scene, pack = matpreview_real
    pk.closest_hit_v2.launches = pk.any_hit_v2.launches = 0
    img = mt.render(scene, spp=16, seed=0, pack=pack)
    assert pk.closest_hit_v2.launches > 0 and pk.any_hit_v2.launches > 0
    golden = np.load(os.path.join(ROOT, "tests", "golden", "matpreview_64_16.npy"))
    assert img.shape == golden.shape and np.isfinite(img).all()
    rmse = float(np.sqrt(np.mean((img / (1 + img) - golden / (1 + golden)) ** 2)))
    assert rmse < 5e-3, rmse


def test_real_matpreview_shadow_rays_equal_plain(matpreview_real):
    """K1/K2 bit-equal to plain on the real scene's camera rays and on
    the shadow rays of their first hits toward alias-sampled envmap
    directions (t_max 1e7), as a pass spawns them."""
    from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect
    from mitsuba_tpu_torch.emitter import eval as em
    from mitsuba_tpu_torch.integrator.path import _offset_ray
    from mitsuba_tpu_torch.sensor.plugins import generate_rays

    scene, pack = matpreview_real
    dev = pack.tri_s.device
    rec = scene.sensor.record
    cam = rec.pack(64, 64, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    o, d = generate_rays(cam, torch.rand(4096, 2, device=dev, generator=g),
                         torch.zeros(4096, 2, device=dev))
    its = fill_interaction(pack, o, d, intersect(pack, o, d))
    ds = em.sample_direct(pack, its.p, torch.rand(4096, 3, device=dev, generator=g))
    assert bool((ds.kind == 6).all())
    keep = its.valid
    o_s = _offset_ray(its.p, its.ng, ds.d)[keep].contiguous()
    d_s = ds.d[keep].contiguous()
    t_s = torch.full((o_s.shape[0],), 1e7, device=dev)
    assert o_s.shape[0] > 1000
    for oo, dd, tm in ((o.contiguous(), d.contiguous(), torch.full((4096,), 1e30, device=dev)),
                       (o_s, d_s, t_s)):
        t1, p1 = pk.closest_hit_v2(oo, dd, tm, pack.tri_s)
        t2, p2 = pk.closest_hit_plain(oo, dd, tm, pack.tri_s)
        assert torch.equal(p1, p2) and torch.equal(t1, t2)
        assert torch.equal(pk.any_hit_v2(oo, dd, tm, pack.tri_s),
                           pk.any_hit_plain(oo, dd, tm, pack.tri_s))


def test_sobol_and_samplers_on_card_equal_cpu(dev):
    """The byte tables, Faure Halton and every sampler kind's draws on
    card tensors equal the CPU's, word for word."""
    from mitsuba_tpu_torch.core import rng, sobol
    from mitsuba_tpu_torch.sampler import plugins as sp

    r = np.random.default_rng(0)
    idx = torch.as_tensor(r.integers(0, 2**32, 70_001, dtype=np.uint64).astype(np.int64))
    lane = torch.as_tensor(r.integers(0, 2**18, 70_001))
    dims = torch.as_tensor(r.integers(-2, 170, (70_001, 4)).astype(np.int32))
    dslot = torch.as_tensor((np.arange(70_001) % 48).astype(np.int32))
    fb = torch.as_tensor(r.random((70_001, 4)).astype(np.float32))

    def both(fn, *args):
        cpu = fn(*args)
        card = fn(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args))
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu), fn.__name__

    both(sobol.sobol_bits, idx, (0, 1, 2, 3, 159))
    both(sobol.sobol_bits_dyn, idx, dims)
    both(rng.sobol_2d_scrambled, idx, lane, idx ^ 0x5A5A5A5A)
    for slot in range(12):
        both(sobol.halton_faure, idx, slot)
    for kind in range(6):
        rec = sp.SamplerRecord(kind=kind, sample_count=16, seed=2)
        both(lambda ln, i: rec.pixel_sample(ln, i, 16), lane, idx)
        both(rec.lens_sample, lane, idx)
        both(lambda ln, i, ds, f: sp.ld_decision4(rec, ln, i, ds, f, 7), lane, idx, dslot, fb)


def test_env_alias_draw_on_card_equals_cpu(matpreview_real):
    """The pack's env tables on the card equal the CPU pack's, and the
    alias draw picks the same texels there (the lat-long uv it samples is
    bit-equal: basic float32 operations only)."""
    from mitsuba_tpu_torch.emitter import eval as em

    scene, pack = matpreview_real
    cpu = pack_scene(scene, "cpu")
    for k in ("env_image", "env_density", "env_alias_prob", "env_alias_idx", "env_alias_fused"):
        assert torch.equal(pack.arrays[k].cpu(), cpu.arrays[k]), k
    u2 = torch.as_tensor(np.random.default_rng(1).random((70_001, 2)).astype(np.float32))
    seen, inner = [], em._env_dir_from_uv
    em._env_dir_from_uv = lambda p, uv: (seen.append(uv.cpu()), inner(p, uv))[1]
    try:
        em._sample_env_dir(cpu, u2)
        em._sample_env_dir(pack, u2.to(pack.env_density.device))
    finally:
        em._env_dir_from_uv = inner
    assert torch.equal(seen[0], seen[1])


@pytest.fixture(scope="module")
def smoke_card():
    """scenes/smoke.xml at 32x32, packed on the card (1,038 triangles in
    11 clusters: the pair pipeline)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba_tpu_torch as mt
    from torch_meshes import smoke_xml

    scene = mt.load_scene_string(smoke_xml(32, 32))
    return scene, pack_scene(scene, torch.device("cuda"))


def test_smoke_shadow_segments_equal_plain(smoke_card):
    """K3/K4 (closest) bit-equal to plain on the smoke's shadow segments:
    the three closest-hit queries of a 16-spp pass's first NEE, through
    the null cube and the smoke, with finite t_max; and on the camera
    rays' query before them."""
    from chip_smoke import smoke_queries
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator import volpath as vp
    from mitsuba_tpu_torch.renderer import make_render_pass

    scene, pack = smoke_card
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    queries = smoke_queries(vp, make_render_pass, new_film, scene, pack, torch.device("cuda"), 16)
    assert [q[0] for q in queries] == ["camera"] + [f"segment {k}"
                                                    for k in range(vp.SHADOW_SEGMENTS)]
    for _, o, d, t_seg in queries:
        _, t_max = pb.finite_tmax(t_seg, o)
        k3 = pairs.dense_cull(o, d, t_max, pack.cl_mbox, c, min(pairs.K, c))
        for a, b in zip(k3, pairs.dense_cull_plain(o, d, t_max, pack.cl_mbox, c, min(pairs.K, c))):
            assert torch.equal(a, b)
        args = (o, d, t_max, k3[0], pack.cl_tri, pack.cl_pad2prim, c, tc)
        out = pairs.pair_hit_closest(*args, pack.cl_cnt, pairs._tri_rows(pack))
        for a, b in zip(out, pairs.pair_hit_closest_plain(*args)):
            assert torch.equal(a, b)
        assert bool((out[1] >= 0).any())


def test_smoke_render_on_card_matches_cpu(smoke_card):
    """volpath through the batched wavefront on the card (K3/K4, K7 on
    overflow) against the same render on the CPU through their plain
    versions (the same random numbers)."""
    import mitsuba_tpu_torch as mt

    scene, pack = smoke_card
    pairs.dense_cull.launches = pairs.pair_hit_closest.launches = 0
    card = mt.render(scene, spp=4, seed=0, pack=pack)
    assert pairs.dense_cull.launches > 0 and pairs.pair_hit_closest.launches > 0
    cpu = mt.render(scene, spp=4, seed=0, device="cpu")
    assert np.isfinite(card).all()
    rmse = float(np.sqrt(np.mean((card / (1 + card) - cpu / (1 + cpu)) ** 2)))
    assert rmse < 5e-3, rmse


def test_smoke_as_it_stands_on_card(smoke_card):
    """`render(load_scene("scenes/smoke.xml"))` as a user calls it: the
    scene as it stands (192x192, 32 spp: one pass of 1,179,648 lanes), on
    the card by default; its mean within 5 % of the reference's converged
    256x256 image (bench_refs/smoke_256.npz, the same view)."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import ROOT, SMOKE_XML

    pairs.dense_cull.launches = 0
    img = mt.render(mt.load_scene(SMOKE_XML))
    assert pairs.dense_cull.launches > 0
    assert img.shape == (192, 192, 3) and np.isfinite(img).all()
    ref = np.load(os.path.join(ROOT, "bench_refs", "smoke_256.npz"))["img"]
    assert abs(img.mean() - ref.mean()) < 0.05 * ref.mean(), (img.mean(), ref.mean())


# ---- the light-transport slice: delta lights, ptracer and bdpt ----

def _tm_rmse(a, b):
    return float(np.sqrt(np.mean((a / (1 + a) - b / (1 + b)) ** 2)))


def test_delta_sample_direct_on_card_equals_cpu(dev):
    """sample_direct's delta arms on the card against the CPU, on the
    scene whose emitter pick reaches all four delta kinds and an area
    light."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.emitter import eval as em
    from torch_meshes import delta_mix_xml

    scene = mt.load_scene_string(delta_mix_xml())
    packs = pack_scene(scene, dev), pack_scene(scene, "cpu")
    r = np.random.default_rng(0)
    p = torch.as_tensor(r.uniform([-2, 0, -2], [2, 2, 2], (65_536, 3)).astype(np.float32))
    u = torch.as_tensor(r.uniform(0, 1, (65_536, 3)).astype(np.float32))
    card = em.sample_direct(packs[0], p.to(dev), u.to(dev))
    cpu = em.sample_direct(packs[1], p, u)
    # PyTorch's CUDA and CPU kernels round cosines and distances in other
    # last places, which the spot's falloff (over cos beam - cos cutoff)
    # and the area pdf's distance squared enlarge: measured up to 5e-4
    # relative on 69 of 196,608 values
    for a, b in zip(card, cpu):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-3, atol=1e-5)
        else:
            assert torch.equal(a.cpu(), b)


def test_ptracer_connections_equal_plain(dev):
    """K1/K2 bit-equal to plain on the particle tracer's camera connections
    on cbox (finite segments between offset points), and the render's
    launches."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import capture_queries
    from mitsuba_tpu_torch.integrator import ptracer as tpt
    from torch_meshes import cbox_ptracer_xml

    scene = mt.load_scene_string(cbox_ptracer_xml(64, 64))
    pack = pack_scene(scene, dev)
    rec = scene.sensor.record
    lane = torch.arange(65_536, device=dev)
    run = tpt.make_ptracer_batch(pack, scene.integrator, rec, 64, 64, 0)
    segs = capture_queries(tpt, "occluded", 3, lambda: run(
        torch.zeros(64, 64, 3, device=dev), lane, torch.zeros_like(lane)))
    for o, d, t in segs:
        assert torch.isfinite(t).all()
        assert torch.equal(pk.any_hit_v2(o, d, t, pack.tri_s), pk.any_hit_plain(o, d, t, pack.tri_s))
        _equal(pk.closest_hit_v2(o, d, t, pack.tri_s), pk.closest_hit_plain(o, d, t, pack.tri_s))


def test_ptracer_golden_on_card(dev):
    """cbox under the particle tracer at 64x64, 16 particles per pixel on
    the card (K1/K2; the splat adds land in any order) against the
    reference's golden."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT, cbox_ptracer_xml

    pk.any_hit_v2.launches = 0
    img = mt.render(mt.load_scene_string(cbox_ptracer_xml(64, 64)), spp=16, seed=0)
    assert pk.any_hit_v2.launches > 0
    golden = np.load(os.path.join(ROOT, "tests", "golden", "torch_cbox_ptracer_64_16.npy"))
    assert _tm_rmse(img, golden) < GOLDEN_GATES["torch_cbox_ptracer_64_16.npy"]


@pytest.fixture(scope="module")
def glass_card():
    """scenes/glass_caustics.xml at 16x16 (1,026 triangles in clusters:
    the pair pipeline), packed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba_tpu_torch as mt
    from torch_meshes import glass_xml

    scene = mt.load_scene_string(glass_xml(16, 16))
    return scene, pack_scene(scene, torch.device("cuda"))


def test_bdpt_connections_equal_plain(glass_card):
    """K3/K4 (any and closest) bit-equal to plain on the first connection
    segments of a glass chunk (16 edges), and K7/K8 on the batches the
    pair pipeline hands its fallback at K = 1."""
    from chip_smoke import capture_queries
    from mitsuba_tpu_torch.integrator import bdpt as tb

    scene, pack = glass_card
    dev = torch.device("cuda")
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    lane = torch.arange(256, device=dev).repeat(4)
    sidx = torch.arange(4, device=dev).repeat_interleave(256)
    chunk = tb.make_bdpt_chunk(pack, scene.integrator, scene.sensor.record, 16, 16, 0)
    for o, d, t_seg in capture_queries(tb, "occluded", 4, lambda: chunk(lane, sidx)):
        _, t_max = pb.finite_tmax(t_seg, o)
        k3 = pairs.dense_cull(o, d, t_max, pack.cl_mbox, c, min(pairs.K, c))
        for a, b in zip(k3, pairs.dense_cull_plain(o, d, t_max, pack.cl_mbox, c, min(pairs.K, c))):
            assert torch.equal(a, b)
        tabs = (pack.cl_cnt, pairs._tri_rows(pack))
        args = (o, d, t_max, k3[0], pack.cl_tri, c, tc)
        assert torch.equal(pairs.pair_hit_any(*args, *tabs), pairs.pair_hit_any_plain(*args))
        args = (o, d, t_max, k3[0], pack.cl_tri, pack.cl_pad2prim, c, tc)
        for a, b in zip(pairs.pair_hit_closest(*args, *tabs), pairs.pair_hit_closest_plain(*args)):
            assert torch.equal(a, b)
        walk = (o, d, t_max, pack.cl_box, pack.cl_tri, tc)
        _equal(pb.cluster_traverse_closest(*walk), pb.cluster_traverse_closest_plain(*walk))
        assert torch.equal(pb.cluster_traverse_any(*walk), pb.cluster_traverse_any_plain(*walk))


def test_bdpt_chunk_on_card_matches_cpu(glass_card):
    """One glass chunk (16x16, 4 spp, 16 edges) on the card against the
    same chunk on the CPU through the plain versions (the same random
    numbers): the estimates and the light-image splats."""
    from mitsuba_tpu_torch.integrator import bdpt as tb

    scene, pack = glass_card
    cpu_pack = pack_scene(scene, "cpu")
    out = []
    for p, dv in ((pack, torch.device("cuda")), (cpu_pack, torch.device("cpu"))):
        lane = torch.arange(256, device=dv).repeat(4)
        sidx = torch.arange(4, device=dv).repeat_interleave(256)
        out.append(tb.make_bdpt_chunk(p, scene.integrator, scene.sensor.record, 16, 16, 0)(
            lane, sidx))
    (L_card, spl_card), (L_cpu, spl_cpu) = out
    np.testing.assert_allclose(L_card.cpu().numpy(), L_cpu.numpy(), rtol=3e-4, atol=1e-6)
    for (_, v_a, ok_a), (_, v_b, ok_b) in zip(spl_card, spl_cpu):
        assert (ok_a.cpu() != ok_b).sum() <= 2
        both = (ok_a.cpu() & ok_b).numpy()
        np.testing.assert_allclose(v_a.cpu().numpy()[both], v_b.numpy()[both], rtol=3e-4,
                                   atol=1e-6)


def test_glass_goldens_on_card(glass_card):
    """`render(load_scene("scenes/glass_caustics.xml"))` cut to 16x16, 4
    spp and to 64x64, 16 spp (bdpt, 16 edges) on the card against the
    pair-pipeline golden and the reference's own golden."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT, glass_xml

    scene, pack = glass_card
    gold = os.path.join(ROOT, "tests", "golden")
    pairs.dense_cull.launches = 0
    img = mt.render(scene, spp=4, seed=0, pack=pack)
    assert pairs.dense_cull.launches > 0
    assert (_tm_rmse(img, np.load(os.path.join(gold, "torch_glass_bdpt_16_4.npy")))
            < GOLDEN_GATES["torch_glass_bdpt_16_4.npy"])
    img = mt.render(mt.load_scene_string(glass_xml(64, 64)), spp=16, seed=0)
    assert np.isfinite(img).all()
    assert _tm_rmse(img, np.load(os.path.join(gold, "glass_caustics_64_16.npy"))) < 5e-3


# ---- the Metropolis slice ----

def _metropolis_xml(name):
    from torch_meshes import (
        cbox_chain_xml,
        door_xml,
        glass_manifold_xml,
        with_integrator,
        with_properties,
    )

    door = door_xml(16, 16, luminance_samples=1024)
    return {
        "torch_door_pssmlt_16_4.npy": (door, 4),
        "torch_door_pssmlt_uni_16_4.npy": (
            door_xml(16, 16, luminance_samples=1024, bidirectional=False), 4),
        "torch_door_mlt_16_4.npy": (with_integrator(door, "mlt"), 4),
        "torch_door_erpt_16_1.npy": (with_properties(with_integrator(door, "erpt"),
                                                     '<integer name="chainLength" value="8"/>'), 1),
        "torch_cbox_mlt_24_8.npy": (cbox_chain_xml("mlt"), 8),
        "torch_cbox_erpt_24_1.npy": (cbox_chain_xml("erpt", chain_length=20), 1),
        "torch_glass_mlt_manifold_16_8.npy": (glass_manifold_xml(), 8),
    }[name]


@pytest.mark.parametrize("name", [
    "torch_door_pssmlt_16_4.npy", "torch_door_pssmlt_uni_16_4.npy", "torch_door_mlt_16_4.npy",
    "torch_door_erpt_16_1.npy", "torch_cbox_mlt_24_8.npy", "torch_cbox_erpt_24_1.npy",
    "torch_glass_mlt_manifold_16_8.npy"])
def test_metropolis_goldens_on_card(dev, name):
    """The chain integrators' goldens (the JAX package's renders) on the
    card, each at its tests/torch_meshes.py GOLDEN_GATES gate."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT

    xml, spp = _metropolis_xml(name)
    img = mt.render(mt.load_scene_string(xml), spp=spp, seed=0)
    gold = np.load(os.path.join(ROOT, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert _tm_rmse(img, gold) < GOLDEN_GATES[name], _tm_rmse(img, gold)


def test_door_pssmlt_agrees_with_bdpt_on_card(dev):
    """door (pssmlt as it stands, bidirectional) at 64x64 against the
    port's bdpt at the same size and budget (24 mutations / samples per
    pixel), as the reference's tests/test_mlt.py holds its mlt: the mean
    radiometry within 40 %, and the 8x8 block means (away from the dark
    blocks) within 50 % at the median."""
    import mitsuba_tpu_torch as mt
    from torch_meshes import door_xml, with_integrator

    m = mt.render(mt.load_scene_string(door_xml(64, 64)), spp=24, seed=3)
    b = mt.render(mt.load_scene_string(with_integrator(door_xml(64, 64), "bdpt")), spp=24, seed=3)
    assert np.isfinite(m).all() and np.isfinite(b).all()
    assert m.mean() > 0.02 and b.mean() > 0.02
    assert abs(m.mean() - b.mean()) < 0.4 * max(m.mean(), b.mean()), (m.mean(), b.mean())
    mb = m.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3, 4))
    bb = b.reshape(8, 8, 8, 8, 3).mean(axis=(1, 3, 4))
    sel = bb > 0.25 * bb.mean()
    assert np.median(np.abs(mb - bb)[sel] / bb[sel]) < 0.5


def test_door_step_queries_equal_plain(dev):
    """K3/K4 (closest and any) and K7/K8 on their fallback batches bit-equal
    to plain on the queries of door's first bidirectional step at 32x32
    (1,024 chains): the proposal's camera query and three connections."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import as_segment, capture_calls
    from mitsuba_tpu_torch.integrator import bdpt as tb
    from mitsuba_tpu_torch.integrator import pssmlt as tps
    from torch_meshes import door_xml

    scene = mt.load_scene_string(door_xml(32, 32, luminance_samples=2048))
    pack = pack_scene(scene, dev)
    steps = tps.iter_pssmlt(scene, pack, 1, 0, None, dev)
    next(steps)
    got = capture_calls(tb, ("intersect", "occluded"), lambda: next(steps),
                        lambda g: sum(c[0] == "occluded" for c in g) == 3)
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    tabs = (pack.cl_cnt, pairs._tri_rows(pack))
    queries = [next(args for name, args in got if name == "intersect")] + [
        args for name, args in got if name == "occluded"]
    for o, d, t_seg in map(as_segment, queries):
        _, t_max = pb.finite_tmax(t_seg, o)
        k3 = pairs.dense_cull(o, d, t_max, pack.cl_mbox, c, min(pairs.K, c))
        for a, b in zip(k3, pairs.dense_cull_plain(o, d, t_max, pack.cl_mbox, c, min(pairs.K, c))):
            assert torch.equal(a, b)
        args = (o, d, t_max, k3[0], pack.cl_tri, c, tc)
        assert torch.equal(pairs.pair_hit_any(*args, *tabs), pairs.pair_hit_any_plain(*args))
        args = (o, d, t_max, k3[0], pack.cl_tri, pack.cl_pad2prim, c, tc)
        for a, b in zip(pairs.pair_hit_closest(*args, *tabs), pairs.pair_hit_closest_plain(*args)):
            assert torch.equal(a, b)
        walk = (o, d, t_max, pack.cl_box, pack.cl_tri, tc)
        _equal(pb.cluster_traverse_closest(*walk), pb.cluster_traverse_closest_plain(*walk))
        assert torch.equal(pb.cluster_traverse_any(*walk), pb.cluster_traverse_any_plain(*walk))


def test_pssmlt_step_on_card_matches_cpu(dev):
    """One PSSMLT step of door (16x16, 256 chains, bidirectional) on the
    card against the same step on the CPU through the plain versions: the
    same bootstrap seeds and proposals (the same random numbers), the
    acceptance ratios at rtol 1e-3 on all but a few lanes."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.integrator import pssmlt as tps
    from torch_meshes import door_xml

    scene = mt.load_scene_string(door_xml(16, 16, luminance_samples=512))
    out = []
    for dv in (dev, torch.device("cpu")):
        pack = pack_scene(scene, dv)
        rec = scene.sensor.record
        trace, D, _ = tps.make_chain_trace(pack, scene.integrator, rec, rec.pack(16, 16, dv), 16,
                                           16)
        seed_mlt = tps.rng.stream_seed(0, tps.rng.STREAM_MLT)
        U0, b = tps.bootstrap_chains(trace, D, 256, 2, 0, seed_mlt, dv)
        U_p, u_ctl = tps._propose(U0, 0, torch.arange(256, device=dv), seed_mlt, 0.3)
        cur = trace(U0)
        prop = trace(U_p)
        _, _, a, _ = tps._mh(torch.zeros(16, 16, 3, device=dv),
                             (U0, cur[0], cur[1], tps._chain_lum(cur[1])),
                             (U_p, prop[0], prop[1], tps._chain_lum(prop[1])), u_ctl[:, 1], 1.0,
                             16, 16)
        out.append((U0.cpu(), b, U_p.cpu(), a.cpu()))
    (U0_c, b_c, Up_c, a_c), (U0_h, b_h, Up_h, a_h) = out
    assert (U0_c != U0_h).any(dim=1).sum() <= 2
    np.testing.assert_allclose(b_c, b_h, rtol=1e-4)
    same = ~(U0_c != U0_h).any(dim=1)
    assert (Up_c[same] != Up_h[same]).float().mean() < 0.01
    close = np.isclose(a_c.numpy(), a_h.numpy(), rtol=1e-3, atol=1e-6)
    assert (~close[same.numpy()]).sum() <= 3


def test_manifold_retrace_equal_plain(dev):
    """K3/K4 (closest) and K7 bit-equal to plain on the re-traces of one
    manifold proposal on glass (48x48, maxDepth 6, 4,096 chains; finite
    rays: chip_smoke.manifold_segments)."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import manifold_segments
    from mitsuba_tpu_torch.integrator import mut_manifold as tmm
    from mitsuba_tpu_torch.integrator import pssmlt as tps
    from torch_meshes import glass_xml, with_integrator

    scene = mt.load_scene_string(with_integrator(glass_xml(48, 48), "mlt", max_depth=6))
    manifold_segments(pairs, pb, tmm, tps, scene, pack_scene(scene, dev), dev, [],
                      n_chains=4096)


# ---- the photon-mapping slice ----

def _photon_golden(name):
    """(XML, iterations, photons an iteration) of a photon-mapping golden
    (tests/make_torch_bigmesh_golden.py)."""
    from torch_meshes import cbox_xml, glass_xml, homog_slab_xml, with_integrator

    return {
        "torch_cbox_sppm_24_4.npy": (cbox_xml("sppm", 24, 24), 4, 1 << 14),
        "torch_glass_sppm_16_4.npy": (with_integrator(glass_xml(16, 16), "sppm"), 4, 1 << 12),
        "torch_homog_photonmapper_32_4.npy": (homog_slab_xml(), 4, 1 << 12),
        "torch_cbox_vpl_24_4.npy": (cbox_xml("vpl", 24, 24), 4, None),
    }[name]


@pytest.mark.parametrize("name", [
    "torch_cbox_sppm_24_4.npy", "torch_glass_sppm_16_4.npy", "torch_homog_photonmapper_32_4.npy",
    "torch_cbox_vpl_24_4.npy"])
def test_photon_goldens_on_card(dev, name, monkeypatch):
    """sppm on cbox and glass, the volumetric photon mapper on the slab
    and vpl on cbox (the JAX package's renders) on the card, through
    `render`, each at its tests/torch_meshes.py GOLDEN_GATES gate."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT

    xml, spp, photons = _photon_golden(name)
    if photons:
        monkeypatch.setenv("MTS_SPPM_PHOTONS", str(photons))
    img = mt.render(mt.load_scene_string(xml), spp=spp, seed=0)
    gold = np.load(os.path.join(ROOT, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert _tm_rmse(img, gold) < GOLDEN_GATES[name], _tm_rmse(img, gold)


def test_photon_queries_equal_plain(dev):
    """K3/K4 (closest) and K7 bit-equal to plain on the first query of an
    sppm photon walk on glass (64x64, 2^16 photons) and of the volumetric
    photon mapper's walk on smoke (2^16 photons); K1/K2 on a vpl pass's
    camera and first shadow batch on cbox at 128x128
    (chip_smoke.sppm_walk_segments, pm_walk_segments, vpl_brute)."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import pm_walk_segments, sppm_walk_segments, vpl_brute
    from mitsuba_tpu_torch.integrator import photonmapper as tpm
    from mitsuba_tpu_torch.integrator import sppm as tsppm
    from mitsuba_tpu_torch.integrator import vpl as tvpl
    from torch_meshes import cbox_xml, glass_xml, smoke_xml, with_integrator

    glass = mt.load_scene_string(with_integrator(glass_xml(64, 64), "sppm"))
    sppm_walk_segments(pairs, pb, tsppm, glass, pack_scene(glass, dev), dev, [],
                       n_photons=1 << 16)
    smoke = mt.load_scene_string(with_integrator(smoke_xml(64, 64), "photonmapper"))
    pm_walk_segments(pairs, pb, tpm, tsppm, smoke, pack_scene(smoke, dev), dev, [],
                     n_photons=1 << 16)
    cbox = mt.load_scene_string(cbox_xml("vpl", 128, 128))
    vpl_brute(pk, tvpl, cbox, pack_scene(cbox, dev), dev, [])


@pytest.mark.parametrize("kind", ["sppm", "photonmapper", "vpl"])
def test_photon_integrators_render_on_card(dev, kind):
    """`render` on the card by default (no device argument): glass_caustics
    under sppm, smoke under the photon mapper and cbox under vpl at their
    own film sizes, 2 iterations or passes; the image is finite and lit,
    and the scene's kernels launched."""
    import mitsuba_tpu_torch as mt
    from torch_meshes import cbox_xml, glass_xml, smoke_xml, with_integrator

    xml = {"sppm": lambda: with_integrator(glass_xml(), kind),
           "photonmapper": lambda: with_integrator(smoke_xml(), kind),
           "vpl": lambda: cbox_xml(kind)}[kind]()
    scene = mt.load_scene_string(xml)
    wrappers = (pk.closest_hit_v2, pk.any_hit_v2) if kind == "vpl" else (
        pairs.dense_cull, pairs.pair_hit_closest)
    for fn in wrappers:
        fn.launches = 0
    img = mt.render(scene, spp=2, seed=0)
    rec = scene.sensor.record.film
    assert img.shape == (rec.height, rec.width, 3) and np.isfinite(img).all()
    assert img.mean() > 0.01
    assert all(fn.launches > 0 for fn in wrappers)


# ---- the subsurface slice, the path family and the meta-integrators ----

def _slice_golden(name):
    """(XML, spp) of each golden of the subsurface slice, the path family
    and the meta-integrators (tests/make_torch_bigmesh_golden.py)."""
    from torch_meshes import NESTED_PATH, cbox_meta_xml, cbox_xml, dipole_xml, with_properties

    return {
        "torch_dipole_32_4.npy": dipole_xml(32, 24),
        "torch_singlescatter_32_4.npy": dipole_xml(32, 24, "singlescatter"),
        "torch_cbox_ao_24_4.npy": cbox_xml("ao", 24, 24),
        "torch_cbox_field_uv_24_4.npy": with_properties(cbox_xml("field", 24, 24),
                                                        '<string name="field" value="uv"/>'),
        "torch_cbox_adaptive_24_4.npy": cbox_meta_xml("adaptive", NESTED_PATH),
        "torch_cbox_irrcache_24_4.npy": cbox_meta_xml("irrcache", NESTED_PATH),
    }[name]


@pytest.mark.parametrize("name", [
    "torch_dipole_32_4.npy", "torch_singlescatter_32_4.npy", "torch_cbox_ao_24_4.npy",
    "torch_cbox_field_uv_24_4.npy", "torch_cbox_adaptive_24_4.npy",
    "torch_cbox_irrcache_24_4.npy"])
def test_slice_goldens_on_card(dev, name):
    """dipole.xml (and its singlescatter variant), cbox under ao, the uv
    field, adaptive and irrcache (the JAX package's renders) on the card,
    through `render`, each at its tests/torch_meshes.py GOLDEN_GATES gate."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT

    img = mt.render(mt.load_scene_string(_slice_golden(name)), spp=4, seed=0)
    gold = np.load(os.path.join(ROOT, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert _tm_rmse(img, gold) < GOLDEN_GATES[name], _tm_rmse(img, gold)


def test_dipole_queries_equal_plain(dev):
    """K3/K4 (closest and any) and K7/K8 bit-equal to plain on dipole.xml's
    camera rays, its irradiance pass's NEE and a singlescatter pass's first
    segment, at 128x96 (chip_smoke.dipole_segments)."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import dipole_segments
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator import sss as tsss
    from mitsuba_tpu_torch.renderer import make_render_pass
    from torch_meshes import dipole_xml

    scene = mt.load_scene_string(dipole_xml(128, 96))
    ss = mt.load_scene_string(dipole_xml(128, 96, "singlescatter"))
    dipole_segments(pairs, pb, tsss, make_render_pass, new_film, scene, pack_scene(scene, dev),
                    ss, pack_scene(ss, dev), dev, [])


def test_dipole_on_card_matches_cpu(dev):
    """The irradiance pass, the dense dipole sum and one render on the card
    against the CPU's (plain kernels) on dipole.xml: E at the 640 points,
    rtol 1e-4, atol 1e-6 on 99 % of the values; sss_lo on 300 random lanes
    about the sphere with the CPU's E, rtol 1e-5, atol 1e-7 (the sums run
    in one order; exp and sqrt differ in the last place); a 16x12, 1-spp
    render on 95 % of the values, its mean within 2 % (a path that a last
    place sends elsewhere moves its pixel whole: 3 of 192 pixels, measured
    on NVIDIA H100 80GB HBM3, 700 W)."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.integrator import sss as tsss
    from torch_meshes import dipole_xml

    scene = mt.load_scene_string(dipole_xml(16, 12))
    card_pack, cpu_pack = pack_scene(scene, dev), pack_scene(scene, "cpu")
    e_card = tsss.compute_sss_irradiance(card_pack, scene.integrator, 0).cpu()
    e_cpu = tsss.compute_sss_irradiance(cpu_pack, scene.integrator, 0)
    assert np.isclose(e_card.numpy(), e_cpu.numpy(), rtol=1e-4, atol=1e-6).mean() > 0.99
    r = np.random.default_rng(41)
    nrm = r.normal(size=(300, 3))
    p = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True) * r.uniform(0.98, 1.02, (300, 1)))
    p, cos_o = torch.tensor(p, dtype=torch.float32), torch.tensor(r.uniform(0, 1, 300),
                                                                   dtype=torch.float32)
    sid = torch.zeros(300, dtype=torch.int32)
    lo = []
    for pk_, device in ((card_pack, dev), (cpu_pack, torch.device("cpu"))):
        pk_ = type(pk_)({**pk_.arrays, "sss_E": e_cpu.to(device)}, pk_.meta)
        lo.append(tsss.sss_lo(pk_, p.to(device), cos_o.to(device), sid.to(device)).cpu().numpy())
    np.testing.assert_allclose(lo[0], lo[1], rtol=1e-5, atol=1e-7)
    card = mt.render(scene, spp=1, seed=0)
    cpu = mt.render(scene, spp=1, seed=0, device="cpu")
    assert np.isclose(card, cpu, rtol=1e-4, atol=1e-6).mean() > 0.95
    np.testing.assert_allclose(card.mean(), cpu.mean(), rtol=0.02)


def test_explicit_photons_without_media_on_card(dev, monkeypatch):
    """render_photonmapper drops an explicit photon count on a scene
    without media, as the reference does: the image is sppm's at its own
    count (MTS_SPPM_PHOTONS), bit for bit on the card."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.integrator import photonmapper as tpm
    from mitsuba_tpu_torch.integrator import sppm as tsppm
    from torch_meshes import cbox_xml

    monkeypatch.setenv("MTS_SPPM_PHOTONS", "4096")
    scene = mt.load_scene_string(cbox_xml("photonmapper", 64, 64))
    a = tpm.render_photonmapper(scene, spp=2, seed=0, photons_per_pass=1 << 14)
    b = tsppm.render_sppm(scene, spp=2, seed=0)
    np.testing.assert_array_equal(a, b)


def test_irrcache_trace_on_card_matches_cpu(dev):
    """irrcache_trace on the card against the CPU's, both fed the records
    of one overture (made on the CPU) on cbox at 24x24: rtol 1e-4, atol
    1e-6 on 90 % of the lanes and rtol 3e-2 on 99 % (the hit points' last
    places move Ward weights, as against the reference:
    tests/test_torch_irrcache.py)."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.integrator import irrcache as tic
    from mitsuba_tpu_torch.sensor.plugins import generate_rays
    from torch_meshes import NESTED_PATH, cbox_meta_xml

    scene = mt.load_scene_string(cbox_meta_xml("irrcache", NESTED_PATH))
    w = h = 24
    rec = scene.sensor.record
    outs = []
    cache = None
    for device in (torch.device("cpu"), dev):
        pack = pack_scene(scene, device)
        cam = rec.pack(w, h, device)

        def rays(stride, cam=cam, device=device):
            xs = (torch.arange(w // stride, device=device) * stride + 0.5) / w
            gx, gy = torch.meshgrid(xs.float(), xs.float(), indexing="xy")
            pos01 = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
            return generate_rays(cam, pos01, torch.zeros_like(pos01))

        if cache is None:
            cache, _ = tic.build_cache(pack, scene.integrator, rays, 0)
        n = w * h
        r = np.random.default_rng(31)
        px = np.arange(n)
        pos01 = torch.tensor(np.stack([(px % w + r.uniform(size=n)) / w,
                                       (px // w + r.uniform(size=n)) / h], -1),
                             dtype=torch.float32, device=device)
        o, d = generate_rays(cam, pos01, torch.zeros_like(pos01))
        lane = torch.arange(n, device=device)
        outs.append(tic.irrcache_trace(pack, scene.integrator, o, d, lane, torch.ones_like(lane),
                                       None, 0, tuple(c.to(device) for c in cache)).cpu().numpy())
    cpu, card = outs
    assert np.isclose(card, cpu, rtol=1e-4, atol=1e-6).all(-1).mean() > 0.9
    assert np.isclose(card, cpu, rtol=3e-2, atol=1e-6).all(-1).mean() > 0.99


def test_hairball_queries_equal_plain(dev):
    """K3/K4 (closest and any) and K7/K8 bit-equal to plain on
    scenes/hairball.xml's camera rays and a pass's first NEE, at 128x96
    (chip_smoke.pair_segments): most camera rays take the fallback."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import pair_segments
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator import path as tpath
    from mitsuba_tpu_torch.renderer import make_render_pass
    from torch_meshes import hairball_xml

    scene = mt.load_scene_string(hairball_xml(128, 96))
    pair_segments(pairs, pb, tpath, make_render_pass, new_film, scene, pack_scene(scene, dev), dev,
                  [], "hairball")


@pytest.mark.parametrize("name", [
    "torch_hairball_32_4.npy", "torch_hairball_exact_32_4.npy", "torch_bsdf_glossy_24_4.npy",
    "torch_bsdf_thin_24_4.npy", "torch_bsdf_layered_24_4.npy", "torch_bsdf_thin_bdpt_24_4.npy"])
def test_hairball_and_gallery_goldens_on_card(dev, name):
    """The hairball (as it stands and exact) and the BSDF galleries (the
    JAX package's renders) on the card, through `render`, each at its
    tests/torch_meshes.py GOLDEN_GATES gate; the hairball's mean within
    1.5 % of the golden's."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT, bsdf_gallery_xml, hairball_xml

    xml = {
        "torch_hairball_32_4.npy": hairball_xml(32, 24),
        "torch_hairball_exact_32_4.npy": hairball_xml(32, 24, exact=True),
        "torch_bsdf_glossy_24_4.npy": bsdf_gallery_xml("glossy", 24, 24),
        "torch_bsdf_thin_24_4.npy": bsdf_gallery_xml("thin", 24, 24),
        "torch_bsdf_layered_24_4.npy": bsdf_gallery_xml("layered", 24, 24),
        "torch_bsdf_thin_bdpt_24_4.npy": bsdf_gallery_xml("thin", 24, 24, "bdpt", 4),
    }[name]
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0)
    gold = np.load(os.path.join(ROOT, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert _tm_rmse(img, gold) < GOLDEN_GATES[name], _tm_rmse(img, gold)
    if "hairball" in name:
        np.testing.assert_allclose(img.mean(), gold.mean(), rtol=0.015)


def test_cylinder_scan_on_card_matches_cpu(dev):
    """accel/cyl.py's scan (plain tensor operations) on the card against
    the CPU's on the exact hairball's 7,189 segments and 20,000 random
    rays: hits, segment ids and occlusion equal but on at most 1 lane in
    1,000 (silhouette rays, ties), t within rtol 1e-3 where the ids agree."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.accel import cyl
    from torch_meshes import hairball_xml

    scene = mt.load_scene_string(hairball_xml(exact=True))
    card, cpu = pack_scene(scene, dev), pack_scene(scene, "cpu")
    r = np.random.default_rng(43)
    o = torch.tensor(r.uniform(-1.3, 1.3, (20_000, 3)), dtype=torch.float32)
    d = torch.tensor(r.normal(size=(20_000, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    best = torch.tensor(r.choice([1e30, 0.5, 1.5], 20_000), dtype=torch.float32)
    hc, tc, ic = (a.cpu() for a in cyl.cyl_closest(card, o.to(dev), d.to(dev), best.to(dev)))
    h0, t0, i0 = cyl.cyl_closest(cpu, o, d, best)
    same = ic == i0
    assert (~same).sum() <= 20 and h0.sum() > 2_000
    assert torch.equal(hc[same], h0[same])
    np.testing.assert_allclose(tc[same].numpy(), t0[same].numpy(), rtol=1e-3)
    t_max = torch.tensor(r.uniform(0.05, 2.0, 20_000), dtype=torch.float32)
    occ = cyl.cyl_any(card, o.to(dev), d.to(dev), t_max.to(dev)).cpu()
    assert (occ != cyl.cyl_any(cpu, o, d, t_max)).sum() <= 20


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    from torch_meshes import feature_assets

    return feature_assets(str(tmp_path_factory.mktemp("feature_assets")))


def test_textured_queries_equal_plain(dev, feature_dir):
    """K3/K4 (closest and any) and K7/K8 bit-equal to plain on TEXTURED's
    camera rays and a pass's first NEE at 256x256 (chip_smoke.pair_segments)."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import pair_segments
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator import path as tpath
    from mitsuba_tpu_torch.renderer import make_render_pass

    scene = mt.load_scene_string(textured_xml(feature_dir, 256, 256))
    pair_segments(pairs, pb, tpath, make_render_pass, new_film, scene, pack_scene(scene, dev), dev,
                  [], "textured")


TEXTURE_GOLDENS = {
    "torch_textured_32_4.npy": lambda d: textured_xml(d, 32, 32),
    "torch_tex_bitmap_24_4.npy": bitmap_xml,
    "torch_tex_bitmap_ewa_24_4.npy": bitmap_xml,
    "torch_tex_normalmap_32_4.npy": lambda d: bump_xml("tilted"),
    "torch_tex_bumpmap_32_4.npy": lambda d: bump_xml("bump", d),
    "torch_tex_vertexcolors_33_4.npy": lambda d: geom_xml("vertexcolors", d),
    "torch_tex_wireframe_33_4.npy": lambda d: geom_xml("wireframe", d),
    "torch_tex_curvature_33_4.npy": lambda d: geom_xml("curvature", d),
    "torch_irawan_cloth_24_4.npy": lambda d: cloth_xml(),
}


@pytest.mark.parametrize("name", sorted(TEXTURE_GOLDENS))
def test_texture_goldens_on_card(dev, feature_dir, name, monkeypatch):
    """TEXTURED and the texture slice's feature scenes (the JAX package's
    renders) on the card, through `render` with its default device, each
    at its tests/torch_meshes.py GOLDEN_GATES gate."""
    import os

    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.scene import texture_eval
    from torch_meshes import GOLDEN_GATES, ROOT

    if "ewa" in name:
        monkeypatch.setattr(texture_eval, "TEX_FILTER", "ewa")
    img = mt.render(mt.load_scene_string(TEXTURE_GOLDENS[name](feature_dir)), spp=4, seed=0)
    gold = np.load(os.path.join(ROOT, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert _tm_rmse(img, gold) < GOLDEN_GATES[name], _tm_rmse(img, gold)


@pytest.mark.parametrize("fp_kind", ["none", "scalar", "feline", "ewa"])
def test_eval_texture_on_card_matches_cpu(dev, feature_dir, fp_kind, monkeypatch):
    """eval_texture on TEXTURED's seven textures, 100,000 lanes of random
    ids, uv, footprints and triangles, the card against the CPU: within
    atol 1e-5, rtol 1e-4 (the card's log2 and exp differ from the CPU's in
    the last place)."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.scene import texture_eval

    if fp_kind == "ewa":
        monkeypatch.setattr(texture_eval, "TEX_FILTER", "ewa")
    scene = mt.load_scene_string(textured_xml(feature_dir, 32, 32))
    card, cpu = pack_scene(scene, dev), pack_scene(scene, "cpu")
    r = np.random.default_rng(5)
    n = 100_000
    tid = torch.tensor(r.integers(-1, 7, n), dtype=torch.int32)
    uv = torch.tensor(r.uniform(-2, 3, (n, 2)), dtype=torch.float32)
    default = torch.tensor(r.random((n, 3)), dtype=torch.float32)
    prim = torch.tensor(r.integers(0, 2758, n), dtype=torch.int32)
    bary = torch.tensor(r.random((n, 2)) * 0.5, dtype=torch.float32)
    fp = None
    if fp_kind == "scalar":
        fp = torch.tensor(10.0 ** r.uniform(-4, 0, n), dtype=torch.float32)
    elif fp_kind in ("feline", "ewa"):
        fp = (torch.tensor(r.normal(size=(n, 2)) * 1e-3, dtype=torch.float32),
              torch.tensor(r.normal(size=(n, 2)) * 1e-2, dtype=torch.float32))

    def to(x):
        return None if x is None else tuple(t.to(dev) for t in x) if isinstance(x, tuple) \
            else x.to(dev)

    out = texture_eval.eval_texture(card, tid.to(dev), uv.to(dev), default.to(dev), to(fp),
                                    (prim.to(dev), bary.to(dev))).cpu().numpy()
    ref = texture_eval.eval_texture(cpu, tid, uv, default, fp, (prim, bary)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


# ---- the sensors, the daylight emitters and spectral mode ----

def _a7a8_golden(name):
    from torch_meshes import daylight_xml, dispersion_xml, sensor_xml, sky_sun_xml

    if name.startswith("torch_sensor_"):
        return sensor_xml(name[len("torch_sensor_"):-len("_24_4.npy")]), None
    return {"torch_dispersion_32_4.npy": (dispersion_xml(32, 32), None),
            "torch_dispersion_spectral9_32_4.npy": (dispersion_xml(32, 32), 9),
            "torch_daylight_32_4.npy": (daylight_xml(32, 32), None),
            "torch_sky_sun_32_4.npy": (sky_sun_xml(32, 32), None)}[name]


@pytest.mark.parametrize("name", [
    "torch_dispersion_32_4.npy", "torch_dispersion_spectral9_32_4.npy", "torch_daylight_32_4.npy",
    "torch_sky_sun_32_4.npy", *(f"torch_sensor_{n}_24_4.npy" for n in (
        "orthographic", "telecentric", "spherical", "thinlens", "rdist"))])
def test_sensor_daylight_spectral_goldens_on_card(dev, name):
    """dispersion.xml in RGB mode and with 9 bins, DAYLIGHT, the Preetham
    sky with its sun and the sensor gallery (the JAX package's renders) on
    the card, through `render` with its default device, each at its
    tests/torch_meshes.py GOLDEN_GATES gate."""
    import os

    import mitsuba_tpu_torch as mt
    from torch_meshes import GOLDEN_GATES, ROOT

    xml, bins = _a7a8_golden(name)
    img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, spectral_bins=bins)
    gold = np.load(os.path.join(ROOT, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert _tm_rmse(img, gold) < GOLDEN_GATES[name], _tm_rmse(img, gold)


@pytest.mark.parametrize("name", ["fluencemeter", "radiancemeter", "irradiancemeter_sphere",
                                  "irradiancemeter_mesh"])
def test_meters_on_card(dev, name):
    """The meters in a unit constant environment on the card: 1 and pi
    (tests/test_sensors.py's tolerances)."""
    import mitsuba_tpu_torch as mt
    from torch_meshes import METERS, meter_xml

    body, exact = METERS[name]
    img = mt.render(mt.load_scene_string(meter_xml(body)), seed=3)
    np.testing.assert_allclose(img, exact, rtol=1e-5 if exact == 1.0 else 1e-3)


@pytest.mark.parametrize("name", ["daylight", "spherical", "dispersion"])
def test_lens_and_spectral_queries_equal_plain(dev, name):
    """K1/K2 bit-equal to plain on DAYLIGHT's camera rays through the
    thinlens and their first NEE, the spherical sensor's camera rays and
    dispersion.xml's camera rays and first NEE, at 128x128
    (chip_smoke.matpreview_brute)."""
    import mitsuba_tpu_torch as mt
    from chip_smoke import matpreview_brute
    from torch_meshes import daylight_xml, dispersion_xml, sensor_xml

    xml = {"daylight": daylight_xml(128, 128), "spherical": sensor_xml("spherical", 128, 64),
           "dispersion": dispersion_xml(128, 128)}[name]
    scene = mt.load_scene_string(xml)
    matpreview_brute(pk, scene, pack_scene(scene, dev), dev, [], name,
                     shadow=name != "spherical")


def test_spectral_pack_on_card_matches_cpu(dev, feature_dir):
    """apply_spectral_pack on a pack on the card: every tensor equal to the
    CPU pack's rewrite (the rewrite is host numpy), on the card's device."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.core.spectral import make_bins
    from mitsuba_tpu_torch.scene.builder import apply_spectral_pack

    scene = mt.load_scene_string(textured_xml(feature_dir, 32, 32))
    card, cpu = pack_scene(scene, dev), pack_scene(scene, "cpu")
    bins = make_bins(9)
    for g in range(3):
        got, ref = apply_spectral_pack(card, bins, g), apply_spectral_pack(cpu, bins, g)
        for k, v in ref.arrays.items():
            assert got.arrays[k].device.type == "cuda", k
            assert torch.equal(got.arrays[k].cpu(), v), k


@pytest.mark.parametrize("name", ["thinlens", "telecentric", "spherical", "rdist"])
def test_generate_rays_on_card_matches_cpu(dev, name):
    """generate_rays of the gallery's cameras on 100,000 seeded film
    positions and lens samples, the card against the CPU: within atol
    2e-6 (sin, cos and rsqrt differ in the last place)."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.sensor.plugins import generate_rays
    from torch_meshes import sensor_xml

    rec = mt.load_scene_string(sensor_xml(name)).sensor.record
    r = np.random.default_rng(11)
    pos01 = torch.tensor(r.random((100_000, 2)), dtype=torch.float32)
    u = torch.tensor(r.random((100_000, 2)), dtype=torch.float32)
    o, d = generate_rays(rec.pack(24, 24, dev), pos01.to(dev), u.to(dev))
    o_ref, d_ref = generate_rays(rec.pack(24, 24, torch.device("cpu")), pos01, u)
    np.testing.assert_allclose(o.cpu().numpy(), o_ref.numpy(), rtol=0, atol=2e-6)
    np.testing.assert_allclose(d.cpu().numpy(), d_ref.numpy(), rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def instanced_small(tmp_path_factory):
    """INSTANCED's configuration at 8 x 8 instances and 128x128
    (tests/torch_meshes.py instanced_xml), packed on the card through the
    two-level accelerator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import mitsuba_tpu_torch as mt
    from torch_meshes import instanced_xml

    d = tmp_path_factory.mktemp("instanced")
    a, b = str(d / "a.ply"), str(d / "b.ply")
    write_ply(a, *bunny_standin(seed=0))
    write_ply(b, *bunny_standin(seed=1, n_phi=132, n_theta=66))
    scene = mt.load_scene_string(instanced_xml(a, b, 128, 128, 4, n=8))
    pack = pack_scene(scene, torch.device("cuda"))
    assert pack.meta["has_instances"] and pack.meta["inst_pairs_ok"]
    return scene, pack


def test_instanced_batches_equal_plain(dev, instanced_small):
    """K3/K4 (closest; closest and any on the NEE) and K7/K8 bit-equal to
    plain on the template-space batches the instance pair path hands
    accel/pairs.py (chip_smoke.instanced_segments), and K1/K2 on the
    static rows."""
    from chip_smoke import instanced_queries, instanced_segments
    from mitsuba_tpu_torch.accel import intersect as tis
    from mitsuba_tpu_torch.accel import tlas
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator import path as tpath
    from mitsuba_tpu_torch.renderer import make_render_pass

    scene, pack = instanced_small
    queries = instanced_queries(tpath, make_render_pass, new_film, scene, pack, dev)
    instanced_segments(pairs, pb, pk, tlas, tis, queries, scene, pack, dev, [], "INSTANCED 8x8")


def test_instanced_pair_path_equals_loop_path(dev, instanced_small):
    """The instance pair path against the loop path on the camera rays and
    the first NEE (chip_smoke.instanced_pair_vs_loop)."""
    from chip_smoke import instanced_pair_vs_loop, instanced_queries
    from mitsuba_tpu_torch.accel import intersect as tis
    from mitsuba_tpu_torch.accel import tlas
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator import path as tpath
    from mitsuba_tpu_torch.renderer import make_render_pass

    scene, pack = instanced_small
    queries = instanced_queries(tpath, make_render_pass, new_film, scene, pack, dev)
    instanced_pair_vs_loop(tis, tlas, queries, pack, "INSTANCED 8x8", "card")


@pytest.mark.parametrize("name", [
    "torch_instancing_32_4.npy", "torch_instancing_tlas_32_4.npy",
    "torch_instancing_two_group_32_4.npy", "torch_shapes_gallery_32_4.npy",
    "torch_bvh_walk_32_4.npy"])
def test_extras_goldens_on_card(dev, name):
    """The geometry extras' goldens on the card through render
    (chip_smoke.extras_goldens renders them all; here each alone)."""
    import os

    import mitsuba_tpu_torch as mt
    from chip_smoke import BVH_WALK_BUDGET, HERE
    from mitsuba_tpu_torch.accel import clusters
    from torch_meshes import (
        GOLDEN_GATES,
        bvh_walk_mesh,
        feature_assets,
        instancing_two_group_xml,
        instancing_xml,
        shape_assets,
        shapes_gallery_xml,
        tm_rmse,
    )

    fd = feature_assets(os.path.join(HERE, "build", "feature_assets"))
    walk = os.path.join(HERE, "build", "bvh_walk.ply")
    write_ply(walk, *bvh_walk_mesh())
    xml, env, budget = {
        "torch_instancing_32_4.npy": (instancing_xml(), {}, None),
        "torch_instancing_tlas_32_4.npy": (instancing_xml(), {"MTS_INSTANCE_EXPAND_MAX": "0"},
                                           None),
        "torch_instancing_two_group_32_4.npy": (instancing_two_group_xml(fd),
                                                {"MTS_INSTANCE_EXPAND_MAX": "0"}, None),
        "torch_shapes_gallery_32_4.npy": (shapes_gallery_xml(shape_assets(fd)), {}, None),
        "torch_bvh_walk_32_4.npy": (bunny_scene_xml(walk, 32, 32), {}, BVH_WALK_BUDGET),
    }[name]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    saved_budget = clusters.CLUSTER_HBM_MAX
    if budget is not None:
        clusters.CLUSTER_HBM_MAX = budget
    try:
        img = mt.render(mt.load_scene_string(xml), spp=4, seed=0, device=dev)
    finally:
        clusters.CLUSTER_HBM_MAX = saved_budget
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    gold = np.load(os.path.join(HERE, "tests", "golden", name))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert tm_rmse(img, gold) < GOLDEN_GATES[name]
