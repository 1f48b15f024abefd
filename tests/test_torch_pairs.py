"""The port's pair pipeline (plain K3, K4, K7/K8 and the entry points built
on them) against the reference: its Pallas kernels in interpret mode
(`_cluster_lists_dense`, `pair_closest` / `pair_any`,
`cluster_closest` / `cluster_any`) and its XLA BVH walks
`_bvh_traverse` / `_bvh_traverse_any`, on tests/test_cluster.py's
random-triangle cluster pack.

Tolerances: the cull is exact (cluster ids equal, entries bit-equal);
hits use tests/test_pairs.py's gates (hit masks equal, t at rtol 1e-4,
prims equal but at exact-t ties, u/v at rtol 1e-3: the reference's K4
evaluates Moller-Trumbore as a bilinear form on the MXU, the port
directly); occlusion is equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.accel import pairs as jprs
from mitsuba_tpu.accel import pallas_bvh as jpb
from mitsuba_tpu_torch.accel import pairs
from mitsuba_tpu_torch.accel import pallas_bvh as pb
from mitsuba_tpu_torch.scene.builder import pack_from_numpy
from tests.test_cluster import cluster_pack
from test_torch_bvh import check_closest

torch.set_num_threads(1)

N_RAYS = 256


@pytest.fixture(scope="module")
def packs():
    jp = cluster_pack(n_tris=3000, tc=64)
    tp = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    return jp, tp


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.05, 3.0, n).astype(np.float32)
    return o, d, t_max


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("finite", [False, True])
def test_dense_cull_matches_reference(packs, finite):
    jp, tp = packs
    o, d, t_max = _rays(N_RAYS, 9)
    if not finite:
        t_max = np.full(N_RAYS, 3e38, np.float32)
    cid_r, ent_r, ov_r = jprs._cluster_lists_dense(jp, o, d, jnp.asarray(t_max), True)
    cid, ent, ov = pairs._cluster_lists_dense(tp, *_t(o, d, t_max))
    np.testing.assert_array_equal(cid.numpy(), np.asarray(cid_r))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(ent_r))
    np.testing.assert_array_equal(ov["n_cl"].numpy(), np.asarray(ov_r["n_cl"]))
    np.testing.assert_array_equal(ov["kept_max_cl"].numpy(), np.asarray(ov_r["kept_max_cl"]))
    assert ov["kk"] == ov_r["kk"] == pairs.K
    assert (cid.numpy() < tp.meta["n_clusters"]).any()


@pytest.mark.parametrize("k", [3, 1])
def test_pair_closest_matches_reference(packs, monkeypatch, k):
    """Default K, and K = 1 (as tests/test_pairs.py:65 does), which sends
    most rays through the K7 fallback."""
    jp, tp = packs
    monkeypatch.setattr(pairs, "K", k)
    monkeypatch.setattr(jprs, "K", k)
    monkeypatch.setattr(jprs, "KS", k)
    o, d, _ = _rays(N_RAYS, 1)
    out = [x.numpy() for x in pairs.pair_closest(tp, *_t(o, d), torch.tensor(np.inf))]
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    check_closest(jprs.pair_closest(jp, jo, jd, jnp.asarray(np.inf), interpret=True), out)
    check_closest(jis._bvh_traverse(jp, jo, jd, jnp.asarray(1e30)), out)
    _, _, ov = pairs._cluster_lists_dense(tp, *_t(o, d), torch.full((N_RAYS,), 3e38))
    overflow = pairs._overflow(ov, torch.as_tensor(out[0]))
    assert overflow.any() if k == 1 else overflow.float().mean() < 0.2


@pytest.mark.parametrize("k", [3, 1])
def test_pair_any_matches_reference(packs, monkeypatch, k):
    jp, tp = packs
    monkeypatch.setattr(pairs, "K", k)
    monkeypatch.setattr(jprs, "K", k)
    monkeypatch.setattr(jprs, "KS", k)
    o, d, t_max = _rays(N_RAYS, 3)
    occ = pairs.pair_any(tp, *_t(o, d, t_max)).numpy()
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    occ_ref = np.asarray(jis._bvh_traverse_any(jp, jo, jd, jt))
    assert 0.05 < occ_ref.mean() < 0.95
    np.testing.assert_array_equal(occ, occ_ref)
    np.testing.assert_array_equal(occ, np.asarray(jprs.pair_any(jp, jo, jd, jt, interpret=True)))


def test_cluster_traversal_matches_reference(packs, monkeypatch):
    """K7/K8 on their own: the reference's chunk kernels (exact prepass,
    VMEM-resident VPU kernel) and its BVH walks."""
    monkeypatch.setattr(jpb, "PREPASS", "exact")
    monkeypatch.setattr(jpb, "KERNEL", "vpu")
    jp, tp = packs
    o, d, t_max = _rays(N_RAYS, 13)
    for tm in (np.float32(np.inf), t_max):
        out = [x.numpy() for x in pb.cluster_closest(tp, *_t(o, d, tm))]
        check_closest(jpb.cluster_closest(jp, o, d, jnp.asarray(tm), sort=True, interpret=True), out)
        check_closest(jis._bvh_traverse(jp, o, d, jnp.asarray(tm)), out)
        np.testing.assert_array_equal(out[0][out[1] < 0], np.broadcast_to(tm, (N_RAYS,))[out[1] < 0])
    occ = pb.cluster_any(tp, *_t(o, d, t_max)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jpb.cluster_any(jp, o, d, jnp.asarray(t_max), sort=True, interpret=True))
    )
    np.testing.assert_array_equal(occ, np.asarray(jis._bvh_traverse_any(jp, o, d, jnp.asarray(t_max))))


def _tied_pack(seed=5, c=40, tc=16):
    """Hand-made cluster tables ({name: numpy array}, meta) whose clusters
    3, 5, 11, 19, 27 and 37 share the box [-1, 1]^3, so that a ray meets
    equal entries ordered by cluster id, and whose clusters 5 and 27 hold
    the same large triangle as two prims (a tie in t that the first cluster
    visited wins); the other clusters have scattered boxes.  Each cluster
    holds 1-5 small triangles inside its box; slots past them hold the far
    triangle (prim n_tris)."""
    r = np.random.default_rng(seed)
    shared = [3, 5, 11, 19, 27, 37]
    lo = r.uniform(-3.0, 2.5, (c, 3))
    hi = lo + r.uniform(0.2, 1.0, (c, 3))
    lo[shared], hi[shared] = -1.0, 1.0
    tri = np.zeros((9, c * tc), np.float32)
    tri[0:3] = 1e30
    n_tri = r.integers(1, 6, c)
    pad2prim = np.full(c * tc, -1, np.int64)
    n = 0
    for k in range(c):
        for j in range(n_tri[k]):
            tri[:, k * tc + j] = np.r_[r.uniform(lo[k], hi[k]), r.uniform(-0.4, 0.4, 6)]
            pad2prim[k * tc + j] = n
            n += 1
    big = [-1, -1, 0, 2, 0, 0, 0, 2, 0]  # the z = 0 square's lower half
    tri[:, 5 * tc + n_tri[5]] = tri[:, 27 * tc + n_tri[27]] = big
    pad2prim[[5 * tc + n_tri[5], 27 * tc + n_tri[27]]] = [n, n + 1]
    n += 2
    pad2prim[pad2prim < 0] = n
    box = np.zeros((8, c), np.float32)
    box[0:3], box[3:6] = lo.T, hi.T
    arrays = {"cl_box": box, "cl_tri": tri, "cl_pad2prim": pad2prim.astype(np.int32)}
    meta = {"n_tris": n, "n_spheres": 0, "use_bvh": True, "n_clusters": c,
            "cluster_tc": tc, "cluster_vmem_ok": True}
    return arrays, meta, (n - 2, n - 1)


def _tied_rays(n, seed):
    """n // 2 rays from a sphere of radius 4 toward the shared box, n // 2
    starting inside it (entry 0 for every shared cluster)."""
    r = np.random.default_rng(seed)
    u = r.normal(size=(n // 2, 3))
    o_out = 4 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d_out = r.uniform(-0.8, 0.8, (n // 2, 3)) - o_out
    o = np.concatenate([o_out, r.uniform(-0.9, 0.9, (n // 2, 3))]).astype(np.float32)
    d = np.concatenate([d_out, r.normal(size=(n // 2, 3))])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, r.uniform(0.5, 6.0, n).astype(np.float32)


@pytest.mark.parametrize("finite", [False, True])
def test_plain_walk_matches_reference_at_ties(monkeypatch, finite):
    """The port's plain K7/K8 walk (through cluster_closest / cluster_any
    on the CPU) against the reference's K7/K8 in interpret mode (exact
    prepass, VPU kernel, sorted chunks) on _tied_pack: equal entries across
    clusters, and a t tied across clusters 5 and 27.  Prims and occlusion
    equal, t within 1e-4 relative, u/v within 1e-3."""
    from mitsuba_tpu.scene.builder import ScenePack

    monkeypatch.setattr(jpb, "PREPASS", "exact")
    monkeypatch.setattr(jpb, "KERNEL", "vpu")
    arrays, meta, (prim5, prim27) = _tied_pack()
    jp = ScenePack({k: jnp.asarray(v) for k, v in arrays.items()}, meta)
    tp = pack_from_numpy(arrays, meta, "cpu")
    o, d, t_max = _tied_rays(N_RAYS, 11)
    tm = t_max if finite else np.float32(np.inf)
    rt, rp, ru, rv = (np.asarray(x) for x in jpb.cluster_closest(
        jp, o, d, jnp.asarray(tm), sort=True, interpret=True))
    bt, bp, bu, bv = (x.numpy() for x in pb.cluster_closest(tp, *_t(o, d, tm)))
    np.testing.assert_array_equal(bp, rp)
    hit = rp >= 0
    assert hit.mean() > 0.1
    np.testing.assert_allclose(bt[hit], rt[hit], rtol=1e-4)
    np.testing.assert_allclose(bu[hit], ru[hit], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(bv[hit], rv[hit], rtol=1e-3, atol=1e-4)
    # the tied triangle goes to the first cluster visited, 5
    assert (bp == prim5).sum() > 5 and not (bp == prim27).any()
    occ = pb.cluster_any(tp, *_t(o, d, t_max)).numpy()
    occ_ref = np.asarray(jpb.cluster_any(jp, o, d, jnp.asarray(t_max), sort=True, interpret=True))
    assert 0.05 < occ_ref.mean() < 0.95
    np.testing.assert_array_equal(occ, occ_ref)


def test_pair_fast_path_engages(packs):
    """The inverted-box padding trap (ROADMAP C, tests/test_pairs.py:112):
    a symmetric slab test cannot reject an inverted sentinel box, which
    then hits every ray at entry 0.  Padded clusters must never reach a
    list or a traversal, culling must find real clusters, and the
    overflow share must stay small."""
    _, tp = packs
    c = tp.meta["n_clusters"]
    assert tp.cl_box.shape[1] > c and tp.cl_mbox.numel() // 6 > c  # padding exists
    o, d, _ = _rays(4096, 0)
    o, d = _t(o, d)
    t_max = torch.full((4096,), 3e38)
    cids, _, ov = pairs._cluster_lists_dense(tp, o, d, t_max)
    assert (cids <= c).all()
    assert ov["n_cl"].float().mean() > 0.3
    order, _, _, n_hit = pb._chunk_prepass(o, d, t_max, tp.cl_box)
    hit_ids = order[torch.arange(order.shape[1])[None] < n_hit[:, None]]
    assert (hit_ids < c).all() and n_hit.float().mean() > 0.3
    best_t, *_ = pairs.pair_closest(tp, o, d, t_max)
    assert pairs._overflow(ov, best_t).float().mean() < 0.2


def test_cpu_wrappers_run_plain_versions(packs):
    """On the CPU the wrappers take the plain versions and launch nothing."""
    _, tp = packs
    counters = (pairs.dense_cull, pairs.pair_hit_closest, pairs.pair_hit_any,
                pb.cluster_traverse_closest, pb.cluster_traverse_any)
    before = [f.launches for f in counters]
    o, d, t_max = _t(*_rays(64, 2))
    pairs.pair_closest(tp, o, d, t_max)
    pairs.pair_any(tp, o, d, t_max)
    pb.cluster_closest(tp, o, d, t_max)
    pb.cluster_any(tp, o, d, t_max)
    assert [f.launches for f in counters] == before
    st = torch.zeros(64, 2, dtype=torch.int32)
    args = (o, d, t_max, tp.cl_box, tp.cl_tri, tp.meta["cluster_tc"])
    for walk in (pb.cluster_traverse_closest, pb.cluster_traverse_any,
                 pb.cluster_stream_closest, pb.cluster_stream_any):
        with pytest.raises(ValueError, match="kernel only"):
            walk(*args, stats=st)
    with pytest.raises(ValueError, match="no kernel"):
        pb.launch("mts_dense_cull", torch.device("meta"))
