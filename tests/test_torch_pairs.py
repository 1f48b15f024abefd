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
    with pytest.raises(ValueError, match="no kernel"):
        pb.launch("mts_dense_cull", torch.device("meta"))
