"""What the redesigned pair-pipeline kernels (K3 dense cull and K4 pair
hits, csrc/cluster_hit.cu; K5 two-level cull and K6 window pair kernel,
csrc/cluster_stream.cu) rely on, held on the CPU against the port's plain
versions and the JAX package's packs:

* the group level of K5 and K3: a box hit by the cull's slab implies a hit
  on its group's union box (property tests over zero direction
  components, origins inside boxes, tiny or BIG t_max and flat or point
  boxes, on drawn boxes and on a pack's cluster boxes), and test-local
  plain models of the group-pruned culls (with the kernels' longer
  register lists) equal `two_level_cull_plain` and `dense_cull_plain`
  exactly;
* the `cl_cnt` columns K4 and K6 test: the same from `pack_scene` and from
  `pack_from_numpy` of the reference's pack, and `pair_hit_*_plain` and
  `window_hit_*_plain` restricted to the first `cl_cnt` columns of each
  cluster equal the full versions exactly;
* the triangle-major `cl_tri_rows`: made on a pack's first pair-pipeline
  call only.

Tolerances: none; every comparison is exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import pairs
from mitsuba_tpu_torch.accel import pallas_bvh as pb
from mitsuba_tpu_torch.accel.bvh import build_bvh
from mitsuba_tpu_torch.accel.clusters import pack_clusters
from mitsuba_tpu_torch.scene.builder import (ScenePack, cluster_columns, pack_from_numpy,
                                             pack_scene)
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.test_cluster import cluster_pack
from torch_meshes import bunny_scene_xml, bunny_standin, write_ply

torch.set_num_threads(1)

BIG = pairs.BIG
MAX_LIST = 8  # the kernel's list capacity (kMaxKs, kMaxK)


@pytest.fixture(scope="module")
def tp():
    """tests/test_torch_dense.py's pack: 3,000 triangles, 69 clusters of
    at most 64, 5 supers."""
    jp = cluster_pack(n_tris=3000, tc=64)
    return pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")


@pytest.fixture(scope="module")
def own_tp(tp):
    """The port's own cluster pack (its BVH builder and pack_clusters) of
    the 3,000 random triangles tests/test_cluster.py cluster_pack draws."""
    rng = np.random.default_rng(0)
    n = 3000
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
    hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
    bvh = build_bvh(v0 + (e1 + e2) / 3, lo, hi)
    tabs = [np.concatenate([a[bvh.order], np.full((4, 3), f, np.float32)])
            for a, f in ((v0, 1e30), (e1, 0.0), (e2, 0.0))]
    arrays, meta = pack_clusters(bvh, *tabs, n, tc=64)
    arrays["cl_cnt"] = cluster_columns(arrays["cl_tri"], 64)
    own = ScenePack({k: torch.as_tensor(v) for k, v in arrays.items()}, meta)
    for k in ("cl_mbox", "cl_tri", "cl_pad2prim", "cl_cnt"):  # the reference's tables
        assert torch.equal(own.arrays[k], tp.arrays[k]), k
    return own


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::7, rng.integers(0, 3)] = 0.0  # axis-parallel components
    t_max = rng.uniform(0.05, 3.0, n).astype(np.float32)
    return [torch.as_tensor(x) for x in (o, d, t_max)]


# ---------------------------------------------------------------------------
# the group level of K5
# ---------------------------------------------------------------------------

_coord = st.floats(-50.0, 50.0, width=32)
_dir = st.one_of(st.sampled_from([0.0, -0.0, 1e-30]), st.floats(-1.0, 1.0, width=32))
_box = st.tuples(st.lists(_coord, min_size=3, max_size=3),
                 st.lists(st.sampled_from([0.0, 0.0, 1e-3, 1.0, 30.0]), min_size=3, max_size=3))


@settings(max_examples=300, deadline=None)
@given(boxes=st.lists(_box, min_size=1, max_size=5), o=st.lists(_coord, min_size=3, max_size=3),
       inside=st.booleans(), d=st.lists(_dir, min_size=3, max_size=3),
       t_max=st.sampled_from([1e-6, 0.5, 7.0, BIG]))
def test_member_hit_implies_group_hit(boxes, o, inside, d, t_max):
    """cull_slab on a group's union box (min of the lo rows, max of the hi
    rows) is hit whenever one of its members is, with an entry no later."""
    lo = np.array([b[0] for b in boxes], np.float32)
    hi = (lo + np.array([b[1] for b in boxes], np.float32)).astype(np.float32)  # flat: extent 0
    o = np.array(o, np.float32)
    if inside:  # the origin inside (or on) the first member
        o = ((lo[0] + hi[0]) / 2).astype(np.float32)
    lo_t, hi_t = torch.as_tensor(lo)[None], torch.as_tensor(hi)[None]  # [1, B, 3]
    o_t = torch.as_tensor(o)[None]
    inv = pb.safe_inv(torch.tensor([d], dtype=torch.float32))
    tm = torch.tensor([t_max], dtype=torch.float32)
    en_m, hit_m = pairs._cull_slab(lo_t, hi_t, o_t, inv, tm)
    en_g, hit_g = pairs._cull_slab(lo_t.amin(dim=1, keepdim=True), hi_t.amax(dim=1, keepdim=True),
                                   o_t, inv, tm)
    if bool(hit_m.any()):
        assert bool(hit_g[0, 0])
        assert float(en_g[0, 0]) <= float(en_m[hit_m].min())


def _group_boxes(cl_sup, s, gs):
    """[1, ceil(s / gs), 3] lo and hi: each group's union of real supers."""
    sup = cl_sup[:, :s]
    n_grp = -(-s // gs)
    lo = torch.stack([sup[0:3, g * gs:(g + 1) * gs].amin(dim=1) for g in range(n_grp)])
    hi = torch.stack([sup[3:6, g * gs:(g + 1) * gs].amax(dim=1) for g in range(n_grp)])
    return lo[None], hi[None]


def _group_pruned_cull(o, d, t_max, cl_sup, cl_mbox, s, c, ks, kk, gs):
    """The kernel's K5 as a plain model: supers slab-tested only inside the
    groups the ray hits; lists kept at MAX_LIST and cut to ks / kk."""
    r, sp = o.shape[0], cl_sup.shape[1]
    g = cl_mbox.shape[1] // 6
    inv = pb.safe_inv(d)
    g_lo, g_hi = _group_boxes(cl_sup, s, gs)
    _, g_hit = pairs._cull_slab(g_lo, g_hi, o, inv, t_max)  # [R, groups]
    idx = torch.arange(sp)
    tested = torch.zeros(r, sp, dtype=torch.bool)
    tested[:, :s] = g_hit[:, idx[:s] // gs]
    en, hit = pairs._cull_slab(cl_sup[0:3].T[None], cl_sup[3:6].T[None], o, inv, t_max)
    hit = hit & tested
    val_s, sid = pairs._k_smallest(torch.where(hit, en, BIG), min(MAX_LIST, sp))
    val_s, sid = val_s[:, :ks], sid[:, :ks]
    mb = cl_mbox[sid].reshape(r, ks * g, 6)
    cand = (sid[:, :, None].to(torch.int32) * g + torch.arange(g, dtype=torch.int32)).reshape(r, ks * g)
    ok = (val_s < BIG).repeat_interleave(g, dim=1) & (cand < c)
    en_c, hit_c = pairs._cull_slab(mb[..., 0:3], mb[..., 3:6], o, inv, t_max)
    hit_c = hit_c & ok
    val_c, pos = pairs._k_smallest(torch.where(hit_c, en_c, BIG), min(MAX_LIST, ks * g))
    val_c, pos = val_c[:, :kk], pos[:, :kk]
    return (torch.where(val_c < BIG, cand.gather(1, pos), c), val_c,
            hit.sum(dim=1, dtype=torch.int32), val_s[:, ks - 1],
            hit_c.sum(dim=1, dtype=torch.int32), val_c[:, kk - 1])


@pytest.mark.parametrize("gs", [1, 2, 4, 16])
@pytest.mark.parametrize("k,ks", [(3, 8), (1, 1), (5, 2)])
def test_group_pruned_cull_equals_plain(tp, k, ks, gs):
    m = tp.meta
    s, c = m["n_supers"], m["n_clusters"]
    ks = min(ks, s)
    o, d, t_max = _rays(512, 11)
    for tm in (t_max, torch.full_like(t_max, BIG)):
        args = (o, d, tm, tp.cl_sup, tp.cl_mbox, s, c, ks, k)
        ref = pairs.two_level_cull_plain(*args)
        out = _group_pruned_cull(*args, gs)
        for a, b, what in zip(out, ref, ("cid", "entry", "n_sup", "kept_sup", "n_cl", "kept_cl")):
            assert torch.equal(a.to(b.dtype), b), what
        assert (ref[0] < c).any() and (ref[2] > 0).any()


# ---------------------------------------------------------------------------
# the group level of K3
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(o=st.lists(_coord, min_size=3, max_size=3), inside=st.integers(-1, 68),
       d=st.lists(_dir, min_size=3, max_size=3), t_max=st.sampled_from([1e-6, 0.5, 7.0, BIG]),
       gs=st.sampled_from([1, 2, 16]))
def test_cluster_hit_implies_group_hit(tp, o, inside, d, t_max, gs):
    """On the reference pack's cluster boxes: every cluster the cull's slab
    hits lies in a hit group of gs consecutive ids, whose entry is no
    later (inside >= 0: the origin at that cluster's centre)."""
    c = tp.meta["n_clusters"]
    boxes = tp.cl_mbox.reshape(-1, 6)[:c]
    o = torch.tensor([o], dtype=torch.float32) * 0.05
    if inside >= 0:
        o = ((boxes[inside, 0:3] + boxes[inside, 3:6]) / 2)[None]
    inv = pb.safe_inv(torch.tensor([d], dtype=torch.float32))
    tm = torch.tensor([t_max], dtype=torch.float32)
    g_lo, g_hi = _group_boxes(boxes.T, c, gs)
    en_m, hit_m = pairs._cull_slab(boxes[None, :, 0:3], boxes[None, :, 3:6], o, inv, tm)
    en_g, hit_g = pairs._cull_slab(g_lo, g_hi, o, inv, tm)
    grp = torch.arange(c) // gs
    assert bool((hit_g[0, grp] | ~hit_m[0]).all())
    assert bool((en_g[0, grp] <= en_m[0])[hit_m[0]].all())


def _group_pruned_dense_cull(o, d, t_max, cl_mbox, c, kk, gs):
    """The kernel's K3 as a plain model: clusters slab-tested only inside
    the groups of gs consecutive ids the ray hits, in cid order; the list
    kept at MAX_LIST and cut to kk."""
    boxes = cl_mbox.reshape(-1, 6)[:c]
    inv = pb.safe_inv(d)
    g_lo, g_hi = _group_boxes(boxes.T, c, gs)
    _, g_hit = pairs._cull_slab(g_lo, g_hi, o, inv, t_max)  # [R, groups]
    tested = g_hit[:, torch.arange(c) // gs]
    en, hit = pairs._cull_slab(boxes[None, :, 0:3], boxes[None, :, 3:6], o, inv, t_max)
    hit = hit & tested
    val, idx = pairs._k_smallest(torch.where(hit, en, BIG), min(MAX_LIST, c))
    val, idx = val[:, :kk], idx[:, :kk]
    return (torch.where(val < BIG, idx, c).to(torch.int32), val,
            hit.sum(dim=1, dtype=torch.int32), val[:, kk - 1])


@pytest.mark.parametrize("gs", [1, 2, 16])
@pytest.mark.parametrize("kk", [1, 3, 8])
@pytest.mark.parametrize("pack_kind", ["reference", "own"])
def test_group_pruned_dense_cull_equals_plain(tp, own_tp, pack_kind, kk, gs):
    """At the pack's 69 clusters and at 33 and 17 (partial last groups),
    random rays with axis-parallel components and rays from cluster
    centres, t_max random, tiny and BIG."""
    pack = tp if pack_kind == "reference" else own_tp
    c_all = pack.meta["n_clusters"]
    assert c_all % 16
    boxes = pack.cl_mbox.reshape(-1, 6)[:c_all]
    o, d, t_max = _rays(512, 17)
    o = torch.cat([o, (boxes[:, 0:3] + boxes[:, 3:6]) / 2])
    d = torch.cat([d, d[:c_all]])
    t_max = torch.cat([t_max, t_max[:c_all]])
    for c in (c_all, 33, 17):
        for tm in (t_max, torch.full_like(t_max, 1e-6), torch.full_like(t_max, BIG)):
            args = (o, d, tm, pack.cl_mbox, c, kk)
            ref = pairs.dense_cull_plain(*args)
            out = _group_pruned_dense_cull(*args, gs)
            for a, b, what in zip(out, ref, ("cid", "entry", "n_cl", "kept_max")):
                assert torch.equal(a, b), (c, what)
            if tm is not t_max or c < c_all:
                continue
            assert (ref[0] < c).any() and (ref[2] > kk).any()


# ---------------------------------------------------------------------------
# cl_cnt: the columns K6 tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_xml(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "standin.ply")
    write_ply(path, *bunny_standin(seed=3, n_phi=64, n_theta=40))
    return bunny_scene_xml(path, 16, 16)


def test_cluster_columns_from_both_packs(mesh_xml):
    """pack_scene and pack_from_numpy of the JAX package's pack give the
    same cl_cnt: a multiple of 4 at most Tc, past which e2 is zero."""
    own = pack_scene(load_scene_string(mesh_xml), "cpu")
    jp = jpack_scene(jload_string(mesh_xml))
    converted = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    assert torch.equal(own.cl_cnt, converted.cl_cnt)
    tc, c = own.meta["cluster_tc"], own.meta["n_clusters"]
    cnt = own.cl_cnt
    assert cnt.dtype == torch.int32 and cnt.shape == (c,)
    assert ((cnt % 4 == 0) & (cnt <= tc) & (cnt > 0)).all()
    e2 = own.cl_tri[6:9].reshape(3, c, tc)
    past = torch.arange(tc)[None] >= cnt[:, None]
    assert (e2[:, past] == 0).all()
    # the real triangles lie before cl_cnt, and padding past them is cut
    real = (own.cl_tri[0] < 1e29).reshape(c, tc).sum(dim=1)
    assert torch.equal(cnt, torch.clamp((real + 3) // 4 * 4, max=tc).to(torch.int32))
    assert int(cnt.sum()) < c * tc


def test_cluster_columns_edge_cases():
    """Empty tiles count 0, a lone triangle 4, a full tile Tc; a zero e2
    inside the tile does not cut it short."""
    tc = 8
    tri = np.zeros((9, 4 * tc), np.float32)
    tri[6, 1 * tc + 0] = 1.0  # cluster 1: column 0
    tri[8, 2 * tc + tc - 1] = -2.0  # cluster 2: the last column
    tri[7, 3 * tc + 5] = 1e-30  # cluster 3: column 5 (columns 0-4 zero)
    assert cluster_columns(tri, tc).tolist() == [0, 4, 8, 8]


def _closest_restricted(o, d, t_max, cid_q, pair_q, kk, cl_tri, pad2prim, c, tc, cl_cnt):
    """window_hit_closest_plain testing only each cluster's first cl_cnt
    columns."""
    pair = pair_q.long()
    ray = pair // kk
    valid, t, u, v, hit = pairs._pair_tests(o[ray], d[ray], t_max[ray], cid_q, cl_tri, c, tc)
    cols = torch.arange(tc, dtype=torch.int32)
    cidc = torch.clamp(cid_q, max=c - 1).long()
    hit = hit & (cols[None] < cl_cnt[cidc][:, None])
    tm = t_max[ray]
    t = torch.where(hit, t, torch.inf)
    tmin = t.amin(dim=1)
    row = torch.where(t == tmin[:, None], cols, tc).amin(dim=1)
    found = tmin < tm
    rsel = row.clamp(max=tc - 1).long()
    res = (torch.where(valid, torch.where(found, tmin, tm), BIG),
           torch.where(valid & found, pad2prim[cidc * tc + rsel], -1),
           torch.where(valid & found, u.gather(1, rsel[:, None])[:, 0], 0.0),
           torch.where(valid & found, v.gather(1, rsel[:, None])[:, 0], 0.0))
    outs = []
    for x in res:
        out = torch.empty_like(x)
        out[pair] = x
        outs.append(out.reshape(-1, kk))
    occ = torch.zeros(pair.shape[0], dtype=torch.bool)
    occ[pair] = valid & ((tm <= 0.0) | hit.any(dim=1))
    return tuple(outs), occ.reshape(-1, kk)


@pytest.mark.parametrize("pack_kind", ["reference", "own"])
def test_window_plain_restricted_to_columns(tp, mesh_xml, pack_kind):
    pack = tp if pack_kind == "reference" else pack_scene(load_scene_string(mesh_xml), "cpu")
    m = pack.meta
    c, tc, s = m["n_clusters"], m["cluster_tc"], m["n_supers"]
    o, d, t_max = _rays(512, 5)
    if pack_kind == "own":  # rays toward the mesh
        o = o * 0.1 + torch.tensor([-0.02, 0.1, 0.0])
    cids = pairs.two_level_cull(o, d, t_max, pack.cl_sup, pack.cl_mbox, s, c, min(8, s), 3)[0]
    cid_q, pair_q = pairs.pair_queue(cids)
    args = (o, d, t_max, cid_q, pair_q, 3, pack.cl_tri, pack.cl_pad2prim, c, tc)
    full = pairs.window_hit_closest_plain(*args)
    restricted, occ = _closest_restricted(*args, pack.cl_cnt)
    for a, b in zip(restricted, full):
        assert torch.equal(a, b)
    assert (full[1] >= 0).any()
    assert torch.equal(occ, pairs.window_hit_any_plain(o, d, t_max, cid_q, pair_q, 3,
                                                       pack.cl_tri, c, tc))


@pytest.mark.parametrize("kk", [1, 3, 8])
@pytest.mark.parametrize("pack_kind", ["reference", "own"])
def test_pair_plain_restricted_to_columns(tp, own_tp, pack_kind, kk):
    """pair_hit_*_plain on K4's [R, kk] lists from dense_cull_plain,
    restricted to the first cl_cnt columns of each cluster, equal the full
    versions (t_max random, BIG and <= 0)."""
    pack = tp if pack_kind == "reference" else own_tp
    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    assert (pack.cl_cnt < tc).any()
    o, d, t_max = _rays(512, 23)
    cids = pairs.dense_cull_plain(o, d, torch.full_like(t_max, BIG), pack.cl_mbox, c, kk)[0]
    assert (cids < c).any() and (cids == c).any()
    t_le0 = torch.where(torch.arange(512) % 3 == 0, 0.0, -t_max)
    for tm in (t_max, torch.full_like(t_max, BIG), t_le0):
        args = (o, d, tm, cids.reshape(-1), torch.arange(cids.numel(), dtype=torch.int32), kk,
                pack.cl_tri, pack.cl_pad2prim, c, tc)
        restricted, occ = _closest_restricted(*args, pack.cl_cnt)
        full = pairs.pair_hit_closest_plain(o, d, tm, cids, pack.cl_tri, pack.cl_pad2prim, c, tc)
        for a, b in zip(restricted, full):
            assert torch.equal(a, b)
        assert torch.equal(occ, pairs.pair_hit_any_plain(o, d, tm, cids, pack.cl_tri, c, tc))
        if tm is t_max:
            assert (full[1] >= 0).any() and occ.any() and not occ.all()


@pytest.mark.parametrize("path", ["bigmesh", "dense"])
def test_tri_rows_made_once_on_the_dense_path(mesh_xml, monkeypatch, path):
    """A pack holds no cl_tri_rows until pair_closest runs on it, on the
    K3/K4 path (up to DENSE_C clusters) or the K5/K6 path; then it holds
    cl_tri transposed, contiguous, made once."""
    pack = pack_scene(load_scene_string(mesh_xml), "cpu")
    o, d, t_max = _rays(64, 3)
    o = o * 0.1 + torch.tensor([-0.02, 0.1, 0.0])
    assert "cl_tri_rows" not in pack.arrays
    if path == "dense":
        monkeypatch.setattr(pairs, "DENSE_C", 0)
    pairs.pair_closest(pack, o, d, t_max)
    rows = pack.arrays["cl_tri_rows"]
    assert rows.is_contiguous() and torch.equal(rows, pack.cl_tri.T)
    pairs.pair_any(pack, o, d, t_max)
    assert pack.arrays["cl_tri_rows"] is rows


def test_pack_arrays_contiguous(mesh_xml):
    """Every array of a pack is C-contiguous, from pack_scene and from
    pack_from_numpy, so that no kernel wrapper copies one per call (cl_tri
    and tri_t are built as transposes)."""
    own = pack_scene(load_scene_string(mesh_xml), "cpu")
    jp = jpack_scene(jload_string(mesh_xml))
    converted = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    for pack in (own, converted):
        bad = [k for k, v in pack.arrays.items() if not v.is_contiguous()]
        assert not bad, bad
