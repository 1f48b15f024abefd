"""The port's big-mesh host side against the reference: the PLY reader,
the BVH builders and their octant layouts, the cluster cut and tables,
the whole `pack_scene` of a PLY mesh (all exact), and the stackless BVH
walks `_bvh_traverse` / `_bvh_traverse_any` (hit masks and prims equal
but for exact-t ties, t at rtol 1e-4 as in tests/test_pairs.py, u/v at
rtol 1e-3); then the render route past the cluster budget (both
packages' budgets lowered): packs without cluster tables, the golden,
and `sort=True` equal to `sort=False` lane for lane."""

import os

import numpy as np
import pytest
import torch

from mitsuba_tpu.accel import bvh as jbvh
from mitsuba_tpu.accel import clusters as jcl
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.io.meshes import load_ply as jload_ply
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import bvh as tbvh
from mitsuba_tpu_torch.accel import clusters as tcl
from mitsuba_tpu_torch.accel import intersect as tis
from mitsuba_tpu_torch.io.meshes import load_ply
from mitsuba_tpu_torch.scene.builder import (
    BVH_ARRAYS,
    BVH_META,
    SLICE_ARRAYS,
    SLICE_META,
    pack_scene,
)
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from torch_meshes import (
    GOLDEN_GATES,
    ROOT,
    bunny_scene_xml,
    bunny_standin,
    bvh_walk_mesh,
    tm_rmse,
    uv_sphere,
    write_ply,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_load_ply_matches_reference(tmp_path, fmt):
    pos, idx = uv_sphere(8, 5, seed=1, amp=0.2)
    rng = np.random.default_rng(2)
    nrm = rng.normal(size=pos.shape).astype(np.float32)
    uv = rng.uniform(size=(len(pos), 2)).astype(np.float32)
    path = str(tmp_path / "m.ply")
    write_ply(path, pos, idx, normals=nrm, texcoords=uv, fmt=fmt)
    (m,), (j,) = load_ply(path), jload_ply(path)
    for name in ("positions", "indices", "normals", "texcoords"):
        a, b = getattr(m, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(m.positions, pos)
    np.testing.assert_array_equal(m.indices, idx)


def test_load_ply_polygons_and_bare_vertices(tmp_path):
    """Fan triangulation of a quad; no normals or uv when absent."""
    path = tmp_path / "quad.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_index\nend_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n"
    )
    (m,), (j,) = load_ply(str(path)), jload_ply(str(path))
    np.testing.assert_array_equal(m.indices, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_array_equal(m.indices, j.indices)
    assert m.normals is None and m.texcoords is None


def _prims(n, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    lo = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
    hi = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
    return v0, e1, e2, v0 + (e1 + e2) / 3, lo, hi


@pytest.mark.parametrize("use_native", [True, False])
def test_build_bvh_matches_reference(use_native):
    """Same tree from the same builder: the reference's C++ source built
    by the port, and the numpy fallback; then the same octant layouts."""
    *_, cen, lo, hi = _prims(1200, 3)
    t = tbvh.build_bvh(cen, lo, hi, use_native=use_native)
    j = jbvh.build_bvh(cen, lo, hi, use_native=use_native)
    for name in ("lo", "hi", "skip", "first", "count", "order"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert t.depth == j.depth
    rows_t, k_t = tbvh.octant_node_rows(t)
    rows_j, k_j = jbvh.octant_node_rows(j)
    assert k_t == k_j == 8
    np.testing.assert_array_equal(rows_t, rows_j)


def test_clusters_match_reference():
    v0, e1, e2, cen, lo, hi = _prims(2000, 4)
    bvh = jbvh.build_bvh(cen, lo, hi)
    pad = lambda a, f=0.0: np.concatenate([a[bvh.order], np.full((8, 3), f, a.dtype)])  # noqa: E731
    tv0, te1, te2 = pad(v0, 1e30), pad(e1), pad(e2)
    for a, b in zip(tcl.cut_clusters(bvh, 64), jcl.cut_clusters(bvh, 64)):
        np.testing.assert_array_equal(a, b)
    t_arr, t_meta = tcl.pack_clusters(bvh, tv0, te1, te2, 2000, tc=64)
    j_arr, j_meta = jcl.pack_clusters(bvh, tv0, te1, te2, 2000, tc=64)
    assert set(t_arr) == set(BVH_ARRAYS) - {"bvh_nodes", "tri9"}
    for k, a in t_arr.items():
        assert a.dtype == j_arr[k].dtype, k
        np.testing.assert_array_equal(a, j_arr[k], err_msg=k)
    assert t_meta == {k: j_meta[k] for k in t_meta}


@pytest.fixture(scope="module")
def ply_packs(tmp_path_factory):
    """The same ~3k-triangle PLY scene packed by the port and by the
    reference."""
    path = str(tmp_path_factory.mktemp("ply") / "m.ply")
    write_ply(path, *bunny_standin(seed=5, n_phi=48, n_theta=32))  # 2976 triangles
    xml = bunny_scene_xml(path, 16, 16)
    return pack_scene(load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml))


def test_pack_scene_matches_reference(ply_packs):
    tp, jp = ply_packs
    for k in SLICE_ARRAYS + BVH_ARRAYS:
        out, ref = tp.arrays[k].numpy(), np.asarray(jp.arrays[k])
        assert out.dtype == ref.dtype, k
        np.testing.assert_array_equal(out, ref, err_msg=k)
    for k in SLICE_META + BVH_META:
        assert tp.meta[k] == jp.meta[k], k
    assert tp.meta["use_bvh"] and tp.meta["has_env"] and tp.meta["n_clusters"] > 8


def _rays(n, seed, center=(-0.02, 0.1, 0.0), spread=0.15):
    rng = np.random.default_rng(seed)
    o = (np.asarray(center) + rng.uniform(-spread, spread, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def check_closest(ref, out):
    """tests/test_pairs.py's gates: hit masks equal, t at rtol 1e-4, prims
    equal but at exact-t ties, u/v of agreeing prims at rtol 1e-3."""
    rt, rp, ru, rv = (np.asarray(x) for x in ref)
    bt, bp, bu, bv = (np.asarray(x) for x in out)
    hit = rp >= 0
    np.testing.assert_array_equal(bp >= 0, hit)
    assert hit.sum() > 20
    np.testing.assert_allclose(bt[hit], rt[hit], rtol=1e-4, atol=1e-5)
    diff = hit & (bp != rp)
    assert (np.abs(bt[diff] - rt[diff]) <= 1e-5).all()
    same = hit & ~diff
    np.testing.assert_allclose(bu[same], ru[same], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(bv[same], rv[same], rtol=1e-3, atol=1e-4)


def test_bvh_traverse_matches_reference(ply_packs):
    tp, jp = ply_packs
    o, d = _rays(1024, 6)
    t_max = np.random.default_rng(7).uniform(0.02, 0.3, 1024).astype(np.float32)
    for tm in (np.float32(np.inf), t_max):
        ref = jis._bvh_traverse(jp, o, d, tm)
        out = tis._bvh_traverse(tp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tm))
        check_closest(ref, [x.numpy() for x in out])
    occ_ref = np.asarray(jis._bvh_traverse_any(jp, o, d, t_max))
    occ = tis._bvh_traverse_any(tp, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    assert 0.05 < occ_ref.mean() < 0.95
    np.testing.assert_array_equal(occ.numpy(), occ_ref)


# ---- the BVH route past the cluster budget ----------------------------------

@pytest.fixture(scope="module")
def walk_packs(tmp_path_factory):
    """scenes/bunny.xml's configuration on bvh_walk_mesh (3,968 triangles,
    46 clusters) with the cluster budget lowered in both packages below
    its clusters, so that neither packs cluster tables; and the XML."""
    path = str(tmp_path_factory.mktemp("walk") / "walk.ply")
    write_ply(path, *bvh_walk_mesh())
    xml = bunny_scene_xml(path, 32, 32)
    saved = jcl.CLUSTER_HBM_MAX, tcl.CLUSTER_HBM_MAX
    jcl.CLUSTER_HBM_MAX = tcl.CLUSTER_HBM_MAX = 1000
    try:
        yield pack_scene(load_scene_string(xml), "cpu"), jpack_scene(jload_string(xml)), xml
    finally:
        jcl.CLUSTER_HBM_MAX, tcl.CLUSTER_HBM_MAX = saved


def test_bvh_route_pack(walk_packs):
    """No cluster tables in either pack; the BVH, its node rows and the
    triangle rows equal."""
    tp, jp, _ = walk_packs
    assert tp.meta["use_bvh"] and jp.meta["use_bvh"]
    assert tp.meta.get("n_clusters", 0) == jp.meta.get("n_clusters", 0) == 0
    assert "cl_tri" not in tp.arrays and "cl_tri" not in jp.arrays
    for k in ("bvh_nodes", "tri9", "tri_v0", "tri_e1", "tri_e2", "tri_s"):
        np.testing.assert_array_equal(tp.arrays[k].numpy(), np.asarray(jp.arrays[k]), err_msg=k)
    assert tp.meta["bvh_n_layouts"] == jp.meta["bvh_n_layouts"]


def test_bvh_route_golden(walk_packs):
    """The render walks the BVH (the pair pipeline never runs), at the
    golden's gate."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.accel import pairs

    tp, _, xml = walk_packs
    before = pairs.pair_closest.rays
    img = mt.render(load_scene_string(xml), spp=4, seed=0, device="cpu", pack=tp)
    assert pairs.pair_closest.rays == before
    golden = "torch_bvh_walk_32_4.npy"
    gold = np.load(os.path.join(ROOT, "tests", "golden", golden))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert tm_rmse(img, gold) < GOLDEN_GATES[golden]


@pytest.mark.parametrize("chunk", [1 << 10, 1 << 15])
def test_bvh_route_sort_equal(walk_packs, monkeypatch, chunk):
    """intersect / occluded with sort=True (coherent chunks of BVH_CHUNK
    rays, the last padded at t_max 0) equal sort=False lane for lane, and
    the reference's walk."""
    tp, jp, _ = walk_packs
    monkeypatch.setattr(tis, "BVH_CHUNK", chunk)
    o, d = _rays(5000, 12)
    t_max = np.random.default_rng(13).uniform(0.02, 0.3, 5000).astype(np.float32)
    to, td, tm = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)
    a, b = tis.intersect(tp, to, td), tis.intersect(tp, to, td, sort=True)
    for x, y in zip((a.t, a.prim, a.u, a.v), (b.t, b.prim, b.u, b.v)):
        assert torch.equal(x, y)
    check_closest(jis._bvh_traverse(jp, o, d, np.float32(np.inf)),
                  [x.numpy() for x in (b.t, b.prim, b.u, b.v)])
    occ = tis.occluded(tp, to, td, tm, sort=True)
    assert torch.equal(occ, tis.occluded(tp, to, td, tm))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jis._bvh_traverse_any(jp, o, d, t_max)))
    assert 0.05 < occ.float().mean() < 0.95
