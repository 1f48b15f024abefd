"""The port's dense-mesh path on the CPU: the plain versions of the
two-level cull (K5), the window pair kernel (K6) and the streamed
traversal (K9/K10), and the entry points that dispatch to them, against
the reference's Pallas kernels in interpret mode (`_cluster_lists_pallas`,
`pair_closest` / `pair_any` with the window kernel, `cluster_closest` /
`cluster_any` with the MXU kernel) and its XLA BVH walks; then the slice
as a whole, rendered against the reference.

Small seeded meshes take the dense-mesh path by lowering DENSE_C (K5/K6)
and setting `cluster_vmem_ok` false (K9/K10), as tests/test_pairs.py and
tests/test_cluster.py do.

Tolerances: the cull is exact (cluster ids, entries and all four overflow
statistics equal); hits use tests/test_pairs.py's gates (hit masks equal,
t at rtol 1e-4, prims equal but at exact-t ties, u/v at rtol 1e-3: the
reference's K6/K9 evaluate Moller-Trumbore as a bilinear form on the MXU,
the port directly); occlusion is equal; renders at tests/test_golden.py's
gate (tone-mapped RMSE < 5e-3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mitsuba_tpu
import mitsuba_tpu_torch as mt
from mitsuba_tpu.accel import intersect as jis
from mitsuba_tpu.accel import pairs as jprs
from mitsuba_tpu.accel import pallas_bvh as jpb
from mitsuba_tpu.scene.builder import pack_scene as jpack_scene
from mitsuba_tpu.scene.xml_loader import load_scene_string as jload_string
from mitsuba_tpu_torch.accel import pairs
from mitsuba_tpu_torch.accel import pallas_bvh as pb
from mitsuba_tpu_torch.scene.builder import pack_from_numpy, pack_scene
from mitsuba_tpu_torch.scene.xml_loader import load_scene_string
from tests.test_cluster import cluster_pack
from test_torch_bvh import check_closest
from torch_meshes import bunny_scene_xml, bunny_standin, write_ply

torch.set_num_threads(1)

N_RAYS = 256


@pytest.fixture(scope="module")
def packs():
    jp = cluster_pack(n_tris=3000, tc=64)
    tp = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    assert tp.meta["n_supers"] > 1
    return jp, tp


def _streamed(tp):
    """The same pack with the reference's VMEM budget exceeded: K9/K10."""
    return type(tp)(tp.arrays, {**tp.meta, "cluster_vmem_ok": False})


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.05, 3.0, n).astype(np.float32)
    return o, d, t_max


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _dense(monkeypatch, k=3, ks=8):
    """Both packages past their dense-cull bound, with the given K / KS."""
    for mod in (pairs, jprs):
        monkeypatch.setattr(mod, "DENSE_C", 0)
        monkeypatch.setattr(mod, "K", k)
        monkeypatch.setattr(mod, "KS", ks)


def _spy(monkeypatch, module, names, calls=None):
    """Count the calls of module's functions `names` (the plain versions
    the CPU takes) in `calls` (a new dict if None), keeping what they
    compute."""
    calls = {} if calls is None else calls
    calls.update(dict.fromkeys(names, 0))
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("finite", [False, True])
@pytest.mark.parametrize("k,ks", [(3, 8), (1, 1), (5, 2)])
def test_two_level_cull_matches_reference(packs, monkeypatch, finite, k, ks):
    jp, tp = packs
    _dense(monkeypatch, k, ks)
    o, d, t_max = _rays(N_RAYS, 9)
    if not finite:
        t_max = np.full(N_RAYS, 3e38, np.float32)
    cid_r, ent_r, ov_r = jprs._cluster_lists_pallas(jp, o, d, jnp.asarray(t_max), True)
    cid, ent, ov = pairs._cluster_lists(tp, *_t(o, d, t_max))
    np.testing.assert_array_equal(cid.numpy(), np.asarray(cid_r))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(ent_r))
    for key in ("n_sup", "kept_max_sup", "n_cl", "kept_max_cl"):
        np.testing.assert_array_equal(ov[key].numpy(), np.asarray(ov_r[key]), err_msg=key)
    assert (ov["ks"], ov["kk"]) == (ov_r["ks"], ov_r["kk"])
    assert (cid.numpy() < tp.meta["n_clusters"]).any()
    if ov["ks"] < tp.meta["n_supers"]:  # the super-overflow class occurs
        assert (ov["n_sup"].numpy() > ov["ks"]).any()


def test_overflow_super_term():
    """A ray whose cull kept every cluster it hit still overflows when it
    hit more supers than KS and found nothing before the kept horizon."""
    ov = {"n_sup": torch.tensor([9, 9, 3]), "ks": 8, "kept_max_sup": torch.tensor([1.0, 1.0, 1.0]),
          "n_cl": torch.tensor([2, 2, 2]), "kk": 3, "kept_max_cl": torch.tensor([0.5, 0.5, 0.5])}
    assert pairs._overflow(ov, torch.tensor([2.0, 0.9, 2.0])).tolist() == [True, False, False]
    del ov["n_sup"]  # the dense cull has no super level
    assert not pairs._overflow(ov, torch.tensor([2.0, 0.9, 2.0])).any()


def test_pair_queue_holds_every_slot(packs, monkeypatch):
    _, tp = packs
    _dense(monkeypatch)
    o, d, t_max = _t(*_rays(N_RAYS, 4))
    cids, _, _ = pairs._cluster_lists(tp, o, d, t_max)
    cid_q, pair_q = pairs.pair_queue(cids)
    assert cid_q.dtype == pair_q.dtype == torch.int32
    assert (cid_q[1:] >= cid_q[:-1]).all()
    assert torch.equal(torch.sort(pair_q.long()).values, torch.arange(cids.numel()))
    assert torch.equal(cids.reshape(-1)[pair_q.long()], cid_q)


@pytest.mark.parametrize("k", [3, 1])
def test_window_pair_closest_matches_reference(packs, monkeypatch, k):
    """K5 + K6 (plain) through pair_closest against the reference's
    window kernel in interpret mode and its BVH walk; K = KS = 1 forces
    the overflow fallback."""
    jp, tp = packs
    _dense(monkeypatch, k, 8 if k == 3 else 1)
    monkeypatch.setenv("MTS_PAIR_KERNEL", "window")
    calls = _spy(monkeypatch, pairs, ["two_level_cull_plain", "window_hit_closest_plain",
                                      "dense_cull_plain", "pair_hit_closest_plain"])
    o, d, _ = _rays(N_RAYS, 1)
    out = [x.numpy() for x in pairs.pair_closest(tp, *_t(o, d), torch.tensor(np.inf))]
    assert calls["two_level_cull_plain"] and calls["window_hit_closest_plain"]
    assert not (calls["dense_cull_plain"] or calls["pair_hit_closest_plain"])
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    check_closest(jprs.pair_closest(jp, jo, jd, jnp.asarray(np.inf), interpret=True), out)
    check_closest(jis._bvh_traverse(jp, jo, jd, jnp.asarray(1e30)), out)
    _, _, ov = pairs._cluster_lists(tp, *_t(o, d), torch.full((N_RAYS,), 3e38))
    overflow = pairs._overflow(ov, torch.as_tensor(out[0]))
    assert overflow.any() if k == 1 else overflow.float().mean() < 0.2


@pytest.mark.parametrize("k", [3, 1])
def test_window_pair_any_matches_reference(packs, monkeypatch, k):
    jp, tp = packs
    _dense(monkeypatch, k, 8 if k == 3 else 1)
    monkeypatch.setenv("MTS_PAIR_KERNEL", "window")
    calls = _spy(monkeypatch, pairs, ["window_hit_any_plain", "pair_hit_any_plain"])
    o, d, t_max = _rays(N_RAYS, 3)
    occ = pairs.pair_any(tp, *_t(o, d, t_max)).numpy()
    assert calls == {"window_hit_any_plain": 1, "pair_hit_any_plain": 0}
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    occ_ref = np.asarray(jis._bvh_traverse_any(jp, jo, jd, jt))
    assert 0.05 < occ_ref.mean() < 0.95
    np.testing.assert_array_equal(occ, occ_ref)
    np.testing.assert_array_equal(occ, np.asarray(jprs.pair_any(jp, jo, jd, jt, interpret=True)))


def test_window_hits_equal_slot_hits(packs, monkeypatch):
    """K6 and K4 compute the same per-slot function: over the queue and
    back by index, the plain versions agree exactly."""
    _, tp = packs
    _dense(monkeypatch)
    o, d, t_max = _t(*_rays(N_RAYS, 8))
    c, tc = tp.meta["n_clusters"], tp.meta["cluster_tc"]
    cids, _, _ = pairs._cluster_lists(tp, o, d, t_max)
    cid_q, pair_q = pairs.pair_queue(cids)
    kk = cids.shape[1]
    rows = pairs._tri_rows(tp)
    win = pairs.window_hit_closest(o, d, t_max, cid_q, pair_q, kk, tp.cl_tri, tp.cl_pad2prim, c, tc,
                                   tp.cl_cnt, rows)
    slot = pairs.pair_hit_closest(o, d, t_max, cids, tp.cl_tri, tp.cl_pad2prim, c, tc, tp.cl_cnt,
                                  rows)
    for a, b in zip(win, slot):
        assert torch.equal(a, b)
    assert (slot[1] >= 0).any()
    assert torch.equal(pairs.window_hit_any(o, d, t_max, cid_q, pair_q, kk, tp.cl_tri, c, tc, tp.cl_cnt,
                                            rows),
                       pairs.pair_hit_any(o, d, t_max, cids, tp.cl_tri, c, tc, tp.cl_cnt, rows))


def test_stream_traversal_matches_reference(packs, monkeypatch):
    """K9/K10 on their own: the reference's MXU chunk kernels (exact
    prepass) and its BVH walks."""
    monkeypatch.setattr(jpb, "PREPASS", "exact")
    monkeypatch.setattr(jpb, "KERNEL", "mxu")
    jp, tp = packs
    sp = _streamed(tp)
    calls = _spy(monkeypatch, pb, ["cluster_stream_closest_plain", "cluster_stream_any_plain",
                                   "cluster_traverse_closest_plain"])
    o, d, t_max = _rays(N_RAYS, 13)
    for tm in (np.float32(np.inf), t_max):
        out = [x.numpy() for x in pb.cluster_closest(sp, *_t(o, d, tm))]
        check_closest(jpb.cluster_closest(jp, o, d, jnp.asarray(tm), sort=True, interpret=True), out)
        check_closest(jis._bvh_traverse(jp, o, d, jnp.asarray(tm)), out)
    occ = pb.cluster_any(sp, *_t(o, d, t_max)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jpb.cluster_any(jp, o, d, jnp.asarray(t_max), sort=True, interpret=True))
    )
    np.testing.assert_array_equal(occ, np.asarray(jis._bvh_traverse_any(jp, o, d, jnp.asarray(t_max))))
    assert calls == {"cluster_stream_closest_plain": 2, "cluster_stream_any_plain": 1,
                     "cluster_traverse_closest_plain": 0}


def test_dense_cull_with_stream_fallback(packs, monkeypatch):
    """The 1,366-1,890-cluster band: the dense cull and slot kernel (K3/K4)
    with the streamed fallback (K9/K10), forced by K = 1."""
    jp, tp = packs
    monkeypatch.setattr(pairs, "K", 1)
    calls = _spy(monkeypatch, pairs, ["dense_cull_plain", "two_level_cull_plain"])
    _spy(monkeypatch, pb, ["cluster_stream_closest_plain", "cluster_stream_any_plain",
                           "cluster_traverse_closest_plain", "cluster_traverse_any_plain"], calls)
    sp = _streamed(tp)
    o, d, t_max = _rays(N_RAYS, 5)
    out = [x.numpy() for x in pairs.pair_closest(sp, *_t(o, d), torch.tensor(np.inf))]
    check_closest(jis._bvh_traverse(jp, o, d, jnp.asarray(1e30)), out)
    occ = pairs.pair_any(sp, *_t(o, d, t_max)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(jis._bvh_traverse_any(jp, o, d, jnp.asarray(t_max))))
    assert calls["dense_cull_plain"] == 2 and calls["two_level_cull_plain"] == 0
    assert calls["cluster_stream_closest_plain"] == calls["cluster_stream_any_plain"] == 1
    assert calls["cluster_traverse_closest_plain"] == calls["cluster_traverse_any_plain"] == 0


def test_plain_chunks_sized_from_clusters(packs, monkeypatch):
    """The plain traversal's steps are sized from a byte budget over Cp
    (at the dense stand-in's 9,856 clusters, far fewer rays than at 1k),
    and the step size does not change what it computes."""
    step = lambda cp: pb._chunks(1 << 20, cp)[0][1]  # noqa: E731
    assert step(9856) * 12 * 9856 <= pb.PLAIN_CHUNK_BYTES
    assert step(9856) < step(776) < 1 << 20
    _, tp = packs
    o, d, t_max = _t(*_rays(N_RAYS, 2))
    args = (o, d, t_max, tp.cl_box, tp.cl_tri, tp.meta["cluster_tc"])
    ref = pb.cluster_stream_closest_plain(*args)
    occ = pb.cluster_stream_any_plain(*args)
    monkeypatch.setattr(pb, "PLAIN_CHUNK_BYTES", 12 * tp.cl_box.shape[1] * 37)  # 37 rays a step
    assert len(pb._chunks(N_RAYS, tp.cl_box.shape[1])) == 7
    for a, b in zip(pb.cluster_stream_closest_plain(*args), ref):
        assert torch.equal(a, b)
    assert torch.equal(pb.cluster_stream_any_plain(*args), occ)


def test_cpu_wrappers_launch_nothing(packs, monkeypatch):
    """On the CPU the new wrappers take the plain versions and launch
    nothing."""
    _, tp = packs
    _dense(monkeypatch)
    counters = (pairs.two_level_cull, pairs.window_hit_closest, pairs.window_hit_any,
                pb.cluster_stream_closest, pb.cluster_stream_any)
    before = [f.launches for f in counters]
    sp = _streamed(tp)
    o, d, t_max = _t(*_rays(64, 2))
    pairs.pair_closest(sp, o, d, t_max)
    pairs.pair_any(sp, o, d, t_max)
    pb.cluster_closest(sp, o, d, t_max)
    pb.cluster_any(sp, o, d, t_max)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError, match="no kernel"):
        pb.launch_stream("mts_two_level_cull", torch.device("meta"))


def _tonemapped_rmse(img, ref):
    return float(np.sqrt(np.mean((img / (1 + img) - ref / (1 + ref)) ** 2)))


@pytest.fixture(scope="module")
def mesh_xml(tmp_path_factory):
    """bunny.xml at 32x32 on a 4,992-triangle stand-in mesh."""
    path = str(tmp_path_factory.mktemp("mesh") / "standin.ply")
    write_ply(path, *bunny_standin(seed=3, n_phi=64, n_theta=40))
    return bunny_scene_xml(path, 32, 32)


@pytest.fixture(scope="module")
def mesh_ref(mesh_xml):
    return np.asarray(mitsuba_tpu.render(jload_string(mesh_xml), spp=4, seed=0))


@pytest.mark.parametrize("k,ks", [(3, 8), (1, 1)])
def test_dense_slice_render_matches_reference(mesh_xml, mesh_ref, monkeypatch, k, ks):
    """The slice as a whole: load_scene -> pack_scene -> render with both
    thresholds forced (K5/K6, and K9/K10 for the overflow rays; plain on
    the CPU) against the JAX package's render of the same scene.  At the
    natural K = 3, KS = 8 no ray of this small render overflows; K = KS = 1
    sends rays through the fallback."""
    monkeypatch.setattr(pairs, "DENSE_C", 0)
    monkeypatch.setattr(pairs, "K", k)
    monkeypatch.setattr(pairs, "KS", ks)
    calls = _spy(monkeypatch, pairs, ["two_level_cull_plain", "window_hit_closest_plain",
                                      "window_hit_any_plain", "dense_cull_plain"])
    _spy(monkeypatch, pb, ["cluster_stream_closest_plain", "cluster_stream_any_plain",
                           "cluster_traverse_closest_plain"], calls)
    scene = load_scene_string(mesh_xml)
    pack = _streamed(pack_scene(scene, "cpu"))
    img = mt.render(scene, spp=4, seed=0, device="cpu", pack=pack)
    assert img.shape == mesh_ref.shape == (32, 32, 3) and np.isfinite(img).all()
    assert 0.1 < img.mean() < 1.0 and (img < 0.99).mean() > 0.3  # the mesh is in view
    assert _tonemapped_rmse(img, mesh_ref) < 5e-3
    assert calls["dense_cull_plain"] == calls["cluster_traverse_closest_plain"] == 0
    assert calls["two_level_cull_plain"] and calls["window_hit_closest_plain"] and calls["window_hit_any_plain"]
    if k == 1:
        assert calls["cluster_stream_closest_plain"] and calls["cluster_stream_any_plain"], calls


def test_reference_pack_renders_identically_dense(mesh_xml, monkeypatch):
    """A converted reference pack (with its cl_sup) renders bit for bit
    like the port's own pack on the dense-mesh path."""
    monkeypatch.setattr(pairs, "DENSE_C", 0)
    jp = jpack_scene(jload_string(mesh_xml))
    converted = pack_from_numpy({k: np.asarray(v) for k, v in jp.arrays.items()}, jp.meta, "cpu")
    scene = load_scene_string(mesh_xml)
    own = pack_scene(scene, "cpu")
    assert torch.equal(converted.cl_sup, own.cl_sup)
    a = mt.render(scene, spp=1, seed=2, device="cpu", pack=_streamed(own))
    b = mt.render(scene, spp=1, seed=2, device="cpu", pack=_streamed(converted))
    np.testing.assert_array_equal(a, b)
