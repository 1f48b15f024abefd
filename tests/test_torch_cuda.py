"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Needs a GPU and nvcc; marked `cuda` and skipped elsewhere.  This
file imports no JAX, so on a machine without JAX it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: the kernels are built without FMA contraction and evaluate
the plain versions' expressions in the same order, so cluster lists,
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
from torch_meshes import bunny_scene_xml, bunny_standin, write_ply

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


@pytest.mark.parametrize("n_tris", [1, 36, 300, 512])
def test_kernels_equal_plain(dev, n_tris):
    o, d, t_max, tri_s = _random_scene(dev, n_tris, 70_001, n_tris)
    for tm in (t_max, torch.full_like(t_max, 1e30)):
        t1, p1 = pk.closest_hit_v2(o, d, tm, tri_s)
        t2, p2 = pk.closest_hit_plain(o, d, tm, tri_s)
        assert torch.equal(p1, p2)
        assert torch.equal(t1, t2)
        assert torch.equal(pk.any_hit_v2(o, d, tm, tri_s), pk.any_hit_plain(o, d, tm, tri_s))
    torch.cuda.synchronize()


def test_launch_counters(dev):
    o, d, t_max, tri_s = _random_scene(dev, 8, 100, 0)
    c0, a0 = pk.closest_hit_v2.launches, pk.any_hit_v2.launches
    pk.closest_hit_v2(o, d, t_max, tri_s)
    pk.any_hit_v2(o, d, t_max, tri_s)
    pk.any_hit_v2(o, d, t_max, tri_s)
    pk.closest_hit_plain(o, d, t_max, tri_s)
    assert (pk.closest_hit_v2.launches - c0, pk.any_hit_v2.launches - a0) == (1, 2)


def test_too_many_triangles_raise(dev):
    o, d, t_max, _ = _random_scene(dev, 8, 100, 0)
    with pytest.raises(ValueError, match="at most"):
        pk.closest_hit_v2(o, d, t_max, torch.zeros(9, 520, device=dev))


def test_empty_ray_batch(dev):
    o, d, t_max, tri_s = _random_scene(dev, 8, 0, 0)
    t, p = pk.closest_hit_v2(o, d, t_max, tri_s)
    assert t.shape == (0,) and p.shape == (0,)


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
    for tm in (t_big, t_any):
        cull = pairs.dense_cull(o, d, tm, pack.cl_mbox, c, k)
        _equal(cull, pairs.dense_cull_plain(o, d, tm, pack.cl_mbox, c, k))
        args = (o, d, tm, cull[0], pack.cl_tri, pack.cl_pad2prim, c, tc)
        _equal(pairs.pair_hit_closest(*args), pairs.pair_hit_closest_plain(*args))
        args = (o, d, tm, cull[0], pack.cl_tri, c, tc)
        assert torch.equal(pairs.pair_hit_any(*args), pairs.pair_hit_any_plain(*args))
    sub = slice(0, None, 8)  # the plain traversal is slow; every 8th ray
    for tm in (t_big, t_any):
        args = (o[sub].contiguous(), d[sub].contiguous(), tm[sub].contiguous(),
                pack.cl_box, pack.cl_tri, tc)
        _equal(pb.cluster_traverse_closest(*args), pb.cluster_traverse_closest_plain(*args))
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


def test_cluster_limits_raise(mesh):
    pack, o, d, t_any = mesh
    max_c, max_k = pb.kernel_limits()
    with pytest.raises(ValueError, match="at most"):
        pairs.dense_cull(o, d, t_any, torch.zeros(max_c + 8, 6, device=o.device), max_c + 1, 3)
    with pytest.raises(ValueError, match="at most"):
        pairs.dense_cull(o, d, t_any, pack.cl_mbox, pack.meta["n_clusters"], max_k + 1)
