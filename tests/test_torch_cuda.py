"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Needs a GPU and nvcc; marked `cuda` and skipped elsewhere.  This
file imports no JAX, so on a machine without JAX it runs without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerance: the kernels are built without FMA contraction and evaluate
the plain versions' expressions in the same order, so prim, occlusion
and t must be equal.
"""

import numpy as np
import pytest
import torch

from mitsuba_tpu_torch.accel import pallas_kernels as pk

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
