"""The yardstick's arithmetic on hand-made inputs."""

import math
import os

import numpy as np
import pytest

import types

from portbench.lib import cells, compare, facts, roofline, stats, trace


def test_union_length():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 10)], 2, 5) == 3
    assert stats.union_length([(4, 5), (0, 1), (0.5, 2)]) == 3
    assert stats.union_length([]) == 0


def test_gaps():
    assert stats.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert stats.gaps([(0, 3), (1, 5)], 0, 5) == []


def test_roofline_bytes_and_share():
    # 10M closest-hit rays over 1,000 triangles in one call
    b = roofline.query_bytes(10_000_000, 0, 1, 1000)
    assert b == 10_000_000 * (32 + 16) + 36_000
    # a shadow query writes one byte an answer
    assert roofline.query_bytes(0, 2, 1, 0) == 2 * 33
    share = roofline.share_percent(3.35e9, 1e-3, "NVIDIA H100 80GB HBM3")
    assert share == pytest.approx(100.0)
    with pytest.raises(KeyError):
        roofline.share_percent(1.0, 1e-3, "some other card")
    assert roofline.share_percent(1.0, 0.0, "NVIDIA H100 80GB HBM3") is None


def test_traced_readers():
    card = "NVIDIA H100 80GB HBM3"
    queries = {"closest_calls": 1, "closest_rays": 1000, "any_calls": 1, "any_rays": 1000}
    dev = {"busy_s": 0.25, "window_s": 1.0, "isect_device_s": 1e-6}
    facts = {"device": dev, "queries": queries, "triangles": 100, "card": card}
    want = 100.0 * (2000 * 32 + 1000 * 16 + 1000 + 2 * 100 * 36) / 3.35e12 / 1e-6
    assert roofline.traced_share(facts) == pytest.approx(want)
    assert roofline.traced_share(dict(facts, queries={})) is None
    idle = cells.load_module(os.path.join(cells.HARNESS_DIR, "metrics", "idle_share.render.py"),
                             "idle_share_render")
    assert idle.read(dict(facts, image_s=0.5)) == pytest.approx(50.0)
    assert idle.read(facts) is None and idle.read({"image_s": 0.5}) is None


def test_render_numbers():
    rng = np.random.default_rng(0)
    k, n_p, n_r = 20000, 8, 256
    mu = rng.uniform(0.1, 1.0, (k, 3))
    sigma2 = mu * 0.5
    r = mu + rng.normal(size=(k, 3)) * np.sqrt(sigma2 / n_r)
    p = mu + rng.normal(size=(k, 3)) * np.sqrt(sigma2 / n_p)
    good = compare.render_numbers(p, r, sigma2, n_p, n_r)
    assert good["bias_z"] < 4 and 0.9 < good["noise_ratio"] < 1.1
    half = mu + rng.normal(size=(k, 3)) * np.sqrt(sigma2 / (n_p // 2))
    assert compare.render_numbers(half, r, sigma2, n_p, n_r)["noise_ratio"] > 1.6
    biased = compare.render_numbers(p * 1.05, r, sigma2, n_p, n_r)
    assert biased["bias_z"] > 10
    p[0, 0] = math.nan
    assert compare.render_numbers(p, r, sigma2, n_p, n_r)["bias_z"] == math.inf


def test_judge():
    ok, lines = compare.judge({"a": 1.0, "b": 0.0}, {"a": 2.0, "b": 0})
    assert ok and lines == [("a", 1.0, 2.0), ("b", 0.0, 0)]
    assert not compare.judge({"a": math.inf}, {"a": 2.0})[0]
    assert not compare.judge({"a": 2.5}, {"a": 2.0})[0]


class _Event:
    """One of kineto's raw events, as trace.reduce reads it."""

    def __init__(self, name, start, dur, cpu, corr=0, linked=0, annotation=False):
        self._v = (name, start, dur, cpu, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CPU" if self._v[3] else "DeviceType.CUDA"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_reduce_hand_made_trace():
    w = trace.WINDOW
    q = trace.QUERY_SPANS[0]
    events = [
        _Event(w, 0, 1000, True, corr=1, annotation=True),
        _Event(q, 100, 300, True, corr=2, annotation=True),
        _Event("cudaLaunchKernel", 150, 10, True, corr=90),
        # the device mirror of a range is not work
        _Event(q, 160, 300, False, annotation=True),
        _Event("shade", 50, 100, False, linked=1),  # launched in the window
        _Event("hit", 160, 200, False, linked=2),  # launched in the query
        _Event("hit", 300, 100, False, linked=2),  # overlaps the one before
        _Event("ncclKernel_AllReduce", 700, 100, False, linked=1),
    ]
    got = trace.reduce(types.SimpleNamespace(events=lambda: events))
    assert got["window_s"] == pytest.approx(1000e-9)
    assert got["busy_s"] == pytest.approx(440e-9)  # 50-150, 160-400, 700-800
    assert got["device_ops"] == 4
    assert got["device_s"] == pytest.approx(500e-9)
    assert got["isect_device_s"] == pytest.approx(300e-9)
    assert got["nccl_device_s"] == pytest.approx(100e-9)
    assert got["device_ops_top"][0] == ["hit", pytest.approx(300e-9)]
    assert sum(v for _, v in got["idle_gaps_top"]) == pytest.approx(560e-9)
    assert trace.reduce(None) is None


def test_render_facts_skip_the_profiled_image():
    spans = types.SimpleNamespace(records={  # the last image is the profiled one
        "render": [(0.0, 2.0), (2.0, 4.5), (4.5, 9.5)],
        "pass": [(0.1, 1.0), (1.0, 1.9), (2.2, 4.0), (4.6, 9.0)],
    })
    ctx = types.SimpleNamespace(trace=True, spans=spans)
    got = facts.render_facts(ctx, [10, 20, 30], 100, {"queries": {"closest_calls": 2}}, 36)
    assert got["passes_traced"] == 1
    assert got["rays_traced"] == 30 and got["render_s"] == pytest.approx(4.5)
    assert got["image_s"] == pytest.approx(2.25)
    assert got["image_overhead_s"] == pytest.approx(((2.0 - 1.8) + (2.5 - 1.8)) / 2)
    one = facts.render_facts(types.SimpleNamespace(trace=True, spans=types.SimpleNamespace(
        records={"render": [(0.0, 5.0)], "pass": [(0.1, 4.0)]})), [10], 100, {}, 36)
    assert "rays_traced" not in one and "image_overhead_s" not in one
    assert facts.render_facts(types.SimpleNamespace(trace=False), [], 1, {}, 1) == {}
