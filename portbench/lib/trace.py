"""The device trace of a traced window, reduced to numbers.

The profiler records the device's activity (kernels, copies, sets, and
the runtime calls that launched them) and, on the host, the benchmark's
own ranges alone: no event for each PyTorch operation, which would slow
the host that paces the work and so inflate the idle share it is meant
to read.  The raw events are read once the window has closed (kineto's
own event list, not the profiler's slower tree of function events).  A
device operation is linked to the innermost benchmark range open when it
was launched.  From them:

* busy_s: the union of device-activity intervals (kernels, copies, sets)
  inside the window, window_s its length;
* the device time of the operations launched inside the benchmark's
  query spans, so the intersection layer's share does not depend on
  kernel names;
* the device time of NCCL's kernels;
* the operations that took most device time, and the idle gaps by what
  the host was doing (the runtime call it was in, inside which benchmark
  span), for the result's `breakdown`.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

from portbench.lib import stats
from portbench.lib.spans import PREFIX

WINDOW = PREFIX + "traced"
QUERY_SPANS = (PREFIX + "intersect", PREFIX + "occluded")
SHORT_GAP_NS = 20_000  # gaps below this are counted together


class DeviceTrace:
    """Profile one stretch of the run: `with trace.window(): ...`; the
    raw results are kept in `results` for `reduce`."""

    def __init__(self, enabled, device):
        self.enabled = enabled and torch.device(device).type == "cuda"
        self.device = torch.device(device)
        self.results = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        from torch.autograd import (
            ProfilerActivity,
            ProfilerConfig,
            ProfilerState,
            _disable_profiler,
            _enable_profiler,
            _prepare_profiler,
        )

        torch.cuda.synchronize(self.device)
        acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        _prepare_profiler(config, acts)
        # host events of record_function ranges only, not of every operation
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        try:
            with torch.profiler.record_function(WINDOW):
                yield
                torch.cuda.synchronize(self.device)
        finally:
            self.results = _disable_profiler()


def _is_cpu(ev):
    return "CPU" in str(ev.device_type())


def reduce(results):
    """Facts of a traced window from kineto's results (None: not traced)."""
    if results is None:
        return None
    host_start = {}  # correlation id -> start (ns) of a host event
    annots = defaultdict(list)  # benchmark span -> [(start, end)]
    ops = []  # (start, end, name) of the runtime calls
    dev = []  # (start, end, name, linked correlation id)
    for ev in results.events():
        s, name = ev.start_ns(), ev.name()
        if _is_cpu(ev):
            if not name.startswith("cu"):  # runtime calls number their own ids
                host_start[ev.correlation_id()] = s  # a range a launch links to
            if name.startswith(PREFIX):
                annots[name].append((s, s + ev.duration_ns()))
            else:
                ops.append((s, s + ev.duration_ns(), name))
        elif not ev.is_user_annotation():  # a range's mirror on the device, not work
            dev.append((s, s + ev.duration_ns(), name, ev.linked_correlation_id()))
    if not annots[WINDOW]:
        raise RuntimeError("the traced window's own span is missing from the trace")
    w0, w1 = annots[WINDOW][0]
    intervals = [(s, e) for s, e, _, _ in dev]
    busy = stats.union_length(intervals, w0, w1)

    spans = sorted(iv for n in QUERY_SPANS for iv in annots[n])
    starts = [s for s, _ in spans]

    def in_query(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    by_name = defaultdict(float)
    isect_ns = nccl_ns = 0
    for s, e, name, linked in dev:
        d = e - s
        by_name[name] += d / 1e9
        t_host = host_start.get(linked, s)
        if in_query(t_host):
            isect_ns += d
        if "nccl" in name.lower():
            nccl_ns += d
    return {
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "device_ops": len(dev),
        "device_s": sum(e - s for s, e in intervals) / 1e9,
        "isect_device_s": isect_ns / 1e9,
        "nccl_device_s": nccl_ns / 1e9,
        "device_ops_top": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
        "idle_gaps_top": _label_gaps(stats.gaps(intervals, w0, w1), ops, annots),
    }


def _label_gaps(gap_list, ops, annots):
    """[[what the host was doing, idle seconds]] of the 10 largest sums."""
    ops.sort()
    op_starts = [s for s, _, _ in ops]
    spans = sorted((s, e, n[len(PREFIX):]) for n, ivs in annots.items() if n != WINDOW
                   for s, e in ivs)
    span_starts = [s for s, _, _ in spans]

    def innermost(seq, starts, t, reach=64):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            if seq[j][0] <= t <= seq[j][1]:
                return seq[j][2]
        return None

    sums = defaultdict(float)
    for s, e in gap_list:
        if e - s < SHORT_GAP_NS:
            sums["short gaps (< 20 us)"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        op = innermost(ops, op_starts, mid) or "host between operations"
        span = innermost(spans, span_starts, mid)
        sums[f"{span}/{op}" if span else op] += (e - s) / 1e9
    return sorted(([k, v] for k, v in sums.items()), key=lambda x: -x[1])[:10]
