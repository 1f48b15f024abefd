"""Spans that the benchmark wraps around the calls into the program's
layers, from outside the program.

Off (--trace 0), nothing is wrapped and `span` records nothing.  On, each
span is a host-clock interval kept in memory and a `record_function`
range named "portbench::<name>" in the profiler's trace.  The ray queries
(`intersect`, `occluded`) are wrapped wherever a module of the program
holds them, and count their calls and rays.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from collections import defaultdict

import torch

PREFIX = "portbench::"
PROGRAM = "mitsuba_tpu_torch"


class Spans:
    def __init__(self, enabled):
        self.enabled = enabled
        self.records = defaultdict(list)  # name -> [(t0, t1)]
        self.counts = defaultdict(int)  # name -> count
        self._undo = []

    @contextlib.contextmanager
    def span(self, name):
        """A span `name`: the host's interval, no synchronisation added."""
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            yield
            self.records[name].append((t0, time.perf_counter()))

    def total(self, name):
        return sum(e - s for s, e in self.records[name])

    def patch(self, module, attr, make_wrapper):
        """Replace module.attr by make_wrapper(original) until `restore`."""
        fn = getattr(module, attr)
        setattr(module, attr, make_wrapper(fn))
        self._undo.append((module, attr, fn))

    def wrap_queries(self):
        """Wrap the program's `intersect` and `occluded` wherever a loaded
        module of it holds them: each call is a span that counts its rays."""
        if not self.enabled:
            return
        from mitsuba_tpu_torch.accel import intersect as isect

        for attr, kind in (("intersect", "closest"), ("occluded", "any")):
            orig = getattr(isect, attr)

            def make(fn, attr=attr, kind=kind):
                @functools.wraps(fn)
                def wrapped(pack, o, d, *a, **kw):
                    self.counts[kind + "_calls"] += 1
                    self.counts[kind + "_rays"] += int(o.shape[0])
                    with torch.profiler.record_function(PREFIX + attr):
                        return fn(pack, o, d, *a, **kw)
                return wrapped

            wrapped = make(orig)
            for name, mod in list(sys.modules.items()):
                if (name.split(".")[0] == PROGRAM and mod is not None
                        and getattr(mod, attr, None) is orig):
                    setattr(mod, attr, wrapped)
                    self._undo.append((mod, attr, orig))

    def wrap_passes(self, module, attr):
        """Wrap the pass builder module.attr so that every pass it returns
        is a span "pass".  No synchronisation is added: the pass's own loop
        waits for the device every few bounces and before it leaves, so a
        pass's span closes with at most its last few launches queued."""
        if not self.enabled:
            return

        def make(build):
            @functools.wraps(build)
            def wrapped_build(*a, **kw):
                render_pass = build(*a, **kw)

                @functools.wraps(render_pass)
                def wrapped_pass(*pa, **pkw):
                    with self.span("pass"):
                        return render_pass(*pa, **pkw)
                return wrapped_pass
            return wrapped_build

        self.patch(module, attr, make)

    def restore(self):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()
