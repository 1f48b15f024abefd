"""Logger + statistics registry (port of mitsuba_tpu/core/logging.py).

The reference's Logger/Appender/Formatter stack (reference:
include/mitsuba/core/logger.h:71-208, appender.h:37-94) and its
StatsCounter registry (statistics.h:76-180) in host Python: the render
loop publishes its counters here between passes.  The level comes from
MTS_LOG_LEVEL (0 trace .. 4 error; 2, info, by default).

Usage:
    from mitsuba_tpu_torch.core.logging import logger, counter
    logger.info("rendering %s", path)
    counter("Rays traced").add(n)
    print(stats_summary())
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field

ETrace, EDebug, EInfo, EWarn, EError = 0, 1, 2, 3, 4
_LEVEL_NAMES = {0: "TRACE", 1: "DEBUG", 2: "INFO", 3: "WARN", 4: "ERROR"}


class Appender:
    """Log sink (= reference Appender, appender.h:37)."""

    def append(self, level: int, text: str):
        raise NotImplementedError


class StreamAppender(Appender):
    """Write to a stream / file (= StreamAppender, appender.h:52)."""

    def __init__(self, stream=None, path=None):
        self._own = path is not None
        # without an explicit target, resolve sys.stderr at APPEND time
        # (it may be redirected/reopened, e.g. by test harnesses)
        self.stream = open(path, "a") if path else stream

    def append(self, level, text):
        stream = self.stream or sys.stderr
        try:
            stream.write(text + "\n")
            stream.flush()
        except ValueError:
            pass  # closed redirected stream — drop the line


class Logger:
    """Level-filtered logger with pluggable appenders
    (= reference Logger, logger.h:71)."""

    def __init__(self, level=EInfo):
        self.level = int(
            os.environ.get("MTS_LOG_LEVEL", level)
        )
        self.appenders: list[Appender] = [StreamAppender()]
        self._t0 = time.time()

    def add_appender(self, a: Appender):
        self.appenders.append(a)

    def clear_appenders(self):
        self.appenders = []

    def log(self, level, fmt, *args):
        if level < self.level:
            return
        msg = (fmt % args) if args else str(fmt)
        text = (
            f"{time.time() - self._t0:8.2f}s "
            f"{_LEVEL_NAMES.get(level, '?'):5s} {msg}"
        )
        for a in self.appenders:
            a.append(level, text)

    def trace(self, fmt, *a):
        self.log(ETrace, fmt, *a)

    def debug(self, fmt, *a):
        self.log(EDebug, fmt, *a)

    def info(self, fmt, *a):
        self.log(EInfo, fmt, *a)

    def warn(self, fmt, *a):
        self.log(EWarn, fmt, *a)

    def error(self, fmt, *a):
        self.log(EError, fmt, *a)


logger = Logger()


@dataclass
class StatsCounter:
    """Named counter (= reference StatsCounter, statistics.h:76).
    `base` turns the summary into a percentage/average when set."""

    name: str
    value: float = 0.0
    base: float = 0.0

    def add(self, n=1.0):
        self.value += float(n)
        return self

    def add_base(self, n=1.0):
        self.base += float(n)
        return self

    def reset(self):
        self.value = 0.0
        self.base = 0.0


_registry: dict[str, StatsCounter] = {}


def counter(name: str) -> StatsCounter:
    if name not in _registry:
        _registry[name] = StatsCounter(name)
    return _registry[name]


def all_counters() -> dict[str, StatsCounter]:
    return dict(_registry)


def reset_statistics():
    for c in _registry.values():
        c.reset()


def _fmt_count(v: float) -> str:
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= div:
            return f"{v / div:.3g}{unit}"
    return f"{v:.4g}"


def stats_summary() -> str:
    """Render-statistics block (= Statistics::getStats,
    statistics.cpp printStats)."""
    lines = ["  * Statistics:"]
    for name in sorted(_registry):
        c = _registry[name]
        if c.base > 0:
            lines.append(
                f"    - {name}: {_fmt_count(c.value)} / "
                f"{_fmt_count(c.base)} ({100.0 * c.value / c.base:.2f}%)"
            )
        else:
            lines.append(f"    - {name}: {_fmt_count(c.value)}")
    return "\n".join(lines) if len(lines) > 1 else "  * Statistics: (none)"
