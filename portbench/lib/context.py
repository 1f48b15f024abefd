"""What a driver gets from the harness, and what it hands back."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from portbench.lib.spans import Spans
from portbench.lib.trace import DeviceTrace


@dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    check: dict  # limits, by name
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the card; the tests pass "cpu"
    t_start: float  # perf_counter() at the process's start
    spans: Spans = None
    dtrace: DeviceTrace = None

    def __post_init__(self):
        self.spans = Spans(self.trace)
        self.dtrace = DeviceTrace(self.trace, self.device)

    @property
    def dev(self):
        return torch.device(self.device)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: dict  # end-to-end metric -> value
    numbers: dict  # compared number -> value
    memory_peak_bytes: int
    facts: dict = field(default_factory=dict)  # what the per-layer readers read
    device_count: int = 1


def sync(device):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device):
    device = torch.device(device)
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
