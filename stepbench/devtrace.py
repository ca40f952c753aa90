"""The device's side of a traced run, read from ``torch.profiler``.

``summarize`` turns the profiler's events into what the metric readers and
the result's ``breakdown`` need: the seconds in which some operation ran on
the device (the union of the kernels', copies' and fills' intervals), each
device operation's durations by name, the device operations that took most
time, and the device's idle gaps summed by what the host was doing when
each began: the innermost host operation running at the gap's middle, on
any thread.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

TOP = 10
MIN_GAP_US = 20.0
NO_HOST_OP = "no host op (Python)"


@dataclass
class DeviceTrace:
    busy_s: float
    window_s: float
    durations: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_durations(self, key: str) -> List[float]:
        """Durations (s) of every device operation whose name contains
        ``key``."""
        return [d for name, ds in self.durations.items() if key in name for d in ds]


def activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _union(spans):
    """Merged, sorted intervals of ``spans`` and their total length."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def _host_label(starts, cpu, t):
    """The innermost host operation running at ``t`` (µs), if any."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 5000), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return NO_HOST_OP


def summarize(events, window_s: float) -> DeviceTrace:
    """``events``: ``profiler.events()`` of the traced window; ``window_s``:
    its length by the host's clock."""
    device, cpu = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
    merged, busy_us = _union((s, e) for s, e, _ in device)
    durations: Dict[str, List[float]] = {}
    for s, e, name in device:
        durations.setdefault(name, []).append((e - s) / 1e6)
    totals = sorted(((n, sum(ds)) for n, ds in durations.items()),
                    key=lambda x: -x[1])[:TOP]
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 - e0 >= MIN_GAP_US:
            label = _host_label(starts, cpu, (e0 + s1) / 2)
            gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:TOP]
    return DeviceTrace(busy_us / 1e6, window_s, durations, totals, idle)
