"""The traced part of a ``--trace 1`` window, and its reduction.

The first calls of the window (at least a number of calls and of seconds)
run under ``torch.profiler`` (host and
device activity), each inside a ``record_function`` span of the benchmark's
own (``search.<class>``), all inside one span ``bench.window``. The
reduction reads, within that span:

* ``busy_s``: the union of the intervals in which an operation ran on the
  device (kernels, copies, fills), so overlapping streams count once;
* ``window_s``: the span's length;
* each device operation's intervals, by name, for the per-layer readers;
* ``breakdown``: the device operations that took most time, and the idle
  gaps between device work summed by what the host was doing as each gap
  began (the innermost host event open at that instant).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

#: entries in each list of the breakdown
TOP = 10
#: characters kept of an operation's name in the breakdown
NAME_CHARS = 160


class Recorder:
    """Profiles the first calls it is handed: at least ``calls`` of them and
    at least ``seconds`` from the start of the first."""

    def __init__(self, calls: int, seconds: float, window_name: str = "bench.window"):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.calls, self.seconds, self.window_name = calls, seconds, window_name
        self.n, self.t0 = 0, None
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.outer = None
        self.done = None

    @contextlib.contextmanager
    def call(self, name: str):
        if self.prof is None:
            yield
            return
        from torch.autograd.profiler import record_function

        if self.outer is None:
            self.outer = record_function(self.window_name)
            self.outer.__enter__()
            self.t0 = time.perf_counter()
        with record_function(name):
            yield
        self.n += 1
        if self.n >= self.calls and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.outer is not None:
            self.outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done, self.prof = self.prof, None

    def finish(self) -> dict:
        self.stop()
        return reduce(self.done.events(), self.window_name)


def union_length(intervals: list) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def reduce(events, window_name: str) -> dict:
    """Busy time, window, device operations and breakdown of one trace
    (times in the trace are in microseconds; results in seconds)."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in host if e.name == window_name]
    if not win:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ops = defaultdict(list)
    for e in events:
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                ops[e.name].append((a, b))
    spans = sorted(iv for ivs in ops.values() for iv in ivs)
    busy = union_length(spans)
    # idle gaps between device work inside the window
    gaps, end = [], w0
    for a, b in spans:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    # the innermost host event open as each gap begins (host events nest)
    inner = sorted((e.time_range.start, e.time_range.end, e.name) for e in host if e.name != window_name)
    by_host = defaultdict(float)
    stack, i = [], 0
    for g0, g1 in gaps:
        while i < len(inner) and inner[i][0] <= g0:
            while stack and stack[-1][1] <= inner[i][0]:
                stack.pop()
            stack.append(inner[i])
            i += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        by_host[stack[-1][2] if stack else "outside any span"] += (g1 - g0) / 1e6
    dev_ops = sorted(((n, sum(b - a for a, b in ivs) / 1e6) for n, ivs in ops.items()),
                     key=lambda t: -t[1])
    return {
        "busy_s": busy / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "ops": {n: [(a / 1e6, b / 1e6) for a, b in ivs] for n, ivs in ops.items()},
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in dev_ops[:TOP]],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in sorted(by_host.items(), key=lambda t: -t[1])[:TOP]],
        },
    }
