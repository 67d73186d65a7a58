"""torch.profiler over a short steady segment of a traced run, read back
from its Chrome trace: the device's operations (kernels, copies, fills) and
the host's events on the thread that ran the segment.

`record(fn)` runs fn() inside the profiler and one `portbench.segment`
span, synchronising before it ends; the segment's span is the traced
window. Kernels are matched by a part of their name (kernel A's are
`nt_apply*`, kernel B's `nt_fused_cg*`, kernel C's `nt_sweeps*`).
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

SEGMENT = "portbench.segment"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 96  # a templated kernel's name, cut for the breakdown


@dataclass
class Trace:
    device: list  # (cat, name, start_us, end_us) inside the window
    host: list  # (name, start_us, end_us) on the segment's thread, by start
    start_us: float
    end_us: float

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> list:
        spans = sorted((s, e) for _, _, s, e in self.device)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_count(self, part: str = "") -> int:
        return sum(1 for c, n, _, _ in self.device if c == "kernel" and part in n)

    def kernel_seconds(self, part: str) -> float:
        return sum(e - s for c, n, s, e in self.device if c == "kernel" and part in n) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[name, device seconds] of the operations that took most time."""
        by: dict = {}
        for _, name, s, e in self.device:
            key = name[:NAME_CHARS]
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """[host activity, idle device seconds]: every gap in the device's
        work, labelled by the innermost host event open when it began (what
        the host was doing), summed by label, longest first."""
        gaps, edge = [], self.start_us
        for s, e in self.busy_intervals() + [[self.end_us, self.end_us]]:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        # one sweep in time order; the host's events on one thread nest, so
        # the stack's top is the innermost event open at t
        by: dict = {}
        stack: list = []
        j = 0
        for t, end in gaps:
            while j < len(self.host) and self.host[j][1] <= t:
                while stack and stack[-1][2] <= self.host[j][1]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            label = stack[-1][0][:NAME_CHARS] if stack else SEGMENT
            by[label] = by.get(label, 0.0) + (end - t) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def record(fn) -> Trace:
    """Profile fn() (which launches device work) as one traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SEGMENT):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    return parse(events.get("traceEvents", events) if isinstance(events, dict) else events)


def parse(events: list) -> Trace:
    """A Trace from Chrome-trace events (complete events, "ph": "X")."""
    seg = next(
        e for e in events
        if e.get("ph") == "X" and e.get("name") == SEGMENT and e.get("cat") == "user_annotation"
    )
    t0, t1 = float(seg["ts"]), float(seg["ts"]) + float(seg["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if end > t0 and s < t1:
                device.append((cat, e.get("name", ""), max(s, t0), min(end, t1)))
        elif cat in HOST_CATS and e.get("tid") == seg.get("tid") and e.get("pid") == seg.get(
                "pid") and end > t0 and s < t1 and e is not seg:
            host.append((e.get("name", ""), s, end))
    host.sort(key=lambda h: (h[1], -h[2]))  # a parent before the child it opens with
    return Trace(device, host, t0, t1)
