"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, read back from its Chrome-trace export.

Device activity is every kernel, copy and memset on the card. The window
is the benchmark's own ``gpubench.window`` annotation; the host's spans
are the benchmark's ``gpubench.<shape>/<stage>`` annotations around each
query's plan, execution and emit, and the profiler's CPU operations.
"""

import bisect
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def annotate(name):
    import torch

    return torch.profiler.record_function("gpubench." + name)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Trace:
    """Device events (name, start_us, end_us, cat) clipped to the window,
    the benchmark's spans and the host operations, all in trace time."""

    def __init__(self, events):
        win = [e for e in events if e.get("name") == "gpubench.window" and e.get("ph") == "X"]
        if len(win) != 1:
            raise RuntimeError("the trace holds no single gpubench.window span")
        self.start = float(win[0]["ts"])
        self.end = self.start + float(win[0]["dur"])
        self.device, self.spans, self.host = [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            t = s + float(e["dur"])
            cat = e.get("cat", "")
            if t <= self.start or s >= self.end:
                continue
            item = (e.get("name", ""), max(s, self.start), min(t, self.end), cat)
            if cat in DEVICE_CATS:
                self.device.append(item)
            elif cat == "user_annotation" and item[0].startswith("gpubench.") and item[0] != "gpubench.window":
                self.spans.append(item)
            elif cat in HOST_CATS:
                self.host.append(item)
        self.busy_intervals = _union([(s, t) for _, s, t, _ in self.device])

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self):
        return sum(t - s for s, t in self.busy_intervals) * 1e-6

    def kernel_seconds(self, names, listed):
        """Summed duration of the kernels whose name contains one of
        ``names`` as a word (``listed=True``) or none of them."""
        pattern = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b") if names else None
        total = 0.0
        for name, s, t, cat in self.device:
            if cat != "kernel":
                continue
            hit = bool(pattern and pattern.search(name))
            if hit == listed:
                total += t - s
        return total * 1e-6

    def device_ops(self, top=10):
        by = {}
        for name, s, t, _ in self.device:
            by[name] = by.get(name, 0.0) + (t - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top=10):
        """Idle time on the device between its busy intervals, summed by
        what the host was doing at each gap's middle: the benchmark's span
        and the innermost host operation."""
        edges = [self.start] + [x for iv in self.busy_intervals for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        spans, host = _Nest(self.spans), _Nest(self.host)
        by = {}
        for s, t in gaps:
            mid = (s + t) / 2
            span = spans.innermost(mid)
            op = host.innermost(mid)
            name = (span[len("gpubench."):] if span else "between queries") + (f": {op}" if op else "")
            by[name] = by.get(name, 0.0) + (t - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]


class _Nest:
    """Nested host intervals: the innermost one holding a time is the
    latest-starting one that has not ended by then."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda x: x[1])
        self.starts = [x[1] for x in self.items]

    def innermost(self, at, look_back=4096):
        i = bisect.bisect_right(self.starts, at)
        for j in range(i - 1, max(-1, i - 1 - look_back), -1):
            name, _, t, _ = self.items[j]
            if t >= at:
                return name
        return None


def read(prof):
    """Export ``prof``'s trace to a temporary file, read it and delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
