"""The traced stretch of a window: torch.profiler over CPU and CUDA activity,
reduced to the device's busy time (the union of its operations' intervals),
per-kernel times by name, and the idle gaps between device operations labelled
by the host operation under way.

The reduction reads the profiler's Chrome trace (`traceEvents`): events of
category kernel, gpu_memcpy and gpu_memset are device operations; cpu_op and
user_annotation events are host operations.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


class Profile:
    def __init__(self, device: str):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def summarize(self) -> "TraceStats":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return TraceStats.from_events(events)


def merge(intervals: list) -> list:
    """Sorted, non-overlapping union of [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceStats:
    """Times in seconds."""

    def __init__(self, device_ops: list, host_ops: list):
        # device_ops: [(name, start_us, dur_us)]; host_ops: [(start_us, dur_us, name)]
        self.kernels = defaultdict(lambda: [0, 0.0])  # name -> [count, total s]
        for name, _, dur in device_ops:
            k = self.kernels[name]
            k[0] += 1
            k[1] += dur / 1e6
        self.busy = merge([(s, s + d) for _, s, d in device_ops])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.host = sorted(host_ops)
        self._starts = [h[0] for h in self.host]

    @classmethod
    def from_events(cls, events: list) -> "TraceStats":
        dev, host = [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((ev.get("name", "?"), float(ev["ts"]), float(ev.get("dur", 0.0))))
            elif cat in HOST_CATS:
                host.append((float(ev["ts"]), float(ev.get("dur", 0.0)), ev.get("name", "?")))
        return cls(dev, host)

    def kernel_time(self, pattern: str) -> tuple:
        """(launches, total s) of the device operations whose name matches `pattern`."""
        rx = re.compile(pattern)
        n, t = 0, 0.0
        for name, (c, s) in self.kernels.items():
            if rx.search(name):
                n, t = n + c, t + s
        return n, t

    def host_op_at(self, t: float) -> str:
        """The innermost host operation running at time t (trace microseconds)."""
        i = bisect.bisect_right(self._starts, t)
        best = None
        for s, d, name in self.host[max(0, i - 400):i]:
            if s <= t < s + d and (best is None or d < best[0]):
                best = (d, name)
        return best[1] if best else "no host op"

    def breakdown(self) -> dict:
        ops = sorted(((n[:160], s) for n, (_, s) in self.kernels.items()), key=lambda x: -x[1])
        gaps = defaultdict(float)
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            gaps[self.host_op_at(0.5 * (e0 + s1))[:160]] += (s1 - e0) / 1e6
        idle = sorted(gaps.items(), key=lambda x: -x[1])
        return {"device_ops": [[n, s] for n, s in ops[:TOP]],
                "idle_gaps": [[n, s] for n, s in idle[:TOP]]}
