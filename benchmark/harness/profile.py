"""Device times from one torch.profiler window, read from its Chrome trace.

Device activity is every kernel, copy and fill the trace records.  A device
event belongs to a span when the host call that launched it (the CUDA API
event of the same correlation id) lies inside one of the span's
`record_function` ranges; where the launch is not in the trace, the event's
own start decides.  The window is the range of the harness's own
`record_function(WINDOW)`: its length is `window_s`, the union of device
intervals inside it is `busy_s`, and each gap between them is charged to
the innermost span open at its middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, int]] = []  # start, end (us), name, corr
        self.launch: Dict[int, float] = {}
        self.ranges: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", "?"), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = ts
            elif cat == "user_annotation":
                self.ranges[e["name"]].append((ts, ts + dur))
        self.device.sort()
        if not self.ranges.get(WINDOW):
            raise ValueError("the trace holds no window range")
        self.w0, self.w1 = self.ranges[WINDOW][0]
        self.launched_in_trace = sum(1 for d in self.device if d[3] in self.launch)

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def in_window(self):
        return [(max(s, self.w0), min(e, self.w1), n, c) for s, e, n, c in self.device
                if e > self.w0 and s < self.w1]

    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for s, e, _n, _c in self.in_window():
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def span_device_s(self, name: str) -> float:
        """Device seconds of the events launched under span `name`."""
        spans = sorted(self.ranges.get(name, []))
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, _n, corr in self.device:
            at = self.launch.get(corr, s)
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += e - s
        return total * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for s, e, name, _c in self.in_window():
            by[name] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time inside the window by the innermost span open at each
        gap's middle (`host` where none is)."""
        busy = self.busy_intervals()
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        spans = [(s, e, name) for name, rs in self.ranges.items() if name != WINDOW
                 for s, e in rs]
        by = defaultdict(float)
        for i in range(0, len(edges), 2):
            g0, g1 = edges[i], edges[i + 1]
            if g1 <= g0:
                continue
            mid = (g0 + g1) / 2
            inner = [(e - s, name) for s, e, name in spans if s <= mid <= e]
            by[min(inner)[1] if inner else "host"] += (g1 - g0) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
