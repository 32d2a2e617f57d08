"""Reading a profile of whole self-play plies: device operations, launch
records, the harness's host ranges, and the idle gaps between device work.

Everything comes from the profiler's own records: device
operations (kernels, copies, fills) with their start and end on the host's
clock, the CUDA runtime's launch records, and the `record_function` ranges
the harness opened (`step`, `search`, `nn_eval`, `reset`). A launch record
of the runtime (a kernel launch, or a CUDA graph's launch, whose kernels
all carry its id) and the device records of what it started share a
correlation id. CUPTI drops device records now and then, so a time is
scaled up by the launches over the launches with a device record found,
and a count of kernels adds one for each kernel launch whose record was
dropped (the method of chip_smoke.py `device_timing`).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HARNESS_RANGES = ("step", "search", "nn_eval", "reset")
KERNEL_LAUNCHES = ("LaunchKernel", "LaunchCooperativeKernel")
GRAPH_LAUNCHES = ("GraphLaunch",)


def launch_kind(name: str) -> Optional[str]:
    """"kernel" or "graph" for a runtime or driver record that launches
    device work (cudaLaunchKernel, cuLaunchKernelEx, cudaGraphLaunch...)."""
    if any(k in name for k in GRAPH_LAUNCHES):
        return "graph"
    if any(k in name for k in KERNEL_LAUNCHES):
        return "kernel"
    return None


class Profile:
    """The records of `plies` profiled plies, read from the profiler's
    Chrome trace (written to a file in the run's temporary directory and
    deleted once read: its categories are the same across torch
    versions). `span` is (start, end) in ns on the profiler's clock: from
    the start of the first `step` range to the end of the last device
    operation or range."""

    def __init__(self, prof, plies: int):
        self.plies = plies
        self.device_ops: List[Tuple[str, int, int, int, str]] = []  # name, start, end, corr, kind
        self.launches: List[Tuple[int, int, str]] = []  # (start, corr, kind) of launch records
        self.ranges: List[Tuple[str, int, int]] = []
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            start = int(round(float(e["ts"]) * 1000))
            end = start + int(round(float(e.get("dur", 0)) * 1000))
            corr = (e.get("args") or {}).get("correlation", -1)
            if cat in DEVICE_ACTIVITIES:
                self.device_ops.append((name, start, end, corr, cat))
            elif cat in ("cuda_runtime", "cuda_driver"):
                kind = launch_kind(name)
                if kind:
                    self.launches.append((start, corr, kind))
            elif cat == "user_annotation" and name in HARNESS_RANGES:
                self.ranges.append((name, start, end))
        self.kernels = [op for op in self.device_ops if op[4] == "kernel"]
        starts = [r[1] for r in self.ranges if r[0] == "step"]
        ends = [op[2] for op in self.device_ops] + [r[2] for r in self.ranges]
        lo = min(starts) if starts else min((op[1] for op in self.device_ops), default=0)
        self.span = (lo, max(ends, default=lo))

    @property
    def span_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    def dropped_records(self) -> int:
        """Launch records with no device record of what they started."""
        have = {k[3] for k in self.kernels}
        return sum(1 for _, corr, _ in self.launches if corr not in have)

    def kernel_count(self) -> int:
        """Kernels that ran: the device records, plus one for each kernel
        launch whose record was dropped (a graph whose records were all
        dropped is not counted: how many kernels it holds is unknown)."""
        have = {k[3] for k in self.kernels}
        lost = sum(1 for _, corr, kind in self.launches if kind == "kernel" and corr not in have)
        return len(self.kernels) + lost

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device operation intervals inside the span."""
        lo, hi = self.span
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e, _, _ in self.device_ops
                     if e > lo and s < hi)
        out: List[Tuple[int, int]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_time(self, match) -> Dict[str, Tuple[int, float]]:
        """{kernel name: (records, mean ns a record)} of the kernels whose
        name `match` accepts."""
        acc = defaultdict(lambda: [0, 0])
        for name, s, e, _, _ in self.kernels:
            if match(name):
                acc[name][0] += 1
                acc[name][1] += e - s
        return {k: (n, t / n) for k, (n, t) in acc.items()}

    def _open_range(self, t: int) -> Optional[str]:
        """The innermost harness range open on the host at time t (ranges
        of one name never overlap; nn_eval nests in search, search in
        step)."""
        if not hasattr(self, "_by_name"):
            self._by_name = {}
            for name in HARNESS_RANGES:
                rs = sorted((s, e) for n, s, e in self.ranges if n == name)
                self._by_name[name] = ([s for s, _ in rs], rs)
        for name in ("nn_eval", "search", "reset", "step"):
            starts, rs = self._by_name[name]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < rs[i][1]:
                return name
        return None

    def range_kernel_ns(self, name: str) -> Tuple[float, int, int]:
        """(device ns, launch records, launch records with a device record)
        of the kernels launched inside ranges called `name`, directly or by
        a graph launched there; the time scaled up by the launches over the
        launches with a record found (dropped records)."""
        rs = sorted((s, e) for n, s, e in self.ranges if n == name)
        starts = [s for s, _ in rs]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < rs[i][1]

        launched = {corr for t, corr, _ in self.launches if inside(t)}
        ns = sum(e - s for _, s, e, corr, _ in self.kernels if corr in launched)
        found = len(launched & {k[3] for k in self.kernels})
        if found == 0:
            return 0.0, len(launched), 0
        return ns * len(launched) / found, len(launched), found

    def top_ops(self, n: int = 10) -> List[List]:
        acc = defaultdict(int)
        for name, s, e, _, _ in self.device_ops:
            acc[name] += e - s
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], t / 1e9] for name, t in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest gaps between device work inside the span, each
        named by the harness range open on the host when it began."""
        busy = self.busy_intervals()
        lo, hi = self.span
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._open_range(s) or "host", (e - s) / 1e9] for s, e in gaps[:n]]

    def idle_by_range(self) -> Dict[str, float]:
        """Seconds of idle device time by the harness range open on the host."""
        out = defaultdict(float)
        busy = self.busy_intervals()
        t = self.span[0]
        for s, e in busy + [(self.span[1], self.span[1])]:
            if s > t:
                out[self._open_range(t) or "host"] += (s - t) / 1e9
            t = max(t, e)
        return dict(out)
