"""Reading the profiler's trace of a ``--trace 1`` run's sub-window.

The trace is exported in Chrome's format and read back: device operations
(kernels, copies, sets) with their stream and the correlation id of the
host call that launched them, the host's runtime calls with their thread,
and the host ranges (``record_function``, aten ops) of the thread that
ran the profiler.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Dict, List, Optional, Tuple

from portbench.bounds import union_s

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, events: List[dict], tid: Optional[int]):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e.get("ph") == "X"]
        self.runtime = [e for e in events
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and e.get("ph") == "X"]
        self.ranges = [e for e in events
                       if e.get("cat") in ("user_annotation", "cpu_op")
                       and e.get("ph") == "X" and not str(
                           e.get("name", "")).startswith("PyTorch Profiler")]
        span = [e for e in events if e.get("ph") == "X"
                and str(e.get("name", "")).startswith("PyTorch Profiler")]
        if span:
            self.t0 = float(span[0]["ts"])
            self.t1 = self.t0 + float(span[0]["dur"])
        else:
            stamps = [float(e["ts"]) for e in events if "ts" in e]
            ends = [float(e["ts"]) + float(e.get("dur", 0)) for e in events
                    if "ts" in e]
            self.t0, self.t1 = min(stamps), max(ends)
        self.tid = tid

    @classmethod
    def from_profiler(cls, prof, work_dir: str, tid=None) -> "Trace":
        os.makedirs(work_dir, exist_ok=True)
        path = os.path.join(work_dir, "trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events, tid)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return [(max(float(e["ts"]), self.t0),
                 min(float(e["ts"]) + float(e["dur"]), self.t1))
                for e in self.device
                if float(e["ts"]) < self.t1
                and float(e["ts"]) + float(e["dur"]) > self.t0]

    def busy_s(self) -> float:
        return union_s(self.busy_intervals()) / 1e6

    def launched_by(self, tid: int, spans: List[Tuple[float, float]]
                    ) -> List[dict]:
        """Device operations whose host call ran on thread ``tid`` inside
        one of ``spans`` (trace microseconds)."""
        corr = set()
        for e in self.runtime:
            if e.get("tid") != tid:
                continue
            ts = float(e["ts"])
            if any(s <= ts <= t for s, t in spans):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    corr.add(c)
        return [e for e in self.device
                if e.get("args", {}).get("correlation") in corr]

    def range_tid(self, name: str):
        """The thread that recorded the host ranges called ``name``."""
        for e in self.ranges:
            if e.get("name") == name:
                return e.get("tid")
        return self.tid

    def range_spans(self, name: str) -> List[Tuple[float, float]]:
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in self.ranges if e.get("name") == name)

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time, and the ten
        longest idle stretches of the device grouped by the innermost host
        range (a ``record_function`` label first, else an aten op) open on
        the profiled thread when each began."""
        by_op = collections.Counter()
        for e in self.device:
            by_op[str(e["name"])] += float(e["dur"]) / 1e6
        idle = collections.Counter()
        end = self.t0
        gaps = []
        for s, e in sorted(self.busy_intervals()):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.t1:
            gaps.append((end, self.t1))
        kinds = [sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         str(e["name"])) for e in self.ranges
                        if (e.get("cat") == "user_annotation") == annotated)
                 for annotated in (True, False)]
        starts = [[r[0] for r in k] for k in kinds]

        def covering(k: int, t: float, depth: int) -> Optional[str]:
            i = bisect.bisect_right(starts[k], t) - 1
            for j in range(i, max(i - depth, -1), -1):
                if kinds[k][j][1] >= t:
                    return kinds[k][j][2]
            return None

        for g0, g1 in gaps:
            label = (covering(0, g0, len(starts[0])) or covering(1, g0, 256)
                     or "host outside any range")
            idle[label] += (g1 - g0) / 1e6
        return {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}
