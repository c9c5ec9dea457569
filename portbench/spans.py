"""The program's own spans in a ``--trace 1`` run's profiled sub-window,
placed on the device trace's clock.

While a profiler records, the program's default tracer
(``vilbert_multitask_tpu_torch.obs``) records every span on every thread,
and each span of the profiled thread also opens a host range of its name
in the trace. The spans of the window are those begun between the
profiler's start and its stop. A window is unreadable (``None``) where the
program keeps no such spans (a program without the tracer's eviction
count) or where its ring has evicted one that ended inside the window.

A span's start is a ``perf_counter`` reading; the trace's clock is Unix
µs less its base. :func:`calibrate` finds the offset between them from the
spans that exist both ways on the profiled thread, and every other
thread's spans are placed with it, since all threads share
``perf_counter``.
"""

from __future__ import annotations

import collections
import statistics
from typing import Dict, List, Optional, Tuple

def program_tracer():
    """The program's default tracer, or None where the program has none."""
    try:
        from vilbert_multitask_tpu_torch import obs
    except ImportError:
        return None
    return obs.default_tracer()


def window(run) -> Optional[list]:
    """The program's spans begun in the traced window, oldest first, or
    None where the window cannot be read whole."""
    t = getattr(run, "tracer", None)
    if (run.records.get("trace") is None or t is None
            or t.t_start is None or t.t_stop is None):
        return None
    tracer = program_tracer()
    evicted_end = getattr(tracer, "evicted_end_s", None)
    if evicted_end is None or evicted_end >= t.t_start:
        return None
    return sorted((s for s in tracer.spans()
                   if t.t_start <= s.start_s <= t.t_stop),
                  key=lambda s: s.start_s)


def named(spans: list, *names: str, thread: Optional[str] = None) -> list:
    return [s for s in spans if s.name in names
            and (thread is None or s.thread_name == thread)]


def _spread(xs: List[float]) -> float:
    """Mean distance from the median: every mispaired span counts."""
    mid = statistics.median(xs)
    return sum(abs(x - mid) for x in xs) / len(xs)


def _align(spans: List[Tuple[float, float]],
           ranges: List[Tuple[float, float]]) -> List[float]:
    """``range start − span start`` (µs) of the pairs of one name, spans
    and ranges as (start, end) matched in order. Where one list is longer
    (a span cut by the profiler's start or stop has no range), its surplus
    lies at its ends: of the shifts that pair the whole shorter list, the
    one whose start and end differences spread least (evenly spaced spans
    differ in length where not in spacing)."""
    flip = len(spans) < len(ranges)
    long, short = (ranges, spans) if flip else (spans, ranges)
    best: Optional[Tuple[float, List[float]]] = None
    for k in range(len(long) - len(short) + 1):
        pairs = [(b, a) if flip else (a, b) for a, b in zip(long[k:], short)]
        starts = [r[0] - s[0] for s, r in pairs]
        score = _spread(starts) + _spread([r[1] - s[1] for s, r in pairs])
        if best is None or score < best[0]:
            best = (score, starts)
    return best[1] if best is not None else []


def calibrate(trace, spans: list) -> Optional[Tuple[float, float]]:
    """(offset, median absolute error), µs: a span begun at ``start_s``
    lies at ``start_s · 1e6 + offset`` in the trace. The offset is the
    median of (range ``ts`` − span start) over the spans of the profiled
    thread that have a range of their name; the error is the median
    distance of those ranges from where the offset puts their spans.
    None without such a pair."""
    own: Dict[str, List[Tuple[float, float]]] = collections.defaultdict(list)
    for s in spans:
        if s.thread_id == trace.tid:
            own[s.name].append((s.start_s * 1e6,
                                (s.start_s + s.dur_s) * 1e6))
    ranges: Dict[str, List[Tuple[float, float]]] = \
        collections.defaultdict(list)
    for e in trace.ranges:
        if (e.get("cat") == "user_annotation" and e.get("tid") == trace.tid
                and e.get("name") in own):
            ts = float(e["ts"])
            ranges[e["name"]].append((ts, ts + float(e["dur"])))
    diffs: List[float] = []
    for name, got in ranges.items():
        diffs += _align(sorted(own[name]), sorted(got))
    if not diffs:
        return None
    offset = statistics.median(diffs)
    return offset, statistics.median(abs(d - offset) for d in diffs)


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_inside(trace, intervals: List[Tuple[float, float]]) -> float:
    """Seconds in which the device was idle inside the union of
    ``intervals`` (trace µs), within the traced window."""
    gaps, end = [], trace.t0
    for a, b in _merged(trace.busy_intervals()):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if end < trace.t1:
        gaps.append((end, trace.t1))
    inside = _merged((max(a, trace.t0), min(b, trace.t1))
                     for a, b in intervals if b > trace.t0 and a < trace.t1)
    total, i = 0.0, 0
    for a, b in inside:
        while i < len(gaps) and gaps[i][1] <= a:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < b:
            total += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
    return total / 1e6
