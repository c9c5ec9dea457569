"""Telemetry export: Prometheus text exposition, Chrome-trace JSON, and
the ``torch.profiler`` toggles behind ``POST /debug/profile/{start,stop}``.

- :func:`render_prometheus` serializes a :class:`Registry` in the
  Prometheus text exposition format (version 0.0.4): HELP/TYPE headers,
  escaped label values, cumulative histogram buckets ending at ``+Inf``
  plus ``_sum``/``_count``. ``GET /metrics?format=prometheus`` serves it.
- :func:`chrome_trace` renders a tracer's span ring as a Chrome-trace /
  Perfetto JSON document (``ph: "X"`` complete events, µs timestamps,
  thread-name metadata) — ``GET /debug/trace`` serves it, on the clock of
  the device trace ``/debug/profile`` writes, so the two lay over each
  other. Open at https://ui.perfetto.dev (drag the file in) or
  chrome://tracing.
- :func:`start_profile`/:func:`stop_profile` wrap the existing device
  trace toggles (serve/metrics.py → ``torch.profiler``) with idempotence
  bookkeeping so the HTTP endpoints can't double-start a trace.
"""

from __future__ import annotations

import math
import os
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from vilbert_multitask_tpu_torch.obs.instruments import (
    Histogram,
    Registry,
    REGISTRY,
)
from vilbert_multitask_tpu_torch.obs.trace import Span, Tracer, default_tracer

# ------------------------------------------------------------- prometheus
_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    name = _NAME_SANITIZE_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\")
                 .replace("\n", "\\n")
                 .replace('"', '\\"'))


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels(names: Sequence[str], values: Sequence[str],
            extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [(k, v) for k, v in zip(names, values)] + list(extra)
    if not pairs:
        return ""
    return ("{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
            + "}")


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def render_prometheus(registry: Optional[Registry] = None,
                      extra: Sequence = ()) -> str:
    """The whole registry in Prometheus text exposition format.

    ``extra`` appends instruments living outside the registry (e.g. the
    per-``Metrics``-instance request-latency histogram). The registry's
    default labels (process identity, set by ``Registry.set_default_labels``)
    are merged into every sample line here — exposition is the one place
    identity stamping happens, so observe-time call sites stay unchanged.
    """
    registry = registry if registry is not None else REGISTRY
    defaults = list(registry.default_labels().items())
    lines: List[str] = []
    for inst in sorted(registry.instruments() + list(extra),
                       key=lambda i: i.name):
        name = _metric_name(inst.name)
        base = [(k, v) for k, v in defaults if k not in inst.labelnames]
        if inst.help:
            lines.append(f"# HELP {name} {_escape_help(inst.help)}")
        lines.append(f"# TYPE {name} {inst.kind}")
        if isinstance(inst, Histogram):
            for key, series in sorted(inst.collect().items()):
                for bound, cumulative in series["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels(inst.labelnames, key, [('le', _fmt(bound))] + base)}"
                        f" {cumulative}")
                lines.append(f"{name}_sum{_labels(inst.labelnames, key, base)} "
                             f"{_fmt(series['sum'])}")
                lines.append(f"{name}_count{_labels(inst.labelnames, key, base)} "
                             f"{series['count']}")
        else:
            for key, value in sorted(inst.collect().items()):
                lines.append(
                    f"{name}{_labels(inst.labelnames, key, base)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def render_openmetrics(registry: Optional[Registry] = None,
                       extra: Sequence = ()) -> str:
    """The registry in OpenMetrics text format, exemplars included.

    Differences from :func:`render_prometheus` that matter here: the
    metric *family* name drops a counter's ``_total`` suffix (the sample
    line keeps it), histogram bucket lines carry their bucket's exemplar
    as ``# {trace_id="..."} value timestamp`` — the metrics→trace link
    Grafana/Prometheus follow straight to a stored autopsy — and the
    exposition ends with ``# EOF``. ``GET /metrics?format=openmetrics``
    serves it.
    """
    registry = registry if registry is not None else REGISTRY
    defaults = list(registry.default_labels().items())
    lines: List[str] = []
    for inst in sorted(registry.instruments() + list(extra),
                       key=lambda i: i.name):
        name = _metric_name(inst.name)
        family = (name[: -len("_total")]
                  if inst.kind == "counter" and name.endswith("_total")
                  else name)
        base = [(k, v) for k, v in defaults if k not in inst.labelnames]
        if inst.help:
            lines.append(f"# HELP {family} {_escape_help(inst.help)}")
        lines.append(f"# TYPE {family} {inst.kind}")
        if isinstance(inst, Histogram):
            exemplars = inst.collect_exemplars()
            for key, series in sorted(inst.collect().items()):
                key_ex = exemplars.get(key, {})
                for i, (bound, cumulative) in enumerate(series["buckets"]):
                    line = (f"{name}_bucket"
                            f"{_labels(inst.labelnames, key, [('le', _fmt(bound))] + base)}"
                            f" {cumulative}")
                    ex = key_ex.get(i)
                    if ex is not None:
                        value, trace_id, ts = ex
                        line += (f' # {{trace_id="{_escape_label(trace_id)}"}}'
                                 f" {_fmt(value)} {ts:.3f}")
                    lines.append(line)
                lines.append(f"{name}_sum{_labels(inst.labelnames, key, base)} "
                             f"{_fmt(series['sum'])}")
                lines.append(f"{name}_count{_labels(inst.labelnames, key, base)} "
                             f"{series['count']}")
        else:
            suffix = "_total" if inst.kind == "counter" else ""
            for key, value in sorted(inst.collect().items()):
                lines.append(f"{family}{suffix}"
                             f"{_labels(inst.labelnames, key, base)} "
                             f"{_fmt(value)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------- chrome trace
def chrome_trace(spans: Optional[Sequence[Span]] = None,
                 tracer: Optional[Tracer] = None,
                 limit: Optional[int] = None) -> Dict[str, Any]:
    """Chrome-trace JSON (``traceEvents``) of the newest ``limit`` spans.

    Timestamps are in the frame ``torch.profiler``'s (Kineto's) device
    trace is written in: Unix µs less the document's
    ``baseTimeNanoseconds`` (here the tracer's anchor, whole seconds), so
    ``ts + base`` is comparable across the two documents. Span starts go
    to Unix time by the tracer's anchor (:meth:`Tracer.unix_ns`).
    ``ph: "X"`` complete events carry trace/span/parent ids and span
    attributes in ``args``, so Perfetto's flow/search tooling can follow
    one trace_id across the HTTP and worker threads; ``tid`` is the OS
    thread id, as in the device trace.
    """
    tracer = tracer if tracer is not None else default_tracer()
    if spans is None:
        spans = tracer.spans(limit=limit)
    elif limit:
        spans = list(spans)[-limit:]
    base_ns = tracer.anchor_unix_ns // 10**9 * 10**9
    pid = os.getpid()
    thread_names: Dict[int, str] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        thread_names.setdefault(s.thread_id, s.thread_name)
        events.append({
            "name": s.name,
            "ph": "X",
            "cat": "obs",
            "ts": round((tracer.unix_ns(s.start_s) - base_ns) / 1e3, 3),
            "dur": round(s.dur_s * 1e6, 3),
            "pid": pid,
            "tid": s.thread_id,
            "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                     "parent_id": s.parent_id, **s.attrs},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(thread_names.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "baseTimeNanoseconds": base_ns}


# -------------------------------------------------------- profile toggles
_PROFILE_LOCK = threading.Lock()
_PROFILE_DIR: Optional[str] = None


def start_profile(log_dir: str) -> Dict[str, Any]:
    """Begin a ``torch.profiler`` device trace into ``log_dir``.

    Returns ``{"ok": True, "log_dir": ...}`` or ``{"ok": False, "error"}``
    when a trace is already running (one at a time) or the
    profiler itself refuses — the HTTP surface must answer JSON either way.
    """
    global _PROFILE_DIR
    with _PROFILE_LOCK:
        if _PROFILE_DIR is not None:
            return {"ok": False,
                    "error": f"profile already running into {_PROFILE_DIR}"}
        from vilbert_multitask_tpu_torch.serve.metrics import start_device_trace

        try:
            start_device_trace(log_dir)
        except Exception as e:  # noqa: BLE001 — surface, don't 500
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        _PROFILE_DIR = log_dir
        return {"ok": True, "log_dir": log_dir}


def stop_profile() -> Dict[str, Any]:
    """Stop the running device trace; ``{"ok": False}`` if none is."""
    global _PROFILE_DIR
    with _PROFILE_LOCK:
        if _PROFILE_DIR is None:
            return {"ok": False, "error": "no profile running"}
        from vilbert_multitask_tpu_torch.serve.metrics import stop_device_trace

        log_dir, _PROFILE_DIR = _PROFILE_DIR, None
        try:
            stop_device_trace()
        except Exception as e:  # noqa: BLE001
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return {"ok": True, "log_dir": log_dir}
