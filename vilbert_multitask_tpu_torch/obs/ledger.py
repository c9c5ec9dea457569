"""Perf ledger: the append-only trajectory behind ``PERF_LEDGER.jsonl``.

Bench and soak results used to land in ad-hoc ``BENCH_*.json`` /
``SERVE_SOAK*.json`` artifacts — rich individually, invisible as a
sequence (the ROADMAP's BENCH trajectory was literally ``[]``). The
ledger is the machine-readable sequence: every bench/soak/smoke run
appends ONE json line of headline numbers (p50/p95, qps, knee_rows,
boot_s ...) stamped with wall time, git rev, and the serving
``config_fingerprint()``, and :func:`check` turns the trailing window
into a regression verdict with noise bounds.

Direction is inferred from key names (the repo's metric-naming
convention is already consistent): ``*_ms``/``*_s`` are latencies
(lower is better), ``*qps``/``*_per_s``/``*_rows``/``speedup``/``value``
are throughputs (higher is better); anything else is recorded but never
gated on. Entries that fail to parse are skipped, never fatal — a
half-written line from a crashed bench must not wedge CI.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional

LEDGER_BASENAME = "PERF_LEDGER.jsonl"

# Bookkeeping keys never compared as metrics.
_META_KEYS = {"ts_unix", "metric", "git_rev", "config_fingerprint",
              "run_id", "artifact", "verdict", "partial"}


def default_ledger_path(root: Optional[str] = None) -> str:
    """``PERF_LEDGER.jsonl`` at the repo root (or ``$VMT_PERF_LEDGER``)."""
    env = os.environ.get("VMT_PERF_LEDGER")
    if env:
        return env
    if root is None:
        # obs/ledger.py -> obs -> package -> repo root
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, LEDGER_BASENAME)


def git_rev(cwd: Optional[str] = None) -> Optional[str]:
    """Short HEAD rev, best-effort (None outside a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=cwd or os.path.dirname(default_ledger_path()),
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:  # noqa: BLE001 — ledger stamping must never raise
        return None


def append_entry(metric: str, values: Dict[str, Any], *,
                 path: Optional[str] = None,
                 config_fingerprint: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Append one run's headline numbers; returns the written entry.

    Best-effort by design: a bench must publish its artifact even when
    the ledger file is unwritable, so IO errors are swallowed (the entry
    is still returned for the caller's own report).
    """
    entry: Dict[str, Any] = {
        "ts_unix": round(time.time(), 3),
        "metric": metric,
        "git_rev": git_rev(),
        "config_fingerprint": config_fingerprint,
    }
    entry.update(values)
    if extra:
        entry.update(extra)
    try:
        p = path or default_ledger_path()
        if os.path.dirname(p):
            os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "a", encoding="utf-8") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")
    except OSError:
        pass
    return entry


def read_entries(path: Optional[str] = None,
                 metric: Optional[str] = None) -> List[Dict[str, Any]]:
    """All parseable entries, oldest first (filtered by ``metric``)."""
    p = path or default_ledger_path()
    out: List[Dict[str, Any]] = []
    try:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue
                if isinstance(entry, dict) and (
                        metric is None or entry.get("metric") == metric):
                    out.append(entry)
    except OSError:
        return []
    return out


def key_direction(key: str) -> Optional[str]:
    """'lower' / 'higher' is-better, or None for ungated keys."""
    if key in _META_KEYS or not isinstance(key, str):
        return None
    # Throughputs first: "_per_s" also ends with "_s", and a rate that
    # went UP must never gate as a latency regression.
    if (key.endswith(("qps", "_per_s", "_rows", "speedup"))
            or key == "value" or key == "knee_rows"):
        return "higher"
    if key.endswith(("_ms", "_s")) or "latency" in key:
        return "lower"
    return None


def _noise_floor(key: str) -> float:
    """Minimum ABSOLUTE delta that can count as a regression.

    Relative tolerance alone is meaningless near zero: a dryrun app's
    boot_s jittering 31 ms -> 40 ms is +29% "worse" and pure scheduler
    noise. Time-unit keys get a floor below which no delta gates;
    rates/counts stay relative-only (their magnitudes are O(10+) here).
    """
    if key.endswith("_ms") or "latency" in key:
        return 2.0
    if key.endswith("_s"):
        return 0.25
    return 0.0


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    mid = len(xs) // 2
    if len(xs) % 2:
        return xs[mid]
    return (xs[mid - 1] + xs[mid]) / 2.0


def check(path: Optional[str] = None, *, metric: Optional[str] = None,
          window: int = 5, tolerance: float = 0.20,
          min_baseline: int = 2) -> Dict[str, Any]:
    """Compare the newest run of each metric against its trailing window.

    Baseline per key = median of up to ``window`` prior runs; a key
    regresses when it is worse than baseline by more than ``tolerance``
    (relative — the noise bound; bench-to-bench jitter on shared CPU
    boxes routinely hits 10-15%) AND by more than the key's absolute
    noise floor (:func:`_noise_floor` — a 9 ms boot_s wobble is not a
    29% regression). Verdicts: ``pass`` / ``regress`` /
    ``empty`` (no entries) / ``no-baseline`` (fewer than
    ``min_baseline`` prior runs for every gated key).
    """
    entries = read_entries(path, metric=None)
    if metric is not None:
        entries = [e for e in entries if e.get("metric") == metric]
    if not entries:
        return {"verdict": "empty", "checked": [], "regressions": [],
                "window": window, "tolerance": tolerance}
    by_metric: Dict[str, List[Dict[str, Any]]] = {}
    for e in entries:
        by_metric.setdefault(str(e.get("metric")), []).append(e)
    checked: List[Dict[str, Any]] = []
    regressions: List[Dict[str, Any]] = []
    any_baseline = False
    for m, runs in sorted(by_metric.items()):
        newest, prior = runs[-1], runs[:-1][-window:]
        for key, value in sorted(newest.items()):
            direction = key_direction(key)
            if direction is None or not isinstance(value, (int, float)) \
                    or isinstance(value, bool):
                continue
            history = [r[key] for r in prior
                       if isinstance(r.get(key), (int, float))
                       and not isinstance(r.get(key), bool)]
            if len(history) < min_baseline:
                continue
            any_baseline = True
            baseline = _median([float(v) for v in history])
            if direction == "lower":
                worse = value > baseline * (1.0 + tolerance)
                delta = (value - baseline) / baseline if baseline else 0.0
            else:
                worse = value < baseline * (1.0 - tolerance)
                delta = (baseline - value) / baseline if baseline else 0.0
            if abs(float(value) - baseline) <= _noise_floor(key):
                worse = False
            record = {"metric": m, "key": key, "value": value,
                      "baseline": round(baseline, 6),
                      "direction": direction,
                      "delta_frac": round(delta, 4),
                      "n_baseline": len(history),
                      "regressed": worse}
            checked.append(record)
            if worse:
                regressions.append(record)
    if not any_baseline:
        return {"verdict": "no-baseline", "checked": [], "regressions": [],
                "window": window, "tolerance": tolerance,
                "metrics": sorted(by_metric)}
    return {"verdict": "regress" if regressions else "pass",
            "checked": checked, "regressions": regressions,
            "window": window, "tolerance": tolerance,
            "metrics": sorted(by_metric)}
