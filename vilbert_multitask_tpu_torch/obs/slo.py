"""Declarative SLOs evaluated with multi-window burn rates.

An :class:`Slo` is a named objective plus a ``counts_fn(window_s) ->
(good, bad)`` probe over a sliding window — everything else (targets,
which histogram feeds it) is closed over by the builder helpers below.
The burn rate of a window is ``bad_ratio / error_budget``: burn 1.0
means the budget is being spent exactly as fast as the objective allows;
burn 10 means a month's budget gone in three days.

:class:`SloEvaluator` applies the Google-SRE multi-window rule: a PAGE
requires the burn to exceed the page threshold on *both* a fast window
(is it happening now?) and a slow window (is it sustained, not a blip?).
Because both windows are sliding, an old burst that has aged out of the
fast window cannot hold a PAGE — exactly the property the tier-1 gate
asserts. States publish as ``vmt_slo_state{slo}`` (0/1/2) and
``vmt_slo_burn_rate{slo,window}``; an OK/WARN→PAGE transition trips the
flight recorder.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from vilbert_multitask_tpu_torch.obs.instruments import REGISTRY, Histogram
from vilbert_multitask_tpu_torch.obs.recorder import record_event

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_PAGE = "page"
_STATE_CODES = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}

SLO_STATE_GAUGE = REGISTRY.gauge(
    "vmt_slo_state", "SLO health (0=ok 1=warn 2=page)", labelnames=("slo",))
SLO_BURN_GAUGE = REGISTRY.gauge(
    "vmt_slo_burn_rate", "Error-budget burn rate per evaluation window",
    labelnames=("slo", "window"))


class Slo:
    """One objective: ``counts_fn(window_s) -> (good, bad)`` + a budget."""

    def __init__(self, name: str, objective: str,
                 counts_fn: Callable[[float], Tuple[int, int]],
                 error_budget: float = 0.01,
                 exemplars_fn: Optional[
                     Callable[[], List[Tuple[float, str]]]] = None):
        if not 0.0 < error_budget < 1.0:
            raise ValueError(f"slo {name!r}: error_budget must be in (0,1), "
                             f"got {error_budget}")
        self.name = name
        self.objective = objective
        self.error_budget = float(error_budget)
        self._counts_fn = counts_fn
        # Optional metrics→trace link: (value, trace_id) pairs for the
        # worst recent observations of the histogram feeding this SLO.
        # Page payloads embed them so a burn links straight to stored
        # autopsies (/debug/autopsy?trace_id=).
        self._exemplars_fn = exemplars_fn

    def exemplar_trace_ids(self) -> List[str]:
        if self._exemplars_fn is None:
            return []
        try:
            return [tid for _v, tid in self._exemplars_fn() if tid]
        except Exception:  # an exemplar probe must never fail evaluation
            return []

    def burn_rate(self, window_s: float) -> Tuple[float, int, int]:
        """(burn, good, bad) over the window; an empty window burns 0 —
        no traffic spends no budget."""
        good, bad = self._counts_fn(window_s)
        total = good + bad
        if total <= 0:
            return 0.0, 0, 0
        return (bad / total) / self.error_budget, good, bad


# ------------------------------------------------------------ SLO builders
def latency_slo(name: str, hist: Histogram, target_ms: float,
                error_budget: float = 0.05, **labels) -> Slo:
    """Requests completing within ``target_ms`` (windowed samples of a
    latency histogram; a sample over target is a bad event)."""
    def counts(window_s: float) -> Tuple[int, int]:
        xs = hist.window_samples(window_s, **labels)
        bad = sum(1 for v in xs if v > target_ms)
        return len(xs) - bad, bad
    return Slo(name, f"latency <= {target_ms:g} ms", counts,
               error_budget=error_budget,
               exemplars_fn=lambda: hist.slowest_exemplars(3))


def slack_floor_slo(name: str, hist: Histogram, floor_ms: float,
                    error_budget: float = 0.05, **labels) -> Slo:
    """Deadline slack staying above a floor: a job arriving at the engine
    with less than ``floor_ms`` of budget left is a bad event (it will
    deadline on any hiccup)."""
    def counts(window_s: float) -> Tuple[int, int]:
        xs = hist.window_samples(window_s, **labels)
        bad = sum(1 for v in xs if v < floor_ms)
        return len(xs) - bad, bad
    return Slo(name, f"deadline slack >= {floor_ms:g} ms", counts,
               error_budget=error_budget)


def availability_slo(name: str, ok_hist: Histogram, fail_hist: Histogram,
                     error_budget: float = 0.02) -> Slo:
    """Terminal results vs. failures, both counted over sliding windows."""
    def counts(window_s: float) -> Tuple[int, int]:
        return (ok_hist.window_count(window_s),
                fail_hist.window_count(window_s))
    return Slo(name, "requests reach a successful terminal result", counts,
               error_budget=error_budget)


class SloEvaluator:
    """Multi-window burn-rate evaluation over a set of SLOs.

    Thread-safe: evaluated from the sampler tick, ``/debug/slo``, and
    ``/healthz`` concurrently. PAGE requires BOTH windows over the page
    threshold; WARN requires both over the warn threshold (fast-only
    spikes are visible in the burn gauges but do not change state).
    """

    def __init__(self, slos: List[Slo], fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0, warn_burn: float = 1.0,
                 page_burn: float = 4.0,
                 on_page: Optional[Callable[[str, dict], None]] = None):
        self.slos = list(slos)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self._on_page = on_page if on_page is not None else self._page_event
        self._lock = threading.Lock()
        self._last_state: Dict[str, str] = {}

    @staticmethod
    def _page_event(slo_name: str, report: dict) -> None:
        record_event("slo_page", slo=slo_name,
                     burn_fast=report["burn"]["fast"],
                     burn_slow=report["burn"]["slow"],
                     exemplar_trace_ids=report.get("exemplar_trace_ids", []))

    def evaluate(self) -> List[dict]:
        """Evaluate every SLO now; publishes gauges, fires the PAGE
        trigger on a transition, returns the full report."""
        reports, paged = [], []
        with self._lock:
            for slo in self.slos:
                fast, fg, fb = slo.burn_rate(self.fast_window_s)
                slow, sg, sb = slo.burn_rate(self.slow_window_s)
                both = min(fast, slow)
                if both >= self.page_burn:
                    state = STATE_PAGE
                elif both >= self.warn_burn:
                    state = STATE_WARN
                else:
                    state = STATE_OK
                report = {
                    "slo": slo.name,
                    "objective": slo.objective,
                    "error_budget": slo.error_budget,
                    "state": state,
                    "burn": {"fast": round(fast, 4), "slow": round(slow, 4)},
                    "windows_s": {"fast": self.fast_window_s,
                                  "slow": self.slow_window_s},
                    "events": {"fast": {"good": fg, "bad": fb},
                               "slow": {"good": sg, "bad": sb}},
                    # Top offending traces (newest slowest exemplars) —
                    # each resolves via /debug/autopsy?trace_id=.
                    "exemplar_trace_ids": slo.exemplar_trace_ids(),
                }
                SLO_STATE_GAUGE.set(_STATE_CODES[state], slo=slo.name)
                SLO_BURN_GAUGE.set(round(fast, 4), slo=slo.name,
                                   window="fast")
                SLO_BURN_GAUGE.set(round(slow, 4), slo=slo.name,
                                   window="slow")
                prev = self._last_state.get(slo.name, STATE_OK)
                if state == STATE_PAGE and prev != STATE_PAGE:
                    paged.append((slo.name, report))
                self._last_state[slo.name] = state
                reports.append(report)
        # Trigger sites run OUTSIDE the evaluator lock: the recorder
        # enqueue is cheap but nothing that does I/O belongs under it.
        for name, report in paged:
            self._on_page(name, report)
        return reports

    def states(self) -> Dict[str, str]:
        """Fresh state per SLO (evaluates; cheap — pure window math)."""
        return {r["slo"]: r["state"] for r in self.evaluate()}

    def worst_state(self) -> str:
        states = self.states().values()
        if STATE_PAGE in states:
            return STATE_PAGE
        if STATE_WARN in states:
            return STATE_WARN
        return STATE_OK
