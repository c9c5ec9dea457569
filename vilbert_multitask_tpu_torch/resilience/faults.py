"""Deterministic, seeded fault injection for the serving stack.

The chaos half of ``resilience/``: named fault sites live UNCONDITIONALLY
on production paths — ``fault_point("queue.claim")`` at the top of the
claim, ``fault_point("remote.post")`` before every transport request — and
a :class:`FaultPlan` installed for a test or a ``serve_soak.py --chaos``
run decides, per call, whether to inject an exception, added latency, or
payload corruption. Because the decision stream is a per-site PRNG seeded
from ``(plan seed, site name)``, the k-th call at a site sees the same
verdict on every run with the same seed: failures found under chaos are
reproducible by seed, which is the whole point.

Disabled mode (no plan installed — production, and every test that didn't
opt in) is a single module-global read + ``is None`` compare, the same
shape as obs's disabled span; tier-1 guards it < 5 µs per call so sites
can stay on hot paths.

Fault-site inventory (see ARCHITECTURE.md for the table):
``queue.publish``, ``queue.claim``, ``worker.intake``, ``remote.post``,
``push.publish``, ``engine.dispatch``, ``engine.load`` (a checkpoint
load, on each rank of a mesh).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from vilbert_multitask_tpu_torch import obs


class FaultInjected(ConnectionError):
    """An error injected by an active :class:`FaultPlan`.

    Subclasses :class:`ConnectionError` so injected failures exercise the
    SAME handling as real transport loss: remote shims treat a failed
    claim as a drained queue, the worker nacks toward dead-letter, the
    push hub drops the frame — no test-only code paths.
    """


@dataclass(frozen=True)
class FaultRule:
    """One injection behavior bound to a site (or site prefix).

    ``site`` matches exactly, or by prefix when it ends with ``"*"``
    (``"queue.*"`` covers publish and claim). ``kind`` is one of
    ``"error"`` (raise :class:`FaultInjected`), ``"delay"`` (sleep
    ``delay_s`` then proceed), or ``"corrupt"`` (return a visibly mangled
    copy of the payload). ``rate`` is the per-call injection probability;
    ``max_injections`` caps total injections from this rule (None =
    unbounded) so a flap can be scripted to heal.
    """

    site: str
    kind: str = "error"      # "error" | "delay" | "corrupt"
    rate: float = 1.0
    delay_s: float = 0.0
    max_injections: Optional[int] = None

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site


class FaultPlan:
    """A seeded schedule of injections across named sites.

    Determinism contract: for a fixed ``(seed, rules)`` the verdict for
    the k-th call at each site is a pure function of ``(seed, site, k)``
    — each site gets its own ``random.Random(f"{seed}:{site}")`` stream
    and draws exactly one variate per call, so interleaving across sites
    (thread scheduling) cannot perturb any single site's schedule.
    """

    def __init__(self, seed: int = 0,
                 rules: Sequence[FaultRule] = ()):
        self.seed = int(seed)
        self.rules = tuple(rules)
        self._lock = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self._injected: Dict[str, int] = {}
        self._calls: Dict[str, int] = {}

    def _rule_for(self, site: str) -> Optional[FaultRule]:
        for rule in self.rules:
            if rule.matches(site):
                return rule
        return None

    def decide(self, site: str) -> Optional[FaultRule]:
        """Record one call at ``site``; return the rule to apply or None."""
        rule = self._rule_for(site)
        with self._lock:
            self._calls[site] = self._calls.get(site, 0) + 1
            if rule is None:
                return None
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = random.Random(
                    f"{self.seed}:{site}")
            # Always draw, THEN gate on the cap: the variate sequence per
            # site stays aligned with the call index regardless of how
            # many injections already fired.
            hit = rng.random() < rule.rate
            if not hit:
                return None
            if (rule.max_injections is not None
                    and self._injected.get(site, 0) >= rule.max_injections):
                return None
            self._injected[site] = self._injected.get(site, 0) + 1
            return rule

    def apply(self, site: str, payload: Any = None) -> Any:
        rule = self.decide(site)
        if rule is None:
            return payload
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
            return payload
        if rule.kind == "corrupt":
            return _corrupt(payload)
        # Error-kind faults are incidents by construction: freeze the
        # evidence (with whatever trace is live on this thread) before
        # the exception starts unwinding through the real handling.
        obs.record_event("fault_injected", site=site, seed=self.seed,
                         trace_id=obs.current_trace_id())
        raise FaultInjected(
            f"injected fault at {site} (seed={self.seed})")

    def injections(self) -> Dict[str, int]:
        """Site → injection count so far (snapshot)."""
        with self._lock:
            return dict(self._injected)

    def calls(self) -> Dict[str, int]:
        """Site → total fault_point calls so far (snapshot)."""
        with self._lock:
            return dict(self._calls)


def _corrupt(payload: Any) -> Any:
    """Visibly mangle a payload copy (never mutate the original)."""
    if isinstance(payload, dict):
        out = dict(payload)
        out["__fault_corrupted__"] = True
        for k, v in out.items():
            if isinstance(v, str):
                out[k] = v[::-1]
        return out
    if isinstance(payload, str):
        return payload[::-1]
    if isinstance(payload, (bytes, bytearray)):
        return bytes(payload)[::-1]
    return payload


# ------------------------------------------------------------- the plane
_PLAN: Optional[FaultPlan] = None


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Activate ``plan`` process-wide (chaos soak / opted-in tests)."""
    global _PLAN
    _PLAN = plan
    return plan


def clear_plan() -> None:
    global _PLAN
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def fault_point(site: str, payload: Any = None) -> Any:
    """A named injection site on a production path.

    With no plan installed this is one global read and an ``is None``
    compare (< 5 µs, tier-1 guarded) — cheap enough to live on hot paths
    unconditionally. With a plan, the site's rule may raise
    :class:`FaultInjected`, sleep, or return a corrupted ``payload``;
    otherwise ``payload`` passes through unchanged.
    """
    plan = _PLAN
    if plan is None:
        return payload
    return plan.apply(site, payload)
