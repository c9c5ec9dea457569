"""Closed-loop autoscaler: SLO burn rates drive the replica count.

The sensors have existed since the obs tier landed (multi-window burn
rates in ``obs/slo.py``, the ``vmt_queue_wait_ms`` histogram, poison
quarantine counters, per-replica breakers) and the actuators since the
pool tier (``ReplicaPool.add_replica`` / ``retire_replica``) — this
module closes the loop. A flash crowd used to shed 429s until a human
added replicas; now a target-tracking controller does it in one
AOT-boot latency.

Control loop (rides the obs sampler tick — NO new threads, exactly like
``ReplicaPool.probe()``)::

    sensors                 policy                     actuators
    -------                 ------                     ---------
    queue-wait p95     ┐
    SLO burn (2 win)   ├──▶  hysteresis band     ──▶  pool.add_replica()
    breaker states     │     + sustain counters  ──▶  pool.retire_replica()
    poison/dead rate   ┘     + cooldowns

Policy shape:

* **Target tracking with hysteresis.** A tick is a *breach* when
  queue-wait p95 rises above ``target * band_high`` or the worst SLO
  burns over threshold on BOTH windows; a *slack* tick needs p95 below
  ``target * band_low`` AND burn under threshold. Between the bands the
  controller holds — the dead zone is what stops limit-cycling around
  the target.
* **Sustain + cooldown.** Scale-out needs ``breach_ticks`` consecutive
  breach ticks, scale-in ``slack_ticks`` consecutive slack ticks (the
  slow direction — capacity is cheap to keep for another window, and
  re-adding it costs a boot). Every action starts both cooldown clocks:
  another scale-out waits ``cooldown_out_s``, a scale-in
  ``cooldown_in_s`` — so freshly added capacity gets a chance to absorb
  the queue before the controller reads the resulting calm as slack.
* **Health gating.** A poison-job storm or a flapping replica breaker
  reads as "unhealthy, don't scale", never "overloaded, add replicas":
  scaling out would boot fresh replicas straight into the same
  poisoned intake. Any open breaker or a poison/dead-letter rate above
  ``max_poison_rate_per_s`` pins the controller to hold (both
  directions — retiring capacity mid-incident is no better).

Every decision is recorded: the ``vmt_autoscale_decisions_total``
counter labeled ``{action,reason}``, the ``vmt_pool_target_replicas``
gauge next to the pool's actual, an ``autoscale`` flight-recorder
trigger on actions and health-gated holds, and a bounded ring of full
decision records (inputs observed, thresholds, action, cooldown state)
served by ``GET /debug/autoscale``.

The policy itself is pure — :func:`decide` maps (policy, state, inputs,
now) to a decision record with no clocks, pool, or sockets — so
``tests/test_autoscale.py`` drives it with a fake clock and hand-built
inputs, no sleeps.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, TYPE_CHECKING

from vilbert_multitask_tpu_torch import obs

if TYPE_CHECKING:  # pragma: no cover — import cycle guard, types only
    from vilbert_multitask_tpu_torch.config import ServingConfig

ACTION_SCALE_OUT = "scale_out"
ACTION_SCALE_IN = "scale_in"
ACTION_HOLD = "hold"

DECISIONS = obs.REGISTRY.counter(
    "vmt_autoscale_decisions_total",
    "Autoscaler decisions by action and reason.",
    labelnames=("action", "reason"))
TARGET_REPLICAS = obs.REGISTRY.gauge(
    "vmt_pool_target_replicas",
    "Replica count the autoscaler is steering toward (compare with "
    "vmt_pool_ready_replicas: a gap is a scale event in progress).")


@dataclasses.dataclass(frozen=True)
class AutoscaleInputs:
    """One tick's sensor readings — everything :func:`decide` sees.

    ``queue_wait_p95_ms`` is None on an empty window (no claims — idle
    trough or cold start), which the policy reads as slack: no traffic
    needs no extra capacity.
    """

    queue_wait_p95_ms: Optional[float] = None
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    ready_replicas: int = 1
    live_replicas: int = 1
    booting_replicas: int = 0
    open_breakers: int = 0
    poison_rate_per_s: float = 0.0
    queue_depth: int = 0
    can_add: bool = True


@dataclasses.dataclass
class ControllerState:
    """The controller's memory between ticks: sustain counters and the
    cooldown clock. Mutated only by :func:`decide`."""

    breach_ticks: int = 0
    slack_ticks: int = 0
    last_action_t: Optional[float] = None
    last_action: Optional[str] = None


class AutoscalePolicy:
    """The knob view: every ``autoscale_*`` ServingConfig field, read
    once at construction (the VMT122 audit tracks these reads)."""

    def __init__(self, serving: "ServingConfig"):
        self.enabled = bool(serving.autoscale_enabled)
        self.min_replicas = max(1, int(serving.autoscale_min_replicas))
        self.max_replicas = int(serving.autoscale_max_replicas)
        self.target_p95_ms = float(serving.autoscale_target_queue_wait_p95_ms)
        self.burn_threshold = float(serving.autoscale_burn_threshold)
        self.band_high = float(serving.autoscale_band_high)
        self.band_low = float(serving.autoscale_band_low)
        self.breach_ticks = max(1, int(serving.autoscale_breach_ticks))
        self.slack_ticks = max(1, int(serving.autoscale_slack_ticks))
        self.cooldown_out_s = float(serving.autoscale_cooldown_out_s)
        self.cooldown_in_s = float(serving.autoscale_cooldown_in_s)
        self.max_poison_rate = float(serving.autoscale_max_poison_rate_per_s)
        self.window_s = float(serving.autoscale_window_s)
        self.history = max(1, int(serving.autoscale_decision_history))

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "target_queue_wait_p95_ms": self.target_p95_ms,
            "burn_threshold": self.burn_threshold,
            "band_high": self.band_high,
            "band_low": self.band_low,
            "breach_ticks": self.breach_ticks,
            "slack_ticks": self.slack_ticks,
            "cooldown_out_s": self.cooldown_out_s,
            "cooldown_in_s": self.cooldown_in_s,
            "max_poison_rate_per_s": self.max_poison_rate,
            "window_s": self.window_s,
        }


def classify(policy: AutoscalePolicy, inputs: AutoscaleInputs) -> str:
    """One tick's signal: ``breach`` / ``slack`` / ``in_band``.

    Burn must clear the threshold on BOTH windows to count as a breach
    (the same both-windows rule the pager uses: fast alone is a blip,
    slow alone is old news) — and must be calm on both to count toward
    slack.
    """
    burn = min(inputs.burn_fast, inputs.burn_slow)
    p95 = inputs.queue_wait_p95_ms
    if (p95 is not None and p95 > policy.target_p95_ms * policy.band_high) \
            or burn >= policy.burn_threshold:
        return "breach"
    if (p95 is None or p95 < policy.target_p95_ms * policy.band_low) \
            and burn < policy.burn_threshold:
        return "slack"
    return "in_band"


def _healthy(policy: AutoscalePolicy, inputs: AutoscaleInputs
             ) -> Optional[str]:
    """None when the pool looks healthy, else the gating reason."""
    if inputs.open_breakers > 0:
        return "breaker_open"
    if inputs.poison_rate_per_s >= policy.max_poison_rate:
        return "poison_storm"
    return None


def decide(policy: AutoscalePolicy, state: ControllerState,
           inputs: AutoscaleInputs, now: float) -> Dict[str, Any]:
    """The pure control step: classify, sustain, gate, act.

    Mutates ``state`` (sustain counters, cooldown stamp) and returns the
    full decision record — the exact dict the decision ring keeps and
    ``/debug/autoscale`` serves.
    """
    signal = classify(policy, inputs)
    if signal == "breach":
        state.breach_ticks += 1
        state.slack_ticks = 0
    elif signal == "slack":
        state.slack_ticks += 1
        state.breach_ticks = 0
    else:
        state.breach_ticks = 0
        state.slack_ticks = 0

    since_action = (None if state.last_action_t is None
                    else now - state.last_action_t)
    cool_out = (since_action is not None
                and since_action < policy.cooldown_out_s)
    cool_in = (since_action is not None
               and since_action < policy.cooldown_in_s)

    action, reason = ACTION_HOLD, "in_band"
    unhealthy = _healthy(policy, inputs)
    if state.breach_ticks >= policy.breach_ticks:
        if unhealthy is not None:
            # The load signal says "add capacity"; the health signal says
            # the capacity we have is being poisoned or is flapping.
            # Health wins: never scale into an incident.
            reason = unhealthy
        elif inputs.live_replicas >= policy.max_replicas:
            reason = "at_max"
        elif cool_out:
            reason = "cooldown_out"
        elif inputs.booting_replicas > 0:
            # A replica is already warming — adding another before the
            # first one lands is how controllers overshoot.
            reason = "boot_in_progress"
        elif not inputs.can_add:
            reason = "no_engine_factory"
        else:
            action, reason = ACTION_SCALE_OUT, "sustained_breach"
    elif state.slack_ticks >= policy.slack_ticks:
        if unhealthy is not None:
            reason = unhealthy
        elif inputs.live_replicas <= policy.min_replicas:
            reason = "at_min"
        elif cool_in:
            reason = "cooldown_in"
        else:
            action, reason = ACTION_SCALE_IN, "sustained_slack"
    elif signal == "breach":
        reason = "breach_building"
    elif signal == "slack":
        reason = "slack_building"

    if action != ACTION_HOLD:
        state.last_action_t = now
        state.last_action = action
        state.breach_ticks = 0
        state.slack_ticks = 0

    target = inputs.live_replicas
    if action == ACTION_SCALE_OUT:
        target += 1
    elif action == ACTION_SCALE_IN:
        target -= 1
    target = min(max(target, policy.min_replicas), policy.max_replicas)

    return {
        "t": round(now, 3),
        "action": action,
        "reason": reason,
        "signal": signal,
        "target_replicas": target,
        "inputs": dataclasses.asdict(inputs),
        "thresholds": {
            "target_p95_ms": policy.target_p95_ms,
            "breach_above_ms": policy.target_p95_ms * policy.band_high,
            "slack_below_ms": policy.target_p95_ms * policy.band_low,
            "burn_threshold": policy.burn_threshold,
            "breach_ticks_needed": policy.breach_ticks,
            "slack_ticks_needed": policy.slack_ticks,
            "max_poison_rate_per_s": policy.max_poison_rate,
        },
        "counters": {"breach_ticks": state.breach_ticks,
                     "slack_ticks": state.slack_ticks},
        "cooldown": {
            "since_last_action_s": (None if since_action is None
                                    else round(since_action, 3)),
            "out_active": cool_out,
            "in_active": cool_in,
        },
    }


class Autoscaler:
    """The loop's plumbing around :func:`decide`: sensor collection from
    live instruments, actuation against the pool, and the decision ring.

    ``tick()`` is called from the app's sampler tick (the same place
    ``pool.probe()`` rides) and returns sample keys for the timeseries —
    the autoscaler owns no thread. ``engine_factory`` builds the engine
    for a scale-out (sharing params/AOT cache with the boot replicas);
    without one the controller still observes and records but can only
    scale in.
    """

    def __init__(self, pool, serving: "ServingConfig", *,
                 slos=None, queue=None,
                 engine_factory: Optional[Callable[[], Any]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._serving = serving
        self.policy = AutoscalePolicy(serving)
        self.pool = pool
        self._slos = slos  # SloEvaluator (or None in bare tests)
        self._queue = queue
        self._engine_factory = engine_factory
        self._clock = clock
        self.state = ControllerState()
        # Bounded by construction (the VMT115 contract): the debug
        # endpoint serves the tail, history beyond it is the recorder's
        # and the counter's job.
        self.decisions: deque = deque(maxlen=self.policy.history)
        # (t, vmt_poison_jobs_total) marks for the windowed poison rate.
        self._poison_marks: deque = deque(maxlen=256)
        self._lock = threading.Lock()
        self.target_replicas = self._live_count()
        TARGET_REPLICAS.set(float(self.target_replicas))

    # ------------------------------------------------------------ sensors
    def _live_count(self) -> int:
        return sum(1 for r in self.pool.replicas_info()
                   if r["state"] != "dead")

    def _poison_rate(self, now: float) -> float:
        total = float(obs.POISON_COUNTER.value())
        marks = self._poison_marks
        marks.append((now, total))
        horizon = now - self.policy.window_s
        oldest = None
        for t, v in marks:
            if t >= horizon:
                oldest = (t, v)
                break
        if oldest is None or now - oldest[0] <= 0:
            return 0.0
        return max(0.0, (total - oldest[1]) / (now - oldest[0]))

    def observe(self, now: Optional[float] = None) -> AutoscaleInputs:
        """One sensor sweep over the live instruments."""
        if now is None:
            now = self._clock()
        p95 = obs.QUEUE_WAIT.window_percentile(0.95, self.policy.window_s)
        burn_fast = burn_slow = worst = 0.0
        if self._slos is not None:
            for slo in self._slos.slos:
                f, _, _ = slo.burn_rate(self._slos.fast_window_s)
                s, _, _ = slo.burn_rate(self._slos.slow_window_s)
                if min(f, s) >= worst:
                    worst = min(f, s)
                    burn_fast, burn_slow = f, s
        infos = self.pool.replicas_info()
        depth = 0
        if self._queue is not None:
            try:
                depth = int(self._queue.counts().get("pending", 0))
            except Exception:  # noqa: BLE001 — a sensor must not kill the tick
                depth = 0
        return AutoscaleInputs(
            queue_wait_p95_ms=p95,
            burn_fast=burn_fast,
            burn_slow=burn_slow,
            ready_replicas=sum(1 for r in infos if r["state"] == "ready"),
            live_replicas=sum(1 for r in infos if r["state"] != "dead"),
            booting_replicas=sum(1 for r in infos
                                 if r["state"] in ("booting", "warming")),
            open_breakers=sum(1 for r in infos
                              if r.get("breaker") == "open"),
            poison_rate_per_s=self._poison_rate(now),
            queue_depth=depth,
            can_add=self._engine_factory is not None,
        )

    # ------------------------------------------------------------ the loop
    def tick(self) -> Dict[str, float]:
        """One control step; returns sample keys for the timeseries."""
        now = self._clock()
        inputs = self.observe(now)
        with self._lock:
            decision = decide(self.policy, self.state, inputs, now)
            self.decisions.append(decision)
            self.target_replicas = decision["target_replicas"]
        DECISIONS.inc(action=decision["action"], reason=decision["reason"])
        TARGET_REPLICAS.set(float(self.target_replicas))
        action = decision["action"]
        if action != ACTION_HOLD or decision["reason"] in (
                "breaker_open", "poison_storm"):
            # Flight-recorder trigger: actions and health-gated holds are
            # the moments an operator replays (recorder_min_interval_s
            # already throttles repeats).
            obs.record_event("autoscale", action=action,
                             reason=decision["reason"],
                             target_replicas=self.target_replicas,
                             queue_wait_p95_ms=inputs.queue_wait_p95_ms,
                             burn_fast=round(inputs.burn_fast, 3),
                             burn_slow=round(inputs.burn_slow, 3),
                             poison_rate_per_s=round(
                                 inputs.poison_rate_per_s, 3))
        if action == ACTION_SCALE_OUT:
            self._do_scale_out(decision)
        elif action == ACTION_SCALE_IN:
            self._do_scale_in(decision)
        return {
            "autoscale_target_replicas": float(self.target_replicas),
            "autoscale_breach_ticks": float(self.state.breach_ticks),
            "autoscale_slack_ticks": float(self.state.slack_ticks),
            "autoscale_queue_wait_p95_ms": float(
                inputs.queue_wait_p95_ms or 0.0),
            "autoscale_burn": float(min(inputs.burn_fast,
                                        inputs.burn_slow)),
            "autoscale_poison_rate_per_s": float(inputs.poison_rate_per_s),
        }

    # --------------------------------------------------------- actuators
    def _do_scale_out(self, decision: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        try:
            rep = self.pool.add_replica(self._engine_factory(), warm=True)
        except Exception as e:  # noqa: BLE001 — a failed boot must not
            decision["actuated"] = {"error": repr(e)}  # kill the sampler
            DECISIONS.inc(action="scale_out_failed", reason="actuator_error")
            obs.record_event("autoscale_actuator_failed",
                             action=ACTION_SCALE_OUT, error=repr(e))
            return
        boot_s = round(time.perf_counter() - t0, 3)
        decision["actuated"] = {"replica": rep.name, "state": rep.state,
                                "boot_s": boot_s}
        if rep.state == "dead":
            # add_replica contains boot failures as a DEAD replica; the
            # controller must not read that as capacity.
            DECISIONS.inc(action="scale_out_failed", reason="boot_failed")

    def _do_scale_in(self, decision: Dict[str, Any]) -> None:
        try:
            info = self.pool.retire_replica()
        except (ValueError, TimeoutError, KeyError) as e:
            decision["actuated"] = {"error": repr(e)}
            DECISIONS.inc(action="scale_in_failed", reason="actuator_error")
            obs.record_event("autoscale_actuator_failed",
                             action=ACTION_SCALE_IN, error=repr(e))
            return
        decision["actuated"] = {"replica": info["name"],
                                "drain_s": info["drain_s"]}

    # ------------------------------------------------------ introspection
    def debug_payload(self, limit: int = 50) -> Dict[str, Any]:
        """The ``GET /debug/autoscale`` body: policy, live state, and the
        last-N decision records, newest last."""
        with self._lock:
            recs = list(self.decisions)[-max(1, int(limit)):]
            state = {
                "breach_ticks": self.state.breach_ticks,
                "slack_ticks": self.state.slack_ticks,
                "last_action": self.state.last_action,
                "last_action_t": self.state.last_action_t,
            }
        return {
            "enabled": self.policy.enabled,
            "target_replicas": self.target_replicas,
            "actual_replicas": self._live_count(),
            "policy": self.policy.snapshot(),
            "state": state,
            "decisions": recs,
        }

    def decisions_list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.decisions)
