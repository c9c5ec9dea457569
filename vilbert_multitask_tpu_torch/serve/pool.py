"""Replica pool: health-gated multi-replica serving behind the queue seam.

The pool owns N :class:`~vilbert_multitask_tpu_torch.engine.runtime.InferenceEngine`
replicas (separate devices, mesh shards, or plain CPU threads in dryrun) and
presents the SAME surface the single-engine stack already programs against —
``ServeWorker(engine=pool)`` and ``app.engine = pool`` work unchanged.  What
changes is what happens underneath every dispatch:

- **checkout/checkin** — the one seam through which engine handles may leave
  the pool.  ``checkout()`` blocks for a ready replica (least-loaded among
  ready; a degraded replica is admitted only while its breaker is half-open,
  which IS the recovery probe), ``checkin(ok=...)`` returns the handle and
  feeds the replica's circuit breaker.  Holding a handle outside this seam
  is a replica-affinity leak (vmtlint VMT117).
- **health state machine** — ``booting → warming → ready`` at boot, then
  ``ready ⇄ degraded`` as the per-replica breaker opens/recovers,
  ``draining → warming → ready`` through a rolling swap, and ``dead`` when
  the replica is killed.  :meth:`probe` rides the obs sampler cadence (the
  pool spawns no threads of its own) and publishes ``vmt_replica_state``.
- **failover** — a replica-caused dispatch failure raises
  :class:`ReplicaFailover`; the worker answers with ``queue.release()`` (the
  abandon path: no attempt charged, job redelivered elsewhere).  Exactly one
  terminal per job survives a replica kill because streamed members keep
  their results and only unstreamed members fail over.  Poison jobs that
  kill every replica are bounded by the queue's ``delivery_count``
  quarantine, not by the pool.
- **rolling swap** — :meth:`rolling_swap` updates params one replica at a
  time: wait for another ready replica, drain this one, load, flip back to
  ready.  Zero downtime: the pool never passes through a zero-ready state
  (for n >= 2), and HTTP ingest never blocks on it anyway (enqueue-only).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.resilience import (
    BreakerBoard,
    DeadlineExceeded,
    ReplicaKilled,
)

__all__ = [
    "STATE_BOOTING", "STATE_WARMING", "STATE_READY", "STATE_DEGRADED",
    "STATE_DRAINING", "STATE_DEAD",
    "NoReadyReplica", "ReplicaFailover", "Replica", "ReplicaPool",
]

# Health states, with the gauge codes `vmt_replica_state` publishes.
STATE_BOOTING = "booting"
STATE_WARMING = "warming"
STATE_READY = "ready"
STATE_DEGRADED = "degraded"
STATE_DRAINING = "draining"
STATE_DEAD = "dead"

STATE_CODES: Dict[str, int] = {
    STATE_BOOTING: 0, STATE_WARMING: 1, STATE_READY: 2,
    STATE_DEGRADED: 3, STATE_DRAINING: 4, STATE_DEAD: 5,
}


class NoReadyReplica(RuntimeError):
    """checkout() timed out with no replica admitting work.

    Transient by construction (replicas recover via half-open probes or a
    swap completes) — callers treat it like a replica failure: release the
    job and let redelivery find a healthier moment.
    """


class ReplicaFailover(RuntimeError):
    """A dispatch failed for replica-local reasons; the job must move.

    Carries the replica name for the ``requeued`` push-frame provenance
    stamp.  The worker's answer is ``queue.release()`` — redelivery without
    charging an attempt — because the JOB is presumed innocent until its
    ``delivery_count`` says otherwise (poison quarantine lives in the
    queue, not here).
    """

    def __init__(self, message: str, replica: str = "?"):
        super().__init__(message)
        self.replica = replica


class Replica:
    """One engine plus the pool-side health bookkeeping around it."""

    def __init__(self, name: str, engine, breaker):
        self.name = name
        self.engine = engine
        self.breaker = breaker
        self.state = STATE_BOOTING
        self.inflight = 0
        self.killed = False
        self.dispatches = 0       # checkins with ok=True
        self.failures = 0         # checkins with ok=False
        self.failovers = 0        # jobs this replica bounced via failover
        self.swaps = 0            # rolling param swaps survived
        self.last_error = ""

    def snapshot(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "state": self.state,
            "breaker": self.breaker.state,
            "inflight": self.inflight,
            "dispatches": self.dispatches,
            "failures": self.failures,
            "failovers": self.failovers,
            "swaps": self.swaps,
            "last_error": self.last_error,
        }


class ReplicaPool:
    """N engines behind the single-engine facade the serve plane expects.

    Host-side work that has nothing to do with device placement —
    tokenisation (:meth:`prepare`/:meth:`prepare_from_store`), chunk
    planning, config access — delegates to replica 0; every engine shares
    the config/tokenizer/store, so any replica would answer identically.
    Device dispatch (:meth:`run`/:meth:`run_many`) goes through
    checkout/checkin and may land on any ready replica.
    """

    def __init__(self, engines: Sequence[Any], serving=None,
                 clock: Callable[[], float] = time.monotonic):
        if not engines:
            raise ValueError("ReplicaPool needs at least one engine")
        self._serving = serving or engines[0].cfg.serving
        self._clock = clock
        self._board = BreakerBoard(
            "replica",
            failure_threshold=self._serving.pool_breaker_failure_threshold,
            window_s=self._serving.pool_breaker_window_s,
            reset_timeout_s=self._serving.pool_breaker_reset_timeout_s,
        )
        self.replicas: List[Replica] = [
            self._make_replica(i, eng) for i, eng in enumerate(engines)
        ]
        self._cond = threading.Condition()
        self._swap_lock = threading.Lock()
        # Per-replica dispatch outcome histograms feed the per-replica
        # availability SLOs (window_count with the replica label).
        self.dispatch_ms = obs.REGISTRY.histogram(
            "vmt_replica_dispatch_ms",
            "Successful pool dispatches per replica (ms).",
            labelnames=("replica",))
        self.dispatch_fail = obs.REGISTRY.histogram(
            "vmt_replica_dispatch_failures",
            "Failed pool dispatches per replica (for availability SLOs).",
            labelnames=("replica",))
        for rep in self.replicas:
            obs.REPLICA_STATE.set(STATE_CODES[rep.state], replica=rep.name)

    def _make_replica(self, i: int, eng) -> Replica:
        name = getattr(eng, "replica_id", None) or f"r{i}"
        if getattr(eng, "replica_id", None) is None:
            try:
                eng.replica_id = name
            except AttributeError:
                pass
        return Replica(name, eng, self._board.get(name))

    # ------------------------------------------------------------------
    # Engine facade: host-side delegation to replica 0.

    @property
    def _host(self):
        return self.replicas[0].engine

    @property
    def cfg(self):
        return self._host.cfg

    @property
    def mesh(self):
        return self._host.mesh

    @property
    def pallas_enabled(self) -> bool:
        return bool(getattr(self._host, "pallas_enabled", False))

    @property
    def kernel_fallback(self) -> bool:
        return bool(getattr(self._host, "kernel_fallback", False))

    def prepare(self, *args, **kwargs):
        return self._host.prepare(*args, **kwargs)

    def prepare_from_store(self, *args, **kwargs):
        return self._host.prepare_from_store(*args, **kwargs)

    def chunk_plan(self, *args, **kwargs):
        return self._host.chunk_plan(*args, **kwargs)

    def decode(self, *args, **kwargs):
        return self._host.decode(*args, **kwargs)

    @property
    def input_cache_stats(self) -> Dict[str, int]:
        return self._host.input_cache_stats

    # ------------------------------------------------------------------
    # Boot.

    def warmup(self, buckets=None, parallel=None) -> None:
        """Warm every replica, walking each through booting→warming→ready.

        Each replica first tries the AOT boot-from-cache path
        (:meth:`_boot_from_cache`): on a warm cache every program
        deserializes and warmup is SKIPPED — replicas come up in seconds.
        Otherwise serial warmup, as before: with the persistent
        compilation cache on, replica 1..n-1 hit the cache replica 0
        populated, so serial warmup costs ~one compile total, and the pool
        becomes partially available as soon as the first replica flips
        ready.
        """
        for rep in self.replicas:
            if rep.state == STATE_DEAD:
                continue
            self._set_state(rep, STATE_WARMING)
            try:
                if not self._boot_from_cache(rep, buckets):
                    rep.engine.warmup(buckets=buckets, parallel=parallel)
            except Exception as e:  # noqa: BLE001 — a bad replica must not
                rep.last_error = repr(e)  # sink the whole boot.
                self._set_state(rep, STATE_DEAD)
                obs.record_event("replica_boot_failed", replica=rep.name,
                                 error=repr(e))
                continue
            self._set_state(rep, STATE_READY)

    def _boot_from_cache(self, rep: Replica, buckets=None) -> bool:
        """Try the engine's AOT warm-boot path; True means every warmup
        program deserialized from the executable cache and warmup can be
        skipped.  Soft: engines without the capability (test doubles,
        cache off) or any loader failure → False → plain warmup."""
        boot = getattr(rep.engine, "boot_from_cache", None)
        if boot is None:
            return False
        try:
            ok = bool(boot(buckets=buckets))
        except Exception as e:  # noqa: BLE001 — cache trouble must never
            obs.record_event(       # be worse than a cold boot.
                "replica_cache_boot_failed", replica=rep.name,
                error=repr(e))
            return False
        if ok:
            obs.record_event("replica_boot_from_cache", replica=rep.name)
        return ok

    def add_replica(self, engine, warm: bool = True) -> Replica:
        """Scale-out: attach one more engine to the live pool (the
        autoscaler's actuator, ROADMAP item 2).  The new replica boots
        from the AOT cache when it can — seconds, not minutes — and only
        flips ready once warm; in-flight traffic on existing replicas is
        untouched.  With ``warm=False`` the replica goes straight to
        ready and pays compiles on first dispatch (the ``--no-warmup``
        contract)."""
        with self._cond:
            names = {r.name for r in self.replicas}
            i = len(self.replicas)
            while f"r{i}" in names:
                i += 1
        rep = self._make_replica(i, engine)
        with self._cond:
            self.replicas.append(rep)
        obs.REPLICA_STATE.set(STATE_CODES[rep.state], replica=rep.name)
        if not warm:
            self._set_state(rep, STATE_READY)
            return rep
        self._set_state(rep, STATE_WARMING)
        try:
            if not self._boot_from_cache(rep, None):
                rep.engine.warmup()
        except Exception as e:  # noqa: BLE001 — same containment as warmup()
            rep.last_error = repr(e)
            self._set_state(rep, STATE_DEAD)
            obs.record_event("replica_boot_failed", replica=rep.name,
                             error=repr(e))
            return rep
        self._set_state(rep, STATE_READY)
        return rep

    def mark_ready(self) -> None:
        """No-warmup boot path: flip still-booting replicas straight to
        ready (the first live request per bucket then pays the compile —
        same debug-only contract as ``--no-warmup``)."""
        with self._cond:
            for rep in self.replicas:
                if rep.state == STATE_BOOTING:
                    self._set_state_locked(rep, STATE_READY)
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # The checkout/checkin seam.

    def _admissible(self, rep: Replica) -> bool:
        if rep.killed or rep.inflight >= \
                self._serving.pool_max_inflight_per_replica:
            return False
        if rep.state == STATE_READY:
            return True
        # A degraded replica takes work only while its breaker is probing
        # (half-open) — that single dispatch IS the recovery probe.
        return rep.state == STATE_DEGRADED and rep.breaker.state == "half_open"

    def checkout(self, timeout_s: Optional[float] = None) -> Replica:
        """Block for the least-loaded admissible replica.

        Raises :class:`NoReadyReplica` on timeout.  Engine handles obtained
        here must return through :meth:`checkin` in the same function
        (vmtlint VMT117 enforces this in serve/).
        """
        if timeout_s is None:
            timeout_s = self._serving.pool_checkout_timeout_s
        deadline = self._clock() + timeout_s
        with self._cond:
            while True:
                ready = [r for r in self.replicas if self._admissible(r)]
                if ready:
                    rep = min(ready, key=lambda r: (r.inflight, r.dispatches))
                    rep.inflight += 1
                    return rep
                remaining = deadline - self._clock()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    raise NoReadyReplica(
                        f"no ready replica within {timeout_s:.1f}s "
                        f"(states: {[r.state for r in self.replicas]})")

    def checkin(self, rep: Replica, ok: bool = True,
                error: Optional[BaseException] = None,
                elapsed_ms: float = 0.0) -> None:
        """Return a checked-out replica and feed its breaker."""
        if ok:
            rep.breaker.record_success()
        else:
            rep.breaker.record_failure()
        with self._cond:
            rep.inflight = max(0, rep.inflight - 1)
            if ok:
                rep.dispatches += 1
                self.dispatch_ms.observe(elapsed_ms, replica=rep.name)
                if rep.state == STATE_DEGRADED:
                    # Successful half-open probe: breaker closed, recover.
                    self._set_state_locked(rep, STATE_READY)
            else:
                rep.failures += 1
                rep.last_error = repr(error) if error is not None else ""
                self.dispatch_fail.observe(elapsed_ms, replica=rep.name)
                if (isinstance(error, ReplicaKilled) or rep.killed
                        or getattr(rep.engine, "killed", False)):
                    rep.killed = True
                    self._set_state_locked(rep, STATE_DEAD)
                elif rep.breaker.state != "closed" and \
                        rep.state in (STATE_READY, STATE_DEGRADED):
                    self._set_state_locked(rep, STATE_DEGRADED)
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # Dispatch: the facade the legacy (non-scheduler) worker path uses.

    def run(self, req, **kwargs):
        rep = self.checkout()
        t0 = time.perf_counter()
        try:
            out = rep.engine.run(req, **kwargs)
        except DeadlineExceeded:
            # The JOB ran out of budget — the replica is fine.
            self.checkin(rep, ok=True,
                         elapsed_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            self.checkin(rep, ok=False, error=e,
                         elapsed_ms=(time.perf_counter() - t0) * 1e3)
            rep.failovers += 1
            raise ReplicaFailover(
                f"replica {rep.name} failed mid-dispatch: {e!r}",
                replica=rep.name) from e
        self.checkin(rep, ok=True,
                     elapsed_ms=(time.perf_counter() - t0) * 1e3)
        return out

    def run_many(self, reqs, *, on_result=None, **kwargs):
        rep = self.checkout()
        t0 = time.perf_counter()
        try:
            out = rep.engine.run_many(reqs, on_result=on_result, **kwargs)
        except DeadlineExceeded:
            self.checkin(rep, ok=True,
                         elapsed_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            self.checkin(rep, ok=False, error=e,
                         elapsed_ms=(time.perf_counter() - t0) * 1e3)
            rep.failovers += 1
            raise ReplicaFailover(
                f"replica {rep.name} failed mid-batch: {e!r}",
                replica=rep.name) from e
        self.checkin(rep, ok=True,
                     elapsed_ms=(time.perf_counter() - t0) * 1e3)
        return out

    # ------------------------------------------------------------------
    # Health: probe rides the obs sampler; kill simulates silent death.

    def probe(self) -> Dict[str, float]:
        """One health sweep: reconcile states, publish gauges, sample.

        Called from the app's sampler tick (and from :meth:`live_stats`),
        so a dead replica is visible in /healthz within one sampler
        cadence without the pool owning a thread.
        """
        sample: Dict[str, float] = {}
        with self._cond:
            for rep in self.replicas:
                if rep.killed or getattr(rep.engine, "killed", False):
                    rep.killed = True
                    if rep.state != STATE_DEAD:
                        self._set_state_locked(rep, STATE_DEAD)
                elif rep.state == STATE_READY and \
                        rep.breaker.state == "open":
                    self._set_state_locked(rep, STATE_DEGRADED)
                obs.REPLICA_STATE.set(STATE_CODES[rep.state],
                                      replica=rep.name)
                sample[f"replica_{rep.name}_state"] = \
                    float(STATE_CODES[rep.state])
                sample[f"replica_{rep.name}_inflight"] = float(rep.inflight)
                sample[f"replica_{rep.name}_dispatches_total"] = \
                    float(rep.dispatches)
                sample[f"replica_{rep.name}_failovers_total"] = \
                    float(rep.failovers)
            self._cond.notify_all()
        sample["pool_ready_replicas"] = float(self.ready_count())
        sample["pool_dead_replicas"] = float(
            sum(1 for r in self.replicas if r.state == STATE_DEAD))
        sample["pool_failovers_total"] = float(
            sum(r.failovers for r in self.replicas))
        return sample

    def kill(self, name: str) -> Replica:
        """Chaos hook: mark a replica dead-but-silent.

        Sets the engine's ``killed`` flag so the NEXT forward raises
        :class:`ReplicaKilled` mid-batch — the pool discovers the death
        through dispatch failure or the next probe, exactly like a real
        silent hardware loss.  The state flip happens there, not here.
        """
        rep = self._by_name(name)
        try:
            rep.engine.killed = True
        except AttributeError:
            rep.killed = True  # engines without the flag die loudly
        obs.record_event("replica_kill", replica=name)
        return rep

    # ------------------------------------------------------------------
    # Rolling checkpoint swap.

    def rolling_swap(self, load_fn: Callable[[Any], None],
                     drain_timeout_s: Optional[float] = None
                     ) -> Dict[str, Any]:
        """Update every live replica's params with zero downtime.

        Per replica: wait for another live replica to be ready (so the
        pool never passes through zero-ready, n >= 2), stop admitting work
        (``draining``), wait out the in-flight dispatch, load
        (``warming``), flip back to ``ready``.  ``load_fn(engine)`` does
        the actual load — typically ``engine.load_params(new_tree)``,
        which is recompile-free for same-shape trees and re-applies the
        engine's param-storage cast (an int8 engine re-quantizes an
        incoming f32 tree; an already-quantized tree passes through).
        """
        if drain_timeout_s is None:
            drain_timeout_s = self._serving.pool_swap_drain_timeout_s
        report: Dict[str, Any] = {"replicas": [], "skipped": [],
                                  "min_ready_seen": len(self.replicas)}

        def note_ready() -> None:
            report["min_ready_seen"] = min(report["min_ready_seen"],
                                           self.ready_count())

        with self._swap_lock:
            for rep in list(self.replicas):
                if rep.state == STATE_DEAD:
                    report["skipped"].append(rep.name)
                    continue
                others = [r for r in self.replicas
                          if r is not rep and r.state != STATE_DEAD]
                with self._cond:
                    if others:
                        # Zero-downtime invariant: never drain the last
                        # ready replica.
                        self._wait_locked(
                            lambda: any(r.state == STATE_READY
                                        for r in others),
                            drain_timeout_s,
                            f"no other replica became ready to cover "
                            f"{rep.name}'s swap")
                    self._set_state_locked(rep, STATE_DRAINING)
                    note_ready()
                    self._wait_locked(lambda: rep.inflight == 0,
                                      drain_timeout_s,
                                      f"{rep.name} did not drain")
                    self._set_state_locked(rep, STATE_WARMING)
                note_ready()
                t0 = time.perf_counter()
                try:
                    load_fn(rep.engine)
                except Exception as e:  # noqa: BLE001 — bad checkpoint must
                    rep.last_error = repr(e)  # not take the replica down
                    self._set_state(rep, STATE_DEGRADED)  # with it.
                    obs.record_event("replica_swap_failed", replica=rep.name,
                                     error=repr(e))
                    raise
                rep.swaps += 1
                # A same-shape load_params keeps every compiled program;
                # but if the swap handed this replica a cold engine (no
                # compiled programs — e.g. a config-bumped rebuild), pull
                # its executables from the AOT cache before flipping ready
                # so the first post-swap dispatch doesn't pay a compile.
                try:
                    cold = not rep.engine.live_stats().get(
                        "engine_compiled_programs", 0.0)
                except Exception:  # noqa: BLE001 — doubles without
                    cold = False   # live_stats() can't be cold-detected.
                if cold:
                    self._boot_from_cache(rep, None)
                self._set_state(rep, STATE_READY)
                note_ready()
                obs.record_event("replica_swap", replica=rep.name,
                                 load_s=round(time.perf_counter() - t0, 3))
                report["replicas"].append(
                    {"name": rep.name,
                     "load_s": round(time.perf_counter() - t0, 3)})
        return report

    # ------------------------------------------------------------------
    # Scale-in: drain-then-remove (the autoscaler's shrink actuator).

    def retire_replica(self, name: Optional[str] = None,
                       drain_timeout_s: Optional[float] = None
                       ) -> Dict[str, Any]:
        """Drain one replica and REMOVE it from the pool — the inverse of
        :meth:`add_replica`.

        Reuses the rolling-swap DRAINING machinery: the victim stops
        admitting work, the in-flight dispatches finish, then the replica
        leaves ``self.replicas`` and its ``vmt_replica_state`` series is
        withdrawn — a retired replica must not haunt /healthz or fleet
        views as a ghost. Unnamed, the least-loaded READY replica is
        picked (same ordering as checkout, inverted). Refuses to shrink
        the live pool below ``autoscale_min_replicas`` or to retire the
        last READY replica; a drain timeout puts the victim back into
        rotation rather than stranding it DRAINING.
        """
        if drain_timeout_s is None:
            drain_timeout_s = self._serving.pool_swap_drain_timeout_s
        min_live = max(1, int(self._serving.autoscale_min_replicas))
        # Serialize against rolling swaps: both walk replicas through
        # DRAINING, and a swap iterating a list the retire just mutated
        # is the kind of race this lock exists for.
        if not self._swap_lock.acquire(timeout=drain_timeout_s):
            raise TimeoutError(
                f"retire stalled: a rolling swap held the pool for "
                f"{drain_timeout_s:.1f}s")
        t0 = time.perf_counter()
        try:
            with self._cond:
                if name is None:
                    ready = [r for r in self.replicas
                             if r.state == STATE_READY]
                    if not ready:
                        raise ValueError("no READY replica to retire")
                    rep = min(ready,
                              key=lambda r: (r.inflight, r.dispatches))
                else:
                    rep = self._by_name(name)
                live = sum(1 for r in self.replicas
                           if r.state != STATE_DEAD)
                if rep.state != STATE_DEAD and live <= min_live:
                    raise ValueError(
                        f"refusing to retire {rep.name}: {live} live "
                        f"replica(s) <= autoscale_min_replicas="
                        f"{min_live}")
                if rep.state == STATE_READY and not any(
                        r.state == STATE_READY for r in self.replicas
                        if r is not rep):
                    raise ValueError(
                        f"refusing to retire {rep.name}: it is the "
                        f"last READY replica")
                self._set_state_locked(rep, STATE_DRAINING)
                self._cond.notify_all()
                try:
                    self._wait_locked(
                        lambda: rep.inflight == 0, drain_timeout_s,
                        f"{rep.name} did not drain for retirement")
                except TimeoutError:
                    # Abandon the retirement, not the replica: back into
                    # rotation rather than stuck DRAINING forever.
                    self._set_state_locked(rep, STATE_READY)
                    self._cond.notify_all()
                    raise
                self.replicas.remove(rep)
                self._cond.notify_all()
        finally:
            self._swap_lock.release()
        # Withdraw the state series AFTER removal — probe() iterates
        # self.replicas, so it can no longer re-publish the ghost.
        obs.REPLICA_STATE.remove(replica=rep.name)
        drain_s = round(time.perf_counter() - t0, 3)
        obs.record_event("replica_retired", replica=rep.name,
                         drain_s=drain_s, dispatches=rep.dispatches)
        return {"name": rep.name, "drain_s": drain_s,
                "dispatches": rep.dispatches, "state": rep.state}

    # ------------------------------------------------------------------
    # Introspection (for /healthz, the sampler, and tests).

    def ready_count(self) -> int:
        return sum(1 for r in self.replicas if r.state == STATE_READY)

    def replicas_info(self) -> List[Dict[str, Any]]:
        with self._cond:
            return [r.snapshot() for r in self.replicas]

    def live_stats(self) -> Dict[str, float]:
        """Per-replica engine stats prefixed by name, plus pool health.

        This is what the sampler tick collects (the app passes
        ``engine.live_stats`` as the stats_fn), so probing piggybacks on
        the existing cadence.
        """
        out: Dict[str, float] = {}
        for i, rep in enumerate(self.replicas):
            try:
                stats = rep.engine.live_stats()
            except Exception:  # noqa: BLE001 — a dying replica's stats are
                stats = {}     # not worth failing the sampler tick over.
            for k, v in stats.items():
                out[f"{rep.name}_{k}"] = v
            if i == 0:
                # Replica 0's raw keys stay un-prefixed too so existing
                # dashboards (and tests) keyed on e.g. ``engine_compiled``
                # keep working.
                out.update(stats)
        out.update(self.probe())
        return out

    # ------------------------------------------------------------------
    # Internals.

    def _by_name(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    def _set_state(self, rep: Replica, state: str) -> None:
        with self._cond:
            self._set_state_locked(rep, state)
            self._cond.notify_all()

    def _set_state_locked(self, rep: Replica, state: str) -> None:
        prev, rep.state = rep.state, state
        obs.REPLICA_STATE.set(STATE_CODES[state], replica=rep.name)
        if prev != state:
            obs.record_event("replica_state", replica=rep.name,
                             prev=prev, state=state)

    def _wait_locked(self, pred: Callable[[], bool], timeout_s: float,
                     what: str) -> None:
        deadline = self._clock() + timeout_s
        while not pred():
            remaining = deadline - self._clock()
            if remaining <= 0 or not self._cond.wait(timeout=remaining):
                if not pred():
                    raise TimeoutError(
                        f"rolling swap stalled: {what} "
                        f"within {timeout_s:.1f}s")
