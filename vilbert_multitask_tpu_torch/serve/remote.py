"""Remote worker mode: drain the job queue over HTTP from another host.

Counterpart of ``vilbert_multitask_tpu/serve/remote.py``. The durable queue
is an embedded sqlite file on the web host; this module gives it a network
face: a worker anywhere reaches the web host's ``/worker/*`` endpoints
(serve/http_api.py) to claim jobs, record audit rows, save answers and push
websocket frames, while inference runs on the worker's own card.

:class:`ServeWorker` talks to exactly three collaborators: queue
(claim/ack/nack), store (create_question/save_answer) and hub (publish).
The remote mode implements those three interfaces as thin HTTP shims, so
the whole job pipeline (intake, micro-batching, failure handling,
rendering) is the same code serving locally and remotely.

Grounding-box rendering reads the source image from local disk; on a
worker host without the media volume the render step degrades gracefully
(no result_images), as the local path does when an image file is missing.

Run: ``python -m vilbert_multitask_tpu_torch.serve.remote --url
http://web:8400`` (on the card; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import signal
import threading
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

from vilbert_multitask_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from vilbert_multitask_tpu_torch.resilience.faults import fault_point
from vilbert_multitask_tpu_torch.serve.queue import Job

log = logging.getLogger(__name__)

# Transient transport failures worth retrying (web-host restart, TCP blip).
# CircuitOpenError and FaultInjected both subclass ConnectionError, so a
# breaker-shed or injected call takes the same handling as real loss.
_NET_ERRORS = (urllib.error.URLError, ConnectionError, TimeoutError, OSError)


class WorkerApiClient:
    """JSON-over-HTTP client for the web host's ``/worker/*`` endpoints.

    Network errors retry through the shared :class:`RetryPolicy` — full
    jitter, so N workers that lost the web host together do NOT hammer it
    back in lockstep when it returns (the old hand-rolled loop here slept
    ``base * 2**attempt`` un-jittered: a thundering herd). A web-host
    restart or TCP blip must not kill a worker that took minutes to
    warm up; the :class:`CircuitBreaker` makes a DEAD web host cheap to
    wait out (fail-fast instead of a connect timeout per call). HTTP
    *status* errors (401 bad token, 400 bad request) do NOT retry: they
    are deterministic and the caller needs to see them.
    """

    def __init__(self, base_url: str, *, token: Optional[str] = None,
                 timeout_s: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        self.retry = retry or RetryPolicy()
        self.breaker = breaker or CircuitBreaker(name="remote.transport")

    def post(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        def attempt() -> Dict[str, Any]:
            # Fault site BEFORE the request: an injected flap models the
            # connection dying, never a half-applied server-side effect.
            fault_point("remote.post")
            req = urllib.request.Request(
                self.base_url + path,
                data=json.dumps(payload).encode(),
                headers={
                    "Content-Type": "application/json",
                    **({"Authorization": f"Bearer {self.token}"}
                       if self.token else {}),
                },
                method="POST",
            )
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                return json.loads(resp.read() or b"{}")

        return self.retry.call(
            attempt, site="remote.post", retry_on=_NET_ERRORS,
            # HTTPError subclasses URLError: without this it would retry.
            no_retry=(urllib.error.HTTPError,), breaker=self.breaker)


class RemoteQueue:
    """DurableQueue's consumer interface over HTTP (claim/ack/nack/release).

    Failure posture follows at-least-once delivery: a claim that can't reach
    the web host reports "queue drained" (the loop sleeps and retries); a
    lost ack/nack is swallowed with a warning — the visibility timeout
    redelivers the job, which is the same guarantee the local sqlite queue
    gives a worker that crashes between claim and ack."""

    def __init__(self, client: WorkerApiClient):
        self._c = client

    def claim(self, exclude: Sequence[int] = (),
              claimed_by: Optional[str] = None) -> Optional[Job]:
        try:
            out = self._c.post("/worker/claim",
                               {"exclude": list(exclude),
                                "claimed_by": claimed_by})
        except _NET_ERRORS as e:
            log.warning("claim unreachable (%s); treating as drained", e)
            return None
        j = out.get("job")
        if j is None:
            return None
        return Job(id=int(j["id"]), body=j["body"],
                   attempts=int(j["attempts"]),
                   deliveries=int(j.get("deliveries", 0)))

    def pop_dead_letters(self) -> List[Job]:
        """Poison-quarantine notifications (exactly-one-notifier: the web
        host's ``dead_notified`` column hands each job to one caller).
        Unreachable web host → empty list; the jobs stay claimable by the
        next poll."""
        try:
            out = self._c.post("/worker/dead_letters", {})
        except _NET_ERRORS as e:
            log.warning("dead_letters unreachable (%s)", e)
            return []
        return [Job(id=int(j["id"]), body=j["body"],
                    attempts=int(j["attempts"]),
                    deliveries=int(j.get("deliveries", 0)))
                for j in out.get("jobs", [])]

    def ack(self, job_id: int) -> None:
        try:
            self._c.post("/worker/ack", {"job_id": job_id})
        except _NET_ERRORS as e:
            log.warning("ack(%d) lost (%s); job will redeliver", job_id, e)

    def nack(self, job_id: int) -> str:
        try:
            return self._c.post("/worker/nack", {"job_id": job_id}).get(
                "status", "gone")
        except _NET_ERRORS as e:
            log.warning("nack(%d) lost (%s); visibility timeout will "
                        "requeue", job_id, e)
            return "gone"

    def release(self, job_id: int) -> None:
        try:
            self._c.post("/worker/release", {"job_id": job_id})
        except _NET_ERRORS as e:
            log.warning("release(%d) lost (%s)", job_id, e)


class RemoteStore:
    """ResultStore's worker-side interface over HTTP."""

    def __init__(self, client: WorkerApiClient):
        self._c = client

    def create_question(self, task_id: int, input_text: str,
                        input_images: List[str], socket_id: str,
                        queue_job_id: Optional[int] = None) -> int:
        out = self._c.post("/worker/question", {
            "task_id": task_id, "input_text": input_text,
            "input_images": list(input_images), "socket_id": socket_id,
            "queue_job_id": queue_job_id,
        })
        return int(out["qa_id"])

    def save_answer(self, qa_id: int, answer: Dict[str, Any],
                    answer_images: Optional[List[str]] = None) -> None:
        self._c.post("/worker/answer", {
            "qa_id": qa_id, "answer": answer,
            "answer_images": answer_images or [],
        })


class RemoteHub:
    """PushHub's publish interface over HTTP — frames fan out to the web
    host's websocket clients. Best-effort like the local hub: a dead web
    host must not crash the job cycle (the queue redelivers on nack)."""

    def __init__(self, client: WorkerApiClient):
        self._c = client

    def publish(self, socket_id: str, payload: Dict[str, Any]) -> int:
        try:
            out = self._c.post("/worker/push",
                               {"socket_id": socket_id, "frame": payload})
            return int(out.get("subscribers", 0))
        except (urllib.error.URLError, OSError, ValueError):
            return 0


def build_remote_worker(base_url: str, *, cfg=None, engine=None,
                        feature_root: str = "features",
                        checkpoint_path: Optional[str] = None,
                        token: Optional[str] = None, device="cuda"):
    """A ServeWorker whose queue/store/hub live on ``base_url``; without
    ``engine`` it builds one on ``device`` (the card unless asked for the
    CPU), from ``checkpoint_path`` when given."""
    from vilbert_multitask_tpu_torch.config import FrameworkConfig
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
    from vilbert_multitask_tpu_torch.features.store import FeatureStore
    from vilbert_multitask_tpu_torch.serve.worker import ServeWorker

    cfg = cfg or FrameworkConfig()
    s = cfg.serving
    client = WorkerApiClient(
        base_url, token=token,
        retry=RetryPolicy(max_attempts=s.retry_max_attempts,
                          base_delay_s=s.retry_base_delay_s,
                          max_delay_s=s.retry_max_delay_s),
        breaker=CircuitBreaker(name="remote.transport",
                               failure_threshold=s.breaker_failure_threshold,
                               window_s=s.breaker_window_s,
                               reset_timeout_s=s.breaker_reset_timeout_s))
    if engine is None:
        params = None
        if checkpoint_path is not None:
            from vilbert_multitask_tpu_torch.checkpoint import restore_params

            params = restore_params(checkpoint_path,
                                    dtype=cfg.engine.param_dtype,
                                    cfg=cfg.model)
        engine = InferenceEngine(cfg, params=params,
                                 feature_store=FeatureStore(feature_root),
                                 device=device)
    return ServeWorker(engine, RemoteQueue(client), RemoteStore(client),
                       RemoteHub(client), cfg.serving)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="ViLBERT multi-task remote worker (PyTorch/CUDA port)")
    p.add_argument("--url", required=True,
                   help="web host base URL, e.g. http://web:8400")
    p.add_argument("--features", default="features")
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint directory of this package or the "
                        "reference's pytorch_model_*.bin; omitting it "
                        "serves SEEDED RANDOM weights")
    p.add_argument("--token", default=None,
                   help="bearer token if the web host sets worker_token")
    p.add_argument("--poll", type=float, default=0.5,
                   help="idle poll interval (s); remote claims are HTTP "
                        "requests, so idle polling is throttled vs the "
                        "local worker's 0.05s sqlite poll")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the engine runs (cuda raises without a card)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (rehearsals and tests; features "
                        "must be 32-wide)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip capturing the per-bucket CUDA graphs")
    args = p.parse_args(argv)

    # This process is its own fleet incarnation: mint the identity and
    # stamp exposition samples and spans, as ServeApp.start() does. Claims
    # this worker posts carry the same ident in claimed_by.
    from vilbert_multitask_tpu_torch import obs
    from vilbert_multitask_tpu_torch.config import FrameworkConfig

    identity = obs.process_identity("remote-worker")
    obs.REGISTRY.set_default_labels(**identity.labels())
    obs.default_tracer().set_default_attrs(
        instance=identity.ident, role=identity.role)
    cfg = FrameworkConfig()
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=cfg.model.tiny())
    worker = build_remote_worker(
        args.url, cfg=cfg, feature_root=args.features,
        checkpoint_path=args.checkpoint, token=args.token,
        device=args.device)
    if args.checkpoint is None:
        print("WARNING: no --checkpoint given; serving seeded random "
              "weights (answers will be meaningless)")
    if not args.no_warmup:
        print("capturing bucket graphs...")
        worker.engine.warmup()
    # SIGTERM (the orchestrator's stop) drains: claiming stops, in-hand
    # work finishes, exit 0. Ctrl-C takes the same path.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    print(f"draining {args.url} ...", flush=True)
    try:
        worker.run_forever(poll_interval_s=args.poll, stop_event=stop)
    except KeyboardInterrupt:
        pass
    print("stopped", flush=True)


if __name__ == "__main__":
    main()
