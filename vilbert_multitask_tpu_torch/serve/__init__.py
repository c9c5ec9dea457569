"""Serving tier: durable queue, result store, push hub, HTTP API, worker.

The port's copy of the JAX package's serving tier (the reference's L3-L6
stack, SURVEY.md §1): Django+RabbitMQ+Redis+Postgres collapse into an
embedded, broker-less stack with the same wire contracts (queue message
schema, websocket frame keys, HTTP endpoints) and the same sqlite schema.
Only the engine underneath differs (engine/runtime.py on one CUDA device).
``serve/remote.py`` drains the queue over HTTP from a worker on another
host.
"""

from vilbert_multitask_tpu_torch.serve.db import ResultStore
from vilbert_multitask_tpu_torch.serve.http_api import ApiServer
from vilbert_multitask_tpu_torch.serve.metrics import Metrics
from vilbert_multitask_tpu_torch.serve.pool import (
    NoReadyReplica,
    Replica,
    ReplicaFailover,
    ReplicaPool,
)
from vilbert_multitask_tpu_torch.serve.push import PushHub, WebSocketBridge, log_to_terminal
from vilbert_multitask_tpu_torch.serve.queue import DurableQueue, Job, make_job_message
from vilbert_multitask_tpu_torch.serve.render import draw_grounding_boxes
from vilbert_multitask_tpu_torch.serve.scheduler import ContinuousScheduler
from vilbert_multitask_tpu_torch.serve.worker import ServeWorker

__all__ = [
    "ApiServer",
    "ContinuousScheduler",
    "DurableQueue",
    "Job",
    "Metrics",
    "NoReadyReplica",
    "PushHub",
    "Replica",
    "ReplicaFailover",
    "ReplicaPool",
    "ResultStore",
    "ServeWorker",
    "WebSocketBridge",
    "draw_grounding_boxes",
    "log_to_terminal",
    "make_job_message",
]
