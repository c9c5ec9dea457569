"""Realtime result push: per-socket groups + websocket bridge.

Reference capability: the Channels/Redis fanout — ``log_to_terminal`` sends
a JSON frame to the Redis group named by the client's socket id
(reference demo/utils.py:5-6); clients join their group by sending the bare
socket id as the first websocket frame (demo/consumers.py:8-12,
result.html:83-88); frames carry ``info`` / ``terminal`` / ``result`` keys
(result.html:96-111).

Redesign: the broker hop is gone. ``PushHub`` is an in-process, thread-safe
group router (worker thread → hub → websocket event loop), and
``WebSocketBridge`` speaks the same client protocol over the ``websockets``
library. Multi-process deployments fan out by running one bridge per web
process and routing jobs by socket id at the queue — cross-host tensors never
ride this path (SURVEY.md §2.3: DCN carries job/control traffic only).
"""

from __future__ import annotations

import asyncio
import json
import queue as queue_mod
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional

from vilbert_multitask_tpu_torch.resilience.faults import FaultInjected, fault_point


class PushHub:
    """socket_id → subscriber queues; publish is non-blocking."""

    def __init__(self, max_queued: int = 256):
        self.max_queued = max_queued
        self._lock = threading.Lock()
        self._groups: Dict[str, List[queue_mod.Queue]] = defaultdict(list)

    def subscribe(self, socket_id: str) -> queue_mod.Queue:
        q: queue_mod.Queue = queue_mod.Queue(self.max_queued)
        with self._lock:
            self._groups[socket_id].append(q)
        return q

    def unsubscribe(self, socket_id: str, q: queue_mod.Queue) -> None:
        with self._lock:
            subs = self._groups.get(socket_id)
            if subs and q in subs:
                subs.remove(q)
            if subs is not None and not subs:
                del self._groups[socket_id]

    def publish(self, socket_id: str, payload: Dict[str, Any]) -> int:
        """Send to every subscriber of the group; slow consumers drop oldest
        (the reference's Redis groups drop silently on backpressure too)."""
        try:
            payload = fault_point("push.publish", payload)
        except FaultInjected:
            # Push is best-effort by contract — an injected fault here
            # models a dropped frame, never an error into the job cycle.
            return 0
        with self._lock:
            subs = list(self._groups.get(socket_id, ()))
        for q in subs:
            try:
                q.put_nowait(payload)
            except queue_mod.Full:
                try:
                    q.get_nowait()
                    q.put_nowait(payload)
                except (queue_mod.Empty, queue_mod.Full):
                    # Racing publisher refilled the slot first — drop this
                    # frame for the slow consumer; push is best-effort and
                    # must never raise into the worker's job cycle.
                    pass
        return len(subs)


def log_to_terminal(hub: PushHub, socket_id: str, message: Dict[str, Any]) -> None:
    """The reference helper's exact contract (demo/utils.py:5-6): publish a
    dict frame — callers use {"terminal": ...}, {"result": ...}, {"info": ...}."""
    hub.publish(socket_id, message)


def fan_out(hub: PushHub, socket_ids: List[str],
            message: Dict[str, Any]) -> int:
    """Publish one frame to MANY groups — the coalescing tier's terminal
    fan-out (worker._fan_to_followers): every follower of a singleflight
    leader hears the leader's result/dead-letter/deadline frame. Each
    group gets its own dict copy (subscriber queues outlive this call;
    a shared mutable frame would alias across consumers). Returns total
    subscriber deliveries, same best-effort contract as publish."""
    delivered = 0
    for sid in socket_ids:
        delivered += hub.publish(sid, dict(message))
    return delivered


class WebSocketBridge:
    """Asyncio websocket server bridging :class:`PushHub` to browsers.

    Client protocol (reference result.html:83-111): first text frame is the
    bare socket id; every server frame afterwards is a JSON object.
    """

    def __init__(self, hub: PushHub, host: str = "127.0.0.1", port: int = 8401):
        self.hub = hub
        self.host = host
        self.port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop: Optional[asyncio.Event] = None
        self.bound_port: Optional[int] = None  # actual port (for port=0)

    async def _handle(self, websocket):
        socket_id = (await websocket.recv()).strip()
        sub = self.hub.subscribe(socket_id)
        loop = asyncio.get_running_loop()

        def next_frame():
            # Short timeout bounds how long a cancelled connection pins its
            # executor thread; frames themselves arrive with no added latency.
            try:
                return sub.get(timeout=1.0)
            except queue_mod.Empty:
                return None

        async def pump():
            while True:
                try:
                    payload = await loop.run_in_executor(None, next_frame)
                except RuntimeError:
                    return  # executor gone: interpreter/bridge shutting down
                if payload is not None:
                    await websocket.send(json.dumps(payload))

        # Race the pump against connection close so idle clients that
        # disconnect don't leak their subscription (nothing is ever sent to
        # an idle group, so a send-side ConnectionClosed never fires).
        pump_task = asyncio.ensure_future(pump())
        closed_task = asyncio.ensure_future(websocket.wait_closed())
        try:
            await asyncio.wait({pump_task, closed_task},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            pump_task.cancel()
            closed_task.cancel()
            self.hub.unsubscribe(socket_id, sub)

    async def _serve(self):
        import websockets

        self._stop = asyncio.Event()
        async with websockets.serve(self._handle, self.host, self.port) as server:
            socks = getattr(server, "sockets", None) or server.server.sockets
            self.bound_port = socks[0].getsockname()[1]
            self._started.set()
            await self._stop.wait()

    def start(self) -> None:
        try:
            import websockets  # noqa: F401
        except ImportError:
            # No websockets lib in this environment: degrade to HTTP-only
            # serving instead of failing boot. In-process consumers (result
            # polling, the soak's direct hub subscription) still get every
            # frame — only the browser bridge is absent. bound_port=0 keeps
            # /config well-formed.
            self.bound_port = 0
            return

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self._serve())

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="ws-bridge")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("websocket bridge failed to start")

    def stop(self) -> None:
        if self._loop and self._stop:
            self._loop.call_soon_threadsafe(self._stop.set)
        if self._thread:
            self._thread.join(timeout=5)
