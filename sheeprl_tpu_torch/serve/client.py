"""The synchronous serve client (counterpart of ``sheeprl_tpu/serve/client.py``): one
observation in, one action and its latency stamps out.

A :class:`PolicyClient` wraps one framed-TCP channel and makes strict request/reply
round trips: concurrency is many clients, not pipelining on one socket (a channel's
``recv`` has one consumer). The wire is the reference's, so this client talks to the
reference's server and the reference's client talks to this package's. The reference's
``FleetClient`` (failover over several endpoints) belongs to the serving fleet, which is
not ported yet.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.distributed.transport import Channel, connect

_REQ_COUNTER = itertools.count()
_REQ_LOCK = threading.Lock()


class ServerDraining(ConnectionError):
    """The replica is draining (it was sent SIGTERM): retry against another replica."""


def _next_req_id() -> int:
    with _REQ_LOCK:
        return next(_REQ_COUNTER)


class PolicyClient:
    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.channel: Channel = connect(host, port, timeout_s=timeout_s)

    def ping(self, timeout: float = 10.0) -> Dict[str, Any]:
        """Readiness probe; returns the server's ``{policies, aliases, draining, ...}``."""
        self.channel.send("ping")
        kind, meta, _ = self.channel.recv(timeout=timeout)
        if kind != "pong":
            raise RuntimeError(f"expected pong, got {kind!r}: {meta}")
        return meta

    def act(
        self,
        obs: Dict[str, np.ndarray],
        policy: str,
        timeout: float = 30.0,
        session: Optional[str] = None,
        reset: bool = False,
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """One round trip: ``(action_row, reply_meta)``. ``reply_meta`` carries
        ``queue_ms``, ``infer_ms``, ``batch_fill``, ``bucket`` and ``p99_ms`` (the
        server's rolling p99 when it replied). ``session`` names this client for a
        stateful (recurrent) policy, whose act state the server keeps on the device
        between calls; ``reset=True`` restarts its episode."""
        req_id = _next_req_id()
        extra: Dict[str, Any] = {}
        if session is not None:
            extra["session"] = session
        if reset:
            extra["reset"] = True
        self.channel.send("act", payload=dict(obs), policy=policy, req_id=req_id, **extra)
        kind, meta, payload = self.channel.recv(timeout=timeout)
        if kind == "draining":
            raise ServerDraining(f"request {req_id} rejected: replica is draining")
        if kind == "error":
            raise RuntimeError(f"server error for request {req_id}: {meta.get('error')}")
        if kind != "act_result" or meta.get("req_id") != req_id:
            raise RuntimeError(f"unexpected reply {kind!r} (meta={meta}) for request {req_id}")
        return np.asarray(payload["action"]), meta

    def close(self) -> None:
        self.channel.close()

    def __enter__(self) -> "PolicyClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def parse_endpoint(endpoint: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    """``"host:port"`` (or a ``(host, port)`` pair) -> ``(host, port)``."""
    if isinstance(endpoint, (tuple, list)):
        host, port = endpoint
        return str(host), int(port)
    host, _, port = str(endpoint).rpartition(":")
    return host or "127.0.0.1", int(port)


def wait_for_server(host: str, port: int, timeout_s: float = 120.0, interval_s: float = 0.25) -> Dict[str, Any]:
    """Poll until a replica answers a ping (its startup captures every bucket's graph, so
    the window is generous); returns the pong meta."""
    deadline = time.monotonic() + timeout_s
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            client = PolicyClient(host, port, timeout_s=min(5.0, timeout_s))
            try:
                return client.ping()
            finally:
                client.close()
        except Exception as e:  # noqa: BLE001 - any failure means "not up yet"
            last = e
            time.sleep(interval_s)
    raise TimeoutError(f"no serve replica at {host}:{port} within {timeout_s}s: {last}")
