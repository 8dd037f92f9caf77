"""The policy server (counterpart of ``sheeprl_tpu/serve/server.py``): registry-backed,
one CUDA graph per batch bucket, continuously batched, drained on SIGTERM.

One :class:`PolicyServer` hosts any number of registered policies. Startup does all the
expensive work: each ``serve.policies`` spec resolves through the registry router,
rebuilds its agent from the run config copied into the version's payload, loads the
checkpoint (checksum-verified) on ``device`` (``cuda`` unless ``device=cpu``), stamps the
parity of a bf16 or int8 tier against a float32 load of the same checkpoint, and captures
one CUDA graph per bucket of the ladder (``precompile.precompile_ladder``), once, on the
main thread, with Python's collector off. After ``mark_warm()`` the steady state is numpy
in, one graph replay, numpy out: any later capture, or a batch shape with no graph, is a
violation of the capture watchdog (``watchdog.py``), counted and warned about, or raised
in the dispatch under ``analysis.strict=True``. A bucket whose capture fails fails the
startup; no bucket is ever served eagerly.

Threads:

* the **accept loop** (``run()``, the main thread) admits connections and watches the
  preemption flag;
* one **reader** per client channel decodes requests and puts them on the endpoint's
  bounded queue (a full queue blocks the reader, which blocks the client's TCP stream:
  backpressure, not unbounded buffering);
* one **dispatcher** per endpoint pulls continuous batches (``batching.collect_batch``),
  pads them to the ladder's bucket, replays the bucket's graph on the endpoint's own
  CUDA stream (the copies in and out ordered by an event, as the decoupled entries'
  threads order theirs) and replies to every request of the batch with its latency and
  queue stamps. The host waits on the event with the interpreter lock released.

Wire protocol (the framed transport of ``distributed/transport.py``; the reference's
messages and fields, so the reference's client talks to this server):

* ``("ping", {}) -> ("pong", {policies, aliases, draining, precision, parity,
  queue_depth, p99_ms})``;
* ``("act", {policy, req_id[, session, reset]}, obs_dict) -> ("act_result", {req_id,
  queue_ms, infer_ms, batch_fill, bucket, p99_ms}, {"action": row})``; ``session`` names
  a client whose recurrent act state stays on the device between requests
  (``state_cache.py``), ``reset`` restarts its episode;
* ``("act", ...)`` while draining -> ``("draining", {req_id})``;
* an unknown policy or a malformed observation -> ``("error", {req_id, error})``.

Drain: on SIGTERM the server stops accepting, answers new requests with ``draining``,
dispatches everything already queued, replies to every accepted request, writes its
summary and returns ``RESUMABLE_EXIT_CODE`` (75).

Not ported yet: the ``obs.perf`` cost models and the fleet exporter (the summary's
``perf`` is null), and the persistent compile cache (graphs are captured at every
start). ``obs.*`` and ``compile_cache.*`` keys are refused by name.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sheeprl_tpu_torch.distributed.transport import Channel, ChannelClosed, Listener
from sheeprl_tpu_torch.fault import preemption as fault_preemption
from sheeprl_tpu_torch.serve.batching import bucket_ladder, collect_batch, pad_obs_batch, pick_bucket
from sheeprl_tpu_torch.serve.precompile import precompile_ladder
from sheeprl_tpu_torch.serve.router import resolve_policy
from sheeprl_tpu_torch.serve.watchdog import CaptureError, CaptureWarning, CaptureWatchdog
from sheeprl_tpu_torch.utils.metric import MetricAggregator

#: Overrides where the exit summary lands.
SERVE_SUMMARY_ENV_VAR = "SHEEPRL_TPU_SERVE_SUMMARY"

# config groups of the reference's serve root that the port does not have yet
_REFUSED_GROUPS = {
    "obs": "the fleet telemetry and perf plane (obs.*)",
    "compile_cache": "a persistent compile cache (CUDA graphs are captured at every start)",
}


def refuse_unported(cfg: Any) -> None:
    """Raise, naming the key, for a ``serve_cli`` key of the reference that the port
    does not have."""
    for group, what in _REFUSED_GROUPS.items():
        node = cfg.get(group)
        if node:
            keys = sorted(f"{group}.{k}" for k in node) if isinstance(node, dict) else [group]
            raise NotImplementedError(f"{', '.join(keys)}: the PyTorch port's policy server has no {what} yet")


@dataclass
class _Request:
    channel: Channel
    req_id: Any
    obs: Dict[str, np.ndarray]
    t_enq: float
    session: Optional[str] = None  # stateful policies: the client id owning act state
    reset: bool = False  # restart that session's episode


class _Endpoint:
    """One loaded policy: its bucket graphs, request queue, stream and dispatcher state."""

    def __init__(self, name: str, version: int, policy, graphs, ladder, queue_depth: int, state_cache=None, generator=None):
        self.name = name
        self.version = version
        self.policy = policy
        self.graphs = graphs
        self.ladder = ladder
        self.queue: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_depth)
        self.state_cache = state_cache
        self.generator = generator  # a non-greedy policy's draws; the graphs advance it
        cuda = policy.device.type == "cuda"
        self.stream = torch.cuda.Stream(policy.device) if cuda else None
        self.done = torch.cuda.Event() if cuda else None
        self.dispatch_counter = 0
        # per bucket: [dispatches, infer seconds]; one writer, the dispatcher
        self.bucket_stats: Dict[int, List[float]] = {}
        # accepted is bumped by every reader thread: guarded. replied, dropped and
        # dispatch_counter have one writer (the dispatcher).
        self.stats_lock = threading.Lock()
        self.accepted = 0
        self.replied = 0
        self.dropped = 0
        self.slo_violations = 0
        self.metrics = MetricAggregator(
            {
                "Serve/latency_ms": "histogram",
                "Serve/infer_ms": "histogram",
                "Serve/batch_fill": "mean",
                "Serve/queue_depth": "mean",
                "Serve/dispatches": "sum",
            }
        )

    @property
    def canonical(self) -> str:
        return f"{self.name}:{self.version}"


class PolicyServer:
    """Load, capture, serve, drain: one instance per replica process."""

    def __init__(self, cfg: Any):
        refuse_unported(cfg)
        self.cfg = cfg
        serve_cfg = cfg.serve
        self.serve_cfg = serve_cfg
        self.max_batch = int(serve_cfg.max_batch_size)
        self.delay_s = float(serve_cfg.max_batch_delay_ms) / 1000.0
        self.drain_timeout_s = float(serve_cfg.drain_timeout_s)
        self.log_every_s = float(serve_cfg.log_every_s)
        self.greedy = bool(serve_cfg.greedy)
        slo = serve_cfg.get("slo_ms", None)
        self.slo_ms: Optional[float] = float(slo) if slo else None
        self.precision = _normalize_precision(serve_cfg.get("precision", "f32"))
        self.strict = bool((cfg.get("analysis") or {}).get("strict", False))
        self.parity: Dict[str, Dict[str, Any]] = {}  # canonical -> parity stamp
        self._draining = False
        self._stop = threading.Event()
        self._channels: List[Channel] = []
        self._channels_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self.endpoints: Dict[str, _Endpoint] = {}  # canonical "name:version" -> endpoint
        self.aliases: Dict[str, str] = {}  # request spec -> canonical
        self.listener: Optional[Listener] = None
        self.startup_seconds = 0.0
        self.precompile_seconds = 0.0
        self.watchdog: Optional[CaptureWatchdog] = None
        self._stats_lock = threading.Lock()  # guards rejected_draining (readers race)
        self.rejected_draining = 0

        t0 = time.perf_counter()
        self._load_policies()
        self.startup_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------------ startup
    def _run_context(self, run_cfg: Any):
        """The context the policy is built in: the server's ``device`` and seed, the
        run's ``mesh.precision`` and ``float32_matmul_precision``."""
        from sheeprl_tpu_torch.parallel.context import make_run_context

        run_cfg.device = self.cfg.get("device", "cuda")
        run_cfg.seed = int(self.cfg.seed)
        return make_run_context(run_cfg)

    def _load_policies(self) -> None:
        from sheeprl_tpu_torch.config.core import load_config
        from sheeprl_tpu_torch.utils.model_manager import build_model_manager
        from sheeprl_tpu_torch.utils.policy import load_policy, parity_stamp

        specs = list(self.serve_cfg.policies)
        if not specs:
            raise ValueError("serve.policies is empty: nothing to serve")
        self.watchdog = CaptureWatchdog()
        manager = build_model_manager(self.cfg)
        ladder = bucket_ladder(self.max_batch, self.serve_cfg.buckets)
        seed = int(self.cfg.seed)
        for spec in specs:
            name, entry = resolve_policy(manager, spec)
            canonical = f"{name}:{int(entry['version'])}"
            if canonical in self.endpoints:
                self.aliases.setdefault(str(spec), canonical)
                continue
            payload_dir = Path(entry["path"])
            run_cfg_path = payload_dir / "config.yaml"
            if not run_cfg_path.is_file():
                raise FileNotFoundError(
                    f"{canonical}: no config.yaml inside the registered payload {payload_dir} (re-register the "
                    "model; registration copies the run config into the version payload)"
                )
            run_cfg = load_config(run_cfg_path)
            ctx = self._run_context(run_cfg)
            policy = load_policy(ctx, run_cfg, str(payload_dir), greedy=self.greedy, precision=self.precision)
            if self.precision != "f32":
                # The parity stamp: a float32 load of the same checkpoint (a fresh run
                # config: load_policy changes it), greedy actions on seeded observations.
                ref_cfg = load_config(run_cfg_path)
                reference = load_policy(self._run_context(ref_cfg), ref_cfg, str(payload_dir), greedy=self.greedy, precision="f32")
                self.parity[canonical] = parity_stamp(policy, reference, seed=seed)
                del reference
                print(f"[serve] {canonical}: parity {self.parity[canonical]}", flush=True)
            cache = None
            if policy.stateful:
                from sheeprl_tpu_torch.serve.state_cache import SessionStateCache

                cache = SessionStateCache(policy.zero_state_fn, capacity=int(self.serve_cfg.session_capacity))
            generator = torch.Generator(device=policy.device)
            generator.manual_seed(seed)
            graphs, secs = precompile_ladder(policy, ladder, generator=generator, cache=cache)
            self.precompile_seconds += secs
            ep = _Endpoint(name, int(entry["version"]), policy, graphs, ladder, int(self.serve_cfg.queue_depth), cache, generator)
            self.endpoints[canonical] = ep
            self._register_aliases(spec, ep, entry)
            print(f"[serve] {canonical}: algo={policy.algo} device={policy.device} ladder={ladder} capture={secs:.2f}s", flush=True)
        # Every graph captured from here on is a violation.
        self.watchdog.mark_warm()

    def _register_aliases(self, spec: str, ep: _Endpoint, entry: Dict[str, Any]) -> None:
        """Route keys for one endpoint: the spec as configured, the canonical
        ``name:version``, the bare name and ``name:latest`` (the first loaded version of
        a name takes those two; pin ``name:version`` to be explicit), and its stage."""
        self.aliases[ep.canonical] = ep.canonical
        self.aliases.setdefault(str(spec), ep.canonical)
        self.aliases.setdefault(ep.name, ep.canonical)
        self.aliases.setdefault(f"{ep.name}:latest", ep.canonical)
        stage = str(entry.get("stage", "") or "")
        if stage and stage.lower() != "none":
            self.aliases.setdefault(f"{ep.name}:{stage}", ep.canonical)

    # ------------------------------------------------------------------ serving
    def run(self) -> int:
        """Listen, serve until stopped or preempted, drain, summarize. Returns the exit
        code: 75 when preempted, 0 after ``shutdown()``."""
        serve_cfg = self.serve_cfg
        self.listener = Listener(host=str(serve_cfg.host), port=int(serve_cfg.port))
        self._write_ready_file()
        print(f"[serve] listening on {self.listener.address} (policies: {sorted(self.endpoints)})", flush=True)
        for ep in self.endpoints.values():
            t = threading.Thread(target=self._dispatch_loop, args=(ep,), name=f"serve-dispatch-{ep.canonical}", daemon=True)
            t.start()
            self._threads.append(t)
        last_log = time.monotonic()
        try:
            while not self._stop.is_set() and not fault_preemption.preemption_requested():
                try:
                    ch = self.listener.accept(timeout=0.2)
                except TimeoutError:
                    pass
                except OSError:
                    break
                else:
                    with self._channels_lock:
                        self._channels.append(ch)
                    t = threading.Thread(target=self._reader_loop, args=(ch,), name="serve-reader", daemon=True)
                    t.start()
                    self._threads.append(t)
                if self.log_every_s > 0 and time.monotonic() - last_log >= self.log_every_s:
                    last_log = time.monotonic()
                    self._log_status()
        finally:
            preempted = fault_preemption.preemption_requested()
            self._drain()
            self._write_summary(preempted=preempted)
            self._close()
        return fault_preemption.RESUMABLE_EXIT_CODE if preempted else 0

    def shutdown(self) -> None:
        """Clean stop (tests, benchmarks): the same drain, exit code 0."""
        self._stop.set()

    # ------------------------------------------------------------------ readers
    def _reader_loop(self, ch: Channel) -> None:
        while not ch.closed:
            try:
                kind, meta, payload = ch.recv(timeout=0.5)
            except TimeoutError:
                continue
            except Exception:  # ChannelClosed, FramingError: the connection is gone
                return
            try:
                self._handle(ch, kind, meta, payload)
            except ChannelClosed:
                return

    def _p99(self) -> float:
        """The largest rolling p99 latency over the endpoints (NaN before any reply)."""
        p99 = float("nan")
        for ep in self.endpoints.values():
            hist = ep.metrics.metrics["Serve/latency_ms"].compute()
            if hist and not (p99 >= hist["p99"]):  # NaN-safe max
                p99 = float(hist["p99"])
        return p99

    def _handle(self, ch: Channel, kind: str, meta: Dict[str, Any], payload: Any) -> None:
        if kind == "ping":
            p99 = self._p99()
            ch.send(
                "pong",
                policies=sorted(self.endpoints),
                aliases=sorted(self.aliases),
                draining=bool(self._draining),
                precision=self.precision,
                parity=self.parity,
                queue_depth=sum(ep.queue.qsize() for ep in self.endpoints.values()),
                p99_ms=p99 if p99 == p99 else None,
            )
            return
        if kind != "act":
            ch.send("error", req_id=meta.get("req_id"), error=f"unknown message kind {kind!r}")
            return
        req_id = meta.get("req_id")
        if self._draining:
            with self._stats_lock:
                self.rejected_draining += 1
            ch.send("draining", req_id=req_id)
            return
        spec = str(meta.get("policy", ""))
        canonical = self.aliases.get(spec)
        if canonical is None:
            ch.send("error", req_id=req_id, error=f"no policy routed as {spec!r} (served: {sorted(self.aliases)})")
            return
        ep = self.endpoints[canonical]
        if not isinstance(payload, dict):
            ch.send("error", req_id=req_id, error="act payload must be an obs dict")
            return
        session = meta.get("session")
        ep.queue.put(
            _Request(
                channel=ch,
                req_id=req_id,
                obs=payload,
                t_enq=time.monotonic(),
                session=str(session) if session is not None else None,
                reset=bool(meta.get("reset", False)),
            )
        )
        with ep.stats_lock:
            ep.accepted += 1

    # --------------------------------------------------------------- dispatcher
    def _dispatch_loop(self, ep: _Endpoint) -> None:
        while True:
            batch = collect_batch(ep.queue, self.max_batch, self.delay_s, first_timeout_s=0.05)
            if not batch:
                if (self._stop.is_set() or self._draining) and ep.queue.empty():
                    return
                continue
            try:
                self._dispatch(ep, batch)
            except Exception as e:  # reply rather than kill the dispatcher
                for req in batch:
                    try:
                        req.channel.send("error", req_id=req.req_id, error=str(e))
                    except ChannelClosed:
                        ep.dropped += 1
                if isinstance(e, CaptureError):
                    raise

    def _violation(self, msg: str) -> None:
        if self.strict:
            raise CaptureError(msg)
        warnings.warn(msg, CaptureWarning)

    def _dispatch(self, ep: _Endpoint, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = pick_bucket(ep.ladder, n)
        try:
            obs = pad_obs_batch([r.obs for r in batch], ep.policy.obs_template, bucket)
        except (KeyError, ValueError) as e:
            for req in batch:
                try:
                    req.channel.send("error", req_id=req.req_id, error=str(e))
                except ChannelClosed:
                    ep.dropped += 1
            return
        graph = ep.graphs.get(bucket)
        if graph is None:
            self.watchdog.missing()
            self.watchdog.poll_new()
            self._violation(f"{ep.canonical}: no CUDA graph for a bucket-{bucket} batch; the ladder's graphs should make this impossible")
            raise RuntimeError(f"{ep.canonical}: no graph for bucket {bucket}; not served eagerly")
        ep.dispatch_counter += 1
        t0 = time.monotonic()
        if ep.state_cache is not None:
            # Stateful dispatch: sessions to rows, padded with the scratch row (padding
            # scatters there harmlessly); the gather, step and scatter are in the graph.
            cache = ep.state_cache
            idx, is_first = cache.assign([r.session for r in batch], [r.reset for r in batch])
            idx_p = np.full((bucket,), cache.scratch, np.int64)
            idx_p[:n] = idx
            is_first_p = np.ones((bucket, 1), np.float32)
            is_first_p[:n] = is_first
            actions = graph(obs, idx_p, is_first_p, stream=ep.stream, done=ep.done)
        else:
            actions = graph(obs, stream=ep.stream, done=ep.done)
        t1 = time.monotonic()

        new = self.watchdog.poll_new()
        if new:
            self._violation(f"{ep.canonical}: {new} CUDA graph capture(s) after warm-up, seen at a bucket-{bucket} dispatch")

        stats = ep.bucket_stats.setdefault(bucket, [0, 0.0])
        stats[0] += 1
        stats[1] += t1 - t0
        infer_ms = (t1 - t0) * 1000.0
        ep.metrics.update("Serve/infer_ms", infer_ms)
        ep.metrics.update("Serve/batch_fill", n / bucket)
        ep.metrics.update("Serve/queue_depth", ep.queue.qsize())
        ep.metrics.update("Serve/dispatches", 1.0)
        latencies = [(t1 - r.t_enq) * 1000.0 for r in batch]
        ep.metrics.update("Serve/latency_ms", latencies)
        if self.slo_ms is not None:
            ep.slo_violations += sum(1 for lat in latencies if lat > self.slo_ms)
        hist = ep.metrics.metrics["Serve/latency_ms"].compute()
        p99 = float(hist["p99"]) if hist else float("nan")
        for i, req in enumerate(batch):
            try:
                req.channel.send(
                    "act_result",
                    payload={"action": actions[i]},
                    req_id=req.req_id,
                    queue_ms=(t0 - req.t_enq) * 1000.0,
                    infer_ms=infer_ms,
                    batch_fill=n / bucket,
                    bucket=bucket,
                    p99_ms=p99,
                )
                ep.replied += 1
            except ChannelClosed:
                ep.dropped += 1

    # ------------------------------------------------------------------ teardown
    def _drain(self) -> None:
        """Stop admitting, flush every queue, reply to everything accepted."""
        self._draining = True
        time.sleep(0.05)  # let in-flight reader enqueues land before the emptiness checks
        deadline = time.monotonic() + self.drain_timeout_s
        for ep in self.endpoints.values():
            while not ep.queue.empty() and time.monotonic() < deadline:
                time.sleep(0.01)
        self._stop.set()
        for t in self._threads:
            if t.name.startswith("serve-dispatch"):
                t.join(timeout=max(deadline - time.monotonic(), 1.0))

    def _close(self) -> None:
        if self.listener is not None:
            self.listener.close()
        with self._channels_lock:
            channels = list(self._channels)
        for ch in channels:
            ch.close()

    def _log_status(self) -> None:
        for ep in self.endpoints.values():
            computed = ep.metrics.compute()
            p99 = computed.get("Serve/latency_ms/p99", float("nan"))
            fill = computed.get("Serve/batch_fill", float("nan"))
            print(
                f"[serve] {ep.canonical}: accepted={ep.accepted} replied={ep.replied} "
                f"p99={p99:.2f}ms fill={fill:.2f} depth={ep.queue.qsize()}",
                flush=True,
            )

    # ------------------------------------------------------------------ artifacts
    def _write_ready_file(self) -> None:
        ready = self.serve_cfg.ready_file
        if not ready:
            return
        doc = {
            "host": self.listener.host,
            "port": self.listener.port,
            "policies": sorted(self.endpoints),
            "startup_seconds": self.startup_seconds,
            "precompile_seconds": self.precompile_seconds,
            "precision": self.precision,
            "parity": self.parity,
        }
        _atomic_write_json(Path(ready), doc)

    def summary(self, preempted: bool = False) -> Dict[str, Any]:
        per_policy = {}
        for canonical, ep in self.endpoints.items():
            per_policy[canonical] = {
                "accepted": ep.accepted,
                "replied": ep.replied,
                "dropped": ep.dropped,
                "dispatches": ep.dispatch_counter,
                "slo_violations": ep.slo_violations,
                "metrics": ep.metrics.compute(),
            }
            if ep.state_cache is not None:
                per_policy[canonical]["sessions"] = ep.state_cache.stats()
        total_replied = sum(ep.replied for ep in self.endpoints.values())
        total_violations = sum(ep.slo_violations for ep in self.endpoints.values())
        return {
            "preempted": bool(preempted),
            "drained": True,
            "rejected_draining": self.rejected_draining,
            "accepted": sum(ep.accepted for ep in self.endpoints.values()),
            "replied": total_replied,
            "dropped": sum(ep.dropped for ep in self.endpoints.values()),
            "slo_ms": self.slo_ms,
            "slo_violations": total_violations,
            "slo_burn": total_violations / max(total_replied, 1),
            # the reference's compiles after warm-up; here captures after warm-up and
            # dispatches that found no graph
            "recompiles": int(self.watchdog.violations) if self.watchdog else 0,
            "startup_seconds": self.startup_seconds,
            "precompile_seconds": self.precompile_seconds,
            "precision": self.precision,
            "parity": self.parity,
            "policies": per_policy,
            "perf": None,
        }

    def _write_summary(self, preempted: bool) -> None:
        path = os.environ.get(SERVE_SUMMARY_ENV_VAR) or self.serve_cfg.summary_path
        if not path:
            return
        _atomic_write_json(Path(path), self.summary(preempted=preempted))


def _normalize_precision(spec: Any) -> str:
    """``serve.precision`` -> the tier's name (f32 | bf16 | int8)."""
    key = str(spec if spec is not None else "f32").lower()
    if key in ("", "none", "null", "f32", "fp32", "float32"):
        return "f32"
    if key in ("bf16", "bfloat16"):
        return "bf16"
    if key == "int8":
        return "int8"
    raise ValueError(f"Unknown serve.precision {spec!r}; expected f32, bf16 or int8")


def _atomic_write_json(path: Path, doc: Dict[str, Any]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=f".{path.name}.", suffix=".tmp", dir=path.parent)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp_name, path)
