"""The observability plane's parts (``sheeprl_tpu_torch/obs``) against the JAX package's
(``sheeprl_tpu/obs``), both fed the same inputs, on the CPU:

* ``SpanTracer``: one span sequence gives the same Chrome-trace names, nesting and
  percentile keys; the port gives each thread a track of its own that is never reused;
* ``GoodputLedger.classify`` and ``StepTimeWatchdog.observe`` give equal outputs;
* ``diagnostics`` agree on the same numpy trees (float32, rtol 1e-6), single-key
  unwrapping and a non-finite gradient included;
* the flight recorder: the ring's bounds, the first dump wins, the meta fields;
* the memory telemetry and the recapture watchdog on the CPU;
* the cost model of a tiny MLP step equals its products' FLOPs;
* the fault counters, the perf report's path and ``perf_enabled``.
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

SPANS = [("Time/update", 0), ("Time/phase_player", 1), ("Time/phase_buffer_add", 2), ("Time/phase_dispatch", 1)]


def _drive(tracer, span_fn):
    """The same sequence on either package's tracer: an update holding a player phase
    (holding a buffer add), then a dispatch."""
    with span_fn("Time/update"):
        with span_fn("Time/phase_player"):
            with span_fn("Time/phase_buffer_add"):
                pass
        with span_fn("Time/phase_dispatch"):
            pass


def _spans(trace):
    return sorted((e["name"], e["args"]["depth"]) for e in trace["traceEvents"] if e["ph"] == "X")


def test_span_tracer_matches_the_reference():
    from sheeprl_tpu.obs import tracer as jtracer
    from sheeprl_tpu_torch.obs import tracer as ttracer

    out = {}
    for name, mod in (("jax", jtracer), ("torch", ttracer)):
        tracer = mod.SpanTracer(rank=3, max_events=3)
        prev = mod.set_active(tracer)
        try:
            _drive(tracer, mod.span)
        finally:
            mod.set_active(prev)
        trace = tracer.chrome_trace()
        out[name] = (trace, tracer.percentiles(reset=False), tracer.dropped_events)
    (jtrace, jpct, jdrop), (ttrace, tpct, tdrop) = out["jax"], out["torch"]
    assert _spans(ttrace) == _spans(jtrace) and len(_spans(ttrace)) == 3  # the cap: 3 events kept
    assert tdrop == jdrop == 1
    assert {e["name"] for e in ttrace["traceEvents"] if e["ph"] == "M"} == {e["name"] for e in jtrace["traceEvents"] if e["ph"] == "M"}
    assert {e["pid"] for e in ttrace["traceEvents"]} == {3}
    assert sorted(tpct) == sorted(jpct) == sorted(n for n, _ in SPANS)
    for name in tpct:
        assert sorted(tpct[name]) == sorted(jpct[name]) == ["count", "mean", "p50", "p95", "p99"]
        assert tpct[name]["count"] == jpct[name]["count"] == 1.0


def test_span_tracer_gives_each_thread_a_track_never_reused():
    """Threads that run one after the other may get one ``threading.get_ident()`` (the
    reference's track key); the port's tracks stay distinct."""
    from sheeprl_tpu_torch.obs.tracer import SpanTracer

    tracer = SpanTracer()

    def work():
        tracer.begin("Time/work")
        tracer.end("Time/work")

    for _ in range(4):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    work()
    tids = [e["tid"] for e in tracer.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert len(tids) == 5 and len(set(tids)) == 5


def test_timer_blocks_are_spans_of_the_active_tracer():
    from sheeprl_tpu_torch.obs import tracer as ttracer
    from sheeprl_tpu_torch.utils.timer import Timer

    timer, tracer = Timer(), ttracer.SpanTracer()
    prev = ttracer.set_active(tracer)
    try:
        with timer("Time/env_interaction_time"), timer("Time/phase_env_step"):
            pass
    finally:
        ttracer.set_active(prev)
    assert _spans(tracer.chrome_trace()) == [("Time/env_interaction_time", 0), ("Time/phase_env_step", 1)]
    assert set(timer.to_dict()) == {"Time/env_interaction_time", "Time/phase_env_step"}


@pytest.mark.parametrize(
    "timers,elapsed,recompile,downtime",
    [
        ({"Time/phase_dispatch": 2.0, "Time/train_time": 5.0, "Time/env_interaction_time": 1.0}, 10.0, 0.5, 0.0),
        ({"Time/train_time": 4.0, "Time/phase_env_step": 3.0, "Time/block_recv": 2.0, "Time/phase_checkpoint": 1.0}, 5.0, 1.0, 2.0),
        ({}, 0.0, 0.0, 0.0),
        ({"Time/queue_wait": 1.5}, 0.0, 0.0, 0.0),
    ],
)
def test_goodput_ledger_classifies_as_the_reference(timers, elapsed, recompile, downtime):
    from sheeprl_tpu.obs.perf import GoodputLedger as JLedger
    from sheeprl_tpu_torch.obs.perf import GoodputLedger as TLedger

    j, t = JLedger(), TLedger()
    jf, tf = j.classify(timers, elapsed, recompile, downtime), t.classify(timers, elapsed, recompile, downtime)
    assert tf == jf
    assert abs(sum(tf.values()) - 1.0) < 1e-12
    assert t.fractions() == j.fractions() and t.goodput() == j.goodput()


def test_step_time_watchdog_observes_as_the_reference():
    from sheeprl_tpu.obs.perf import StepTimeWatchdog as JDog
    from sheeprl_tpu_torch.obs.perf import StepTimeWatchdog as TDog

    rng = np.random.default_rng(0)
    steps = np.concatenate([rng.uniform(0.9, 1.1, 30), rng.uniform(2.0, 2.2, 12), rng.uniform(0.9, 1.1, 20), rng.uniform(3.0, 3.1, 12)])
    j, t = JDog(warmup_steps=10, sustain_steps=3, max_captures=1), TDog(warmup_steps=10, sustain_steps=3, max_captures=1)
    jev, tev = [j.observe(float(dt)) for dt in steps], [t.observe(float(dt)) for dt in steps]
    assert tev == jev
    assert t.anomalies == j.anomalies == 2
    assert [e["capture"] for e in tev if e] == [True, False]


def _trees(seed: int):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    grads = {"world_model": {"enc": f(4, 3), "dec": f(5)}, "actor": {"w": f(2, 2)}, "critic": {"w": f(3)}}
    grads["critic"]["w"][1] = np.inf
    params = {"world_model": {"enc": f(4, 3), "dec": f(5)}, "actor": {"w": f(2, 2)}, "critic": {"w": f(3)}, "target_critic": {"w": f(3)}}
    updates = {k: {n: 1e-3 * f(*np.shape(v)) for n, v in g.items()} for k, g in grads.items()}
    return grads, params, updates, {"value_mean": f(7), "value_std": np.float32(0.5)}


@pytest.mark.parametrize("unwrap", [False, True])
def test_diagnostics_match_the_reference(unwrap):
    """The same numpy trees through both packages: every name, every value within rtol
    1e-6 (float32). ``unwrap``: single-key trees, which both unwrap to the inner names."""
    import jax.numpy as jnp

    from sheeprl_tpu.obs.health import diagnostics as jdiag
    from sheeprl_tpu_torch.obs.health import diagnostics as tdiag

    grads, params, updates, aux = _trees(1)
    if unwrap:
        grads, updates = {"critic": grads["world_model"]}, {"critic": updates["world_model"]}
    to_j = lambda t: {k: to_j(v) for k, v in t.items()} if isinstance(t, dict) else jnp.asarray(t)  # noqa: E731
    to_t = lambda t: {k: to_t(v) for k, v in t.items()} if isinstance(t, dict) else torch.as_tensor(t)  # noqa: E731
    want = jdiag(grads=to_j(grads), params=to_j(params), updates=to_j(updates), aux=to_j(aux))
    got = tdiag(grads=to_t(grads), params=to_t(params), updates=to_t(updates), aux=to_t(aux))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    if not unwrap:
        assert got["Health/grad_finite_frac"].item() == pytest.approx(23 / 24)


def test_optimizer_update_norms_equal_the_deltas_norms():
    """The norms the optimizer returns are those of the deltas it applied (no parameter
    copy is taken to get them), for each update rule and a learning-rate schedule. rtol
    1e-3: the reading ``new - old`` of a ~1e-3 delta on ~1 parameters keeps only ~1e-4 of
    its relative precision in float32."""
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, polynomial_schedule

    torch.manual_seed(0)
    cases = [
        ({"name": "adam", "lr": 1e-3}, None),
        ({"name": "adam", "lr": 3e-4}, polynomial_schedule(3e-4, 1e-8, 1.0, 10)),
        ({"name": "sgd", "lr": 0.1, "momentum": 0.9}, None),
        ({"name": "rmsprop_tf", "lr": 1e-3, "alpha": 0.99, "eps": 1e-5, "momentum": 0.0, "centered": False}, None),
    ]
    for opt_cfg, schedule in cases:
        opt = make_optimizer(opt_cfg, 0.5, schedule)
        params = [torch.randn(3, 4), torch.randn(5)]
        state = opt.init(params)
        for _ in range(2):
            before = [p.clone() for p in params]
            grads = [torch.randn_like(p) for p in params]
            norm, update_norms = opt.update(params, grads, state, update_norms=True)
            want = torch.stack([torch.linalg.vector_norm(p - b) for p, b in zip(params, before)])
            torch.testing.assert_close(update_norms, want, rtol=1e-3, atol=0, msg=lambda m: f"{opt_cfg['name']}: {m}")
            torch.testing.assert_close(norm, torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))


def test_flight_recorder_ring_first_dump_and_meta(tmp_path):
    from sheeprl_tpu_torch.obs import flight_recorder as fr

    rec = fr.FlightRecorder(str(tmp_path), capacity=5, keep_events=3, algo="dreamer_v3", cfg={"algo": {"name": "dreamer_v3"}, "seed": 1})
    prev = fr.install(rec)
    try:
        for i in range(8):
            fr.record_event("metric_flush", step=i, values={"Health/x": float(i), "Loss/nan": float("nan")}, t=torch.tensor(2.5))
        fr.record_span("Time/update", 1.23456, 0)
        assert len(rec) == 5 and rec.total_recorded == 9
        assert [e.get("step") for e in rec.events()][:4] == [4, 5, 6, 7]
        try:
            raise RuntimeError("boom at update 3")
        except RuntimeError as exc:
            first = fr.dump_active("crash", exc)
        second = fr.dump_active("crash again")
    finally:
        fr.install(prev)
    assert first == second == str(tmp_path / "blackbox")
    lines = [json.loads(line) for line in (tmp_path / "blackbox" / "events.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["metric_flush", "metric_flush", "span"]
    assert lines[-1]["dur_ms"] == 1.235 and lines[0]["t"] == 2.5 and lines[0]["values"]["Loss/nan"] == "nan"
    meta = json.loads((tmp_path / "blackbox" / "meta.json").read_text())
    assert meta["reason"] == "crash" and meta["algo"] == "dreamer_v3"
    assert meta["staged_state"] is False and meta["replay_target"] is None
    assert meta["events_recorded"] == 9 and meta["events_dumped"] == 3
    assert meta["exception"]["type"] == "RuntimeError" and "boom at update 3" in meta["exception"]["message"]
    assert meta["torch_version"] == torch.__version__ and "cuda_version" in meta and "device_name" in meta
    assert "jax_version" not in meta and len(meta["config_fingerprint"]) == 64
    assert (tmp_path / "blackbox" / "config.yaml").is_file()


def test_flight_recorder_meta_fields_are_the_references_but_the_versions(tmp_path):
    from sheeprl_tpu.obs.flight_recorder import FlightRecorder as JRec
    from sheeprl_tpu_torch.obs.flight_recorder import FlightRecorder as TRec

    cfg = {"algo": {"name": "sac"}, "seed": 3}
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    JRec(str(jdir), cfg=cfg, algo="sac").dump("crash", ValueError("x"))
    TRec(str(tdir), cfg=cfg, algo="sac").dump("crash", ValueError("x"))
    jmeta = json.loads((jdir / "blackbox" / "meta.json").read_text())
    tmeta = json.loads((tdir / "blackbox" / "meta.json").read_text())
    versions = {"jax_version", "jaxlib_version"}, {"torch_version", "cuda_version", "device_name"}
    assert set(tmeta) - versions[1] == set(jmeta) - versions[0]
    assert tmeta["config_fingerprint"] == jmeta["config_fingerprint"]


def test_telemetry_on_the_cpu_reports_host_rss_only():
    from sheeprl_tpu.obs.telemetry import _host_rss_bytes as jrss
    from sheeprl_tpu_torch.obs.telemetry import DeviceTelemetry

    tel = DeviceTelemetry(interval_s=3600.0, devices=[])
    first = tel.poll()
    assert set(first) == set(jrss()) == {"Memory/host_peak_rss_bytes"} and first["Memory/host_peak_rss_bytes"] > 0
    assert tel.poll() == {} and tel.poll(force=True)


def test_recapture_watchdog_counts_a_capture_after_warm_up(monkeypatch):
    from sheeprl_tpu_torch.obs.watchdog import RecompileWatchdog
    from sheeprl_tpu_torch.utils import graphs

    monkeypatch.setattr(graphs, "_captured", 7)
    monkeypatch.setattr(graphs, "_capture_seconds", 1.0)
    dog = RecompileWatchdog()
    graphs._captured, graphs._capture_seconds = 9, 1.5  # the run's warm-up captures
    assert dog.poll_new() == 0
    dog.mark_warm()
    assert dog.metrics() == {"Compile/total_compiles": 2.0, "Compile/recompiles": 0.0, "Compile/compile_seconds": 0.5}
    graphs._captured, graphs._capture_seconds = 10, 2.0  # a capture after warm-up
    assert dog.poll_new() == 1 and dog.poll_new() == 0
    assert dog.recompiles == 1 and dog.total_compiles == 3
    assert dog.drain_compile_seconds() == pytest.approx(1.0) and dog.drain_compile_seconds() == 0.0


def test_monitor_warns_on_a_capture_after_warm_up(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.obs import TrainingMonitor, perf
    from sheeprl_tpu_torch.obs.watchdog import RecompileWarning
    from sheeprl_tpu_torch.utils import graphs

    cfg = compose(overrides=["exp=ppo_dummy", "device=cpu", "obs.enabled=True", "obs.xprof_annotations=False"])
    monitor = TrainingMonitor(cfg, str(tmp_path))
    try:
        monitor.advance()
        monitor.advance()  # warm after the first update
        monkeypatch.setattr(graphs, "_captured", graphs.capture_count() + 1)
        with pytest.warns(RecompileWarning, match="capture"):
            monitor.advance()
        metrics = {}
        monitor.log_metrics(None, metrics, 1)
        assert metrics["Compile/recompiles"] == 1.0
    finally:
        monitor.close()
        perf.reset()
    assert (tmp_path / "trace.json").is_file()


def test_cost_model_of_a_tiny_mlp_step_is_its_products_flops():
    """A linear 8 -> 16 -> 4 MLP's step at batch 5: forward 2*B*(8*16 + 16*4) FLOPs, the
    backward twice that less the first layer's input gradient (x needs none)."""
    from sheeprl_tpu_torch.obs import perf

    torch.manual_seed(0)
    mlp = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    x = torch.randn(5, 8)

    def step():
        loss = mlp(x).square().mean()
        return torch.autograd.grad(loss, list(mlp.parameters()))

    B = 5
    fwd = 2 * B * (8 * 16 + 16 * 4)
    want = fwd + 2 * B * (8 * 16 + 16 * 4) + 2 * B * 16 * 4  # weight grads, then dL/dh of the second layer
    perf.reset()
    perf.set_counting(True)
    try:
        instrumented = perf.instrument({"obs": {"perf": {"enabled": True}}}, "tiny/train_fn", step)
        for _ in range(3):
            instrumented()
        models = perf.registered_cost_models()
    finally:
        perf.reset()
    assert models["tiny/train_fn"]["flops"] == want
    assert models["tiny/train_fn"]["calls"] == 3
    # every aten op's inputs and outputs, before fusion: at least the parameters, read twice
    assert models["tiny/train_fn"]["bytes_accessed"] > 2 * 4 * sum(p.numel() for p in mlp.parameters())


def test_step_graph_counts_its_cost_once_and_every_call(monkeypatch):
    from sheeprl_tpu_torch.obs import perf
    from sheeprl_tpu_torch.utils.graphs import StepGraph

    w = torch.randn(6, 3)
    inputs = {"x": torch.randn(4, 6)}
    perf.reset()
    perf.set_counting(True)
    try:
        steps = [StepGraph(lambda i: {"y": i["x"] @ w}, inputs, cost_name="a/train_block") for _ in range(2)]
        for s in steps:
            s()
            s()
        models = perf.registered_cost_models()
    finally:
        perf.reset()
    assert models == {"a/train_block": {"flops": 2 * 4 * 6 * 3, "bytes_accessed": 4 * (4 * 6 + 6 * 3 + 4 * 3), "calls": 4}}


def test_perf_plane_gauges_and_report(tmp_path, monkeypatch):
    """``Perf/*`` at a flush from the registered cost models and the drained timers, and
    ``perf_report.json`` (the environment's path wins); a CUDA device without a peak row
    leaves the MFU out with one warning."""
    from sheeprl_tpu_torch.obs import perf

    cfg = {"obs": {"perf": {"enabled": True}}}
    assert perf.perf_enabled(cfg) and not perf.perf_enabled({"obs": {}}) and not perf.perf_enabled({"obs": {"perf": {"enabled": False}}})
    perf.reset()
    try:
        plane = perf.PerfPlane(cfg, device=torch.device("cpu"))
        perf.register_cost_model("x/train_fn", 1e9, 2e9)
        perf.record_call("x/train_fn", 5)
        metrics = {"Time/train_time": 0.5}
        plane.flush(metrics)
        assert 0 < metrics["Perf/mfu"] and metrics["Perf/hbm_bw_util"] > 0
        assert abs(sum(metrics[f"Perf/goodput_{c}"] for c in perf.GOODPUT_CATEGORIES) - 1.0) < 1e-9
        path = tmp_path / "elsewhere.json"
        monkeypatch.setenv(perf.PERF_REPORT_ENV_VAR, str(path))
        assert perf.report_path(str(tmp_path)) == str(path)
        assert plane.write_report(perf.report_path(str(tmp_path))) == str(path)
        report = json.loads(path.read_text())
        assert report["device_kind"] == "cpu" and report["cost_models"]["x/train_fn"]["calls"] == 5
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "Some Card")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert perf.peak_flops(torch.device("cuda", 0)) is None and perf.peak_hbm_bw(torch.device("cuda", 0)) is None
        assert len([w for w in caught if "Some Card" in str(w.message)]) == 1
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
        assert perf.peak_flops(torch.device("cuda", 0)) == 989e12 and perf.peak_hbm_bw(torch.device("cuda", 0)) == 3.35e12
    finally:
        perf.reset()


def test_fault_counters_match_the_reference(monkeypatch):
    from sheeprl_tpu.fault import counters as jc
    from sheeprl_tpu_torch.fault import counters as tc

    monkeypatch.setenv(tc.RESTARTS_ENV_VAR, "2")
    assert tc.RESTARTS_ENV_VAR == jc.RESTARTS_ENV_VAR
    for mod in (jc, tc):
        mod.reset()
        mod.bump("Fault/preemptions")
        mod.bump("Fault/preemptions", 2)
    assert tc.fault_metrics() == jc.fault_metrics() == {"Fault/restarts": 2.0, "Fault/preemptions": 3}
    monkeypatch.delenv(tc.RESTARTS_ENV_VAR)
    for mod in (jc, tc):
        mod.reset()
    assert tc.fault_metrics() == {} == jc.fault_metrics()


def test_obs_config_equals_the_references():
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.config.core import compose

    assert compose(overrides=["exp=dreamer_v3_dummy", "device=cpu"]).obs == jax_compose(overrides=["exp=dreamer_v3_dummy"]).obs
