"""The observability plane through the PyTorch port's train entry on the CPU, at a tiny
DreamerV3 size:

* ``obs.enabled=True obs.capture_steps=[2,3]`` writes ``trace.json`` (``Time/update`` and
  the ``Time/phase_*`` spans), a profiler trace under ``profile/`` and
  ``perf_report.json`` (the step's cost model, goodput fractions summing to 1), and logs
  the reference's families: ``Health/*`` (finite), ``Perf/*``, ``Time/phase_*``,
  ``Memory/*``, ``Compile/*`` with no recapture;
* a run whose train step raises leaves ``blackbox/events.jsonl`` and ``meta.json``; a
  clean run leaves no blackbox;
* the fleet plane is refused by name (``obs.fleet.dir``, ``SHEEPRL_TPU_FLEET``), as is
  ``logger=mlflow``; ``env=line_dummy`` composes and steps.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from tests.test_torch_dv3_agent import TINY

RUN = [
    *TINY,
    "device=cpu",
    "env.num_envs=2",
    "env.sync_env=True",
    "env.wrapper.n_steps=20",
    "algo.total_steps=32",
    "algo.learning_starts=16",
    "algo.replay_ratio=0.5",
    "checkpoint.every=0",
    "metric.log_every=8",
    "algo.run_test=False",
]


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


class Recorder:
    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, dict(metrics)))

    def close(self):
        pass


@pytest.fixture
def log(monkeypatch):
    import sheeprl_tpu_torch.algos.dreamer_loop as loop

    rec = Recorder()
    monkeypatch.setattr(loop, "get_logger", lambda cfg, log_dir: rec)
    return rec


def test_enabled_run_writes_the_trace_profile_and_perf_report(tmp_path, log):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.obs import flight_recorder, perf, tracer

    result = run([*RUN, f"log_root={tmp_path}", "obs.enabled=True", "obs.capture_steps=[2,3]"])
    log_dir = Path(result.log_dir)
    assert tracer.get_active() is None and flight_recorder.get_active() is None and not perf.registered_cost_models()

    trace = json.loads((log_dir / "trace.json").read_text())
    spans = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"Time/update", "Time/log", "Time/env_interaction_time"} <= spans
    assert {"Time/phase_player", "Time/phase_buffer_add", "Time/phase_env_step", "Time/phase_dispatch", "Time/phase_drain"} <= spans
    window = log_dir / "profile" / "window_rank0_updates2-3.json"
    assert json.loads(window.read_text())["traceEvents"]

    report = json.loads((log_dir / "perf_report.json").read_text())
    model = report["cost_models"]["dreamer_v3/train_block"]
    assert model["flops"] > 0 and model["bytes_accessed"] > 0 and model["calls"] == result.grad_steps
    assert abs(sum(report["goodput_fractions"].values()) - 1.0) < 1e-6
    assert 0 < report["mfu"] and report["device_kind"] == "cpu"

    logged = {k: v for _, m in log.logged for k, v in m.items()}
    health = {k: v for k, v in logged.items() if k.startswith("Health/")}
    assert {"Health/grad_finite_frac", "Health/grad_norm/world_model", "Health/update_ratio/actor", "Health/critic_value_std",
            "Health/replay_age_mean", "Health/param_norm/target_critic"} <= set(health)
    assert all(math.isfinite(v) for v in health.values()) and health["Health/grad_finite_frac"] == 1.0
    assert {"Perf/mfu", "Perf/goodput", "Perf/goodput_other", "Perf/anomalies", "Time/phase_dispatch", "Time/update/p50",
            "Memory/host_peak_rss_bytes", "Compile/recompiles"} <= set(logged)
    assert logged["Compile/recompiles"] == 0.0


def test_default_run_logs_the_plane_and_a_crash_leaves_a_blackbox(tmp_path, log, monkeypatch):
    """At the defaults (``obs.enabled=False``) the health, perf and phase families are
    logged and no trace is written; a clean run leaves no blackbox, a train step that
    raises at its third call leaves one."""
    import sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 as dv3
    from sheeprl_tpu_torch.cli import run

    clean = run([*RUN, f"log_root={tmp_path / 'clean'}"])
    clean_dir = Path(clean.log_dir)
    assert not (clean_dir / "blackbox").exists() and not (clean_dir / "trace.json").exists()
    assert (clean_dir / "perf_report.json").is_file()
    names = {k for _, m in log.logged for k in m}
    assert {"Health/grad_norm/critic", "Perf/goodput", "Time/phase_env_step"} <= names
    assert not any(k.startswith(("Memory/", "Compile/", "Time/update/")) for k in names)

    make = dv3.make_train_step

    def failing(*args, **kwargs):
        step, init = make(*args, **kwargs)
        calls = {"n": 0}

        def train_step(*a, **k):
            calls["n"] += 1
            if calls["n"] == 3:
                raise FloatingPointError("injected at the third gradient step")
            return step(*a, **k)

        for attr in ("sample_draws", "draw_shapes", "init_extra"):
            setattr(train_step, attr, getattr(step, attr))
        return train_step, init

    monkeypatch.setattr(dv3, "make_train_step", failing)
    with pytest.raises(FloatingPointError, match="third gradient step"):
        run([*RUN, f"log_root={tmp_path / 'crash'}", "run_name=crashed"])
    box = next((tmp_path / "crash").rglob("blackbox"))
    events = [json.loads(line) for line in (box / "events.jsonl").read_text().splitlines()]
    assert events and all("kind" in e for e in events)
    meta = json.loads((box / "meta.json").read_text())
    assert meta["reason"] == "crash" and meta["algo"] == "dreamer_v3" and meta["staged_state"] is False
    assert meta["exception"]["type"] == "FloatingPointError"


@pytest.mark.parametrize("override", ["obs.fleet.dir=fleet", "env:SHEEPRL_TPU_FLEET=127.0.0.1:1", "logger=mlflow"])
def test_the_fleet_plane_and_mlflow_are_refused_by_name(tmp_path, monkeypatch, override):
    from sheeprl_tpu_torch.cli import run

    overrides = [*RUN, f"log_root={tmp_path}"]
    if override.startswith("env:"):
        key, _, value = override[4:].partition("=")
        monkeypatch.setenv(key, value)
        match = key
    else:
        overrides.append(override)
        match = r"obs\.fleet\.dir" if override.startswith("obs") else r"logger\.name='mlflow'"
    with pytest.raises(NotImplementedError, match=match):
        run(overrides)


def test_line_dummy_composes_as_the_reference_and_steps(tmp_path):
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.core import compose

    cfg = compose(overrides=["exp=dreamer_v3_dummy", "env=line_dummy", "device=cpu"])
    ref = jax_compose(overrides=["exp=dreamer_v3_dummy", "env=line_dummy"])
    assert cfg.env.wrapper._target_ == "sheeprl_tpu_torch.envs.dummy.LineWalkDummyEnv"
    assert {k: v for k, v in cfg.env.items() if k != "wrapper"} == {k: v for k, v in ref.env.items() if k not in ("wrapper", "pool")}
    result = run([*[o for o in RUN if not o.startswith("env=")], "env=line_dummy", "algo.total_steps=20", f"log_root={tmp_path}"])
    assert result.policy_steps == 20 and result.grad_steps >= 1
