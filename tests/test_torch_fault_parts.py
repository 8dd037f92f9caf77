"""The PyTorch port's fault layer part by part (``sheeprl_tpu_torch/fault``), each held
against the JAX package's on the same inputs: the classify matrix, the backoff, the
resume checkpoint's search over ``version_*`` dirs whose newest checkpoint is corrupted,
``corrupt_file``, the ``PREEMPTED`` marker, ``ChaosMonkey``'s edge triggers (a resumed
run past a threshold too), the training guard's save, its fallback when the save fails,
and its marker; the grace deadline in a subprocess; the handler check that replaces
another module's SIGTERM handler."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_fault_common import clean_fault_state, on_main_thread  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent


def packages():
    """(reference, port) module namespaces of the fault layer and checkpoint manager."""
    import types

    from sheeprl_tpu.checkpoint import manager as ref_manager
    from sheeprl_tpu.fault import chaos as ref_chaos
    from sheeprl_tpu.fault import classify as ref_classify
    from sheeprl_tpu.fault import counters as ref_counters
    from sheeprl_tpu.fault import guard as ref_guard
    from sheeprl_tpu.fault import preemption as ref_preemption
    from sheeprl_tpu.fault import supervisor as ref_supervisor
    from sheeprl_tpu_torch.checkpoint import manager
    from sheeprl_tpu_torch.fault import chaos, classify, counters, guard, preemption, supervisor

    ref = types.SimpleNamespace(chaos=ref_chaos, classify=ref_classify, counters=ref_counters, guard=ref_guard,
                                preemption=ref_preemption, supervisor=ref_supervisor, manager=ref_manager)
    port = types.SimpleNamespace(chaos=chaos, classify=classify, counters=counters, guard=guard, preemption=preemption,
                                 supervisor=supervisor, manager=manager)
    return ref, port


class NonFiniteError(Exception):
    pass


class SignatureDriftError(Exception):
    pass


def test_classify_matrix_matches_the_reference():
    ref, port = packages()
    metas = [None, {}, {"exception": {"type": "NonFiniteError"}}, {"exception": {"type": "RuntimeError"}},
             {"exception": {"type": "KeyboardInterrupt"}}, {"exception": None}]
    for rc in (0, 75, -9, 1, 137):
        for meta in metas:
            got = port.classify.classify_exit(rc, meta)
            assert got == ref.classify.classify_exit(rc, meta), (rc, meta)
    assert [port.classify.classify_exit(rc) for rc in (0, 75, -9, 1)] == ["done", "resume", "retry", "retry"]
    assert port.classify.classify_exit(1, metas[2]) == "fatal" and port.classify.classify_exit(-9, metas[2]) == "fatal"
    excs = [RuntimeError("x"), NonFiniteError(), SignatureDriftError(), KeyboardInterrupt(), OSError()]
    for exc in excs:
        assert port.classify.classify_exception(exc) == ref.classify.classify_exception(exc), exc
    assert port.classify.classify_exception(port.preemption.Preempted(3)) == "resume"
    assert ref.classify.classify_exception(ref.preemption.Preempted(3)) == "resume"
    assert port.classify.FATAL_EXCEPTIONS == ref.classify.FATAL_EXCEPTIONS


def test_read_blackbox_meta_takes_the_newest_readable(tmp_path):
    ref, port = packages()
    for i, body in enumerate(['{"exception": {"type": "NonFiniteError"}}', "not json{"]):
        d = tmp_path / f"version_{i}" / "blackbox"
        d.mkdir(parents=True)
        (d / "meta.json").write_text(body)
        os.utime(d / "meta.json", (1000 + i, 1000 + i))
    assert port.classify.read_blackbox_meta(tmp_path) == ref.classify.read_blackbox_meta(tmp_path) == {"exception": {"type": "NonFiniteError"}}
    assert port.classify.read_blackbox_meta(tmp_path / "none") is None


def test_backoff_and_override_strip_match_the_reference():
    ref, port = packages()
    for retries in range(0, 9):
        for base, cap in ((2.0, 60.0), (0.5, 3.0), (0.0, 1.0)):
            assert port.supervisor.backoff_seconds(retries, base, cap) == ref.supervisor.backoff_seconds(retries, base, cap)
    ovs = ["exp=ppo", "fault.autoresume=True", "seed=3", "fault.autoresume=False"]
    assert port.supervisor._strip_override(ovs, "fault.autoresume") == ref.supervisor._strip_override(ovs, "fault.autoresume")


def test_find_resume_checkpoint_skips_a_corrupted_newest_across_versions(tmp_path):
    """The same layout in each package's format: version_0 with ckpt_16 and ckpt_32,
    version_1 with ckpt_32 and ckpt_48, the newest (ckpt_48) bit-flipped, then truncated
    as well as version_1's ckpt_32."""
    ref, port = packages()
    layout = {0: (16, 32), 1: (32, 48)}
    roots = {}
    for name, pkg, state in (("ref", ref, {"w": np.arange(64, dtype=np.float32)}), ("port", port, {"w": torch.arange(64.0)})):
        root = tmp_path / name
        for version, steps in layout.items():
            mgr = pkg.manager.CheckpointManager(root / f"version_{version}" / "checkpoints", keep_last=None)
            for step in steps:
                mgr.save(step, state)
        roots[name] = (pkg, root)

    def found():
        return {name: str(pkg.supervisor.find_resume_checkpoint(root).relative_to(root)) for name, (pkg, root) in roots.items()}

    assert found() == {"ref": "version_1/checkpoints/ckpt_48", "port": "version_1/checkpoints/ckpt_48"}
    for name, (pkg, root) in roots.items():
        victim = max((root / "version_1/checkpoints/ckpt_48").iterdir(), key=lambda p: p.stat().st_size)
        pkg.chaos.corrupt_file(victim, mode="bitflip", seed=7)
    assert found() == {"ref": "version_1/checkpoints/ckpt_32", "port": "version_1/checkpoints/ckpt_32"}
    for name, (pkg, root) in roots.items():
        victim = max((root / "version_1/checkpoints/ckpt_32").iterdir(), key=lambda p: p.stat().st_size)
        pkg.chaos.corrupt_file(victim, mode="truncate")
    assert found() == {"ref": "version_0/checkpoints/ckpt_32", "port": "version_0/checkpoints/ckpt_32"}
    assert port.supervisor.find_resume_checkpoint(tmp_path / "missing") is None


@pytest.mark.parametrize("mode,seed", [("bitflip", 0), ("bitflip", 12345), ("truncate", 0)])
def test_corrupt_file_damages_the_same_bytes(tmp_path, mode, seed):
    ref, port = packages()
    data = np.random.default_rng(seed).integers(0, 256, 4099, dtype=np.uint8).tobytes()
    for name in ("ref", "port"):
        (tmp_path / name).write_bytes(data)
    ref.chaos.corrupt_file(tmp_path / "ref", mode=mode, seed=seed)
    port.chaos.corrupt_file(tmp_path / "port", mode=mode, seed=seed)
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "ref").read_bytes() and got != data


def test_marker_round_trip_matches_the_reference(tmp_path):
    ref, port = packages()
    markers = {}
    for name, pkg in (("ref", ref), ("port", port)):
        pkg.preemption.request_preemption("SIGTERM")
        d = tmp_path / name
        d.mkdir()
        path = pkg.preemption.write_marker(d, 128, resume_from="runs/x/version_0/checkpoints/ckpt_128")
        assert path == d / "PREEMPTED" and pkg.preemption.PREEMPTED_MARKER == "PREEMPTED"
        markers[name] = pkg.preemption.read_marker(d)
        pkg.preemption.clear_marker(d)
        assert pkg.preemption.read_marker(d) is None
        (d / "PREEMPTED").write_text("not json{")
        assert pkg.preemption.read_marker(d) is None
    assert set(markers["port"]) == set(markers["ref"]) == {"step", "resume_from", "signal", "time"}
    assert {k: v for k, v in markers["port"].items() if k != "time"} == {k: v for k, v in markers["ref"].items() if k != "time"}
    assert port.preemption.signal_name() == ref.preemption.signal_name() == "SIGTERM"


SCHEDULES = [
    # (chaos config, resumed, boundary steps)
    ({"kill_at_step": 32, "corrupt_ckpt_at_step": 16, "delay_at_step": 8, "delay_ms": 0}, False, [8, 16, 24, 32, 40, 48]),
    ({"kill_at_step": 30, "corrupt_ckpt_at_step": 30, "delay_at_step": 31, "delay_ms": 0}, False, [16, 32, 48]),
    # resumed past every threshold: nothing fires
    ({"kill_at_step": 32, "corrupt_ckpt_at_step": 16, "delay_at_step": 8, "delay_ms": 0}, True, [40, 48, 56]),
    # resumed before them: they fire on the crossing
    ({"kill_at_step": 32, "corrupt_ckpt_at_step": 16, "delay_at_step": 8, "delay_ms": 0}, True, [8, 16, 24, 32]),
    ({"kill_at_step": 32}, True, [32, 40]),
    ({}, False, [8, 16]),
]


@pytest.mark.parametrize("chaos_cfg,resumed,steps", SCHEDULES)
def test_chaos_monkey_edge_triggers_match_the_reference(chaos_cfg, resumed, steps):
    ref, port = packages()
    fired = {}
    for name, pkg in (("ref", ref), ("port", port)):
        monkey = pkg.chaos.ChaosMonkey({"chaos": chaos_cfg}, ckpt_dir=None, resumed=resumed)
        events = []
        monkey._kill = lambda events=events, monkey=monkey: events.append(("kill", monkey._last_step))
        monkey._corrupt_latest = lambda step, events=events: events.append(("corrupt", step))
        for step in steps:
            before = pkg.counters.fault_metrics().get("Fault/chaos_injected", 0)
            monkey.fire(step)
            if pkg.counters.fault_metrics().get("Fault/chaos_injected", 0) > before:
                events.append(("injected", step))
        fired[name] = (events, monkey.enabled, sorted(monkey._fired))
    assert fired["port"] == fired["ref"]


def test_chaos_install_validates_like_the_reference():
    ref, port = packages()
    for cfg in ({"chaos": {"kill_at_step": 3, "kill_signal": "SIGHUP"}}, {"chaos": {"corrupt_ckpt_at_step": 3, "corrupt_mode": "zero"}},
                {"chaos": {"worker_fault_at_step": 3, "worker_fault_mode": "explode"}}):
        for pkg in (ref, port):
            with pytest.raises(ValueError):
                pkg.chaos.install(cfg)
    for pkg in (ref, port):
        pkg.chaos.install({"chaos": {"kill_at_step": 3, "kill_signal": "sigkill", "corrupt_ckpt_at_step": 2}})


def test_chaos_corrupts_the_largest_pt_of_the_newest_checkpoint(tmp_path):
    _, port = packages()
    mgr = port.manager.CheckpointManager(tmp_path / "checkpoints")
    mgr.save(16, {"small": torch.zeros(4), "big": torch.zeros(4096)})
    mgr.save(32, {"small": torch.zeros(4), "big": torch.zeros(4096)})
    before = (tmp_path / "checkpoints/ckpt_32/big.pt").read_bytes()
    monkey = port.chaos.ChaosMonkey({"chaos": {"corrupt_ckpt_at_step": 32, "seed": 5}}, ckpt_dir=tmp_path / "checkpoints")
    monkey.fire(32)
    after = (tmp_path / "checkpoints/ckpt_32/big.pt").read_bytes()
    assert sum(a != b for a, b in zip(before, after)) == 1 and after[5] == before[5] ^ 1
    assert not port.manager.CheckpointManager.verify(tmp_path / "checkpoints/ckpt_32")
    assert port.manager.CheckpointManager.latest_valid(tmp_path / "checkpoints").name == "ckpt_16"
    assert port.counters.fault_metrics() == {"Fault/chaos_injected": 1}


def _guard_outcome(pkg, log_dir: Path, state, fail: bool):
    """A guard's boundary under a requested preemption: the ``Preempted`` it raises, the
    marker and the counters, with a save closure that writes ckpt_48 (or fails)."""
    ckpt_dir = log_dir / "checkpoints"
    mgr = pkg.manager.CheckpointManager(ckpt_dir)
    mgr.save(16, state)
    mgr.save(32, state)
    pkg.chaos.corrupt_file(max((ckpt_dir / "ckpt_32").iterdir(), key=lambda p: p.stat().st_size), mode="truncate")

    def save_ckpt():
        if fail:
            raise OSError("disk full")
        return mgr.save(48, state)

    guard = pkg.guard.TrainingGuard({"chaos": {}}, str(log_dir))
    guard.boundary(40, save_ckpt)  # no preemption yet: nothing happens
    pkg.preemption.request_preemption("SIGTERM")
    with pytest.raises(pkg.preemption.Preempted) as info:
        if fail:
            with pytest.warns(UserWarning, match="preemption checkpoint at step 48 failed"):
                guard.boundary(48, save_ckpt)
        else:
            guard.boundary(48, save_ckpt)
    exc = info.value
    marker = pkg.preemption.read_marker(log_dir)
    rel = lambda p: str(Path(p).relative_to(log_dir)) if p else None  # noqa: E731
    return {"step": exc.step, "ckpt": rel(exc.ckpt_path), "log_dir": exc.log_dir == str(log_dir), "marker_step": marker["step"],
            "marker_resume": rel(marker["resume_from"]), "signal": marker["signal"], "counters": pkg.counters.fault_metrics()}


@pytest.mark.parametrize("fail", [False, True], ids=["save", "failed-save"])
def test_guard_saves_falls_back_and_marks_like_the_reference(tmp_path, fail):
    ref, port = packages()
    got = {"ref": _guard_outcome(ref, tmp_path / "ref", {"w": np.ones(8, np.float32)}, fail),
           "port": _guard_outcome(port, tmp_path / "port", {"w": torch.ones(8)}, fail)}
    assert got["port"] == got["ref"]
    # a failed save falls back to the newest checkpoint that verifies (ckpt_32 is truncated)
    assert got["port"]["ckpt"] == ("checkpoints/ckpt_16" if fail else "checkpoints/ckpt_48")
    assert got["port"]["counters"] == {"Fault/preemptions": 1}


def test_the_handler_check_replaces_another_modules_handler():
    """The reference's flag says "installed" while the port's handler is gone: the port
    looks at the handler in place, so a SIGTERM still reaches its flag."""
    ref, port = packages()
    on_main_thread()
    assert port.preemption.install_signal_handlers()
    ref.preemption._installed = False
    assert ref.preemption.install_signal_handlers()  # the reference's handler replaces the port's
    assert signal.getsignal(signal.SIGTERM) is ref.preemption._handler
    assert port.preemption.install_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) is port.preemption._handler
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5.0
    while not port.preemption.preemption_requested() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert port.preemption.preemption_requested() and port.preemption.signal_name() == "SIGTERM"
    assert not ref.preemption.preemption_requested()
    assert port.counters.fault_metrics() == {"Fault/preemption_signals": 1}


def test_grace_deadline_dumps_the_flight_recorder_and_exits_75(tmp_path):
    """A process whose boundary never comes: the deadline dumps the active recorder's
    black box and exits with the resumable code, in a process of its own."""
    code = (
        "import os, signal, time\n"
        "from sheeprl_tpu_torch.obs import flight_recorder\n"
        "from sheeprl_tpu_torch.fault import preemption\n"
        f"flight_recorder.install(flight_recorder.FlightRecorder({str(tmp_path)!r}, algo='drill'))\n"
        "assert preemption.install_signal_handlers(grace_seconds=0.5)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "print('flagged', flush=True)\n"
        "time.sleep(60)\n"
        "print('not reached', flush=True)\n"
    )
    start = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 75 and proc.stdout == "flagged\n", (proc.returncode, proc.stdout, proc.stderr[-2000:])
    assert time.monotonic() - start < 50
    meta = json.loads((tmp_path / "blackbox" / "meta.json").read_text())
    events = [json.loads(line) for line in (tmp_path / "blackbox" / "events.jsonl").read_text().splitlines()]
    assert meta["reason"] == "preemption_grace_expired" and meta["fault_counters"] == {"Fault/preemption_signals": 1}
    assert [e["kind"] for e in events] == ["preemption_signal"] and events[0]["signal"] == "SIGTERM"


def test_a_second_sigterm_exits_75_at_once():
    code = (
        "import os, signal, time\n"
        "from sheeprl_tpu_torch.fault import preemption\n"
        "assert preemption.install_signal_handlers()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "while not preemption.preemption_requested():\n"
        "    time.sleep(0.01)\n"
        "print('flagged', flush=True)\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "time.sleep(60)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 75 and proc.stdout == "flagged\n", (proc.returncode, proc.stdout, proc.stderr[-2000:])
