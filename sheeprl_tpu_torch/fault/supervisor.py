"""The autoresume supervisor (counterpart of ``sheeprl_tpu/fault/supervisor.py``):
``python -m sheeprl_tpu_torch.supervise <overrides>``.

It wraps a training run in a relaunch loop, as a fleet scheduler would, on one host and
with the repo's own failure classification (``fault/classify.py``):

1. compose the config once to pin ``run_name``, so that every attempt lands in one run
   directory (its checkpoints, markers and blackboxes together);
2. launch ``python -m sheeprl_tpu_torch <overrides> run_name=<pinned>`` as a
   subprocess, with ``checkpoint.resume_from=<newest valid checkpoint>`` from the second
   attempt on;
3. classify each death: exit 0 is done; exit 75 (graceful preemption) resumes at once;
   a blackbox whose exception is deterministic (``NonFiniteError``, ...) stops; anything
   else retries with bounded exponential backoff (``fault.backoff_s`` doubling up to
   ``fault.backoff_max_s``, at most ``fault.max_retries`` times);
4. resume from the newest checkpoint that verifies (``CheckpointManager.verify``: a
   truncated or bit-flipped newest checkpoint is skipped, never deserialised), searching
   every ``version_*`` of the run (each attempt logs into a new version).

Children get ``SHEEPRL_TPU_FAULT_RESTARTS``, so that their ``Fault/restarts`` counter
reports the cumulative relaunch count, and ``fault.autoresume=False``, so that the retry
accounting lives in one place. Deviation: the chaos schedule's step faults
(``CHAOS_STEP_FAULTS``) go to the first attempt only. A relaunch resumes from the newest
valid checkpoint, which after a SIGKILL or a corrupted checkpoint lies before the
faults' steps; the reference relaunches with them, so its children meet them again and
its loop ends only when the retry budget is spent. ``fault.autoresume=True`` runs the
same loop in process (``cli.run``); only this supervisor survives SIGKILL or the
out-of-memory killer.

``--serve`` wraps a ``python -m sheeprl_tpu_torch.serve`` replica instead
(:func:`supervise_serve`): exit 0 is done, exit 75 (drained on SIGTERM) respawns at once
(bounded by ``fault.max_preemptions``), anything else retries with the same backoff on
the consecutive crash count, ``fault.max_retries`` bounding all crashes. Every exit of
either loop writes a summary to ``fault.summary_path`` or
``$SHEEPRL_TPU_SUPERVISE_SUMMARY``. Not ported: the fleet mode
(``serve.fleet.enabled=True``) and the fleet telemetry plane (``obs.fleet.dir``), which
``supervise_serve`` refuses by name.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from sheeprl_tpu_torch.fault import classify as _classify
from sheeprl_tpu_torch.fault.counters import RESTARTS_ENV_VAR
from sheeprl_tpu_torch.fault.preemption import RESUMABLE_EXIT_CODE

#: where the supervisor's exit summary lands (over ``fault.summary_path``)
SUPERVISE_SUMMARY_ENV_VAR = "SHEEPRL_TPU_SUPERVISE_SUMMARY"

#: the chaos schedule's step faults, which only a supervised run's first attempt gets
CHAOS_STEP_FAULTS = ("chaos.kill_at_step", "chaos.corrupt_ckpt_at_step", "chaos.delay_at_step")


def fault_cfg(cfg: Any) -> Dict[str, Any]:
    """The config's ``fault`` group as a plain dict ({} where it has none)."""
    try:
        section = cfg.get("fault") if hasattr(cfg, "get") else getattr(cfg, "fault", None)
    except Exception:
        section = None
    return dict(section) if section else {}


def run_dir_for(cfg: Any) -> Path:
    """The run's root directory (every ``version_*`` attempt lives under it)."""
    return Path(cfg.get("log_root", "logs")) / "runs" / str(cfg["root_dir"]) / str(cfg["run_name"])


def find_resume_checkpoint(run_dir: os.PathLike) -> Optional[Path]:
    """The newest valid checkpoint across every ``version_*`` of the run, by (step,
    version): a later attempt resumes from the newest step wherever it was written. A
    checkpoint that fails ``CheckpointManager.verify`` is skipped, never deserialised."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    run_dir = Path(run_dir)
    if not run_dir.exists():
        return None

    def sort_key(ckpt: Path) -> Tuple[int, int]:
        step = int(ckpt.name.split("_")[1])
        version_dir = ckpt.parent.parent.name  # version_N/checkpoints/ckpt_S
        version = int(version_dir.split("_")[1]) if version_dir.startswith("version_") else -1
        return (step, version)

    candidates = sorted(run_dir.glob("version_*/checkpoints/ckpt_*"), key=sort_key, reverse=True)
    for candidate in candidates:
        if candidate.is_dir() and CheckpointManager.verify(candidate):
            return candidate
    return None


def backoff_seconds(retries: int, base_s: float, max_s: float) -> float:
    """Exponential backoff for retry number ``retries`` (1-based): base * 2^(n-1)."""
    return min(float(base_s) * (2 ** max(retries - 1, 0)), float(max_s))


def _strip_override(overrides: List[str], key: str) -> Tuple[List[str], Optional[str]]:
    """``overrides`` without ``key=...``, and the value it had (None if absent)."""
    value = None
    kept = []
    for ov in overrides:
        if ov.startswith(f"{key}="):
            value = ov.split("=", 1)[1]
        else:
            kept.append(ov)
    return kept, value


def _log(msg: str) -> None:
    print(f"[supervise] {msg}", flush=True)


def write_supervisor_summary(f_cfg: Dict[str, Any], doc: Dict[str, Any]) -> Optional[Path]:
    """Write the supervisor's lifetime summary atomically (every exit of a supervising
    loop calls it: clean, out of budget or crashed)."""
    path = os.environ.get(SUPERVISE_SUMMARY_ENV_VAR) or f_cfg.get("summary_path")
    if not path:
        return None
    out = Path(str(path))
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp_name = tempfile.mkstemp(prefix=f".{out.name}.", suffix=".tmp", dir=out.parent)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp_name, out)
    return out


def _budgets(f_cfg: Dict[str, Any]) -> Tuple[int, Optional[Any], float, float]:
    return (int(f_cfg.get("max_retries", 3)), f_cfg.get("max_preemptions"), float(f_cfg.get("backoff_s", 2.0)),
            float(f_cfg.get("backoff_max_s", 60.0)))


def supervise_serve(overrides: List[str]) -> int:
    """The serving relaunch loop: keep one stateless replica alive. A drained preemption
    (rc 75) answered every accepted request, so the respawn is immediate; crashes back off
    on the consecutive crash count (a clean drain in between resets it), while
    ``fault.max_retries`` bounds all crashes."""
    from sheeprl_tpu_torch.config.core import compose

    cfg = compose(config_name="serve_cli", overrides=overrides)
    if bool(((cfg.get("serve") or {}).get("fleet") or {}).get("enabled", False)):
        raise NotImplementedError(
            "serve.fleet.enabled=True asks for the fleet manager (a front and N replicas, autoscaling, canary), which the "
            "PyTorch port does not have yet"
        )
    fleet_dir = ((cfg.get("obs") or {}).get("fleet") or {}).get("dir")
    if fleet_dir:
        raise NotImplementedError(f"obs.fleet.dir={fleet_dir!r} asks for the fleet telemetry plane's aggregator, which the PyTorch port does not have yet")
    f_cfg = fault_cfg(cfg)
    max_retries, max_preemptions, base_backoff, max_backoff = _budgets(f_cfg)

    retries = 0  # all crashes, bounded by fault.max_retries
    preemptions = 0
    consecutive_crashes = 0  # the backoff's input; a clean preemption resets it
    summary: Dict[str, Any] = {"mode": "serve", "attempts": 0, "retries": 0, "preemptions": 0, "events": [], "outcome": None, "rc": None}

    def finish(outcome: str, rc: int) -> int:
        summary["outcome"] = outcome
        summary["rc"] = rc
        return rc

    try:
        while True:
            env = dict(os.environ)
            env[RESTARTS_ENV_VAR] = str(retries + preemptions)
            summary["attempts"] += 1
            _log(f"serve attempt {retries + preemptions + 1} (retries={retries}/{max_retries}, preemptions={preemptions})")
            proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch.serve"] + overrides, env=env)
            rc = proc.returncode
            if rc == 0:
                _log("replica shut down cleanly")
                return finish("clean", 0)
            if rc == RESUMABLE_EXIT_CODE:
                preemptions += 1
                consecutive_crashes = 0  # a correct drain shows the binary healthy
                summary["preemptions"] = preemptions
                summary["events"].append({"kind": "preemption", "rc": rc, "time": time.time()})
                if max_preemptions is not None and preemptions > int(max_preemptions):
                    _log(f"exceeded fault.max_preemptions={max_preemptions}; giving up")
                    return finish("preemption_budget", rc)
                _log(f"replica drained on preemption (rc={rc}); respawning immediately")
                continue
            retries += 1
            consecutive_crashes += 1
            summary["retries"] = retries
            summary["events"].append({"kind": "crash", "rc": rc, "time": time.time()})
            if retries > max_retries:
                _log(f"exceeded fault.max_retries={max_retries}; giving up (rc={rc})")
                return finish("retry_budget", rc if rc else 1)
            delay = backoff_seconds(consecutive_crashes, base_backoff, max_backoff)
            _log(f"replica died (rc={rc}); retry {retries}/{max_retries} (consecutive crash {consecutive_crashes}) in {delay:.1f}s")
            time.sleep(delay)
    except BaseException:
        if summary["outcome"] is None:
            summary["outcome"] = "supervisor_crashed"
        raise
    finally:
        write_supervisor_summary(f_cfg, summary)


def supervise(args: Optional[List[str]] = None) -> int:
    """The training relaunch loop; returns the exit code to die with. Its summary (where
    ``fault.summary_path`` or the environment names a file) lists every attempt's exit
    code, verdict and the checkpoint it resumed from."""
    from sheeprl_tpu_torch.config.core import compose

    overrides = list(args if args is not None else sys.argv[1:])
    if "--serve" in overrides:
        return supervise_serve([ov for ov in overrides if ov != "--serve"])
    if "-m" in overrides or "--multirun" in overrides:
        raise ValueError("the supervisor wraps a single run; use one supervisor per sweep job")
    # the supervisor owns the retry accounting: children never resume themselves, and the
    # run name is pinned so that every attempt shares one run directory
    overrides, _ = _strip_override(overrides, "fault.autoresume")
    overrides, _ = _strip_override(overrides, "+fault.autoresume")
    cfg = compose(overrides=overrides)
    if not cfg.get("run_name"):
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        cfg.run_name = f"{stamp}_{cfg.get('exp_name', 'run')}_{cfg.get('seed', 0)}_supervised"
    overrides, _ = _strip_override(overrides, "run_name")
    f_cfg = fault_cfg(cfg)
    max_retries, max_preemptions, base_backoff, max_backoff = _budgets(f_cfg)
    run_dir = run_dir_for(cfg)

    retries = 0  # crash relaunches, bounded by fault.max_retries
    preemptions = 0  # graceful resumes, unbounded unless fault.max_preemptions
    resume_from: Optional[str] = cfg.get("checkpoint", {}).get("resume_from")
    summary: Dict[str, Any] = {"mode": "train", "run_dir": str(run_dir), "attempts": [], "retries": 0, "preemptions": 0,
                               "outcome": None, "rc": None}

    def finish(outcome: str, rc: int) -> int:
        summary.update(outcome=outcome, rc=rc, retries=retries, preemptions=preemptions)
        return rc

    relaunch = list(overrides)
    for key in CHAOS_STEP_FAULTS:
        for form in (key, f"+{key}"):
            relaunch, _ = _strip_override(relaunch, form)
    try:
        while True:
            attempt = [*(relaunch if summary["attempts"] else overrides), f"run_name={cfg.run_name}", "fault.autoresume=False"]
            if resume_from:
                attempt = [ov for ov in attempt if not ov.startswith("checkpoint.resume_from=")] + [f"checkpoint.resume_from={resume_from}"]
            env = dict(os.environ)
            env[RESTARTS_ENV_VAR] = str(retries + preemptions)
            attempt_start = time.time()
            _log(f"attempt {retries + preemptions + 1} (retries={retries}/{max_retries}, preemptions={preemptions})"
                 + (f", resuming from {resume_from}" if resume_from else ""))
            proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch"] + attempt, env=env)
            rc = proc.returncode

            meta = None
            if rc not in (0, RESUMABLE_EXIT_CODE):
                meta = _classify.read_blackbox_meta(run_dir)
                if meta is not None and float(meta.get("time", 0) or 0) < attempt_start - 1:
                    meta = None  # an earlier attempt's dump: not this death's story
            verdict = _classify.classify_exit(rc, meta)
            exc_type = ((meta or {}).get("exception") or {}).get("type")
            summary["attempts"].append({"rc": rc, "verdict": verdict, "exception": exc_type, "resume_from": resume_from,
                                        "seconds": time.time() - attempt_start})

            if verdict == _classify.DONE:
                _log("run completed")
                return finish("done", 0)
            if verdict == _classify.FATAL:
                _log(f"fatal failure ({exc_type or 'unknown'}, rc={rc}): a retry would replay it; giving up")
                return finish("fatal", rc if rc else 1)
            if verdict == _classify.RESUME:
                preemptions += 1
                if max_preemptions is not None and preemptions > int(max_preemptions):
                    _log(f"exceeded fault.max_preemptions={max_preemptions}; giving up")
                    return finish("preemption_budget", rc)
                _log(f"graceful preemption (rc={rc}); resuming immediately")
            else:  # RETRY
                retries += 1
                if retries > max_retries:
                    _log(f"exceeded fault.max_retries={max_retries}; giving up (rc={rc})")
                    return finish("retry_budget", rc if rc else 1)
                delay = backoff_seconds(retries, base_backoff, max_backoff)
                _log(f"transient failure (rc={rc}); retry {retries}/{max_retries} in {delay:.1f}s")
                time.sleep(delay)

            ckpt = find_resume_checkpoint(run_dir)
            if ckpt is None:
                _log("no valid checkpoint yet; restarting from scratch")
                resume_from = None
            else:
                resume_from = str(ckpt)
    except BaseException:
        if summary["outcome"] is None:
            summary["outcome"] = "supervisor_crashed"
        raise
    finally:
        write_supervisor_summary(f_cfg, summary)


def main(args: Optional[List[str]] = None) -> None:
    sys.exit(supervise(args))
