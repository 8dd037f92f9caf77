"""Graceful preemption (counterpart of ``sheeprl_tpu/fault/preemption.py``): SIGTERM/SIGINT
set a sticky flag and nothing else; every training loop polls the flag once per update
at its safe boundary (``fault/guard.py::TrainingGuard``, between updates, where the
checkpointable state is what a periodic checkpoint saves), cuts one final checkpoint,
writes the ``PREEMPTED`` marker and raises :class:`Preempted`, which ``cli.run`` turns
into :data:`RESUMABLE_EXIT_CODE` (75, BSD ``EX_TEMPFAIL``: "transient, retry me"). The
policy server polls the flag in its accept loop, drains and returns 75.

The handler takes no checkpoint itself: a signal can land in the middle of a launch,
where the device state is half updated. A second SIGINT restores Python's
``KeyboardInterrupt``; a second SIGTERM exits at once with the resumable code.
``grace_seconds > 0`` arms a deadline that dumps the flight recorder and exits with the
resumable code if the process has not finished that long after the first signal: a
half-written checkpoint is a temporary directory that no resume sees.

Deviations: the reference keeps the handlers installed once with a module flag; here
``install_signal_handlers`` asks ``signal.getsignal`` whether this module's handler is
the one in place, so a handler another module installed in the same process since
(an embedding application's, or the reference's in the port's tests) is replaced rather
than trusted. And the train entry installs them for a job only (``signal_handlers``), the
process's own handlers put back after it: the reference's stay installed, so in a process
that also runs the reference its ``_installed`` flag would outlive its handler. Standard
library only.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.fault import counters as _counters

#: BSD ``EX_TEMPFAIL``: the conventional "transient failure, retry" exit code.
RESUMABLE_EXIT_CODE = 75

#: The marker file written in the run's log dir on a graceful shutdown.
PREEMPTED_MARKER = "PREEMPTED"

_flag = threading.Event()
_signal_name: Optional[str] = None
_grace_seconds: float = 0.0


class Preempted(Exception):
    """A graceful preemption at a training-loop boundary, raised after the final
    checkpoint: the CLI's crash boundary lets it pass without a blackbox dump. Carries the
    policy step the final checkpoint covers, its path and the run's log dir (where the
    ``PREEMPTED`` marker lies)."""

    def __init__(self, step: int, log_dir: Optional[str] = None, ckpt_path: Optional[str] = None):
        self.step = int(step)
        self.log_dir = log_dir
        self.ckpt_path = ckpt_path
        super().__init__(f"preempted ({_signal_name or 'requested'}) at policy step {step}; final checkpoint: {ckpt_path or 'none'}")


def flight_recorder() -> Any:
    """The flight recorder's module where the process loaded it (a recorder can only be
    active then), else None: importing it here would load torch through ``obs``, and the
    supervisor and the Sebulba launcher import this module without torch."""
    return sys.modules.get("sheeprl_tpu_torch.obs.flight_recorder")


def preemption_requested() -> bool:
    """True once a shutdown signal arrived (or :func:`request_preemption` ran)."""
    return _flag.is_set()


def request_preemption(reason: str = "requested") -> None:
    """Set the sticky flag programmatically (tests, embedding applications)."""
    global _signal_name
    if not _flag.is_set():
        _signal_name = reason
        _flag.set()


def clear_preemption() -> None:
    """Drop the sticky flag (in-process autoresume clears it before it runs again)."""
    global _signal_name
    _signal_name = None
    _flag.clear()


def signal_name() -> Optional[str]:
    """The name of the signal (or the reason) that set the flag; None while it is clear."""
    return _signal_name


def _arm_grace_deadline() -> None:
    if _grace_seconds <= 0:
        return

    def deadline() -> None:
        time.sleep(_grace_seconds)
        if _flag.is_set():  # cleared meanwhile (autoresume): the shutdown was called off
            recorder = flight_recorder()
            if recorder is not None:
                recorder.dump_active("preemption_grace_expired")
            os._exit(RESUMABLE_EXIT_CODE)

    threading.Thread(target=deadline, name="fault-grace-deadline", daemon=True).start()


def _handler(signum: int, frame: Any) -> None:
    global _signal_name
    name = signal.Signals(signum).name
    if _flag.is_set():
        # Second signal: the sender is done waiting for the boundary.
        if signum == signal.SIGINT:
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt
        os._exit(RESUMABLE_EXIT_CODE)
    _signal_name = name
    _flag.set()
    _counters.bump("Fault/preemption_signals")
    recorder = flight_recorder()
    if recorder is not None:
        recorder.record_event("preemption_signal", signal=name)
    _arm_grace_deadline()


def install_signal_handlers(grace_seconds: float = 0.0) -> bool:
    """Install the SIGTERM/SIGINT -> sticky-flag handlers (idempotent: a no-op where this
    module's handler is already SIGTERM's). Returns False, changing nothing, off the main
    thread, where Python cannot install handlers."""
    global _grace_seconds
    _grace_seconds = float(grace_seconds or 0.0)
    if signal.getsignal(signal.SIGTERM) is _handler and signal.getsignal(signal.SIGINT) is _handler:
        return True
    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:  # not the main thread
        return False
    return True


@contextlib.contextmanager
def signal_handlers(grace_seconds: float = 0.0):
    """``install_signal_handlers`` for the duration of the block (a train job); the
    SIGTERM and SIGINT handlers in place before it are put back after it. Yields whether
    the handlers were installed (False off the main thread)."""
    previous = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    installed = install_signal_handlers(grace_seconds)
    try:
        yield installed
    finally:
        if installed:
            for sig, handler in previous.items():
                if handler is not None:  # None: a handler not installed from Python
                    signal.signal(sig, handler)


# --------------------------------------------------------------------- marker file
def write_marker(log_dir: os.PathLike, step: int, resume_from: Optional[str] = None) -> Optional[Path]:
    """Write ``<log_dir>/PREEMPTED`` (JSON: step, resume checkpoint, signal, time),
    fsynced: it must outlive the hard kill that follows the grace window. Advisory: a
    resume verifies checkpoints whatever the marker says."""
    try:
        path = Path(log_dir) / PREEMPTED_MARKER
        payload = {"step": int(step), "resume_from": str(resume_from) if resume_from else None, "signal": _signal_name, "time": time.time()}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        return path
    except OSError as e:
        warnings.warn(f"could not write {PREEMPTED_MARKER} marker in {log_dir}: {e}")
        return None


def read_marker(log_dir: os.PathLike) -> Optional[Dict[str, Any]]:
    """Parse ``<log_dir>/PREEMPTED``; None when absent or unreadable."""
    try:
        with open(Path(log_dir) / PREEMPTED_MARKER) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def clear_marker(log_dir: os.PathLike) -> None:
    try:
        (Path(log_dir) / PREEMPTED_MARKER).unlink(missing_ok=True)
    except OSError:
        pass
