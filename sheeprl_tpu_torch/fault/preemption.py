"""Graceful preemption, the signal half (counterpart of
``sheeprl_tpu/fault/preemption.py``): SIGTERM/SIGINT set a sticky flag and nothing
else; the process polls the flag at a safe boundary, finishes there and exits
:data:`RESUMABLE_EXIT_CODE` (75, BSD ``EX_TEMPFAIL``: "transient, retry me"). The policy
server polls it in its accept loop, drains and returns 75.

A second SIGINT restores Python's ``KeyboardInterrupt``; a second SIGTERM exits at once
with the resumable code. ``grace_seconds > 0`` arms a deadline that exits with the
resumable code if the process has not finished that long after the first signal.

Not ported yet: the ``PREEMPTED`` marker file and the training guard that cuts a final
checkpoint (the train loops refuse ``fault.autoresume``), and the flight-recorder dump
at the grace deadline. Standard library only.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Optional

#: BSD ``EX_TEMPFAIL``: the conventional "transient failure, retry" exit code.
RESUMABLE_EXIT_CODE = 75

_flag = threading.Event()
_installed = False
_signal_name: Optional[str] = None
_grace_seconds: float = 0.0


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
    """Drop the sticky flag."""
    global _signal_name
    _signal_name = None
    _flag.clear()


def _arm_grace_deadline() -> None:
    if _grace_seconds <= 0:
        return

    def deadline() -> None:
        time.sleep(_grace_seconds)
        if _flag.is_set():  # cleared meanwhile: the shutdown was called off
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
    _arm_grace_deadline()


def install_signal_handlers(grace_seconds: float = 0.0) -> bool:
    """Install the SIGTERM/SIGINT -> sticky-flag handlers (idempotent). Returns False,
    changing nothing, off the main thread, where Python cannot install handlers."""
    global _installed, _grace_seconds
    _grace_seconds = float(grace_seconds or 0.0)
    if _installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    except ValueError:  # not the main thread
        return False
    _installed = True
    return True
