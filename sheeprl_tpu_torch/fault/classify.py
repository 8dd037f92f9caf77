"""Failure classification (counterpart of ``sheeprl_tpu/fault/classify.py``): the
supervisor's retry/fatal matrix. A relaunch loop asks of each death whether running the
same computation again would do any good:

===========================  ==========  =========================================
observation                  verdict     why
===========================  ==========  =========================================
exit 0                       DONE        the run finished
exit 75 / ``Preempted``      RESUME      graceful preemption: a boundary checkpoint
                                         exists, resume at once
``NonFiniteError``           FATAL       a NaN/Inf follows from the checkpointed
                                         state: the retry meets it at the same step
``SignatureDriftError``      FATAL       a config or code fault, deterministic
``RecompileError``           FATAL       a config or code fault, deterministic
``KeyboardInterrupt``        FATAL       the operator asked for a stop
anything else                RETRY       a crash, out of memory, flaky I/O, SIGKILL:
                                         transient until shown otherwise (bounded by
                                         ``fault.max_retries``)
===========================  ==========  =========================================

The exception's type name comes from the flight recorder's ``blackbox/meta.json``
(``exception.type``) for a dead subprocess, or from the live exception in process: the
same names either way, so both paths share one table. The fatal types are names, not
imports (the port raises none of them yet: its strict mode is not ported).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

from sheeprl_tpu_torch.fault.preemption import RESUMABLE_EXIT_CODE, Preempted

DONE = "done"
RESUME = "resume"  # graceful preemption: restart from the boundary checkpoint now
RETRY = "retry"  # transient: restart with backoff, bounded by fault.max_retries
FATAL = "fatal"  # deterministic: a retry replays the same failure

#: the exception type names that make a retry pointless
FATAL_EXCEPTIONS = frozenset({"NonFiniteError", "SignatureDriftError", "RecompileError", "KeyboardInterrupt"})


def classify_exception(exc: BaseException) -> str:
    """The in-process verdict (``fault.autoresume=True``)."""
    if isinstance(exc, Preempted):
        return RESUME
    return FATAL if type(exc).__name__ in FATAL_EXCEPTIONS else RETRY


def classify_exit(returncode: int, blackbox_meta: Optional[Dict[str, Any]] = None) -> str:
    """A subprocess's verdict (the supervisor): the exit code first, then the blackbox."""
    if returncode == 0:
        return DONE
    if returncode == RESUMABLE_EXIT_CODE:
        return RESUME
    exc_type = ((blackbox_meta or {}).get("exception") or {}).get("type")
    return FATAL if exc_type in FATAL_EXCEPTIONS else RETRY


def read_blackbox_meta(run_dir: Path) -> Optional[Dict[str, Any]]:
    """The newest ``blackbox/meta.json`` under the run dir (any ``version_*``), or None."""
    metas = sorted(Path(run_dir).glob("**/blackbox/meta.json"), key=lambda p: p.stat().st_mtime, reverse=True)
    for meta_path in metas:
        try:
            with open(meta_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
    return None
