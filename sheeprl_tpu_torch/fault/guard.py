"""``TrainingGuard`` (counterpart of ``sheeprl_tpu/fault/guard.py``): the safe-boundary hook
every training loop calls once per update::

    guard = TrainingGuard(cfg, log_dir)            # beside the loop's CheckpointManager
    ...
    for update in ...:
        ...train, log, periodic checkpoint...
        guard.boundary(policy_step, save_ckpt)     # the end of every update

``boundary`` first fires the chaos faults that cross this step (``fault/chaos.py``:
inert without a schedule), then looks at the sticky preemption flag
(``fault/preemption.py``). When it is set, it calls ``save_ckpt``, the loop's own
checkpoint closure (so the preemption checkpoint holds what a periodic one holds), falls
back to the newest valid checkpoint on disk where the closure failed or returned
nothing, writes the ``PREEMPTED`` marker and raises ``Preempted``. The boundary sits at
the end of the update, after the periodic checkpoint: the loop's counters then describe
finished work, and a resume neither repeats nor skips an update.

Cost with no schedule and no signal: two attribute checks.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Callable, Optional

from sheeprl_tpu_torch.fault import counters as _counters
from sheeprl_tpu_torch.fault import preemption
from sheeprl_tpu_torch.fault.chaos import ChaosMonkey
from sheeprl_tpu_torch.obs import flight_recorder as _flight_recorder


class TrainingGuard:
    def __init__(self, cfg: Any, log_dir: Optional[str] = None, ckpt_dir: Optional[str] = None):
        self.cfg = cfg
        self.log_dir = str(log_dir) if log_dir else None
        # every entry keeps its checkpoints in <log_dir>/checkpoints: the chaos corruption
        # and the marker's resume hint both look there
        if ckpt_dir is None and log_dir:
            ckpt_dir = str(Path(log_dir) / "checkpoints")
        self.ckpt_dir = ckpt_dir
        self.chaos = ChaosMonkey(cfg, ckpt_dir=ckpt_dir)

    def boundary(self, step: int, save_ckpt: Optional[Callable[[], Any]] = None) -> None:
        """Call once per update with the current policy step; ``save_ckpt`` is the loop's
        checkpoint closure (returns the checkpoint's path, or None)."""
        if self.chaos.enabled:
            self.chaos.fire(step)
        if preemption.preemption_requested():
            self._preempt(int(step), save_ckpt)

    def _preempt(self, step: int, save_ckpt: Optional[Callable[[], Any]]) -> None:
        sig = preemption.signal_name()
        _counters.bump("Fault/preemptions")
        _flight_recorder.record_event("preemption", step=step, signal=sig)
        ckpt_path = None
        if save_ckpt is not None:
            try:
                ckpt_path = save_ckpt()
            except Exception as e:  # a failed goodbye checkpoint must not mask the exit
                warnings.warn(f"preemption checkpoint at step {step} failed: {e}")
        if ckpt_path is None and self.ckpt_dir is not None:
            from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

            ckpt_path = CheckpointManager.latest_valid(self.ckpt_dir)
        if self.log_dir:
            preemption.write_marker(self.log_dir, step, resume_from=ckpt_path)
        raise preemption.Preempted(step, log_dir=self.log_dir, ckpt_path=str(ckpt_path) if ckpt_path else None)
