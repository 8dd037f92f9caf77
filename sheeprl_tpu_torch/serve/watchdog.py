"""The serving path's capture watchdog (counterpart, for this path, of
``sheeprl_tpu/obs/watchdog.py::RecompileWatchdog``).

The reference counts every compile after ``mark_warm()`` as a recompile. The port's
steady state is the replay of graphs captured at startup, so after ``mark_warm()`` a
violation is any graph capture in the process (``utils/graphs.py::capture_count``) or
any dispatch whose batch shape has no graph (:meth:`missing`). By default violations are
counted (the server's summary reports them as ``recompiles``) and warned about; under
``analysis.strict=True`` the offending dispatch raises :class:`CaptureError`. A
dispatch without a graph never runs the act function eagerly.
"""

from __future__ import annotations

import threading
from typing import Optional

from sheeprl_tpu_torch.utils.graphs import capture_count


class CaptureWarning(UserWarning):
    """A graph was captured, or a batch shape had no graph, after warm-up."""


class CaptureError(RuntimeError):
    """:class:`CaptureWarning` as an error, under ``analysis.strict=True``."""


class CaptureWatchdog:
    def __init__(self):
        self._lock = threading.Lock()
        self._warm_at: Optional[int] = None
        self.missing_graphs = 0
        self._polled = 0

    def mark_warm(self) -> None:
        """Every capture so far was warm-up; any later one is a violation."""
        with self._lock:
            self._warm_at = capture_count()

    @property
    def captures_after_warm(self) -> int:
        return 0 if self._warm_at is None else capture_count() - self._warm_at

    def missing(self) -> None:
        """A dispatch found no graph for its batch shape."""
        with self._lock:
            self.missing_graphs += 1

    @property
    def violations(self) -> int:
        return self.captures_after_warm + self.missing_graphs

    def poll_new(self) -> int:
        """Violations since the last poll."""
        with self._lock:
            total = self.violations
            new, self._polled = total - self._polled, total
        return new
