"""What the fault tests of the PyTorch port share (not a test module).

The fault layer is process-global in both packages: the sticky preemption flag, the
``Fault/*`` counters, the chaos schedule and the SIGTERM/SIGINT handlers (and, in the
reference, the named-timer registry that its monitor folds into each flush). A test that
leaves any of them behind changes what a later test in the same worker logs or does:
a reference test that bumped ``Fault/preemptions`` adds that name to every later
reference run's metric flushes (``sheeprl_tpu/obs/monitor.py`` folds the counters in),
and a flag left set preempts the next run at its first boundary. ``clean_fault_state``,
imported into a test module, resets all of it around each of its tests.

Signal handlers install only on the main thread, and a SIGTERM to an xdist worker with
no handler kills it: every run that injects a signal runs on the main thread
(``on_main_thread``)."""

import signal
import threading

import pytest


def reset_fault_state() -> None:
    """Both packages' counters reset (each package's own test hook), flags cleared, chaos
    schedules emptied; and the reference's named-timer registry emptied, which is as
    process-global: a reference PPO run's last checkpoint, timed after its last flush,
    leaves ``Time/phase_checkpoint`` for the next reference run's first flush."""
    from sheeprl_tpu.fault import chaos as ref_chaos
    from sheeprl_tpu.fault import counters as ref_counters
    from sheeprl_tpu.fault import preemption as ref_preemption
    from sheeprl_tpu.utils.timer import timer as ref_timer
    from sheeprl_tpu_torch.fault import chaos, counters, preemption

    ref_timer.reset()

    for mod in (ref_preemption, preemption):
        mod.clear_preemption()
    for mod in (ref_counters, counters):
        mod.reset()
    for mod in (ref_chaos, chaos):
        mod.install({})


@pytest.fixture(autouse=True)
def clean_fault_state():
    """Reset the fault state before and after the test, and put back the SIGTERM and
    SIGINT handlers that were there before it. The reference keeps its handlers
    installed with a module flag, which goes back with them."""
    from sheeprl_tpu.fault import preemption as ref_preemption

    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    ref_installed = ref_preemption._installed
    reset_fault_state()
    yield
    reset_fault_state()
    if threading.current_thread() is threading.main_thread():
        for sig, handler in handlers.items():
            if handler is not None:
                signal.signal(sig, handler)
    ref_preemption._installed = ref_installed


def on_main_thread() -> None:
    """A run that sends itself a signal must run where its handler is installed."""
    assert threading.current_thread() is threading.main_thread(), "a signal drill runs on the main thread only"


class Recorder:
    """A logger that keeps what it was asked to log, by step."""

    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, dict(metrics)))

    def close(self):
        pass

    def fault(self):
        """The logged ``Fault/*`` values, by step."""
        return [(step, {k: v for k, v in m.items() if k.startswith("Fault/")}) for step, m in self.logged]

