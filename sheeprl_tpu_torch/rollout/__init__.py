"""The rollout engine (counterpart of ``sheeprl_tpu/rollout``):

* ``EnvPool``: the shared-memory, multi-process, fault-tolerant vector env behind
  ``env.pool.enabled`` (``pool.py``, its workers ``worker.py``, its slabs ``shared.py``);
* ``PipelinedPlayer``: the policy on the device overlapped with env stepping
  (``rollout.pipeline_depth``, ``pipeline.py``);
* ``rollout_metrics``: the ``Rollout/*`` counters for a loop's metric flush;
* ``RolloutAbortError``: raised when the worker-restart budget is spent;
* ``sharding.py``: an env-pool budget shared across Sebulba actors.

Every name is loaded on first use (``__getattr__``): the pool's workers import
``rollout.worker`` and ``rollout.shared``, which must not load torch, and ``pool.py`` and
``pipeline.py`` do (the pool through the observability plane).
"""

_EXPORTS = {
    "EnvPool": "sheeprl_tpu_torch.rollout.pool",
    "RolloutAbortError": "sheeprl_tpu_torch.rollout.pool",
    "rollout_metrics": "sheeprl_tpu_torch.rollout.pool",
    "PipelinedPlayer": "sheeprl_tpu_torch.rollout.pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
