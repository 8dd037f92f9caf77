"""What every train loop of the port shares (the Dreamer loop, ``dreamer_loop.py``, the
PPO family's, ``ppo/ppo.py``, and the SAC family's, ``sac/sac.py``): ``grads`` (one loss's gradient over a parameter
list), ``update_module`` (one optimizer update, its norms given to the step's health
probe), ``refuse_unported`` (the reference's loop keys the port does not have; a loop
names the ones it reads itself: ``REGISTERS`` where its reference registers the run's
last checkpoint in the model registry), ``register_last_checkpoint`` and
``TrainResult`` (what a train entry returns)."""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch


def grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradient of ``loss`` with respect to ``params`` (zeros where it does not
    depend on one), leaving every ``.grad`` untouched."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def update_module(probe, name: str, opt, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any]) -> torch.Tensor:
    """``opt.update(params, grads, state)``, its gradient norm returned. With a health
    probe (``obs/health.py::StepHealth``, where ``obs.health`` is on) the module's
    gradients and the optimizer's update norms go to it under ``name``."""
    if probe is None:
        return opt.update(params, grads, state)
    probe.grads(name, grads)
    norm, update_norms = opt.update(params, grads, state, update_norms=True)
    probe.updates(name, update_norms)
    return norm


def _pipeline_refusal(cfg: Dict[str, Any], value: Any) -> str:
    """A loop that does not name ``rollout.pipeline_depth`` in ``handled`` acts
    synchronously. Of the reference's loops that the port runs this way, only
    DreamerV3's reads the key (``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py:523``)."""
    name = (cfg.get("algo") or {}).get("name")
    if name == "dreamer_v3":
        return (
            f"rollout.pipeline_depth={value!r}: the reference's dreamer_v3 loop acts through the pipelined player at "
            "this depth; the PyTorch port's DreamerV3 loop acts synchronously and does not use the port's "
            "PipelinedPlayer (rollout/pipeline.py) yet"
        )
    return (
        f"rollout.pipeline_depth={value!r}: the {name} loop acts synchronously, as the reference's does (it does "
        "not read the key); only the ppo and sac loops run the pipelined player"
    )


#: the modes of ``distributed.mode`` that the decoupled entries run (they name the key in
#: ``handled`` for these; ``decoupled_handled``)
DECOUPLED_MODES = ("thread", "sebulba")


def _sebulba_refusal(cfg: Dict[str, Any], value: Any) -> str:
    """Only the decoupled entries read ``distributed.mode``; they run ``thread`` and
    ``sebulba`` and refuse any other mode."""
    name = (cfg.get("algo") or {}).get("name")
    if name in ("sac_decoupled", "ppo_decoupled"):
        return (
            f"distributed.mode={value!r}: the {name} loop runs its player and learner as two threads of one process "
            "(distributed.mode=thread) or as placed processes (distributed.mode=sebulba, python -m "
            "sheeprl_tpu_torch.sebulba); there is no other mode"
        )
    return f"distributed.mode={value!r}: the {name} loop has no player/learner split, as the reference's has not (it does not read the key)"


def decoupled_handled(cfg: Dict[str, Any]) -> tuple:
    """``handled`` for a decoupled entry: ``distributed.mode`` when its value is one the
    entry runs."""
    mode = (cfg.get("distributed") or {}).get("mode")
    return ("distributed.mode",) if mode in (None, *DECOUPLED_MODES) else ()


def _anakin_refusal(cfg: Dict[str, Any], value: Any) -> str:
    """Only the ppo and sac loops read ``algo.anakin``; they hand the run to the Anakin
    engine before they refuse anything."""
    name = (cfg.get("algo") or {}).get("name")
    return (
        f"algo.anakin={value!r}: the {name} loop does not run the Anakin engine, as the reference's does not (it does "
        "not read the key); only the ppo and sac loops hand a run to the engine (engine/anakin.py)"
    )


#: the key a loop whose reference registers its last checkpoint names in ``handled``
REGISTERS = "model_manager.disabled"


def _registration_refusal(cfg: Dict[str, Any], value: Any) -> str:
    """Only the ppo, sac and dreamer_v3 loops of the reference register their last
    checkpoint at the end of a run (``maybe_register_models``)."""
    name = (cfg.get("algo") or {}).get("name")
    return (
        f"model_manager.disabled={value!r}: the reference's {name} loop does not register its checkpoint at the end "
        "of a run (only ppo, sac and dreamer_v3 do); register one with python -m sheeprl_tpu_torch.registration"
    )


def _set(value: Any) -> bool:
    return value is not None


# (key, test on its value, what the reference does there that the port does not yet, or
# a function of the config and the value that words the whole refusal)
_NOT_PORTED = (
    ("rollout.pipeline_depth", lambda v: int(v or 0) > 0, _pipeline_refusal),
    ("distributed.mode", lambda v: v not in (None, "thread"), _sebulba_refusal),
    ("env.pool.enabled", bool, "the shared-memory env pool"),
    ("chaos.kill_at_step", _set, "the chaos harness's process kill at a loop boundary (the training guard)"),
    ("chaos.corrupt_ckpt_at_step", _set, "the chaos harness's checkpoint corruption (the training guard)"),
    ("chaos.delay_at_step", _set, "the chaos harness's boundary delay (the training guard)"),
    ("chaos.worker_fault_at_step", _set, "the chaos harness's env-pool worker fault"),
    ("algo.anakin", bool, _anakin_refusal),
    ("obs.fleet.dir", _set, "the fleet telemetry plane's aggregator (obs/fleet.py)"),
    ("analysis.strict", bool, "strict mode"),
    ("fault.autoresume", bool, "the training guard"),
    (REGISTERS, lambda v: v is not None and not v, _registration_refusal),
    ("logger.name", lambda v: v not in (None, "tensorboard"), "the MLflow logger"),
    ("algo.world_model.decoupled_rssm", bool, "the decoupled RSSM"),
    ("mesh.devices", lambda v: v not in (None, 1, "auto"), "more than one device"),
    ("mesh.data", lambda v: v not in (None, -1, 1), "more than one device"),
    ("mesh.model", lambda v: v not in (None, 1), "tensor parallelism"),
    ("mesh.sequence", lambda v: v not in (None, 1), "sequence parallelism"),
)


#: the fleet aggregator's address, which the reference's launcher sets for its children
FLEET_ENV_VAR = "SHEEPRL_TPU_FLEET"


def refuse_unported(cfg: Dict[str, Any], handled: Sequence[str] = ()) -> None:
    """Raise, naming the key, when the config asks for a loop feature of the reference
    that the port does not have: such a key is never silently ignored. ``handled``: keys
    the loop reads itself (DreamerV3's ``algo.world_model.decoupled_rssm``, PPO's and the
    SAC family's ``rollout.pipeline_depth``). A set ``SHEEPRL_TPU_FLEET`` is refused as
    well: the reference's processes push their metrics to that fleet aggregator."""
    if os.environ.get(FLEET_ENV_VAR):
        raise NotImplementedError(
            f"{FLEET_ENV_VAR}={os.environ[FLEET_ENV_VAR]!r} asks for the fleet telemetry plane's exporter, which the "
            "PyTorch port does not have yet"
        )
    for key, asks, what in _NOT_PORTED:
        if key in handled:
            continue
        node: Any = cfg
        for part in key.split("."):
            node = node.get(part) if isinstance(node, dict) else None
        if node is not None and asks(node):
            if callable(what):
                raise NotImplementedError(what(cfg, node))
            raise NotImplementedError(f"{key}={node!r} asks for {what}, which the PyTorch port does not have yet")


def register_last_checkpoint(cfg: Dict[str, Any], log_dir: str) -> None:
    """With ``model_manager.disabled=False``, register the run's last checkpoint (the
    end of the ppo, sac and dreamer_v3 loops; the other loops refuse the key)."""
    if not (cfg.get("model_manager") or {}).get("disabled", True):
        from sheeprl_tpu_torch.utils.model_manager import maybe_register_models

        maybe_register_models(cfg, log_dir)


class TrainResult(NamedTuple):
    log_dir: str
    policy_steps: int
    grad_steps: int  # gradient steps of this run (a resumed run counts its own)
    checkpoint: Optional[str]  # the last checkpoint written, if any
    seconds: float  # wall time of the loop
    train_seconds: float  # wall time of dispatching the gradient steps (host side)
    env_seconds: float  # wall time of acting and env stepping
    test_reward: Optional[float]
