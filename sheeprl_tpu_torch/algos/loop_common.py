"""What every train loop of the port shares (the Dreamer loop, ``dreamer_loop.py``, the
PPO family's, ``ppo/ppo.py``, and the SAC family's, ``sac/sac.py``): ``grads`` (one loss's gradient over a parameter
list), ``refuse_unported`` (the reference's loop keys the port does not have; a loop
names the ones it reads itself) and ``TrainResult`` (what a train entry returns)."""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch


def grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradient of ``loss`` with respect to ``params`` (zeros where it does not
    depend on one), leaving every ``.grad`` untouched."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


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


def _sebulba_refusal(cfg: Dict[str, Any], value: Any) -> str:
    """Only the decoupled entries read ``distributed.mode``; their default, ``thread``, is
    ported."""
    name = (cfg.get("algo") or {}).get("name")
    if name in ("sac_decoupled", "ppo_decoupled"):
        return (
            f"distributed.mode={value!r}: the reference's {name} then runs its player and learner as placed processes "
            "(a launcher, a transport channel and weight publishers), which the PyTorch port does not have yet; the "
            "port runs them as two threads of one process (distributed.mode=thread)"
        )
    return f"distributed.mode={value!r}: the {name} loop has no player/learner split, as the reference's has not (it does not read the key)"


# (key, test on its value, what the reference does there that the port does not yet, or
# a function of the config and the value that words the whole refusal)
_NOT_PORTED = (
    ("rollout.pipeline_depth", lambda v: int(v or 0) > 0, _pipeline_refusal),
    ("distributed.mode", lambda v: v not in (None, "thread"), _sebulba_refusal),
    ("env.pool.enabled", bool, "the shared-memory env pool"),
    ("algo.anakin", bool, "the Anakin engine"),
    ("obs.enabled", bool, "the training monitor"),
    ("obs.health", bool, "the health diagnostics"),
    ("obs.flight_recorder", bool, "the flight recorder"),
    ("analysis.strict", bool, "strict mode"),
    ("fault.autoresume", bool, "the training guard"),
    ("model_manager.disabled", lambda v: v is not None and not v, "the model manager"),
    ("logger.name", lambda v: v not in (None, "tensorboard"), "the MLflow logger"),
    ("algo.world_model.decoupled_rssm", bool, "the decoupled RSSM"),
    ("mesh.devices", lambda v: v not in (None, 1, "auto"), "more than one device"),
    ("mesh.data", lambda v: v not in (None, -1, 1), "more than one device"),
    ("mesh.model", lambda v: v not in (None, 1), "tensor parallelism"),
    ("mesh.sequence", lambda v: v not in (None, 1), "sequence parallelism"),
)


def refuse_unported(cfg: Dict[str, Any], handled: Sequence[str] = ()) -> None:
    """Raise, naming the key, when the config asks for a loop feature of the reference
    that the port does not have: such a key is never silently ignored. ``handled``: keys
    the loop reads itself (DreamerV3's ``algo.world_model.decoupled_rssm``, PPO's and the
    SAC family's ``rollout.pipeline_depth``)."""
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


class TrainResult(NamedTuple):
    log_dir: str
    policy_steps: int
    grad_steps: int  # gradient steps of this run (a resumed run counts its own)
    checkpoint: Optional[str]  # the last checkpoint written, if any
    seconds: float  # wall time of the loop
    train_seconds: float  # wall time of dispatching the gradient steps (host side)
    env_seconds: float  # wall time of acting and env stepping
    test_reward: Optional[float]
