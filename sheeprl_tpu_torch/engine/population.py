"""Population Anakin: the member axis for multi-seed and multi-hyperparameter runs
(counterpart of ``sheeprl_tpu/engine/population.py``).

With ``algo.population.size=K`` the Anakin engine (``engine/anakin.py``) trains K
independent members in one dispatch: each member has its own parameters, optimizer
state, env states, replay ring, generators and episode accumulators, and replays its
own captured graphs, back to back. This is the counterpart of the reference's
``vectorize=False`` layout (``lax.map``), whose per-member program is the standalone
one: each member equals a standalone run bit for bit. ``vectorize=True`` (the
reference's ``vmap`` layout, one batched program over the members) is not ported and
raises, naming the key.

``algo.population.sweep`` maps named scalar hyperparameters across members
(``{ent_coef: [0.0, 0.01, ...]}``, one value per member). Sweepable names:

* PPO: ``clip_coef`` and ``ent_coef`` (inputs of the update already) and
  ``optimizer.lr``;
* SAC: ``actor.optimizer.lr``, ``critic.optimizer.lr`` and ``alpha.optimizer.lr``.

A swept learning rate lives in the member's optimizer state (``Optimizer(inject_lr=
True)``, the counterpart of ``optax.inject_hyperparams``): ``set_injected_lr`` stamps
each member's rate into its own state.

Generators (``member_generators``): member 0 continues the run's own generators, so a
population of one is the plain run bit for bit; member ``m > 0`` gets generators seeded
from the run's seed and ``m``.

Checkpoints keep the members' carries stacked under a leading member axis
(``stack_members``; ``slice_member`` takes one out).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

#: sweepable hyperparameter names per Anakin algorithm family
SWEEPABLE = {
    "ppo": ("clip_coef", "ent_coef", "optimizer.lr"),
    "sac": ("actor.optimizer.lr", "critic.optimizer.lr", "alpha.optimizer.lr"),
}


def _flatten(prefix: str, node: Any, out: Dict[str, Any]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = node


@dataclass(frozen=True)
class PopulationSpec:
    """The validated ``algo.population`` config: member count, execution mode and the
    flattened sweep table (``name -> (v_0, ..., v_{K-1})``)."""

    size: int = 1
    vectorize: bool = False
    sweep: Dict[str, Tuple[float, ...]] = field(default_factory=dict)

    @property
    def enabled(self) -> bool:
        """The engine takes the population path for K > 1 or any sweep (a sweep of
        length 1 is a valid single-member population)."""
        return self.size > 1 or bool(self.sweep)

    @classmethod
    def from_cfg(cls, cfg, algo: str) -> "PopulationSpec":
        pop = cfg.algo.get("population", {}) or {}
        size = int(pop.get("size", 1) or 1)
        if size < 1:
            raise ValueError(f"algo.population.size must be >= 1; got {size}")
        vectorize = bool(pop.get("vectorize", False))
        raw = pop.get("sweep", {}) or {}
        flat: Dict[str, Any] = {}
        _flatten("", raw, flat)
        allowed = SWEEPABLE.get(algo, ())
        sweep: Dict[str, Tuple[float, ...]] = {}
        for name, values in flat.items():
            if name not in allowed:
                raise ValueError(f"algo.population.sweep.{name} is not sweepable for {algo!r}; supported: {list(allowed)}")
            if not isinstance(values, (list, tuple)):
                raise ValueError(f"algo.population.sweep.{name} must be a per-member list; got {values!r}")
            if len(values) != size:
                raise ValueError(
                    f"algo.population.sweep.{name} has {len(values)} values but "
                    f"algo.population.size={size}: one value per member required"
                )
            sweep[name] = tuple(float(v) for v in values)
        return cls(size=size, vectorize=vectorize, sweep=sweep)

    def values(self, name: str, default: float) -> List[float]:
        """Per-member values of ``name``: the sweep's row, or the config's value for
        every member."""
        if name in self.sweep:
            return list(self.sweep[name])
        return [float(default)] * self.size

    def sweeps_lr(self, *names: str) -> bool:
        return any(n in self.sweep for n in names)


def population_spec(cfg, algo: str) -> PopulationSpec:
    """``PopulationSpec.from_cfg``, refusing the layout the port does not have."""
    spec = PopulationSpec.from_cfg(cfg, algo)
    if spec.vectorize:
        raise NotImplementedError(
            "algo.population.vectorize=True asks for the reference's vmap layout (one batched program over the "
            "members), which the PyTorch port does not have yet; vectorize=False replays each member's own graphs"
        )
    return spec


def member_seed(seed: int, member: int, stream: int) -> int:
    """The seed of member ``member``'s generator number ``stream`` (``member > 0``)."""
    return int(np.random.SeedSequence((int(seed), int(member), int(stream))).generate_state(1, np.uint64)[0] >> 1)


def member_generators(base: Sequence[torch.Generator], seed: int, size: int) -> List[List[torch.Generator]]:
    """Per member, its generators: member 0 continues ``base`` (the run's own, so a
    population of one is the plain run); member ``m > 0`` gets fresh generators on the
    same devices, seeded from ``seed`` and ``m``."""
    out = [list(base)]
    for m in range(1, size):
        out.append([torch.Generator(device=g.device).manual_seed(member_seed(seed, m, i)) for i, g in enumerate(base)])
    return out


def stack_members(carries: Sequence[Any]) -> Any:
    """Stack per-member carries (trees of dicts, lists and tuples over tensors) under a
    leading member axis, leaf by leaf; other leaves (Python numbers) are stacked into
    tensors too."""
    first = carries[0]
    if isinstance(first, dict):
        return {k: stack_members([c[k] for c in carries]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_members([c[i] for c in carries]) for i in range(len(first)))
    return torch.stack([torch.as_tensor(c) for c in carries])


def slice_member(tree: Any, member: int) -> Any:
    """Member ``member``'s slice of a stacked tree (the member axis dropped)."""
    if isinstance(tree, dict):
        return {k: slice_member(v, member) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(slice_member(v, member) for v in tree)
    return tree[member]


def set_injected_lr(opt_state: Dict[str, Any], lr: float) -> Dict[str, Any]:
    """Stamp ``lr`` into an injected optimizer state (``Optimizer(inject_lr=True)``), in
    place: how a swept learning rate becomes a member's own."""
    if "lr" not in opt_state:
        raise ValueError(
            "no injected learning_rate found in the optimizer state: build the optimizer with inject_lr=True to "
            "sweep its learning rate"
        )
    with torch.no_grad():
        opt_state["lr"].fill_(float(lr))
    return opt_state


# ------------------------------------------------------------------- metrics
#: key prefixes whose population "best" is the minimum across members; every other
#: reduced namespace (Rewards/, Game/, Episodes/) takes the maximum. Health/* and
#: Params/* get member rows and the median only.
_BEST_MIN_PREFIXES = ("Loss/",)
_BEST_MAX_PREFIXES = ("Rewards/", "Game/", "Episodes/")


def population_rows(key: str, member_values: np.ndarray) -> Dict[str, float]:
    """The drained ``Population/*`` rows of one metric: each member's value, the median
    across members and, where a direction exists, the best (``Loss/*``: the minimum;
    ``Rewards/*``, ``Game/*``, ``Episodes/*``: the maximum). A non-finite member entry
    means no data this window (no finished episode) and is skipped."""
    vals = np.asarray(member_values, np.float64).reshape(-1)
    out = {f"Population/{key}/member_{m}": float(v) for m, v in enumerate(vals) if np.isfinite(v)}
    finite = vals[np.isfinite(vals)]
    if finite.size:
        out[f"Population/{key}/median"] = float(np.median(finite))
        if key.startswith(_BEST_MIN_PREFIXES):
            out[f"Population/{key}/best"] = float(finite.min())
        elif key.startswith(_BEST_MAX_PREFIXES):
            out[f"Population/{key}/best"] = float(finite.max())
    return out
