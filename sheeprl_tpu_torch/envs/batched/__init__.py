"""Batched environments on the device for the Anakin engine (counterpart of
``sheeprl_tpu/envs/jax``; ``engine/anakin.py``).

``make_batched_env`` is the registry: the reference's classic-control ids, with or
without the config's ``jax_`` prefix, and the ``mountain_car`` alias. The reference's
``gymnax:<EnvName>`` ids need the gymnax package, a JAX library the port does not run.
"""

from __future__ import annotations

from sheeprl_tpu_torch.envs.batched.cartpole import CartPole
from sheeprl_tpu_torch.envs.batched.core import BatchedEnv
from sheeprl_tpu_torch.envs.batched.mountain_car import MountainCarContinuous
from sheeprl_tpu_torch.envs.batched.pendulum import Pendulum

_BATCHED_ENVS = {
    "cartpole": CartPole,
    "pendulum": Pendulum,
    "mountain_car_continuous": MountainCarContinuous,
    "mountain_car": MountainCarContinuous,  # alias: env/jax_mountain_car.yaml's id
}


def make_batched_env(env_id: str, **env_kwargs) -> BatchedEnv:
    """A batched env by id: ``cartpole``, ``jax_cartpole``, ``pendulum``, ..."""
    name = str(env_id)
    if name.startswith("gymnax:"):
        raise NotImplementedError(
            f"env.jax.env_id={name!r}: gymnax envs are JAX programs; the PyTorch port runs its own batched "
            f"envs only ({', '.join(sorted(_BATCHED_ENVS))})"
        )
    short = name[len("jax_"):] if name.startswith("jax_") else name
    if short in _BATCHED_ENVS:
        return _BATCHED_ENVS[short](**env_kwargs)
    raise ValueError(
        f"Unknown jax env id {env_id!r}; in-tree: {sorted(_BATCHED_ENVS)} "
        "(optionally prefixed 'jax_'), external: 'gymnax:<EnvName>'."
    )


__all__ = ["BatchedEnv", "CartPole", "MountainCarContinuous", "Pendulum", "make_batched_env"]
