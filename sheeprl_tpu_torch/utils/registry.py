"""Algorithm / evaluation registries.

Mirrors the decorator-based registry of the reference
(SheepRL's ``utils/registry.py:11-108``): each algorithm module registers a
train entrypoint with ``@register_algorithm()`` and an eval entrypoint with
``@register_evaluation()``; the CLI dispatches by ``cfg.algo.name``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

# name -> {"module": str, "entrypoint": callable, "decoupled": bool}
algorithm_registry: Dict[str, Dict[str, Any]] = {}
# name -> callable
evaluation_registry: Dict[str, Callable] = {}


def register_algorithm(name: str | None = None, decoupled: bool = False):
    def decorator(fn: Callable) -> Callable:
        algo_name = name or fn.__module__.split(".")[-1]
        algorithm_registry[algo_name] = {
            "module": fn.__module__,
            "entrypoint": fn,
            "decoupled": decoupled,
        }
        return fn

    return decorator


def register_evaluation(algorithms: str | list | None = None):
    def decorator(fn: Callable) -> Callable:
        names = algorithms
        if names is None:
            names = [fn.__module__.split(".")[-2]]
        if isinstance(names, str):
            names = [names]
        for n in names:
            evaluation_registry[n] = fn
        return fn

    return decorator


def get_algorithm(name: str) -> Dict[str, Any]:
    if name not in algorithm_registry:
        raise ValueError(
            f"Algorithm '{name}' is not registered. Available: {sorted(algorithm_registry)}"
        )
    return algorithm_registry[name]


def get_evaluation(name: str) -> Callable:
    if name not in evaluation_registry:
        raise ValueError(
            f"No evaluation registered for '{name}'. Available: {sorted(evaluation_registry)}"
        )
    return evaluation_registry[name]
