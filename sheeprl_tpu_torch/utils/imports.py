"""Dotted-path instantiation (from ``sheeprl_tpu/utils/imports.py``).

``instantiate`` replaces ``hydra.utils.instantiate``: it builds env adapters from
``_target_`` config nodes (SheepRL's ``sheeprl/utils/env.py:73``). The optional-
dependency guards of the reference module come with the adapters that need them.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict


def resolve(path: str) -> Any:
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ImportError(f"Cannot resolve '{path}': no module component")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(node: Dict[str, Any], **overrides: Any) -> Any:
    """Instantiate ``{_target_: 'pkg.mod.Class', **kwargs}`` config nodes."""
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError(f"instantiate() requires a dict with a '_target_' key, got: {node!r}")
    node = dict(node)
    target = node.pop("_target_")
    node.pop("_convert_", None)
    partial = node.pop("_partial_", False)
    kwargs = {**node, **overrides}
    cls = resolve(target)
    if partial:
        import functools

        return functools.partial(cls, **kwargs)
    return cls(**kwargs)
