"""Registry routing (counterpart of ``sheeprl_tpu/serve/router.py``): ``name[:selector]``
policy specs to registry version entries. One grammar for ``serve.policies``, a
request's ``policy`` and ``sheeprl_tpu_torch.eval checkpoint_path=name:selector``:

* ``name`` / ``name:latest``: the highest registered version;
* ``name:3``: that version;
* ``name:production`` (any other selector): the newest version whose registry ``stage``
  matches, case-insensitively (set with ``transition_model``).

Standard library only: the eval entry resolves a spec before it builds anything.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

Selector = Union[None, int, str]


def parse_spec(spec: str) -> Tuple[str, Selector]:
    """``"name[:selector]"`` → ``(name, selector)``; integer selectors are parsed."""
    name, sep, selector = str(spec).partition(":")
    name = name.strip()
    if not name:
        raise ValueError(f"empty policy name in spec {spec!r}")
    if not sep or not selector.strip():
        return name, None
    selector = selector.strip()
    try:
        return name, int(selector)
    except ValueError:
        return name, selector


def resolve_version(versions: List[Dict[str, Any]], selector: Selector) -> Dict[str, Any]:
    """Pick one registry version entry out of ``versions`` for ``selector``."""
    if not versions:
        raise ValueError("model has no registered versions")
    by_version = sorted(versions, key=lambda e: int(e["version"]))
    if selector is None or selector == "latest":
        return by_version[-1]
    if isinstance(selector, int):
        for entry in by_version:
            if int(entry["version"]) == selector:
                return entry
        raise ValueError(
            f"no version {selector} (registered: {[int(e['version']) for e in by_version]})"
        )
    stage = str(selector).lower()
    staged = [e for e in by_version if str(e.get("stage", "")).lower() == stage]
    if not staged:
        stages = sorted({str(e.get("stage", "None")) for e in by_version})
        raise ValueError(f"no version at stage {selector!r} (stages present: {stages})")
    return staged[-1]


def resolve_policy(manager, spec: str) -> Tuple[str, Dict[str, Any]]:
    """Resolve ``spec`` against a model manager's index → ``(name, version entry)``."""
    name, selector = parse_spec(spec)
    index = manager.get_models()
    if name not in index or not index[name].get("versions"):
        known = sorted(index)
        raise ValueError(f"no registered model named {name!r} (registry has: {known})")
    try:
        entry = resolve_version(index[name]["versions"], selector)
    except ValueError as e:
        raise ValueError(f"cannot resolve {spec!r}: {e}") from e
    return name, entry


def resolve_registry_checkpoint(
    spec: str, overrides: Optional[List[str]] = None
) -> Tuple[str, int, Path]:
    """``name[:selector]`` → ``(name, version, payload path)`` for the eval CLI.

    The registry location comes from a ``model_manager.registry_dir=...`` token in
    ``overrides`` (the same override the registration CLI takes), defaulting to the
    config group's ``models_registry``.  Only the local backend resolves here: a
    spec is a *filesystem* routing decision made before any config is composed.
    """
    from sheeprl_tpu_torch.utils.model_manager import LocalModelManager

    registry_dir = "models_registry"
    for ov in overrides or []:
        if ov.startswith("model_manager.registry_dir="):
            registry_dir = ov.split("=", 1)[1]
    if not Path(registry_dir).is_dir():
        raise ValueError(
            f"checkpoint spec {spec!r} is not a path and no registry exists at "
            f"{registry_dir!r} (set model_manager.registry_dir=...)"
        )
    name, entry = resolve_policy(LocalModelManager(registry_dir=registry_dir), spec)
    return name, int(entry["version"]), Path(entry["path"])
