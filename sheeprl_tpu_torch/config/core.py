"""Lightweight Hydra-like configuration composition (a copy of
``sheeprl_tpu/config/core.py``, kept in the port so that it imports nothing of the JAX
package).

The framework's user API is a tree of YAML files organised in groups (``algo/``,
``env/``, ``exp/`` ...). This module implements the subset of Hydra's semantics that the
tree uses:

* a root ``config.yaml`` whose ``defaults:`` list selects one option per group,
* experiment files (``exp/*.yaml``) that override anything globally,
* command-line overrides ``group=option`` and dotted assignments ``a.b.c=value``,
* ``${a.b.c}`` interpolation resolved after composition,
* a user-extensible search path via the ``SHEEPRL_TPU_TORCH_SEARCH_PATH`` environment
  variable.

Composition rules (deliberately simpler than Hydra):

* A ``defaults`` list entry ``{group: option}`` loads ``<group>/<option>.yaml`` and
  merges its content under the ``group`` key (last path component), unless the file sets
  ``_global_: true`` in which case content merges at the root.  ``exp`` configs are
  implicitly global.
* Group files may have their own ``defaults`` which are processed first (recursively).
* ``???`` marks a required value; composition fails if any remain after overrides.
* Later merges win, dicts merge recursively, lists replace.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml

MISSING = "???"

_BUILTIN_CONFIG_DIR = Path(__file__).parent / "configs"


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with a YAML-1.2 float resolver (PyYAML reads ``1e-3`` as a string)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
          |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
          |\.[0-9_]+(?:[eE][-+][0-9]+)?
          |[-+]?\.(?:inf|Inf|INF)
          |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str) -> Any:
    return yaml.load(text, Loader=_YamlLoader)


class DotDict(dict):
    """dict with attribute access, recursively applied (reference: utils/utils.py:34)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        return DotDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return DotDict({k: DotDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return [DotDict.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        return unwrap(self)


def unwrap(obj: Any) -> Any:
    """Convert DotDicts back to plain dicts (for YAML dumping)."""
    if isinstance(obj, dict):
        return {k: unwrap(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [unwrap(v) for v in obj]
    return obj


def _merge(dst: dict, src: dict) -> dict:
    """Recursively merge ``src`` into ``dst`` (in place); ``src`` wins."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _set_dotted(cfg: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _get_dotted(cfg: dict, key: str) -> Any:
    node: Any = cfg
    for p in key.split("."):
        if isinstance(node, dict):
            node = node[p]
        elif isinstance(node, (list, tuple)):
            node = node[int(p)]
        else:
            raise KeyError(key)
    return node


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML semantics (``null``/``true``/``1e-4``/lists)."""
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


class ConfigSource:
    """Resolves ``group/option`` to YAML files across the search path."""

    def __init__(self, extra_dirs: Optional[Sequence[os.PathLike]] = None):
        dirs: List[Path] = [_BUILTIN_CONFIG_DIR]
        env_path = os.environ.get("SHEEPRL_TPU_TORCH_SEARCH_PATH", "")
        for entry in env_path.split(";"):
            entry = entry.strip()
            if entry.startswith("file://"):
                entry = entry[len("file://") :]
            if entry:
                dirs.append(Path(entry))
        for d in extra_dirs or []:
            dirs.append(Path(d))
        self.dirs = dirs

    def find(self, rel: str) -> Optional[Path]:
        if not rel.endswith(".yaml"):
            rel += ".yaml"
        # Later search-path entries win (user dirs override builtins).
        for d in reversed(self.dirs):
            p = d / rel
            if p.is_file():
                return p
        return None

    def options(self, group: str) -> List[str]:
        out = set()
        for d in self.dirs:
            g = d / group
            if g.is_dir():
                out.update(p.stem for p in g.glob("*.yaml"))
        return sorted(out)


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_interpolations(cfg: dict) -> None:
    """Resolve ``${dotted.path}`` references in string values, to a fixed point."""

    def resolve_str(s: str, depth: int = 0) -> Any:
        if depth > 16:
            raise ValueError(f"interpolation loop while resolving {s!r}")
        m = _INTERP_RE.fullmatch(s.strip())
        if m:  # whole-string reference: preserve the referenced type
            target = _lookup(m.group(1))
            if isinstance(target, str):
                return resolve_str(target, depth + 1)
            return copy.deepcopy(target)

        def sub(mm: re.Match) -> str:
            v = _lookup(mm.group(1))
            if isinstance(v, str):
                v = resolve_str(v, depth + 1)
            return str(v)

        return _INTERP_RE.sub(sub, s)

    def _lookup(path: str) -> Any:
        path = path.strip()
        if path.startswith("oc.env:") or path.startswith("env:"):
            name = path.split(":", 1)[1]
            name, _, default = name.partition(",")
            return os.environ.get(name.strip(), _parse_value(default.strip()) if default else None)
        try:
            return _get_dotted(cfg, path)
        except (KeyError, IndexError, ValueError) as e:
            raise KeyError(f"interpolation target '{path}' not found") from e

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    walk(cfg)


def _check_missing(cfg: dict, prefix: str = "") -> List[str]:
    missing = []
    for k, v in cfg.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            missing += _check_missing(v, path + ".")
        elif isinstance(v, str) and v == MISSING:
            missing.append(path)
    return missing


class Composer:
    def __init__(self, source: ConfigSource, group_overrides: Optional[Dict[str, str]] = None):
        self.source = source
        # CLI group selections beat every defaults-list entry, wherever it appears.
        self.group_overrides = dict(group_overrides or {})
        # ``override group: option`` entries from enclosing files, in effect while
        # their siblings (e.g. an inherited parent exp) are being processed.
        self.scoped_overrides: Dict[str, Any] = {}
        self.applied_groups: set = set()
        # Groups declared mandatory (``???``) somewhere in the tree: a later
        # ``override group:`` entry is the legitimate way to satisfy them.
        self.mandatory_groups: set = set()
        # group -> option actually loaded; a group is re-loaded only when the
        # effective option differs (re-merging the same option after an exp's
        # content would clobber the exp's value overrides with group defaults).
        self.applied_options: Dict[str, str] = {}

    def _effective_option(self, group: str, option: Any) -> Any:
        if group in self.group_overrides:  # CLI wins over everything
            return self.group_overrides[group]
        return self.scoped_overrides.get(group, option)

    def process_defaults(self, cfg: dict, defaults: List[Any], parent_group: str = "") -> None:
        """Apply a ``defaults`` list with Hydra's ``override`` semantics: an
        ``override group: option`` entry re-selects which option the group loads
        *wherever* it is loaded (typically by an inherited parent exp) — it does NOT
        re-merge the group file after the parent's content, which would clobber the
        parent's value overrides with the group file's defaults."""
        overrides_here: List[tuple] = []
        plain: List[Any] = []
        for entry in defaults:
            # Classify per key: only keys of the form "override <group>" /
            # "override/<group>" are overrides.  A mixed dict entry keeps its plain
            # keys as plain selections, and a group whose name merely begins with
            # "override" (no separator) is a plain group, never truncated.
            if isinstance(entry, dict):
                plain_part: Dict[Any, Any] = {}
                for group, option in entry.items():
                    g = str(group)
                    if g.startswith("override ") or g.startswith("override/"):
                        overrides_here.append((g[len("override") :].strip().lstrip("/"), option))
                    else:
                        plain_part[group] = option
                if plain_part:
                    plain.append(plain_part)
            else:
                plain.append(entry)
        pushed = []
        for group, option in overrides_here:
            # An enclosing (child) config's override beats this one, CLI beats both.
            if group not in self.scoped_overrides:
                self.scoped_overrides[group] = option
                pushed.append(group)
        try:
            for entry in plain:
                self._apply_default(cfg, entry, parent_group=parent_group)
            # Override entries whose effective option no sibling loaded (directly or
            # via this scope's redirection): if the group exists anywhere in the
            # defaults tree processed so far (loaded earlier, e.g. by the root
            # config, or recorded as a mandatory ``???`` group), re-select it here.
            # A group that exists NOWHERE is an error, matching Hydra ("could not
            # find match for override") — catches typos like ``override /enviro:``.
            for group, option in overrides_here:
                if group not in self.applied_groups and group not in self.mandatory_groups:
                    raise ValueError(
                        f"Defaults-list override 'override /{group}: {option}' matches no "
                        f"'{group}' entry in the defaults tree. Overrides re-select an "
                        f"existing entry; use a plain '{group}: {option}' entry to add one."
                    )
                self._select_and_load(cfg, group, option)
        finally:
            for group in pushed:
                self.scoped_overrides.pop(group, None)

    def load_group_file(self, cfg: dict, group: str, option: str) -> None:
        rel = f"{group}/{option}" if group else option
        path = self.source.find(rel)
        if path is None:
            opts = self.source.options(group)
            raise FileNotFoundError(
                f"Config '{rel}.yaml' not found in search path "
                f"{[str(d) for d in self.source.dirs]}. Available options for "
                f"'{group}': {opts}"
            )
        raw = _yaml_load(path.read_text()) or {}
        defaults = raw.pop("defaults", [])
        is_global = bool(raw.pop("_global_", False)) or group == "exp"
        # Process nested defaults first so the file's own content wins.
        self.process_defaults(cfg, defaults, parent_group=group)
        if is_global:
            _merge(cfg, raw)
        else:
            key = group.split("/")[-1]
            node = cfg.setdefault(key, {})
            if not isinstance(node, dict):
                cfg[key] = {}
                node = cfg[key]
            _merge(node, raw)

    def _apply_default(self, cfg: dict, entry: Any, parent_group: str = "") -> None:
        if entry == "_self_":
            return
        if isinstance(entry, str):
            # "group/option" or bare "option" relative to the parent group.  Bare
            # within-group inheritance (e.g. algo/dreamer_v3_S ← dreamer_v3) is NOT
            # subject to scoped overrides — redirecting it would self-recurse.
            if "/" in entry:
                group, option = entry.rsplit("/", 1)
            else:
                group, option = parent_group, entry
            self.load_group_file(cfg, group, option)
            return
        if isinstance(entry, dict):
            for group, option in entry.items():
                self._select_and_load(cfg, str(group).strip().lstrip("/"), option)
            return
        raise ValueError(f"Unsupported defaults entry: {entry!r}")

    def _select_and_load(self, cfg: dict, group: str, option: Any) -> None:
        """Resolve a group selection (CLI > enclosing overrides > the entry itself)
        and load it, unless that exact option was already loaded or the selection is
        null/mandatory."""
        option = self._effective_option(group, option)
        if option is None or option == "null":
            return
        if str(option).startswith("???"):
            # Mandatory group: must be chosen by an override; record it.
            self.mandatory_groups.add(group)
            cfg.setdefault("_mandatory_groups_", []).append(group)
            return
        if self.applied_options.get(group) == str(option):
            return
        self.applied_groups.add(group)
        self.applied_options[group] = str(option)
        self.load_group_file(cfg, group, str(option))


def compose(
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    extra_dirs: Optional[Sequence[os.PathLike]] = None,
    resolve: bool = True,
) -> DotDict:
    """Compose the configuration tree, mirroring the reference Hydra entry point.

    ``overrides`` are CLI-style tokens: ``exp=dreamer_v3``, ``env=atari``,
    ``algo.learning_rate=1e-4``, ``+extra.key=1`` (force-add), ``~key`` (delete).
    """
    overrides = list(overrides or [])
    source = ConfigSource(extra_dirs)
    cfg: dict = {}

    root_path = source.find(config_name)
    if root_path is None:
        raise FileNotFoundError(f"root config '{config_name}.yaml' not found")
    raw = _yaml_load(root_path.read_text()) or {}
    defaults = raw.pop("defaults", [])

    # Partition overrides: group selections vs dotted value assignments.
    group_overrides: Dict[str, str] = {}
    value_overrides: List[tuple] = []
    deletions: List[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        if "=" not in ov:
            raise ValueError(f"Malformed override {ov!r} (expected key=value)")
        key, _, val = ov.partition("=")
        key = key.lstrip("+")
        if "." not in key and any((d / key).is_dir() for d in source.dirs):
            # The key names a config group: the value must be an existing option.
            if source.find(f"{key}/{val}") is None:
                raise FileNotFoundError(
                    f"Config group '{key}' has no option '{val}'. Available: {source.options(key)}"
                )
            group_overrides[key] = val
        else:
            value_overrides.append((key, _parse_value(val)))

    # Apply defaults; CLI group selections substitute in wherever the group appears
    # (root defaults or nested exp defaults).
    composer = Composer(source, group_overrides)
    if "_self_" in defaults:
        self_pos = defaults.index("_self_")
        composer.process_defaults(cfg, defaults[:self_pos])
        _merge(cfg, raw)
        composer.process_defaults(cfg, defaults[self_pos + 1 :])
    else:
        composer.process_defaults(cfg, defaults)
        _merge(cfg, raw)

    # Group overrides never consumed by any defaults list (e.g. exp=...).
    for group, option in group_overrides.items():
        if group not in composer.applied_groups:
            composer.load_group_file(cfg, group, option)

    # A mandatory group is satisfied when its key exists in the composed config
    # (whether via an explicit override or an exp file's defaults).
    mandatory = set(cfg.pop("_mandatory_groups_", []))  # jaxlint: disable=JL006 (internal sentinel)
    still_missing = {g for g in mandatory if g.split("/")[-1] not in cfg}
    if still_missing:
        raise ValueError(
            f"Mandatory config groups not chosen: {sorted(still_missing)}. "
            f"Select them with e.g. '{next(iter(still_missing))}=<option>' or an 'exp=' preset."
        )

    for key, val in value_overrides:
        _set_dotted(cfg, key, val)
    for key in deletions:
        try:
            parent = _get_dotted(cfg, key.rsplit(".", 1)[0]) if "." in key else cfg
            parent.pop(key.rsplit(".", 1)[-1], None)
        except KeyError:
            pass

    if resolve:
        _resolve_interpolations(cfg)
        missing = _check_missing(cfg)
        if missing:
            raise ValueError(f"Missing mandatory config values: {missing}")
    return DotDict.wrap(cfg)


def save_config(cfg: dict, path: os.PathLike) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(unwrap(cfg), f, sort_keys=False)


def load_config(path: os.PathLike) -> DotDict:
    with open(path) as f:
        return DotDict.wrap(yaml.load(f, Loader=_YamlLoader) or {})


def print_config(cfg: dict, file=None) -> None:
    """Pretty-print the composed config (reference: utils/utils.py:208)."""
    print(yaml.safe_dump(unwrap(cfg), sort_keys=False), file=file)
