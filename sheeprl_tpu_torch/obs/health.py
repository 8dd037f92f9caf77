"""Training-health diagnostics, ``Health/*`` (counterpart of ``sheeprl_tpu/obs/health.py``).

The reference computes these scalars inside its jitted update. The port computes them
inside the train step that ``utils/graphs.py`` captures as a CUDA graph: every value is a
0-d tensor that kernels of the graph write, returned with the step's other metrics and
drained with them at the log cadence. Nothing here reads a value on the host, so a
graphed step adds no host sync, and a replay's values equal the eager step's.

Per-module grouping: the top level of the grads, params and updates trees becomes the
metric suffix (``Health/grad_norm/actor``); single-key mappings are unwrapped first, as
in the reference. A tree is a mapping of names to tensors, lists of tensors or further
mappings. Update norms come from the port's optimizer (``algos/ppo/ppo.py::Optimizer``),
which returns the norms of the deltas it applies, so no parameter is cloned:
``update_norms`` maps a module to its per-tensor norms (a vector) or its global norm.
The norms are batched with ``torch._foreach_norm`` (one multi-tensor kernel per tree).

``obs.health`` is read when the step is built, as the reference reads it at trace time:
with it off, the step is the one without diagnostics.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch

_EPS = 1e-12


def health_enabled(cfg: Any) -> bool:
    """True unless ``obs.health`` is off (False without an ``obs`` section)."""
    if cfg is None:
        return False
    try:
        obs_cfg = cfg.get("obs") if hasattr(cfg, "get") else getattr(cfg, "obs", None)
    except Exception:
        return False
    if not obs_cfg:
        return False
    try:
        return bool(obs_cfg.get("health", True) if hasattr(obs_cfg, "get") else getattr(obs_cfg, "health", True))
    except Exception:
        return False


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of mappings, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return []


def _top_modules(tree: Any) -> Dict[str, Any]:
    while isinstance(tree, Mapping) and len(tree) == 1:
        tree = next(iter(tree.values()))
    if isinstance(tree, Mapping) and tree:
        return {str(k): v for k, v in tree.items()}
    return {"all": tree}


def module_slices(module: torch.nn.Module, list_names: Optional[Mapping[str, str]] = None) -> Dict[str, slice]:
    """The reference's top-level module names of ``module``'s children, each with the
    slice of ``list(module.parameters())`` that it holds (a one-optimizer agent's
    per-module grouping). A ``ModuleList`` child named in ``list_names`` gives one name
    per entry, ``list_names[name].format(i)`` (the reference's ``actor_head_0``, ...)."""
    list_names = dict(list_names or {})
    if any(True for _ in module.parameters(recurse=False)):
        raise ValueError(f"{type(module).__name__} holds parameters of its own: no per-module grouping")
    out: Dict[str, slice] = {}
    start = 0
    for name, child in module.named_children():
        entries = [(list_names[name].format(i), c) for i, c in enumerate(child)] if name in list_names else [(name, child)]
        for entry, c in entries:
            n = sum(1 for _ in c.parameters())
            if n:
                out[entry] = slice(start, start + n)
                start += n
    return out


def global_norm(tree: Any) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of every element of the tree, float32."""
    ts = leaves(tree)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)).float())


class StepHealth:
    """The diagnostics of one step, gathered as the step runs so that no gradient list
    outlives its module's update: ``grads(name, tensors)`` right after a module's
    gradient, ``updates(name, norms)`` with its optimizer's update norms, and
    ``metrics(params, aux)`` at the end of the step."""

    def __init__(self) -> None:
        self._out: Dict[str, torch.Tensor] = {}
        self._update: Dict[str, torch.Tensor] = {}
        self._finite: List[torch.Tensor] = []
        self._total = 0
        self.aux: Dict[str, torch.Tensor] = {}  # further Health/<name> means, noted as the step runs

    def grads(self, name: str, tree: Any) -> None:
        self._out[f"Health/grad_norm/{name}"] = global_norm(tree)
        float_leaves = [x for x in leaves(tree) if x.is_floating_point()]
        if float_leaves:
            self._total += sum(x.numel() for x in float_leaves)
            flat = torch.cat([x.detach().reshape(-1) for x in float_leaves])
            self._finite.append(torch.isfinite(flat).sum())

    def updates(self, name: str, norms: torch.Tensor) -> None:
        """``norms``: the module's per-tensor update norms (or their global norm)."""
        self._update[name] = torch.linalg.vector_norm(norms.float())

    def update_tree(self, name: str, tree: Any) -> None:
        """A module's update given as the deltas themselves."""
        self._update[name] = global_norm(tree)

    def metrics(self, params: Any = None, aux: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        out = dict(self._out)
        param_mods = _top_modules(params) if params is not None else {}
        for name, p in param_mods.items():
            out[f"Health/param_norm/{name}"] = global_norm(p)
        for name, u_norm in self._update.items():
            out[f"Health/update_norm/{name}"] = u_norm
            if name in param_mods:
                out[f"Health/update_ratio/{name}"] = u_norm / (out[f"Health/param_norm/{name}"] + _EPS)
        if self._finite:
            out["Health/grad_finite_frac"] = torch.stack(self._finite).sum().float() / float(self._total)
        for name, value in {**self.aux, **(aux or {})}.items():
            if value is None:
                continue
            v = torch.as_tensor(value)
            out[f"Health/{name}"] = v.float() if v.dim() == 0 else v.float().mean()
        return {k: v.detach() for k, v in out.items()}


def diagnostics(
    grads: Any = None,
    params: Any = None,
    updates: Any = None,
    aux: Optional[Mapping[str, Any]] = None,
    update_norms: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The health scalars of one step, as 0-d float32 tensors:

    * ``Health/grad_norm/<module>``, ``Health/param_norm/<module>``,
      ``Health/update_norm/<module>``: per-module global norms (an update norm from
      ``updates``, the deltas, or from ``update_norms``, the optimizer's norms of them);
    * ``Health/update_ratio/<module>``: update norm over param norm, for the modules in
      both trees;
    * ``Health/grad_finite_frac``: the fraction of finite gradient elements, a device sum
      over the static element count;
    * ``Health/<name>``: the mean of each ``aux`` entry.
    """
    health = StepHealth()
    for name, g in (_top_modules(grads) if grads is not None else {}).items():
        health.grads(name, g)
    for name, u in (_top_modules(updates) if updates is not None else {}).items():
        health.update_tree(name, u)
    for name, norms in (update_norms or {}).items():
        health.updates(name, norms)
    return health.metrics(params, aux)


def health_metrics(cfg: Any, metrics: Dict[str, Any], **kwargs: Any) -> Dict[str, Any]:
    """``metrics`` with :func:`diagnostics` merged in where ``obs.health`` is on."""
    if health_enabled(cfg):
        metrics = {**metrics, **diagnostics(**kwargs)}
    return metrics


def replay_age_metrics(rb: Any) -> Dict[str, Any]:
    """``Health/replay_age_*`` of ``rb``'s latest sample: any buffer with
    ``sample_age_metrics()`` contributes, every other returns ``{}``."""
    fn = getattr(rb, "sample_age_metrics", None)
    if fn is None:
        return {}
    try:
        return dict(fn())
    except Exception:
        return {}
