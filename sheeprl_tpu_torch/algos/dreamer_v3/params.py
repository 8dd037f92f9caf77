"""Carry a parameter tree of the reference package into the port (every algorithm's:
the Dreamers', P2E's and the PPO family's).

``params_from_jax`` takes the reference's ``params`` (nested dicts of numpy arrays, as
``jax.device_get`` gives the fourth value of its ``build_agent``) and returns the
port's ``state_dict`` for each of ``world_model``, ``actor``, ``critic`` and
``target_critic``. It needs no JAX: the tree is plain numpy.

Names map by rule (``_torch_key``): the Flax child ``Dense_<i>`` is ``dense.<i>``,
``LayerNorm_<i>`` is ``norms.<i>``, ``Conv_<i>`` is ``convs.<i>``, ``ConvTranspose_<i>`` is
``deconvs.<i>``, ``MLP_0`` is ``mlp``, ``CNN_0`` is ``cnn``, ``head_<k>`` is ``heads.<k>``,
PPO's ``actor_head_<i>`` and recurrent PPO's ``actor_heads_<i>`` are ``actor_heads.<i>``,
the GRU cell's ``Dense_0`` is ``linear``, Flax's ``GRUCell`` input layer ``in`` and
``OptimizedLSTMCell`` forget-gate input kernel ``if`` (Python keywords) are ``in_`` and
``if_``, and the ``layers_0`` level of a Flax ``nn.Sequential`` is dropped, as are an
``nn.vmap`` ensemble's level (``VmapMLP_0``, DroQ's ``Vmap_Critic_0``: its leaves keep
their leading member axis) and a ``params`` level inside a tree of several Flax trees
(the SAC family's ``{"actor": {"params": ...}, "critic": ..., "log_alpha": ...}``, whose
0-d ``log_alpha`` is a leaf of the agent). Layouts convert as well:

* Dense kernel ``[in, out]`` -> ``Linear.weight`` ``[out, in]``; a stacked one ``[N,
  in, out]`` (P2E's ensembles, ``algos/p2e::StackedLinear``) stays as it is;
* Conv kernel HWIO -> ``Conv2d.weight`` OIHW (the PPO family's ``MultiEncoder``
  flattens its last conv map in Flax's ``H, W, C`` order, so the Dense after it needs
  no row permutation);
* ConvTranspose kernel ``[kh, kw, in, out]`` -> ``ConvTranspose2d.weight``
  ``[in, out, kh, kw]``, flipped in both spatial axes: Flax's transposed conv
  (``transpose_kernel=False``) correlates the stride-dilated input with the kernel as
  it stands, while torch's flips it.

Every leaf must map to exactly one entry of the module's ``state_dict`` with the same
shape, and every entry must be filled: a leaf left over or an entry missing raises.

A ``ModuleDict`` of modules takes a dict of their trees. ``parameter_list_from_jax``
carries a tree shaped like a module's parameters, such as
an optimizer's moments (optax's ``mu``/``nu``), into the order of
``module.parameters()``, the order of the port's optimizer state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

_RULES = (
    (re.compile(r"(^|/)params/"), r"\1"),
    (re.compile(r"(^|/)Vmap\w*_0/"), r"\1"),
    (re.compile(r"(^|/)layers_0/"), r"\1"),
    (re.compile(r"(^|/)MLP_0/"), r"\1mlp/"),
    (re.compile(r"(^|/)rnn/Dense_0/"), r"\1rnn/linear/"),
    (re.compile(r"(^|/)in/"), r"\1in_/"),
    (re.compile(r"(^|/)if/"), r"\1if_/"),
    (re.compile(r"(^|/)CNN_0/"), r"\1cnn/"),
    (re.compile(r"(^|/)actor_heads?_(\d+)/"), r"\1actor_heads/\2/"),
    (re.compile(r"(^|/)Dense_(\d+)/"), r"\1dense/\2/"),
    (re.compile(r"(^|/)LayerNorm_(\d+)/"), r"\1norms/\2/"),
    (re.compile(r"(^|/)ConvTranspose_(\d+)/"), r"\1deconvs/\2/"),
    (re.compile(r"(^|/)Conv_(\d+)/"), r"\1convs/\2/"),
    (re.compile(r"(^|/)head_([^/]+)/"), r"\1heads/\2/"),
)
_LEAVES = {"kernel": "weight", "scale": "weight"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _torch_key(path: str) -> str:
    parent, _, leaf = path.rpartition("/")
    parent = f"{parent}/" if parent else ""
    for pattern, repl in _RULES:
        parent = pattern.sub(repl, parent)
    return (parent + _LEAVES.get(leaf, leaf)).replace("/", ".")


def _convert(path: str, value: np.ndarray) -> np.ndarray:
    if not path.endswith("/kernel"):
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 3:
        return value
    if value.ndim == 4:
        parent = path.split("/")[-2]
        if parent.startswith("Conv_"):
            return value.transpose(3, 2, 0, 1)
        return value[::-1, ::-1].transpose(2, 3, 0, 1)
    raise ValueError(f"{path}: unexpected kernel rank {value.ndim}")


def module_state_from_jax(tree: Mapping[str, Any], module: nn.Module, name: str = "module") -> Dict[str, torch.Tensor]:
    """One Flax parameter tree (nested dicts of arrays) -> ``module``'s ``state_dict``.
    Raises on a leaf with no entry, an entry with no leaf, or a shape that differs."""
    target = module.state_dict()
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree).items():
        key = _torch_key(path)
        if key not in target:
            raise KeyError(f"{name}: leaf {path!r} maps to {key!r}, which the port's module does not have")
        if key in state:
            raise KeyError(f"{name}: two leaves map to {key!r}")
        arr = np.array(_convert(path, value), order="C")  # ascontiguousarray would make a 0-d leaf 1-d
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError(f"{name}: {path!r} -> {key!r} has shape {arr.shape}, expected {tuple(target[key].shape)}")
        state[key] = torch.from_numpy(arr.astype(np.float32, copy=True)).to(target[key].dtype)
    missing = sorted(set(target) - set(state))
    if missing:
        raise KeyError(f"{name}: no reference leaf for {missing}")
    return state


def params_from_jax(params: Mapping[str, Any], modules: Mapping[str, nn.Module]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``params``: ``{name: {"params": tree}}`` for each name in ``modules``. Returns
    ``{name: state_dict}`` ready for ``modules[name].load_state_dict``. A module that is
    an ``nn.ModuleDict`` takes a dict of such trees, one per child (P2E-DV3's
    ``critics_exploration``: ``{name: {"module": ..., "target": ...}}``)."""
    if set(params) != set(modules):
        raise KeyError(f"parameter trees {sorted(params)} do not match modules {sorted(modules)}")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, module in modules.items():
        tree = params[name]
        if isinstance(module, nn.ModuleDict):
            nested = params_from_jax(tree, module)
            out[name] = {f"{child}.{k}": v for child, state in nested.items() for k, v in state.items()}
            continue
        tree = tree["params"] if set(tree) == {"params"} else tree
        out[name] = module_state_from_jax(tree, module, name)
    return out


def parameter_list_from_jax(tree: Mapping[str, Any], module: nn.Module, name: str = "module") -> List[torch.Tensor]:
    """A tree shaped like ``module``'s parameters -> one tensor per
    ``module.parameters()`` entry, in that order (the port's optimizer-state layout)."""
    tree = tree["params"] if set(tree) == {"params"} else tree
    state = module_state_from_jax(tree, module, name)
    return [state[k] for k, _ in module.named_parameters()]
