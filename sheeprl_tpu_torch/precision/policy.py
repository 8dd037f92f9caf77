"""Precision policies (counterpart of ``sheeprl_tpu/precision/policy.py``).

``PrecisionPolicy`` is a (param, compute, output) dtype triple with boundary-cast helpers
over trees of tensors; ``resolve_policy`` maps a precision name (the reference's
``_POLICIES``, fp16's and ``bf16-true``'s included) to one.

``train_policy`` is the training path's compute dtype, from ``algo.precision``: ``mesh``
(the default) inherits ``mesh.precision`` through the run context's compute dtype;
``bf16`` (bfloat16 compute over float32 parameters) or ``f32`` force one per run.
Parameters and optimizer states stay float32 either way. An explicit float16 policy is
refused, as the reference refuses it; so are the reference's ``bf16-true`` parameters,
which the port's train loops do not have.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

_POLICIES = {
    # full precision
    "f32": (torch.float32, torch.float32, torch.float32),
    "fp32": (torch.float32, torch.float32, torch.float32),
    "float32": (torch.float32, torch.float32, torch.float32),
    "32-true": (torch.float32, torch.float32, torch.float32),
    # bf16 mixed: float32 parameters and optimizer state, bfloat16 compute, float32 outputs
    "bf16": (torch.float32, torch.bfloat16, torch.float32),
    "bf16-mixed": (torch.float32, torch.bfloat16, torch.float32),
    # bf16 true: everything bfloat16, the parameters too
    "bf16-true": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    # fp16 mixed: needs loss scaling (see train_policy's refusal)
    "fp16": (torch.float32, torch.float16, torch.float32),
    "16-mixed": (torch.float32, torch.float16, torch.float32),
}
_FP16 = ("fp16", "16-mixed")


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """A (param, compute, output) dtype triple. The cast helpers touch floating-point
    tensors only: integer and boolean ones (discrete actions, done flags) pass through."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def _cast(self, tree: Any, dtype: torch.dtype) -> Any:
        return _map(tree, lambda x: x.to(dtype) if torch.is_floating_point(x) else x)

    def cast_to_compute(self, tree: Any) -> Any:
        return self._cast(tree, self.compute_dtype)

    def cast_to_param(self, tree: Any) -> Any:
        return self._cast(tree, self.param_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        return self._cast(tree, self.output_dtype)

    @property
    def is_mixed(self) -> bool:
        return self.compute_dtype != self.param_dtype

    def describe(self) -> str:
        name = lambda d: str(d).removeprefix("torch.")  # noqa: E731
        return f"params={name(self.param_dtype)} compute={name(self.compute_dtype)} output={name(self.output_dtype)}"


def resolve_policy(spec: str) -> PrecisionPolicy:
    """A precision name (``algo.precision`` / ``mesh.precision``) -> its policy."""
    key = str(spec).lower()
    if key not in _POLICIES:
        raise ValueError(f"Unknown precision spec {spec!r}; expected one of {sorted(_POLICIES)}")
    param, compute, output = _POLICIES[key]
    return PrecisionPolicy(param_dtype=param, compute_dtype=compute, output_dtype=output)


def train_policy(cfg: Any, ctx: Any) -> torch.dtype:
    """The compute dtype of the train path from ``cfg.algo.precision``; ``ctx`` is the
    run context, whose ``compute_dtype`` is ``mesh.precision``'s."""
    spec = str((cfg.get("algo") or {}).get("precision", "mesh") or "mesh").lower()
    if spec == "mesh":
        return ctx.compute_dtype
    if spec in _FP16:
        raise ValueError(
            f"algo.precision={spec} is not supported: float16 training needs dynamic loss scaling in every "
            "train carry, which the reference refuses too. Use algo.precision=bf16."
        )
    if spec == "bf16-true":
        raise NotImplementedError("algo.precision=bf16-true (bfloat16 parameters) is not ported yet; use bf16 or f32")
    return resolve_policy(spec).compute_dtype
