"""The training path's compute dtype (counterpart of
``sheeprl_tpu/precision/policy.py::train_policy``; the rest of that module, its
``PrecisionPolicy`` triples and their cast helpers, is not ported).

``algo.precision`` picks it: ``mesh`` (the default) inherits ``mesh.precision`` through
the run context's compute dtype; ``bf16`` (bfloat16 compute over float32 parameters) or
``f32`` force one per run. Parameters and optimizer states stay float32 either way. An
explicit float16 policy is refused, as the reference refuses it; so are the
reference's ``bf16-true`` parameters, which the port does not have.
"""

from __future__ import annotations

from typing import Any

import torch

# algo.precision values, as the reference's resolve_policy names them
_COMPUTE = {
    "f32": torch.float32,
    "fp32": torch.float32,
    "float32": torch.float32,
    "32-true": torch.float32,
    "bf16": torch.bfloat16,
    "bf16-mixed": torch.bfloat16,
}
_FP16 = ("fp16", "16-mixed")


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
    if spec not in _COMPUTE:
        raise ValueError(f"Unknown precision spec {spec!r}; expected mesh or one of {sorted(_COMPUTE)}")
    return _COMPUTE[spec]
