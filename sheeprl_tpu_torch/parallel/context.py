"""The run context: what an entry point hands an algorithm in place of the reference's
``MeshContext`` (``sheeprl_tpu/parallel/mesh.py``). The port runs on one device; the
mesh, sharding and multi-process parts are not ported.

``RunContext`` carries the device, the compute dtype, the seed, and ``rng()``, which
returns a fresh ``torch.Generator`` from a seeded chain, so two runs with one seed draw
the same numbers. The compute dtype comes from ``mesh.precision`` as in the reference
(``MeshContext.compute_dtype``): ``bf16-mixed`` (the default) computes in bfloat16 over
float32 parameters, ``32-true`` in float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

# The reference's float32_matmul_precision values, in torch's words.
_MATMUL_PRECISION = {
    "highest": "highest",
    "float32": "highest",
    "high": "high",
    "tensorfloat32": "high",
    "medium": "medium",
    "bfloat16": "medium",
}


# mesh.precision values the port implements, as the reference reads them
_COMPUTE_DTYPES = {
    "bf16-mixed": torch.bfloat16,
    "bf16": torch.bfloat16,
    "32-true": torch.float32,
    "32": torch.float32,
    "fp32": torch.float32,
    "f32": torch.float32,
    "float32": torch.float32,
}
# values the reference accepts and the port does not implement yet
_NOT_PORTED = {
    "bf16-true": "bfloat16 parameters",
    "16-mixed": "float16 compute with loss scaling",
    "fp16": "float16 compute with loss scaling",
}


def compute_dtype(precision: str) -> torch.dtype:
    """The compute dtype for a ``mesh.precision`` value; raises for the values the port
    does not implement."""
    name = str(precision)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"mesh.precision={name!r} ({_NOT_PORTED[name]}) is not ported yet; use bf16-mixed or 32-true"
        )
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"mesh.precision must be one of {sorted(_COMPUTE_DTYPES)}, got {name!r}")
    return _COMPUTE_DTYPES[name]


@dataclass
class RunContext:
    device: torch.device
    seed: int = 42
    compute_dtype: torch.dtype = torch.float32
    _draws: int = field(default=0, repr=False)

    def rng(self, device: Optional[torch.device | str] = None) -> torch.Generator:
        """A new generator on ``device`` (default: the run's), seeded from the run's
        seed and the number of generators drawn before it."""
        gen = torch.Generator(device=torch.device(device) if device is not None else self.device)
        gen.manual_seed(self.seed * 1_000_003 + self._draws)
        self._draws += 1
        return gen


def resolve_device(name: str) -> torch.device:
    """``cuda`` (any index) or ``cpu``; asking for CUDA where there is none raises."""
    device = torch.device(str(name))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={name!r} but CUDA is not available; pass device=cpu to run on the CPU"
            )
    elif device.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return device


def make_run_context(cfg: Dict[str, Any]) -> RunContext:
    """Build the context from the root config's ``device``, ``seed``,
    ``mesh.precision`` and ``float32_matmul_precision`` (the last applies to CUDA runs
    only)."""
    device = resolve_device(cfg.get("device", "cuda"))
    precision = cfg.get("float32_matmul_precision")
    if device.type == "cuda" and precision:
        if str(precision) not in _MATMUL_PRECISION:
            raise ValueError(f"float32_matmul_precision must be one of {sorted(_MATMUL_PRECISION)}, got {precision!r}")
        torch.set_float32_matmul_precision(_MATMUL_PRECISION[str(precision)])
    dtype = compute_dtype((cfg.get("mesh") or {}).get("precision", "bf16-mixed"))
    return RunContext(device=device, seed=int(cfg.get("seed", 42)), compute_dtype=dtype)
