"""The run context: what an entry point hands an algorithm in place of the reference's
``MeshContext`` (``sheeprl_tpu/parallel/mesh.py``). The port runs on one device; the
mesh, sharding and multi-process parts are not ported.

``RunContext`` carries the device, the compute dtype, the seed, and ``rng()``, which
returns a fresh ``torch.Generator`` from a seeded chain, so two runs with one seed draw
the same numbers.
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
    """Build the context from the root config's ``device``, ``seed`` and
    ``float32_matmul_precision`` (the last applies to CUDA runs only)."""
    device = resolve_device(cfg.get("device", "cuda"))
    precision = cfg.get("float32_matmul_precision")
    if device.type == "cuda" and precision:
        if str(precision) not in _MATMUL_PRECISION:
            raise ValueError(f"float32_matmul_precision must be one of {sorted(_MATMUL_PRECISION)}, got {precision!r}")
        torch.set_float32_matmul_precision(_MATMUL_PRECISION[str(precision)])
    return RunContext(device=device, seed=int(cfg.get("seed", 42)))
