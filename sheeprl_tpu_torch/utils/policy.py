"""Policy parameters out of a loaded checkpoint (counterpart of
``sheeprl_tpu/utils/policy.py::extract_policy_params``; the act functions and the
serving path of that module are not ported).

The port writes the host loop's layout only: ``params`` at the top of the checkpoint.
The reference's Anakin runs keep them inside the scan ``carry`` and its population runs
add a member axis; neither engine is ported, so such a checkpoint raises, naming its
key."""

from __future__ import annotations

from typing import Any, Dict


def extract_policy_params(state: Dict[str, Any], cfg: Any, algo: str) -> Any:
    if "params" in state:
        return state["params"]
    if "carry" in state:
        raise NotImplementedError(
            f"{algo}: the checkpoint keeps its parameters under 'carry' (an algo.anakin run, or a population "
            "run's member axis), a layout the PyTorch port does not load yet"
        )
    raise KeyError(f"{algo}: the checkpoint has no 'params' (keys: {sorted(state)})")
