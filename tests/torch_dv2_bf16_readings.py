"""The readings behind the limits of ``tests/test_torch_dv2_bf16.py``: the PyTorch
port's DreamerV2 train step at bf16-mixed against the JAX package's, on the CPU, for
both actors and a few seeds of weights, batch and draws. For each, the largest share of
parameter changes off JAX's, the largest relative distance of any Adam ``mu`` and ``nu``
leaf (and which), and of the losses and gradient norms; and, for the leaves the
reference sums in bfloat16, the port's distance from JAX's float32 step and how far
JAX's own bf16 values lie from it. Then, per case, each package's bf16 world-model
gradient norm against that package's own float32 norm from the same parameters, batch
and draws (``own_float32_norms``): which side sets the distance of the bf16 norm.

    JAX_PLATFORMS=cpu python -m tests.torch_dv2_bf16_readings [seeds, default 0,1,2]
"""

import json
import sys

from tests.test_torch_dv2_bf16 import SUMMED_IN_BF16, UNCLIPPED, train_step_readings
from tests.test_torch_dv2_train import build_jax_step, build_port_step, build_train_pair, run_jax, run_pair, run_port


def own_float32_norms(kind: str, seed: int) -> dict:
    """``Grads/world_model`` of one step in each package at bf16-mixed and at 32-true,
    from the same carried parameters, batch and draws (the readings' cases)."""
    pair = build_train_pair(kind, "bf16-mixed", seed=seed, extra=UNCLIPPED[kind])
    jout, (_, metrics) = run_pair(pair, kind, seed=seed + 3)
    jstep32, jinit32, _ = build_jax_step(kind, "32-true", seed, UNCLIPPED[kind])
    jax32 = run_jax(jstep32, jinit32, pair["params"], kind, seed + 3)
    _, step32, init32, _ = build_port_step(pair["params"], kind, "32-true", seed, UNCLIPPED[kind])
    _, metrics32 = run_port(step32, init32, kind, seed + 3)
    norms = {
        "jax_bf16": float(jout[2]["Grads/world_model"]), "jax_f32": float(jax32[2]["Grads/world_model"]),
        "port_bf16": metrics["Grads/world_model"].item(), "port_f32": metrics32["Grads/world_model"].item(),
    }
    return {
        **norms,
        "jax_bf16_off_own_f32": abs(norms["jax_bf16"] / norms["jax_f32"] - 1),
        "port_bf16_off_own_f32": abs(norms["port_bf16"] / norms["port_f32"] - 1),
        "port_f32_off_jax_f32": abs(norms["port_f32"] / norms["jax_f32"] - 1),
    }


def main(seeds) -> None:
    for kind in ("discrete", "continuous"):
        for seed in seeds:
            r = train_step_readings(kind, seed)
            print(json.dumps({
                "actor": kind,
                "seed": seed,
                "max_off_share": max(r["off_share"].items(), key=lambda kv: kv[1]),
                "max_mu_rel": max(r["mu"].items(), key=lambda kv: kv[1]),
                "max_nu_rel": max(r["nu"].items(), key=lambda kv: kv[1]),
                "max_metric_rel": max(r["metrics"].items(), key=lambda kv: kv[1]),
                # the leaves the reference sums in bf16: the port's bf16 step against JAX's
                # float32 step, and JAX's own bf16 step against it
                "max_summed_rel": max(
                    ((f"{leaf}.{m}", r[m][leaf]) for m in ("mu", "nu") for leaf in SUMMED_IN_BF16 if leaf in r[m]),
                    key=lambda kv: kv[1],
                    default=None,
                ),
                "grads_world_model_rel": r["metrics"]["Grads/world_model"],
                "max_jax_off_f32": max(r["jax_off_f32"].items(), key=lambda kv: kv[1]) if r["jax_off_f32"] else None,
                "jax_grads_world_model_off_f32": r["jax_off_f32"].get("Grads/world_model"),
            }), flush=True)
            print(json.dumps({"actor": kind, "seed": seed, "grads_world_model": own_float32_norms(kind, seed)}), flush=True)


if __name__ == "__main__":
    main([int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else "0,1,2").split(",")])
