"""The readings behind the limits of ``tests/test_torch_dv2_bf16.py``: the PyTorch
port's DreamerV2 train step at bf16-mixed against the JAX package's, on the CPU, for
both actors and a few seeds of weights, batch and draws. For each, the largest share of
parameter changes off JAX's, the largest relative distance of any Adam ``mu`` and ``nu``
leaf (and which), and of the losses and gradient norms; and, for the leaves the
reference sums in bfloat16, the port's distance from JAX's float32 step and how far
JAX's own bf16 values lie from it.

    JAX_PLATFORMS=cpu python -m tests.torch_dv2_bf16_readings [seeds, default 0,1,2]
"""

import json
import sys

from tests.test_torch_dv2_bf16 import SUMMED_IN_BF16, train_step_readings


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


if __name__ == "__main__":
    main([int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else "0,1,2").split(",")])
