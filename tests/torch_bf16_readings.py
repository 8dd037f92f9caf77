"""The readings behind the limits of ``test_train_step_bf16_matches_jax_bf16``: the
PyTorch port's DreamerV3 train step at bf16-mixed against the JAX package's, on the CPU,
for both actors and a few seeds of weights, batch and draws. For each, the largest share
of parameter changes off JAX's, the largest relative distance of any Adam ``mu`` and
``nu`` leaf (and which), and of the losses and gradient norms; and, for the leaf the
reference sums in bfloat16, how far the port's and JAX's values lie from the port's
float32 step.

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_readings [seeds, default 0,1,2]
"""

import json
import sys

from tests.test_torch_dv3_bf16 import train_step_readings


def main(seeds) -> None:
    for kind in ("discrete", "continuous"):
        for seed in seeds:
            r = train_step_readings(kind, seed)
            worst = {m: max(r[m].items(), key=lambda kv: kv[1]) for m in ("mu", "nu")}
            print(json.dumps({
                "actor": kind,
                "seed": seed,
                "max_off_share": max(r["off_share"].items(), key=lambda kv: kv[1]),
                "max_mu_rel": worst["mu"],
                "max_nu_rel": worst["nu"],
                "max_metric_rel": max(r["metrics"].items(), key=lambda kv: kv[1]),
                "bf16_summed_leaf": {m: {"port_vs_f32": r[m][leaf], "jax_vs_f32": off} for m in ("mu", "nu")
                                     for leaf, off in r[f"jax_{m}_off_f32"].items()},
            }), flush=True)


if __name__ == "__main__":
    main([int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else "0,1,2").split(",")])
