"""The readings behind the bf16 limits of ``tests/test_torch_dv1_train.py``: the PyTorch
port's DreamerV1 train step at bf16-mixed against the JAX package's, on the CPU, for both
actors and a few seeds of weights, batch and draws. For each, the largest share of
parameter changes off JAX's, the largest relative distance of any Adam ``mu`` and ``nu``
leaf (and which), and of the losses and gradient norms; and, for the conv biases the
reference sums in bfloat16, how far JAX's own bf16 values lie from its float32 step.

    JAX_PLATFORMS=cpu python -m tests.torch_dv1_bf16_readings [seeds, default 0,1,2]

On the CPU, seeds 0-2: the largest off share 2.9 % (the continuous actor, seed 1); ``mu``
0.136 and ``nu`` 0.243 on ``world_model.observation_model_cnn.deconvs.0.bias`` (against
JAX's float32 step, discrete actor, seed 1), at most 0.044 and 0.072 on any other leaf;
the metrics at most 8.9e-3 (``Grads/critic``); JAX's own bf16 step 0.66-0.93 off its
float32 step on the summed biases.
"""

import json
import sys

from tests.test_torch_dv1_train import train_step_readings


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
                "max_jax_off_f32": max(r["jax_off_f32"].items(), key=lambda kv: kv[1]) if r["jax_off_f32"] else None,
            }), flush=True)


if __name__ == "__main__":
    main([int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else "0,1,2").split(",")])
