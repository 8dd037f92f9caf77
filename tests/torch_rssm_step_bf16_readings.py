"""The readings behind the bf16 limits of the fused step's backward (``chip_smoke.py``'s
``step_bwd_atol`` and ``test_cuda_backward_kernel_matches_plain_version``): the JAX
package's own kernel, ``fused_gru_step`` in interpret mode, with bf16 operands at the
card's shapes (B 13, 16, 64 and 256; K 1024; H 512), on ``chip_smoke.py``'s operand
distribution. For each B, types and seed: the largest error of dw against the plain
version on float32 operands, dw's largest entry, and, against the plain version on the
same bf16 operands, each gradient's largest error past one bf16 rounding (2^-7 of the
entry) as a share of the gradient's largest entry. Then the worst of each over the cases.

    JAX_PLATFORMS=cpu python -m tests.torch_rssm_step_bf16_readings [seeds, default 0,1,2,3]
"""

import json
import sys

import numpy as np
import torch

from sheeprl_tpu_torch.ops.rssm_step import gru_step_backward_reference

K, H = 1024, 512
TYPES = {"bfloat16": (torch.bfloat16,) * 3, "bf16_xw": (torch.bfloat16, torch.float32, torch.float32)}
NAMES = ("dxh", "dh", "dw", "dgamma", "dbeta")


def readings(batch: int, seed: int) -> list:
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.ops.rssm_step import fused_gru_step

    rng = np.random.default_rng(seed)
    f32 = [
        rng.normal(size=(batch, K)),
        rng.normal(size=(batch, H)),
        rng.normal(size=(K, 3 * H)) * K**-0.5,
        1 + 0.1 * rng.normal(size=3 * H),
        0.1 * rng.normal(size=3 * H),
        rng.normal(size=(batch, H)),
    ]
    f32 = [torch.from_numpy(a.astype(np.float32)) for a in f32]
    ref = gru_step_backward_reference(*f32)
    rows = []
    for types, (ti, th, tg) in TYPES.items():
        ops = [f32[0].to(ti), f32[1].to(th), f32[2].to(ti), f32[3].to(tg), f32[4].to(tg), f32[5].to(th)]
        same = gru_step_backward_reference(*ops)
        args = [jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for t in ops]
        _, vjp = jax.vjp(fused_gru_step, *args[:5])
        grads = [np.asarray(g, np.float32) for g in vjp(args[5])]
        past = {}
        for name, g, s in zip(NAMES, grads, same):
            s = s.float().numpy()
            past[name] = float((np.abs(g - s) - 2**-7 * np.abs(s)).max() / np.abs(s).max())
        rows.append({
            "B": batch,
            "types": types,
            "seed": seed,
            "dw_err_vs_f32": float(np.abs(grads[2] - ref[2].numpy()).max()),
            "dw_max": float(ref[2].abs().max()),
            "past_one_rounding_share": past,
        })
    return rows


def main(seeds) -> None:
    worst_dw, worst_past = {}, {}
    for batch in (13, 16, 64, 256):
        for seed in seeds:
            for row in readings(batch, seed):
                print(json.dumps(row))
                worst_dw[batch] = max(worst_dw.get(batch, 0.0), row["dw_err_vs_f32"])
                for name, v in row["past_one_rounding_share"].items():
                    worst_past[name] = max(worst_past.get(name, -1.0), v)
    print(json.dumps({"worst_dw_err_vs_f32_by_B": worst_dw, "worst_past_one_rounding_share": worst_past}))


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1].split(",")] if len(sys.argv) > 1 else [0, 1, 2, 3])
