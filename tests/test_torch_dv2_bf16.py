"""``mesh.precision=bf16-mixed``: a whole DreamerV2 training step of the PyTorch port
against the JAX package's at the same precision, the discrete actor over the image and
vector keys and the continuous actor over the vector key (the cases of
``test_torch_dv2_train.py``).

Both packages compute in bfloat16 over float32 parameters, layer by layer, but round at
other places, so the step agrees to bf16's precision, not bit for bit. The first Adam
step moves each parameter by about its ``lr`` with the gradient's sign, so compared, as
for DreamerV3 (``test_torch_dv3_bf16.py``):

- the parameter change (new minus old) of each module against JAX's: at most
  ``MAX_OFF_SHARE`` of a module's entries may differ by more than 0.1 of its ``lr``
  (those whose gradient sign bf16's rounding decides); a step that updates nothing or
  follows wrong gradients misses on ~50-100 %;
- each leaf's Adam ``mu`` by relative norm (``MU_RTOL``) and ``nu`` at twice that. The
  leaves in ``SUMMED_IN_BF16`` are held to the JAX package's float32 step on the same
  parameters, batch and draws instead: biases added after a conv or a transposed conv,
  whose gradient sums every position of the map; the reference adds them in bf16, so
  their gradient is a bf16 ``reduce_sum``, while the port sums in float32;
- the losses and the ``Grads/*`` norms, ``METRIC_RTOL``; the world model's norm, which
  those bias gradients dominate, against JAX's float32 step's.

Those bf16 sums put the reference's world-model norm 16-38 % off its float32 value
(readings, discrete actor), and at the exp's clip of 100 that rescales every world-model leaf's
update by as much. The discrete case therefore lifts the world model's clip
(``UNCLIPPED``) in all three steps, so that each leaf is held on its own; the bf16
world-model update at the clip of 100 is not held against the reference.

The limits rest on the readings ``python -m tests.torch_dv2_bf16_readings`` prints
(seeds 0-2, both actors, on the CPU): off shares at most 1.1 % (the critic), ``mu`` at
most 0.022 and ``nu`` 0.043 (a conv bias, against JAX's float32 step), the metrics at
most 6.9e-3 (``Grads/actor``), the world model's norm at most 2.0e-3 from JAX's float32
step's; JAX's own bf16 sums lie 0.64-0.77 from its float32 step on the conv biases'
moments.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_dv2_train import GRADS, LOSSES, METRICS, build_jax_step, build_train_pair, few_threads, run_jax, run_pair  # noqa: F401
from tests.test_torch_dv3_train import _adam_state

STEP_ATOL_OF_LR = 0.1
MAX_OFF_SHARE = 0.04
MU_RTOL, NU_RTOL = 0.1, 0.2
METRIC_RTOL = 2e-2
# gradients the reference sums in bfloat16 (see the module's docstring)
UNCLIPPED = {"discrete": ["algo.world_model.clip_gradients=1e9"], "continuous": []}
SUMMED_IN_BF16 = {
    "world_model.encoder.cnn_encoder.convs.0.bias",
    "world_model.encoder.cnn_encoder.convs.1.bias",
    "world_model.encoder.cnn_encoder.convs.2.bias",
    "world_model.encoder.cnn_encoder.convs.3.bias",
    "world_model.observation_model_cnn.deconvs.0.bias",
    "world_model.observation_model_cnn.deconvs.1.bias",
    "world_model.observation_model_cnn.deconvs.2.bias",
    "world_model.observation_model_cnn.head.bias",
}


def train_step_readings(kind: str, seed: int = 0) -> dict:
    """One whole step at bf16-mixed in both packages, and what the test compares: per
    module, the share of parameter changes off JAX's by more than ``STEP_ATOL_OF_LR`` of
    its lr; per leaf, the relative norm distance of the Adam moments from JAX's (from
    JAX's float32 step's for ``SUMMED_IN_BF16``, and there also the distance of JAX's
    bf16 step from it); the relative distance of the losses and ``Grads/*`` norms."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax, params_from_jax

    pair = build_train_pair(kind, "bf16-mixed", seed=seed, extra=UNCLIPPED[kind])
    modules = pair["modules"]
    assert modules["world_model"].rssm.recurrent_model.rnn.linear.compute_dtype == torch.bfloat16
    old = params_from_jax(pair["params"], modules)
    jout, (opt, metrics) = run_pair(pair, kind, seed=seed + 3)
    new_jax = params_from_jax(jout[0], modules)
    algo = pair["cfg"].algo
    lr = {"world_model": algo.world_model.optimizer.lr, "actor": algo.actor.optimizer.lr, "critic": algo.critic.optimizer.lr}
    lr["target_critic"] = lr["critic"]
    out = {"off_share": {}, "mu": {}, "nu": {}, "metrics": {}, "jax_off_f32": {}}
    for name, module in modules.items():
        off = torch.cat([
            ((v.float() - old[name][k]) - (new_jax[name][k] - old[name][k])).abs().flatten() > STEP_ATOL_OF_LR * lr[name]
            for k, v in module.state_dict().items()
        ])
        out["off_share"][name] = off.float().mean().item()

    # JAX's float32 step from the same parameters, batch and key, where the case has
    # leaves that the reference sums in bf16
    f32 = None
    if any(f"{name}.{k}" in SUMMED_IN_BF16 for name, m in modules.items() for k, _ in m.named_parameters()):
        jstep32, jinit32, _ = build_jax_step(kind, "32-true", seed, UNCLIPPED[kind])
        f32 = run_jax(jstep32, jinit32, pair["params"], kind, seed + 3)
    for name in ("world_model", "actor", "critic"):
        ref = _adam_state(jout[1][name])
        leaves = [k for k, _ in modules[name].named_parameters()]
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), modules[name], name)
            want32 = want if f32 is None else parameter_list_from_jax(getattr(_adam_state(f32[1][name]), moment), modules[name], name)
            for leaf, got, exp, exp32 in zip(leaves, opt[name][moment], want, want32):
                if f"{name}.{leaf}" in SUMMED_IN_BF16:
                    out["jax_off_f32"][f"{name}.{leaf}.{moment}"] = ((exp - exp32).norm() / exp32.norm()).item()
                    exp = exp32
                err, norm = (got - exp).norm().item(), exp.norm().item()
                out[moment][f"{name}.{leaf}"] = err / norm if norm > 0 else (0.0 if err == 0 else float("inf"))
    for name in (*LOSSES, *GRADS):
        # the world model's norm against JAX's float32 step's where the case has such leaves
        ref = float(f32[2][name]) if name == "Grads/world_model" and f32 is not None else float(jout[2][name])
        out["metrics"][name] = abs(metrics[name].item() - ref) / max(abs(ref), 1e-6)
    if f32 is not None:
        out["jax_off_f32"]["Grads/world_model"] = abs(float(jout[2]["Grads/world_model"]) / float(f32[2]["Grads/world_model"]) - 1)
    out["finite"] = all(np.isfinite(metrics[name].item()) for name in METRICS + GRADS)
    return out


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_train_step_bf16_matches_jax_bf16(kind):
    readings = train_step_readings(kind)
    for name, share in readings["off_share"].items():
        assert share <= MAX_OFF_SHARE, (name, share)
    for moment, rtol in (("mu", MU_RTOL), ("nu", NU_RTOL)):
        for leaf, rel in readings[moment].items():
            assert rel <= rtol, (leaf, moment, rel)
    for name, rel in readings["metrics"].items():
        assert rel <= METRIC_RTOL, (name, rel)
    assert readings["finite"]
