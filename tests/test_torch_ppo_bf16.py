"""The bf16-mixed PPO update of the PyTorch port against the JAX package's bf16 update,
held as ``test_torch_dv3_bf16.py`` holds DreamerV3's (the agents, rollouts and options
of ``test_torch_ppo_train.py``).

One gradient step over the whole rollout (``BF16_ONE_STEP``): over further steps Adam
turns bf16's rounding of the smallest gradients into whole lr-sized moves (at eps 1e-6,
JAX's own bf16 update lies more than 0.1 lr off its float32 one on 13 % (discrete) and
56 % (continuous) of the entries after two updates of 4 steps). Held: the parameter
change off JAX's by more than 0.1 of the lr on at most ``MAX_OFF_SHARE`` (4 %) of the
entries, each Adam leaf's ``mu`` and ``nu`` within ``MU_RTOL`` (0.2) and ``NU_RTOL``
(0.4) by relative norm, the losses within ``METRIC_RTOL`` (5e-2, relative to at least
0.05). Readings (``JAX_PLATFORMS=cpu python -m tests.test_torch_ppo_bf16``, seeds 0-2,
both actors, on the CPU): off shares at most 0.27 %, ``mu`` at most 0.034, ``nu``
0.078, the losses 1.5e-3.
"""

import pytest
import torch

from tests.test_torch_ppo_train import adam, moments, port_tree, run_ppo_pair

STEP_ATOL_OF_LR, MAX_OFF_SHARE = 0.1, 0.04
MU_RTOL, NU_RTOL = 0.2, 0.4
METRIC_RTOL = 5e-2
BF16_ONE_STEP = ["algo.update_epochs=1", "algo.per_rank_batch_size=16"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def bf16_readings(action: str, seed: int = 0):
    """The bf16-mixed update's distance to JAX's, one gradient step over the whole
    rollout: per-entry parameter change off (over the lr), the Adam moments' relative
    norms, the losses' relative differences."""
    params, new_params, o_state, before, fns, agent, jmet, met = run_ppo_pair(action, "bf16-mixed", 1, BF16_ONE_STEP, seed)
    want, lr = port_tree(new_params, agent), 2.5e-4
    off = torch.cat([((v - before[k]) - (want[k] - before[k])).abs().flatten() / lr for k, v in agent.state_dict().items()])
    state = adam(o_state)
    rel = {
        name: max(((g - r).norm() / r.norm().clamp_min(1e-30)).item() for g, r in zip(fns.opt_state[name], moments(getattr(state, name), agent)))
        for name in ("mu", "nu")
    }
    # the policy loss is ~0 at ratios ~1 over normalized advantages: relative to at least 0.05
    metric = max(abs(v - float(jm[k])) / max(abs(float(jm[k])), 0.05) for jm, m in zip(jmet, met) for k, v in m.items())
    return {"off_share": (off > STEP_ATOL_OF_LR).float().mean().item(), "off_max": off.max().item(), **rel, "metric": metric}


@pytest.mark.parametrize("action", ["discrete", "continuous"])
def test_ppo_update_bf16_matches_jax_bf16(action):
    r = bf16_readings(action)
    assert r["off_share"] <= MAX_OFF_SHARE, r
    assert r["mu"] <= MU_RTOL and r["nu"] <= NU_RTOL, r
    assert r["metric"] <= METRIC_RTOL, r


if __name__ == "__main__":  # the readings behind MAX_OFF_SHARE, MU_RTOL, NU_RTOL, METRIC_RTOL
    torch.set_num_threads(2)
    for action in ("discrete", "continuous"):
        for seed in range(3):
            print(action, seed, bf16_readings(action, seed))
