"""The bf16-mixed SAC update of the PyTorch port against the JAX package's bf16 update,
held as ``test_torch_ppo_bf16.py`` holds PPO's (the agent, batches and draws of
``test_torch_sac_train.py``; SAC's train policy resolves ``mesh.precision=bf16-mixed``
to bfloat16 compute over float32 parameters in both packages).

One gradient step (``G = 1``): over further steps Adam turns bf16's rounding of the
smallest gradients into whole lr-sized moves. Held: the parameter change off JAX's by
more than 0.1 of the lr on at most ``MAX_OFF_SHARE`` of the entries, each Adam leaf's
``mu`` and ``nu`` within ``MU_RTOL`` and ``NU_RTOL`` by relative norm (the 0-d
temperature's too), the losses within ``METRIC_RTOL`` (relative to at least 0.05).
Readings (``JAX_PLATFORMS=cpu python -m tests.test_torch_sac_bf16``, seeds 0-2, on the
CPU): off shares 0 (the largest change off by 0.041 lr), ``mu`` at most 0.0077, ``nu``
0.0149, the losses 6.0e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sac_modules import ACT, agent_pair, t
from tests.test_torch_sac_train import adam_state, make_batches, make_draws

STEP_ATOL_OF_LR, MAX_OFF_SHARE = 0.1, 0.04
MU_RTOL, NU_RTOL = 0.2, 0.4
METRIC_RTOL = 5e-2


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def bf16_readings(seed: int = 0) -> dict:
    """One bf16-mixed SAC step in each package from the same carried parameters, batch
    and draws: the share of parameter changes off JAX's by more than 0.1 lr (and the
    largest, in lr), the largest relative norm distance of an Adam ``mu`` and ``nu``
    leaf, the largest relative distance of a loss."""
    from sheeprl_tpu.algos.sac.sac import make_sac_train_fn
    from sheeprl_tpu.analysis.ir.synth import box_act_space
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax, params_from_jax
    from sheeprl_tpu_torch.algos.sac.sac import SACDraws, make_sac_update

    (jactor, jcritic), params, agent, jcfg, tcfg = agent_pair("sac", "bf16-mixed", seed=seed)
    assert agent.actor.mlp.dense[0].compute_dtype == torch.bfloat16
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    aopt, copt, topt, train_fn = make_sac_train_fn(jactor, jcritic, jcfg, box_act_space(ACT))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = {"actor": aopt.init(jp["actor"]), "critic": copt.init(jp["critic"]), "alpha": topt.init(jp["log_alpha"])}
    batches, key = make_batches(20 + seed, 1), jax.random.PRNGKey(30 + seed)
    new_params, new_opt, jmet = jax.device_get(train_fn(jp, jopt, {k: jnp.asarray(v) for k, v in batches.items()}, key, jnp.asarray(0)))
    update, _, opt_states = make_sac_update(agent, tcfg, ACT)
    met = update(opt_states, {k: t(v[0]) for k, v in batches.items()}, True, SACDraws(*make_draws(key, 1)[0]))
    want, lr = params_from_jax({"agent": new_params}, {"agent": agent})["agent"], 3e-4
    off = torch.cat([((v - before[k]) - (want[k] - before[k])).abs().flatten() / lr for k, v in agent.state_dict().items()])
    rel = {}
    for moment in ("mu", "nu"):
        worst = 0.0
        for name, module in (("actor", agent.actor), ("critic", agent.critic), ("alpha", None)):
            tree = getattr(adam_state(new_opt[name]), moment)
            refs = [t(np.asarray(tree))] if module is None else parameter_list_from_jax(tree, module, name)
            for got, ref in zip(opt_states[name][moment], refs):
                worst = max(worst, ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item())
        rel[moment] = worst
    metric = max(abs(v.item() - float(jmet[k])) / max(abs(float(jmet[k])), 0.05) for k, v in met.items())
    return {"off_share": (off > STEP_ATOL_OF_LR).float().mean().item(), "off_max": off.max().item(), **rel, "metric": metric}


def test_sac_update_bf16_matches_jax_bf16():
    r = bf16_readings()
    assert r["off_share"] <= MAX_OFF_SHARE, r
    assert r["mu"] <= MU_RTOL and r["nu"] <= NU_RTOL, r
    assert r["metric"] <= METRIC_RTOL, r


if __name__ == "__main__":  # the readings behind MAX_OFF_SHARE, MU_RTOL, NU_RTOL, METRIC_RTOL
    torch.set_num_threads(2)
    for seed in range(3):
        print(seed, bf16_readings(seed))
