"""A whole DroQ update of the PyTorch port against the JAX package's
``make_droq_train_fns``, and the port's captured block with its actor tail against its
eager steps.

Both packages build the tiny agent of ``test_torch_sac_modules.py`` (dropout 0.2, so
that the masks matter at these widths; ``target_network_frequency=2``) and run a block
of ``G = 3`` critic steps, then the actor and temperature step on a batch of its own,
on the same numpy batches. The port is handed JAX's draws: the normals
``jax.random.normal`` makes from the keys the reference splits, and the dropout masks
its ``nn.Dropout`` drew (recorded by ``nn.intercept_methods``, ``DropoutMasks``).
Compared afterwards as in ``test_torch_sac_train.py`` (``F32``): every parameter, the
Adam moments and counts (the critic's ``G``, the actor's and the temperature's 1), the
losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sac_modules import ACT, B, DropoutMasks, agent_pair, t
from tests.test_torch_sac_train import F32, assert_opt_states_match, assert_params_match, block_against_eager, make_batches, make_draws

G, FREQ = 3, 2
EXTRA = ["algo.critic.dropout=0.2", f"algo.critic.target_network_frequency={FREQ}"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def droq_run():
    import flax.linen as nn

    from sheeprl_tpu.algos.droq.droq import make_droq_train_fns
    from sheeprl_tpu.analysis.ir.synth import box_act_space
    from sheeprl_tpu_torch.algos.droq.droq import DroQDraws, make_droq_update
    from sheeprl_tpu_torch.utils.blocks import target_flags

    torch.set_num_threads(2)
    (jactor, jcritic), params, agent, jcfg, tcfg = agent_pair("droq", extra=EXTRA)
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    aopt, copt, topt, critics_fn, actor_fn = make_droq_train_fns(jactor, jcritic, jcfg, box_act_space(ACT))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = {"actor": aopt.init(jp["actor"]), "critic": copt.init(jp["critic"]), "alpha": topt.init(jp["log_alpha"])}
    batches, actor_obs = make_batches(2), make_batches(3, 1)["obs"][0]
    key, akey = jax.random.PRNGKey(8), jax.random.PRNGKey(9)
    masks, n = DropoutMasks(), jcfg.algo.critic.n
    with nn.intercept_methods(masks):
        p1, o1, cmet = critics_fn(jp, jopt, {k: jnp.asarray(v) for k, v in batches.items()}, key, jnp.asarray(0))
        p2, o2, amet = actor_fn(p1, o1, {"obs": jnp.asarray(actor_obs)}, akey)
        new_params, new_opt, cmet, amet = jax.device_get((p2, o2, cmet, amet))
    assert len(masks.masks) == (G + 1) * 2 * n  # two layers of n members: G critic steps, then the actor's
    critic_update, actor_update, _, opt_states = make_droq_update(agent, tcfg, ACT)
    flags = target_flags(0, G, FREQ, 1)
    met = []
    for g, (k_next, _) in enumerate(make_draws(key)):
        draws = DroQDraws(k_next, masks.noise(n, 2 * n * g))
        met.append(critic_update(opt_states, {k: t(v[g]) for k, v in batches.items()}, bool(flags[g]), draws))
    k_act = t(jax.random.normal(jax.random.split(akey)[0], (B, ACT)))  # the actor's key is split once, not per step
    ameta = actor_update(opt_states, t(actor_obs), DroQDraws(k_act, masks.noise(n, 2 * n * G)))
    return dict(agent=agent, before=before, new_params=new_params, new_opt=new_opt, cmet=cmet, amet=amet, met=met, ameta=ameta,
                opt_states=opt_states)


def test_droq_update_parameters_match_jax(droq_run):
    agent, before = droq_run["agent"], droq_run["before"]
    assert_params_match(agent, droq_run["new_params"])
    for k, v in agent.state_dict().items():
        assert not torch.equal(v, before[k]), k


def test_droq_update_optimizer_states_match_jax(droq_run):
    agent = droq_run["agent"]
    modules = {"actor": agent.actor, "critic": agent.critic, "alpha": None}
    assert_opt_states_match(droq_run["opt_states"], droq_run["new_opt"], modules, {"actor": 1, "critic": G, "alpha": 1})


def test_droq_update_losses_match_jax(droq_run):
    got = float(np.mean([m["Loss/value_loss"].item() for m in droq_run["met"]]))
    np.testing.assert_allclose(got, float(droq_run["cmet"]["Loss/value_loss"]), rtol=F32["metric_rtol"], atol=1e-7)
    for name in ("Loss/policy_loss", "Loss/alpha_loss"):
        np.testing.assert_allclose(droq_run["ameta"][name].item(), float(droq_run["amet"][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


def test_droq_update_health_matches_jax(droq_run):
    """The critic steps report their critic's per-layer norms and the target's mean; the
    actor step the rest, which in the reference's block replaces the critic steps' same
    names: together, the reference's names."""
    from tests.test_torch_sac_train import assert_health_matches

    cmet, amet = droq_run["cmet"], droq_run["amet"]
    critic_names = [k for k in droq_run["met"][0] if k.startswith("Health/")]
    assert_health_matches(droq_run["met"], cmet, critic_names)
    assert_health_matches([droq_run["ameta"]], amet)
    assert {k for k in cmet if k.startswith("Health/")} | set(amet) >= set(critic_names) | set(droq_run["ameta"])
    assert {k for k in cmet if k.startswith("Health/")} - set(amet) == set(critic_names)


def test_captured_droq_block_and_actor_tail_equal_eager_steps():
    from sheeprl_tpu_torch.algos.dreamer_loop import fill_draws, zero_draws
    from sheeprl_tpu_torch.algos.droq.droq import DRAW_KINDS, droq_parts, draw_shapes, make_droq_update
    from sheeprl_tpu_torch.utils.blocks import target_flags
    from tests.test_torch_sac_modules import spaces

    def build(ctx):
        _, _, _, _, cfg = agent_pair("droq", extra=EXTRA)
        _, obs_t, _, act_t = spaces("droq")
        parts = droq_parts(ctx, cfg, obs_t, act_t)
        shapes = draw_shapes(B, ACT, cfg.algo.critic.n, cfg.algo.critic.hidden_size)

        def eager(twin, states, batch, count, gen):
            critic_update, actor_update, _, _ = make_droq_update(twin, cfg, ACT)
            draws = fill_draws(zero_draws(shapes, torch.device("cpu")), DRAW_KINDS, gen)
            if count is None:  # the tail: the actor's step on its own batch
                actor_update(states, batch["obs"], draws)
            else:
                critic_update(states, batch, bool(target_flags(count, 1, FREQ, 1)[0]), draws)

        return parts, cfg, eager

    block_against_eager(build, tail_steps=1)
