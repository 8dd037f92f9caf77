"""Whole SAC-AE updates of the PyTorch port against the JAX package's
``make_sac_ae_train_fn``, and the port's captured cadence steps against its eager steps.

Both packages build the tiny agent of ``test_torch_sac_modules.py`` (3 x 16 x 16 frames,
a 4-channel trunk, 8 features) and run ``G = 4`` gradient steps on the same numpy
batches of uint8 frames, the port handed the normals ``jax.random.normal`` draws from
the keys the reference splits. The cadences are set so that each branch fires and
skips within the four steps, each on its own counts: the targets' EMA every 2 steps
(counts 0, 2), the actor and temperature every 3 (0, 3), the autoencoder every 2 (0, 2).
An off-by-one in any cadence moves a branch to other counts, which the parameters, the
Adam moments and, above all, the Adam counts (critic 4, actor and temperature 2, encoder
and decoder 2) catch. Compared as in ``test_torch_sac_train.py`` (``F32``), the losses
as JAX's means over the steps (a skipped branch reports 0 in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sac_modules import ACT, B, SCREEN, agent_pair, t
from tests.test_torch_sac_train import F32, assert_opt_states_match, assert_params_match, block_against_eager, make_draws

G = 4
CADENCES = ["algo.critic.per_rank_target_network_update_freq=2", "algo.actor.per_rank_update_freq=3", "algo.decoder.per_rank_update_freq=2"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def frame_batches(seed: int, n: int = G):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.integers(0, 256, (n, B, 3, SCREEN, SCREEN), dtype=np.uint8),
        "next_obs": rng.integers(0, 256, (n, B, 3, SCREEN, SCREEN), dtype=np.uint8),
        "actions": rng.uniform(-1, 1, (n, B, ACT)).astype(np.float32),
        "rewards": rng.normal(0, 1, (n, B, 1)).astype(np.float32),
        "dones": (rng.random((n, B, 1)) < 0.3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def sac_ae_run():
    from sheeprl_tpu.algos.sac_ae.sac_ae import make_sac_ae_train_fn
    from sheeprl_tpu.analysis.ir.synth import box_act_space
    from sheeprl_tpu_torch.algos.sac.sac import SACDraws
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import cadence_of, make_sac_ae_update

    torch.set_num_threads(2)
    (jenc, jdec, jcritic, jactor), params, agent, jcfg, tcfg = agent_pair("sac_ae", extra=CADENCES)
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    aopt, copt, topt, eopt, dopt, train_fn = make_sac_ae_train_fn(jenc, jdec, jcritic, jactor, jcfg, box_act_space(ACT))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = {
        "actor": aopt.init(jp["actor"]), "critic": copt.init({"encoder": jp["encoder"], "critic": jp["critic"]}),
        "alpha": topt.init(jp["log_alpha"]), "encoder": eopt.init(jp["encoder"]), "decoder": dopt.init(jp["decoder"]),
    }
    batches, key = frame_batches(4), jax.random.PRNGKey(12)
    new_params, new_opt, jmet = jax.device_get(train_fn(jp, jopt, {k: jnp.asarray(v) for k, v in batches.items()}, key, jnp.asarray(0)))
    update, _, opt_states = make_sac_ae_update(agent, tcfg, ACT)
    cadence = cadence_of(tcfg)
    met = [
        update(opt_states, {k: t(v[g]) for k, v in batches.items()}, cadence(g), SACDraws(*draws[:2]))
        for g, draws in enumerate(make_draws(key, G, 3))
    ]
    return dict(agent=agent, before=before, new_params=new_params, new_opt=new_opt, jmet=jmet, met=met, opt_states=opt_states,
                cadences=[cadence(g) for g in range(G)])


def test_sac_ae_update_parameters_match_jax(sac_ae_run):
    agent, before = sac_ae_run["agent"], sac_ae_run["before"]
    assert [tuple(c) for c in sac_ae_run["cadences"]] == [(True, True, True), (False, False, False), (True, False, True), (False, True, False)]
    assert_params_match(agent, sac_ae_run["new_params"])
    for k, v in agent.state_dict().items():
        assert not torch.equal(v, before[k]), k


def test_sac_ae_update_optimizer_states_match_jax(sac_ae_run):
    agent = sac_ae_run["agent"]
    modules = {"actor": agent.actor, "critic": {"encoder": agent.encoder, "critic": agent.critic}, "alpha": None,
               "encoder": agent.encoder, "decoder": agent.decoder}
    counts = {"actor": 2, "critic": G, "alpha": 2, "encoder": 2, "decoder": 2}
    assert_opt_states_match(sac_ae_run["opt_states"], sac_ae_run["new_opt"], modules, counts)


def test_sac_ae_update_losses_match_jax(sac_ae_run):
    for name in ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss"):
        got = float(np.mean([m[name].item() for m in sac_ae_run["met"]]))
        np.testing.assert_allclose(got, float(sac_ae_run["jmet"][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


def test_sac_ae_update_health_matches_jax(sac_ae_run):
    from tests.test_torch_sac_train import assert_health_matches

    assert_health_matches(sac_ae_run["met"], sac_ae_run["jmet"])


def test_captured_sac_ae_cadence_steps_equal_eager_steps():
    from sheeprl_tpu_torch.algos.dreamer_loop import fill_draws, zero_draws
    from sheeprl_tpu_torch.algos.sac.sac import SACDraws
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import cadence_of, make_sac_ae_update, sac_ae_parts
    from tests.test_torch_sac_modules import spaces

    def build(ctx):
        _, _, _, _, cfg = agent_pair("sac_ae", extra=CADENCES)
        _, obs_t, _, act_t = spaces("sac_ae")
        parts = sac_ae_parts(ctx, cfg, obs_t, act_t)

        def eager(twin, states, batch, count, gen):
            update, _, _ = make_sac_ae_update(twin, cfg, ACT)
            draws = fill_draws(zero_draws(SACDraws((B, ACT), (B, ACT)), torch.device("cpu")), ("normal", "normal"), gen)
            update(states, batch, cadence_of(cfg)(count), draws)

        return parts, cfg, eager

    block_against_eager(build, n=7, start=5)
