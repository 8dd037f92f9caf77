"""The MineDojo actors of the PyTorch port (DreamerV3's ``MinedojoActor``, and
``MinedojoActorV2`` of DreamerV2 and DreamerV1) against the JAX package's.

Each actor is built as ``tests/test_models/test_minedojo_actor.py`` builds the
reference's (heads 19, 6 and 10; dense 8 x 1 onto a 16-wide state); the JAX parameters,
perturbed with seeded noise, are carried into the port, and the port is handed the
Gumbel noise JAX draws from each key, head by head (``split(key, 3)``). For every mask
case of that file (and no mask, and greedy), over several keys: the sampled one-hots
are the reference's, and each head's logits (after unimix and masking) are within atol
= rtol = 1e-4 (float32). Masked entries sit at float32's lowest value, as the
reference's. Then the agents' builds choose the masked actor on a MineDojo wrapper, and
the DreamerV3 player forwards the observation's masks to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import OBS_SPACE

HEADS = (19, 6, 10)
TOL = dict(atol=1e-4, rtol=1e-4)


def _mask(action_type=None, craft=None, equip=None, destroy=None, rows=4):
    """The four masks, all True but for the given allowed indices of each."""
    def one(n, allowed):
        m = np.ones((rows, n), bool) if allowed is None else np.zeros((rows, n), bool)
        if allowed is not None:
            m[:, allowed] = True
        return m

    return {
        "mask_action_type": one(19, action_type),
        "mask_craft_smelt": one(6, craft),
        "mask_equip_place": one(10, equip),
        "mask_destroy": one(10, destroy),
    }


# the mask cases of tests/test_models/test_minedojo_actor.py: (mask, what every sample must obey)
CASES = {
    "none": (None, lambda a: True),
    "action_type": (_mask(action_type=[3, 15]), lambda a: np.isin(a[0], [3, 15]).all()),
    "craft_when_crafting": (_mask(action_type=[15], craft=[2]), lambda a: (a[1] == 2).all()),
    "craft_free_otherwise": (_mask(action_type=[1], craft=[2]), lambda a: (a[0] == 1).all()),
    "destroy": (_mask(action_type=[18], equip=[1], destroy=[7]), lambda a: (a[2] == 7).all()),
    "equip": (_mask(action_type=[16, 17], equip=[4], destroy=[7]), lambda a: (a[2] == 4).all()),
    "v2_craft": (_mask(action_type=[15], craft=[3]), lambda a: (a[0] == 15).all() and (a[1] == 3).all()),
}


def build(version: int, seed: int = 0):
    """The reference's actor and the port's, over the same perturbed parameters."""
    from sheeprl_tpu.algos.dreamer_v2.agent import MinedojoActorV2 as JaxV2
    from sheeprl_tpu.algos.dreamer_v3.agent import MinedojoActor as JaxV3
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import MinedojoActorV2
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    if version == 3:
        jactor = JaxV3(actions_dim=HEADS, is_continuous=False, dense_units=8, mlp_layers=1)
        actor = MinedojoActor(16, HEADS, False, dense_units=8, mlp_layers=1)
    else:
        jactor = JaxV2(actions_dim=HEADS, dense_units=8, mlp_layers=1)
        actor = MinedojoActorV2(16, HEADS, False, dense_units=8, mlp_layers=1)
    params = jax.device_get(jactor.init(jax.random.PRNGKey(seed), jnp.zeros((4, 16)), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0.0, 0.3, x.shape)).astype(np.float32), params)
    actor.load_state_dict(params_from_jax({"actor": params}, {"actor": actor})["actor"])
    return jactor, params, actor


def head_gumbels(key, rows: int = 4):
    """The Gumbel noise the reference's actor draws from ``key``, one per head."""
    keys = jax.random.split(key, len(HEADS))
    return tuple(torch.from_numpy(np.array(jax.random.gumbel(k, (rows, d)))) for k, d in zip(keys, HEADS))


@pytest.mark.parametrize("version,case", [(v, c) for v in (3, 2) for c in sorted(CASES)])
def test_masked_sampling_matches_jax(version, case):
    jactor, params, actor = build(version)
    mask, obeys = CASES[case]
    state = np.random.default_rng(7).normal(size=(4, 16)).astype(np.float32)
    japply = lambda p, x, k, m: jactor.apply(p, x, k, False, m)  # noqa: E731
    tmask = None if mask is None else {k: torch.from_numpy(v) for k, v in mask.items()}
    seen_craft = set()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        jactions, jdists = japply(params, state, key, None if mask is None else {k: jnp.asarray(v) for k, v in mask.items()})
        with torch.no_grad():
            tactions, tdists = actor(torch.from_numpy(state), mask=tmask, gumbels=head_gumbels(key))
        got = [a.numpy().argmax(-1) for a in tactions]
        for i in range(len(HEADS)):
            np.testing.assert_array_equal(got[i], np.asarray(jactions[i]).argmax(-1), err_msg=f"head {i}, seed {seed}")
            np.testing.assert_allclose(tdists[i].logits.numpy(), np.asarray(jdists[i].logits), **TOL)
        assert obeys(got), (case, got)
        seen_craft.update(got[1].tolist())
    if case == "craft_free_otherwise":
        assert len(seen_craft) > 1, "the craft head must be free for a non-craft action"
    if mask is not None:
        lowest = torch.finfo(torch.float32).min
        assert (tdists[0].logits[~tmask["mask_action_type"]] <= lowest / 2).all()


@pytest.mark.parametrize("version", [3, 2])
def test_greedy_actions_match_jax(version):
    jactor, params, actor = build(version, seed=1)
    mask = _mask(action_type=[15, 16], craft=[0, 5], equip=[2])
    state = np.random.default_rng(8).normal(size=(4, 16)).astype(np.float32)
    jactions, _ = jactor.apply(params, state, None, True, {k: jnp.asarray(v) for k, v in mask.items()})
    with torch.no_grad():
        tactions, _ = actor(torch.from_numpy(state), greedy=True, mask={k: torch.from_numpy(v) for k, v in mask.items()})
    for t, j in zip(tactions, jactions):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_continuous_action_space_is_refused():
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import MinedojoActorV2
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor

    for cls in (MinedojoActor, MinedojoActorV2):
        with pytest.raises(ValueError, match="MultiDiscrete"):
            cls(16, (3,), True)


@pytest.mark.parametrize("exp,cls", [("dreamer_v3_dummy", "MinedojoActor"), ("dreamer_v2_dummy", "MinedojoActorV2"), ("dreamer_v1_dummy", "MinedojoActorV2")])
def test_builds_choose_the_masked_actor_on_minedojo(exp, cls):
    import importlib

    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg = compose(overrides=[f"exp={exp}", "device=cpu", "env.wrapper._target_=sheeprl.envs.minedojo.MineDojoWrapper"])
    agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{exp[:-6]}.agent")
    actor = agent.build_agent(RunContext(torch.device("cpu"), 0), HEADS, False, cfg, OBS_SPACE)[1]
    assert type(actor).__name__ == cls and tuple(actor.actions_dim) == HEADS
    plain = compose(overrides=[f"exp={exp}", "device=cpu"])
    assert type(agent.build_agent(RunContext(torch.device("cpu"), 0), HEADS, False, plain, OBS_SPACE)[1]).__name__ != cls


def test_dv3_player_forwards_the_masks():
    """The DreamerV3 player hands the observation's ``mask*`` entries to the actor: every
    sampled action type is an allowed one, and the craft argument obeys its mask."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, build_agent, make_player_step
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg = compose(overrides=["exp=dreamer_v3_dummy", "device=cpu", "env.screen_size=64", "env.wrapper._target_=sheeprl.envs.minedojo.MineDojoWrapper"])
    wm, actor, *_ = build_agent(RunContext(torch.device("cpu"), 0), HEADS, False, cfg, OBS_SPACE)
    wm_cfg = cfg.algo.world_model
    step = make_player_step(wm, actor, HEADS, wm_cfg.discrete_size)
    n = 8
    state = PlayerState(torch.zeros(n, wm_cfg.recurrent_model.recurrent_state_size), torch.zeros(n, wm_cfg.stochastic_size * wm_cfg.discrete_size), torch.zeros(n, sum(HEADS)))
    gen = torch.Generator().manual_seed(0)
    masks = {k: torch.from_numpy(v) for k, v in _mask(action_type=[15], craft=[4], rows=n).items()}
    for t in range(3):
        obs = {"rgb": torch.randint(0, 256, (n, 3, 64, 64), generator=gen, dtype=torch.uint8), "state": torch.randn(n, 10, generator=gen), **masks}
        with torch.no_grad():
            actions, stored, state = step(state, obs, torch.full((n, 1), float(t == 0)), gen)
        assert (actions[0].argmax(-1) == 15).all() and (actions[1].argmax(-1) == 4).all()
        assert stored.shape == (n, sum(HEADS))
