"""Carrying the JAX package's DreamerV3 parameters into the PyTorch port, and the port's
own initialisation.

* ``params_from_jax`` maps every leaf of the reference tree exactly once, converts the
  layouts, and refuses a tree with a missing, an extra or a misshapen leaf.
* ``build_agent`` initialises as the reference does: Flax's truncated lecun-normal
  kernels (std ``sqrt(1/fan_in)``), Hafner's uniform heads (std
  ``sqrt(1 / ((shape[0] + shape[-1]) / 2))`` of the Flax kernel shape), zero biases,
  unit LayerNorm scales, and zeroed reward and critic heads. The std of every kernel
  with at least 2048 entries must be within 5% of its expected value (the sampling
  error at that size is about 1.6%).
"""

import copy
import math

import numpy as np
import pytest
import torch
from torch import nn

from tests.test_torch_dv3_agent import ACTIONS_DIM, OBS_SPACE, build_pair


@pytest.fixture(scope="module")
def carried():
    return build_pair(perturb=0.05)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _modules(p):
    return {"world_model": p.wm, "actor": p.actor, "critic": p.critic, "target_critic": copy.deepcopy(p.critic)}


def test_every_leaf_maps_exactly_once(carried):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    modules = _modules(carried)
    states = params_from_jax(carried.params, modules)
    for name, module in modules.items():
        leaves = _leaves(carried.params[name]["params"])
        assert len(leaves) == len(states[name]) == len(module.state_dict()), name
        assert sum(v.size for v in leaves.values()) == sum(t.numel() for t in states[name].values()), name
    wm_leaves = _leaves(carried.params["world_model"]["params"])
    wm = states["world_model"]
    np.testing.assert_array_equal(
        wm["rssm.recurrent_model.rnn.linear.weight"].numpy(), wm_leaves["rssm/recurrent_model/rnn/Dense_0/kernel"].T
    )
    np.testing.assert_array_equal(
        wm["encoder.cnn_encoder.convs.0.weight"].numpy(),
        wm_leaves["encoder/cnn_encoder/Conv_0/kernel"].transpose(3, 2, 0, 1),
    )
    np.testing.assert_array_equal(
        wm["observation_model_cnn.head.weight"].numpy(),
        wm_leaves["observation_model_cnn/head/kernel"][::-1, ::-1].transpose(2, 3, 0, 1),
    )
    np.testing.assert_array_equal(
        wm["observation_model_mlp.heads.state.bias"].numpy(), wm_leaves["observation_model_mlp/head_state/bias"]
    )


def _edit(params, how):
    params = copy.deepcopy(params)
    rssm = params["world_model"]["params"]["rssm"]
    if how == "missing":
        del rssm["trans_logits"]["bias"]
    elif how == "extra":
        rssm["trans_logits"]["extra"] = np.zeros(3, np.float32)
    elif how == "shape":
        rssm["trans_logits"]["bias"] = np.zeros(3, np.float32)
    else:  # a whole module's tree missing
        del params["target_critic"]
    return params


@pytest.mark.parametrize("how,error", [("missing", KeyError), ("extra", KeyError), ("shape", ValueError), ("module", KeyError)])
def test_rejects_a_tree_that_does_not_fit(carried, how, error):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    with pytest.raises(error):
        params_from_jax(_edit(carried.params, how), _modules(carried))


def _expected_std(name, module):
    """Expected std of a layer's weight under the reference's initialisation."""
    w = module.weight
    if isinstance(module, nn.Linear):
        fan_in, first, last = w.shape[1], w.shape[1], w.shape[0]
    elif isinstance(module, nn.ConvTranspose2d):
        fan_in, first, last = w.shape[0] * w.shape[2] * w.shape[3], w.shape[2], w.shape[1]
    else:
        fan_in, first, last = w.shape[1] * w.shape[2] * w.shape[3], None, None
    parts = name.split(".")
    hafner = parts[-1] in {"repr_logits", "trans_logits", "continue_head", "head"} or (len(parts) > 1 and parts[-2] == "heads")
    return math.sqrt(1.0 / ((first + last) / 2.0)) if hafner else math.sqrt(1.0 / fan_in)


def test_build_agent_initialises_like_the_reference():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.models.blocks import LayerNorm
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg = compose(
        overrides=[
            "exp=dreamer_v3_dummy",
            "algo=dreamer_v3_XS",
            "env=discrete_dummy",
            "env.screen_size=64",
            "device=cpu",
            "algo.dense_units=64",
            "algo.world_model.encoder.cnn_channels_multiplier=16",
            "algo.world_model.recurrent_model.recurrent_state_size=64",
            "algo.world_model.transition_model.hidden_size=64",
            "algo.world_model.representation_model.hidden_size=64",
        ]
    )
    wm, actor, critic, target_critic, _ = build_agent(RunContext(torch.device("cpu"), seed=3), ACTIONS_DIM, False, cfg, OBS_SPACE)
    checked = 0
    for root, tree in (("wm", wm), ("actor", actor), ("critic", critic)):
        for name, m in tree.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                if m.bias is not None:
                    assert torch.count_nonzero(m.bias) == 0, f"{root}.{name}.bias"
                if name in ("reward_head", "head") and root in ("wm", "critic"):
                    assert torch.count_nonzero(m.weight) == 0, f"{root}.{name} must be zeroed"
                    continue
                if m.weight.numel() >= 2048:
                    expected = _expected_std(name, m)
                    assert abs(m.weight.std().item() / expected - 1) < 0.05, f"{root}.{name}"
                    checked += 1
            elif isinstance(m, LayerNorm):
                assert torch.all(m.weight == 1) and torch.all(m.bias == 0)
    assert checked >= 10
    rnn = wm.rssm.recurrent_model.rnn
    assert torch.all(rnn.ln_scale == 1) and torch.all(rnn.ln_bias == 0)
    for k, v in critic.state_dict().items():
        assert torch.equal(v, target_critic.state_dict()[k]), k
    # the same seed gives the same weights
    again = build_agent(RunContext(torch.device("cpu"), seed=3), ACTIONS_DIM, False, cfg, OBS_SPACE)[0]
    for k, v in wm.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


# ---------------------------------------------------------------------------------------
# The trees of this slice: the decoupled RSSM, the MineDojo heads, P2E-DV3's
# ---------------------------------------------------------------------------------------


def _count_leaves(tree) -> int:
    return sum(_count_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


def test_carries_the_decoupled_world_model():
    """The decoupled representation model reads the embedding alone: its first kernel is
    ``[embed, hidden]``, carried to ``representation_model.dense.0.weight``."""
    import jax

    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext
    from tests.test_torch_dv1_agent import jax_ctx
    from tests.test_torch_dv3_agent import _jitted_init, compose_pair

    jcfg, tcfg = compose_pair(["algo.world_model.decoupled_rssm=True"])
    with _jitted_init():
        params = jax.device_get(jax_build_agent(jax_ctx(), ACTIONS_DIM, False, jcfg, OBS_SPACE)[3])
    wm = build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, tcfg, OBS_SPACE)[0]
    state = params_from_jax({"world_model": params["world_model"]}, {"world_model": wm})["world_model"]
    assert len(state) == _count_leaves(params["world_model"]) == len(wm.state_dict())
    kernel = params["world_model"]["params"]["rssm"]["representation_model"]["layers_0"]["Dense_0"]["kernel"]
    assert kernel.shape[0] == wm.encoder.output_dim
    np.testing.assert_array_equal(state["rssm.representation_model.dense.0.weight"].numpy(), np.asarray(kernel).T)


def test_carries_the_minedojo_heads():
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v3.agent import MinedojoActor as JaxActor
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    heads = (19, 6, 10)
    params = jax.device_get(JaxActor(actions_dim=heads, dense_units=8, mlp_layers=1).init(jax.random.PRNGKey(0), jnp.zeros((1, 16)), None))
    actor = MinedojoActor(16, heads, False, dense_units=8, mlp_layers=1)
    state = params_from_jax({"actor": params}, {"actor": actor})["actor"]
    assert len(state) == _count_leaves(params) == len(actor.state_dict())
    for i, d in enumerate(heads):
        np.testing.assert_array_equal(state[f"heads.{i}.weight"].numpy(), np.asarray(params["params"][f"head_{i}"]["kernel"]).T)
        assert state[f"heads.{i}.bias"].shape == (d,)


@pytest.fixture(scope="module")
def p2e_dv3_trees():
    import jax

    from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext
    from tests.test_torch_dv1_agent import jax_ctx
    from tests.test_torch_dv3_agent import _jitted_init

    overrides = ["exp=p2e_dv3_dummy", "env=discrete_dummy", "env.screen_size=64"]
    with _jitted_init():
        params = jax.device_get(jax_build_agent(jax_ctx(), ACTIONS_DIM, False, jax_compose(overrides=overrides), OBS_SPACE)[4])
    modules = build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, compose(overrides=[*overrides, "device=cpu"]), OBS_SPACE)[0]
    return params, modules


def test_carries_the_p2e_dv3_tree(p2e_dv3_trees):
    """Every tree of P2E-DV3's: the exploration critics as ``{name: {"module",
    "target"}}`` in the config's order, the stacked ensembles as they stand."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    params, modules = p2e_dv3_trees
    states = params_from_jax(params, modules)
    assert list(states) == list(modules) == ["world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
                                             "critics_exploration", "ensembles"]
    for name, module in modules.items():
        assert len(states[name]) == _count_leaves(params[name]) == len(module.state_dict()), name
        module.load_state_dict(states[name])
    critics = params["critics_exploration"]
    # the port keeps the config's order; JAX's tree flattening sorts the keys
    assert list(modules["critics_exploration"]) == ["intrinsic", "extrinsic"] and set(critics) == {"intrinsic", "extrinsic"}
    for k in critics:
        for part in ("module", "target"):
            np.testing.assert_array_equal(
                states["critics_exploration"][f"{k}.{part}.head.weight"].numpy(), np.asarray(critics[k][part]["params"]["head"]["kernel"]).T
            )
    kernel = np.asarray(params["ensembles"]["params"]["Dense_0"]["kernel"])
    assert kernel.ndim == 3 and kernel.shape[0] == 3
    np.testing.assert_array_equal(states["ensembles"]["dense.0.weight"].numpy(), kernel)
    assert "norms.0.weight" in states["ensembles"]


@pytest.mark.parametrize("how", ["critic", "part"])
def test_rejects_a_p2e_dv3_tree_without_a_critic(p2e_dv3_trees, how):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    params, modules = p2e_dv3_trees
    params = copy.deepcopy(params)
    if how == "critic":
        del params["critics_exploration"]["extrinsic"]
    else:
        del params["critics_exploration"]["intrinsic"]["target"]
    with pytest.raises(KeyError):
        params_from_jax(params, modules)
