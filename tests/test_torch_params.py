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
