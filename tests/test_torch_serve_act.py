"""The serving act functions of the PyTorch port (``utils/policy.py``) against the JAX
package's, for each servable family at each precision tier.

Both packages build their agent for the same tiny config; the JAX package's parameters
(perturbed with seeded noise) are carried into the port with ``params_from_jax``; each
side then applies the tier as its ``load_policy`` does (``algo.precision=bf16`` before
the build at bf16, ``f32`` otherwise; ``wrap_policy_precision``) and acts greedily on the
same 64 seeded observations. The reference's act functions run eagerly here (its
``parity_stamp`` with ``jax.jit`` as the identity), so the file compiles no JAX program
beyond the agents' initialisation.

Tolerances: discrete actions equal; continuous actions within 1e-5 at f32 and int8 (the
same dequantized weights, float32 sums in another order), and at bf16 within the
reference's own bf16-to-f32 distance plus 1e-3; ``parity_stamp``'s action agreement
within 1/64 (one row of 64) of the reference's; the recurrent act function's actions
equal and its state within 1e-5 over 4 steps with a reset.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ppo_modules import obs_batch, perturbed, spaces_pair

TIERS = ("f32", "bf16", "int8")
N_OBS = 64
_KEYS = ["algo.mlp_keys.encoder=[state]", "mesh.precision=32-true"]
FAMILIES = {
    # (overrides, action kind, image shape or None)
    "ppo": (["exp=ppo_dummy", "env=discrete_dummy", "algo.cnn_keys.encoder=[rgb]", *_KEYS, "algo.dense_units=12",
             "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=10"], "multidiscrete", (3, 36, 36)),
    "ppo_continuous": (["exp=ppo_dummy", "env=continuous_dummy", "algo.cnn_keys.encoder=[]", *_KEYS, "algo.dense_units=12",
                        "algo.encoder.mlp_features_dim=10"], "continuous", None),
    "ppo_recurrent": (["exp=ppo_recurrent", "env=discrete_dummy", "algo.cnn_keys.encoder=[]", *_KEYS, "algo.dense_units=12",
                       "algo.encoder.mlp_features_dim=10", "algo.rnn.lstm.hidden_size=8", "algo.rnn.pre_rnn_mlp.apply=True"],
                      "discrete", None),
    "ppo_recurrent_attention": (["exp=ppo_recurrent", "env=discrete_dummy", "algo.cnn_keys.encoder=[]", *_KEYS, "algo.dense_units=12",
                                 "algo.encoder.mlp_features_dim=10", "algo.rnn.lstm.hidden_size=8", "algo.sequence_model=attention",
                                 "algo.attention.num_heads=2", "algo.attention.window=3"], "discrete", None),
    "sac": (["exp=sac", "env=continuous_dummy", *_KEYS, "algo.hidden_size=12"], "continuous", None),
}
_BUILT = {}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def built(family: str, algo_precision: str):
    """Both packages' policies of ``family`` built with ``algo.precision`` (f32 or bf16)
    over the same perturbed parameters, before any tier is applied; cached."""
    key = (family, algo_precision)
    if key not in _BUILT:
        from sheeprl_tpu.analysis.ir.synth import compose_tiny, tiny_ctx
        from sheeprl_tpu.utils.policy import build_policy as jax_build
        from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
        from sheeprl_tpu_torch.config.core import compose
        from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype
        from sheeprl_tpu_torch.utils.policy import build_policy

        overrides, action, image = FAMILIES[family]
        ov = [*overrides, f"algo.precision={algo_precision}"]
        jcfg, tcfg = compose_tiny(ov), compose(overrides=[*ov, "device=cpu"])
        obs_j, obs_t, act_j, act_t = spaces_pair(action, image, 6)
        jpolicy, params = jax_build(tiny_ctx(jcfg), jcfg, obs_j, act_j)
        params = perturbed(params, 21)
        jpolicy.params = params["actor"] if jpolicy.family == "sac" else params
        policy, agent = build_policy(RunContext(torch.device("cpu"), 0, compute_dtype("32-true")), tcfg, obs_t, act_t)
        agent.load_state_dict(params_from_jax({"agent": params}, {"agent": agent})["agent"])
        _BUILT[key] = (jpolicy, policy, obs_j)
    return _BUILT[key]


def tiered(family: str, tier: str):
    """``(reference policy, port policy, observation space)`` at ``tier``: fresh copies, so
    the cached builds stay float32."""
    from sheeprl_tpu.utils.policy import wrap_policy_precision as jax_wrap
    from sheeprl_tpu_torch.utils.policy import wrap_policy_precision

    jpolicy, policy, obs_space = built(family, "bf16" if tier == "bf16" else "f32")
    return jax_wrap(dataclasses.replace(jpolicy), tier), wrap_policy_precision(dataclasses.replace(policy), tier), obs_space


def act_both(jpolicy, policy, obs, is_first=None, jstate=None, state=None):
    """One greedy act of each package on the same numpy observations (and, stateful, the
    same ``is_first`` and each side's state); numpy actions (and new states)."""
    key = np.zeros((2,), np.uint32)
    with torch.no_grad():
        obs_t = policy.obs_tensors(obs)
        if is_first is None:
            return np.asarray(jpolicy.act_fn(jpolicy.params, obs, key)), policy.act_fn(policy.params, obs_t).numpy()
        jact, jnew = jpolicy.act_fn(jpolicy.params, obs, jnp.asarray(is_first), jstate, key)
        act, new = policy.act_fn(policy.params, obs_t, torch.from_numpy(is_first), state)
    return np.asarray(jact), act.numpy(), jnew, new


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("family", ["ppo", "ppo_continuous", "ppo_recurrent", "sac"])
def test_act_function_matches_the_reference(family, tier, monkeypatch):
    from sheeprl_tpu.utils import policy as jax_policy_module
    from sheeprl_tpu_torch.utils.policy import parity_stamp

    jpolicy, policy, obs_space = tiered(family, tier)
    assert policy.precision == jpolicy.precision == tier and policy.stateful == jpolicy.stateful
    obs = obs_batch(np.random.default_rng(33), obs_space, (N_OBS,))
    if policy.stateful:
        is_first = np.ones((N_OBS, 1), np.float32)
        jact, act, _, _ = act_both(jpolicy, policy, obs, is_first, jpolicy.zero_state_fn(N_OBS), policy.zero_state_fn(N_OBS))
    else:
        jact, act = act_both(jpolicy, policy, obs)
    assert act.shape == jact.shape
    if not policy.is_continuous:
        assert act.dtype == np.int32
        np.testing.assert_array_equal(act, jact)
    elif tier == "bf16":
        jref, _, _ = tiered(family, "f32")
        own = np.max(np.abs(jact - act_both(jref, tiered(family, "f32")[1], obs)[0]))
        np.testing.assert_allclose(act, jact, atol=own + 1e-3, rtol=0)
    else:
        np.testing.assert_allclose(act, jact, atol=1e-5, rtol=0)
    if tier != "f32":
        jref, ref, _ = tiered(family, "f32")
        monkeypatch.setattr(jax, "jit", lambda f: f)  # the reference's stamp, run eagerly
        want = jax_policy_module.parity_stamp(jpolicy, jref, n_obs=N_OBS, seed=3)
        got = parity_stamp(policy, ref, n_obs=N_OBS, seed=3)
        assert got["precision"] == want["precision"] and got["reference"] == want["reference"] == "f32"
        assert abs(got["action_agreement"] - want["action_agreement"]) <= 1 / N_OBS


@pytest.mark.parametrize("family", ["ppo", "ppo_recurrent", "sac"])
def test_quantize_params_quantizes_the_reference_leaves(family):
    """The same number of quantized leaves on both sides (PPO's Nature CNN convs stay
    float, so do biases and LayerNorm scales; SAC's act parameters are its actor's), and
    the dequantized parameters equal within 1e-7."""
    from sheeprl_tpu.precision.quantize import Int8Weight as JaxInt8
    from sheeprl_tpu.precision.quantize import dequantize_params as jax_dequantize
    from sheeprl_tpu.precision.quantize import quantize_params as jax_quantize
    from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax, reference_ndim
    from sheeprl_tpu_torch.precision import Int8Weight, dequantize_params, quantize_params

    jpolicy, policy, _ = built(family, "f32")
    jq = jax_quantize(jpolicy.params)
    n_jax = sum(isinstance(x, JaxInt8) for x in jax.tree.leaves(jq, is_leaf=lambda x: isinstance(x, JaxInt8)))
    kernels = {k for k, n in reference_ndim(policy.module).items() if n == 2}
    q = quantize_params(dict(policy.params), kernels)
    assert sum(isinstance(v, Int8Weight) for v in q.values()) == n_jax > 0
    if family == "ppo":
        assert any(".convs." in k for k in q) and not any(isinstance(v, Int8Weight) for k, v in q.items() if ".convs." in k)
    want = module_state_from_jax(jax.device_get(jax_dequantize(jq)), policy.module)
    got = dequantize_params(q)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-7, atol=0, err_msg=k)


@pytest.mark.parametrize("family", ["ppo_recurrent", "ppo_recurrent_attention"])
def test_recurrent_act_function_carries_its_state_like_the_reference(family):
    jpolicy, policy, obs_space = tiered(family, "f32")
    rng = np.random.default_rng(8)
    n = 16
    jstate, state = jpolicy.zero_state_fn(n), policy.zero_state_fn(n)
    for step in range(4):
        obs = obs_batch(rng, obs_space, (n,))
        is_first = np.zeros((n, 1), np.float32) if step else np.ones((n, 1), np.float32)
        if step == 2:
            is_first[::3] = 1.0  # a reset of some sessions mid-episode
        jact, act, jstate, state = act_both(jpolicy, policy, obs, is_first, jstate, state)
        np.testing.assert_array_equal(act, jact)
        np.testing.assert_allclose(state["prev"].numpy(), np.asarray(jstate["prev"]), atol=1e-5, rtol=0)
        for got, want in zip(state["rnn"], jax.tree.leaves(jstate["rnn"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert all(t.dtype == torch.float32 for t in (*state["rnn"], state["prev"]))


def test_policy_family_refuses_what_the_reference_refuses():
    from sheeprl_tpu.utils.policy import policy_family as jax_family
    from sheeprl_tpu_torch.utils.policy import policy_family

    for algo in ("ppo", "ppo_decoupled", "a2c", "sac", "sac_decoupled", "ppo_recurrent"):
        assert policy_family(algo) == jax_family(algo)
    for algo in ("dreamer_v3", "droq", "sac_ae", "p2e_dv3_finetuning"):
        with pytest.raises(ValueError) as want:
            jax_family(algo)
        with pytest.raises(ValueError) as got:
            policy_family(algo)
        assert str(got.value) == str(want.value)
