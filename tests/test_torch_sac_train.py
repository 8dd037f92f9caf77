"""Whole SAC updates of the PyTorch port against the JAX package's ``make_sac_train_fn``,
and the port's captured block against its eager steps.

Both packages build the tiny agent of ``test_torch_sac_modules.py`` (its JAX parameters
perturbed with seeded noise, the target critic off the critic, carried into the port),
and run ``G = 3`` gradient steps at ``target_network_frequency=2`` on the same numpy
batches, the port handed the normals ``jax.random.normal`` draws from the keys the
reference splits (``make_draws``). Compared afterwards: every parameter (the target
critic, updated at the second step only, and ``log_alpha`` included), each optimizer's
Adam moments and count, and the losses (JAX's mean over the steps). Tolerances, float32
(``F32``): parameters atol 1e-6, moments 1e-3 of their leaf's largest entry, losses rtol
1e-4; counts equal.

The captured block (``utils/blocks.py``, over the device transition ring's indices and
over host batches) is held, bit for bit on the CPU, to the same update called step by
step with the same batches, flags and draws.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sac_modules import ACT, B, OBS, agent_pair, t

F32 = dict(params=1e-6, mom_rtol=1e-3, metric_rtol=1e-4)
G, FREQ = 3, 2
SAC_EXTRA = [f"algo.critic.target_network_frequency={FREQ}"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def make_batches(seed: int, n: int = G, obs_dim: int = OBS):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(0, 2, (n, B, obs_dim)).astype(np.float32),
        "next_obs": rng.normal(0, 2, (n, B, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (n, B, ACT)).astype(np.float32),
        "rewards": rng.normal(0, 1, (n, B, 1)).astype(np.float32),
        "dones": (rng.random((n, B, 1)) < 0.3).astype(np.float32),
    }


def make_draws(key, n: int = G, parts: int = 2):
    """Per step, the ``[B, ACT]`` normals the reference draws from each of the ``parts``
    keys it splits the step's key into (the scanned update splits ``key`` into ``n``)."""
    return [[t(jax.random.normal(k, (B, ACT))) for k in jax.random.split(kg, parts)] for kg in jax.random.split(key, n)]


def adam_state(state):
    from tests.test_torch_dv3_train import _adam_state

    return _adam_state(state)


def assert_opt_states_match(opt_states, jax_opt, modules, counts):
    """Each optimizer's Adam ``mu``/``nu`` within ``mom_rtol`` of its leaf's largest entry
    (``modules[name]``: the module whose parameter tree the moments follow, or a list of
    them, or None for the 0-d ``log_alpha``) and its count."""
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax

    for name, mods in modules.items():
        ref = adam_state(jax_opt[name])
        assert int(opt_states[name]["count"]) == int(ref.count) == counts[name], name
        for moment in ("mu", "nu"):
            tree = getattr(ref, moment)
            if mods is None:
                want = [t(np.asarray(tree))]
            elif isinstance(mods, dict):  # SAC-AE's critic optimizer: encoder, then critic
                want = [w for k, m in mods.items() for w in parameter_list_from_jax(jax.device_get(tree[k]), m, k)]
            else:
                want = parameter_list_from_jax(jax.device_get(tree), mods, name)
            assert len(want) == len(opt_states[name][moment])
            for got, ref_leaf in zip(opt_states[name][moment], want):
                atol = F32["mom_rtol"] * float(ref_leaf.abs().max()) + 1e-12
                np.testing.assert_allclose(got.numpy(), ref_leaf.numpy(), atol=atol, rtol=0, err_msg=f"{name}.{moment}")


def assert_params_match(agent, new_params):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    want = params_from_jax({"agent": jax.device_get(new_params)}, {"agent": agent})["agent"]
    diffs = {k: (v - want[k]).abs().max().item() for k, v in agent.state_dict().items()}
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= F32["params"], (worst, diffs[worst])


@pytest.fixture(scope="module")
def sac_run():
    """G steps of each package from the same parameters, batches and draws."""
    from sheeprl_tpu.algos.sac.sac import make_sac_train_fn
    from sheeprl_tpu.analysis.ir.synth import box_act_space
    from sheeprl_tpu_torch.algos.sac.sac import SACDraws, make_sac_update
    from sheeprl_tpu_torch.utils.blocks import target_flags

    torch.set_num_threads(2)
    (jactor, jcritic), params, agent, jcfg, tcfg = agent_pair("sac", extra=SAC_EXTRA)
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    aopt, copt, topt, train_fn = make_sac_train_fn(jactor, jcritic, jcfg, box_act_space(ACT))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = {"actor": aopt.init(jp["actor"]), "critic": copt.init(jp["critic"]), "alpha": topt.init(jp["log_alpha"])}
    batches, key = make_batches(1), jax.random.PRNGKey(7)
    new_params, new_opt, jmet = jax.device_get(train_fn(jp, jopt, {k: jnp.asarray(v) for k, v in batches.items()}, key, jnp.asarray(0)))
    update, _, opt_states = make_sac_update(agent, tcfg, ACT)
    flags = target_flags(0, G, FREQ, 1)
    met = [
        update(opt_states, {k: t(v[g]) for k, v in batches.items()}, bool(flags[g]), SACDraws(*draws))
        for g, draws in enumerate(make_draws(key))
    ]
    return dict(agent=agent, before=before, new_params=new_params, new_opt=new_opt, jmet=jmet, met=met, opt_states=opt_states, flags=flags)


def test_sac_update_parameters_match_jax(sac_run):
    agent, before = sac_run["agent"], sac_run["before"]
    assert_params_match(agent, sac_run["new_params"])
    assert list(sac_run["flags"]) == [False, True, False]  # (count + 1) % 2 == 0
    for k, v in agent.state_dict().items():
        assert not torch.equal(v, before[k]), k  # every tree moved, the target at its one update


def test_sac_update_optimizer_states_match_jax(sac_run):
    agent = sac_run["agent"]
    modules = {"actor": agent.actor, "critic": agent.critic, "alpha": None}
    assert_opt_states_match(sac_run["opt_states"], sac_run["new_opt"], modules, {"actor": G, "critic": G, "alpha": G})


def test_sac_update_losses_match_jax(sac_run):
    for name in ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss"):
        got = float(np.mean([m[name].item() for m in sac_run["met"]]))
        np.testing.assert_allclose(got, float(sac_run["jmet"][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


# --------------------------------------------------------------------------- the captured block


def recording_ctx():
    """A CPU run context that keeps every generator it hands out (``ctx.generators``)."""
    from sheeprl_tpu_torch.parallel.context import RunContext

    ctx = RunContext(torch.device("cpu"), 0)
    ctx.generators, rng = [], ctx.rng

    def recorded(*args, **kwargs):
        ctx.generators.append(rng(*args, **kwargs))
        return ctx.generators[-1]

    ctx.rng = recorded
    return ctx


def block_against_eager(build, tail_steps: int = 0, n: int = 5, start: int = 3):
    """Run ``n`` gradient steps through ``make_transition_replay`` (device ring, then host
    batches) and the same steps eagerly on a copy of the agent; every parameter and
    optimizer tensor equal bit for bit. ``build(ctx) -> (parts, cfg, eager)`` makes the
    algorithm's ``SACParts`` from ``ctx`` (whose last generator draws the steps' draws);
    ``eager(agent, opt_states, batch, count, generator)`` runs one step (``count`` None:
    the tail's step) with its draws taken from ``generator`` as the block takes them."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import make_transition_replay
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    for device_replay in (True, False):
        ctx = recording_ctx()
        parts, cfg, eager = build(ctx)
        draws_seed = ctx.generators[-1].initial_seed()
        agent, opt_states = parts.agent, parts.opt_states
        twin, twin_states = copy.deepcopy(agent), copy.deepcopy(opt_states)
        cfg.buffer.device = device_replay
        rb = ReplayBuffer(8, 2, obs_keys=("obs",))
        specs = {"obs": parts.obs_spec, "next_obs": parts.obs_spec, "actions": ((ACT,), np.float32),
                 "rewards": ((1,), np.float32), "dones": ((1,), np.float32)}
        ring, prefetcher, run_block, rb_add = make_transition_replay(ctx, cfg, rb, specs, parts.make_step, parts.target_update_freq, parts.count_offset, parts.tail)
        assert (ring is not None) == device_replay
        rng = np.random.default_rng(11)
        for _ in range(8):
            rb_add({k: (rng.integers(0, 256, (1, 2, *s)) if d == np.uint8 else rng.normal(0, 1, (1, 2, *s))).astype(d) for k, (s, d) in specs.items()})
        rb.seed(3)
        tail = run_block(n, start, stage_next=False)
        if parts.run_tail is not None:
            parts.run_tail(tail)
        if prefetcher is not None:
            prefetcher.close()
        # the same steps eagerly: the same index draws from the same seed, the same draws' stream
        rb.seed(3)
        envs, rows = rb.sample_idx(cfg.algo.per_rank_batch_size, n + tail_steps)
        gen = torch.Generator().manual_seed(draws_seed)
        for g in range(n + tail_steps):
            batch = {k: t(rb._buf[k][rows[g], envs[g]]) for k in specs}
            eager(twin, twin_states, batch, start + g if g < n else None, gen)
        for (k, v), w in zip(agent.state_dict().items(), twin.state_dict().values()):
            assert torch.equal(v, w), (device_replay, k)
        for a, b in zip(tree_tensors(opt_states), tree_tensors(twin_states)):
            assert torch.equal(a, b), device_replay


def test_captured_sac_block_equals_eager_steps():
    from sheeprl_tpu_torch.algos.dreamer_loop import fill_draws, zero_draws
    from sheeprl_tpu_torch.algos.sac.sac import SACDraws, make_sac_update, sac_parts
    from sheeprl_tpu_torch.utils.blocks import target_flags
    from tests.test_torch_sac_modules import spaces

    def build(ctx):
        _, _, _, _, cfg = agent_pair("sac", extra=SAC_EXTRA)
        _, obs_t, _, act_t = spaces("sac")
        parts = sac_parts(ctx, cfg, obs_t, act_t)

        def eager(twin, states, batch, count, gen):
            update, _, _ = make_sac_update(twin, cfg, ACT)
            draws = fill_draws(zero_draws(SACDraws((B, ACT), (B, ACT)), torch.device("cpu")), ("normal", "normal"), gen)
            update(states, batch, bool(target_flags(count, 1, FREQ, 1)[0]), draws)

        return parts, cfg, eager

    block_against_eager(build)
