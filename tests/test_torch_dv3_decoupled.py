"""DreamerV3's decoupled RSSM (``algo.world_model.decoupled_rssm=True``) in the PyTorch
port against the JAX package.

Both packages build the tiny agent of ``test_torch_dv3_agent.py`` with the decoupled
RSSM; the JAX parameters (perturbed with seeded noise) are carried into the port, and
the port is fed the draws JAX makes from its keys. Held:

* the modules: the representation model reads the embedding alone (its input is the
  embedding's width), the posterior of a whole ``[T, B]`` batch in one call, the
  prior-only dynamic step and the player's rollout, at ``test_torch_dv3_agent.py``'s
  tolerance (atol = rtol = 1e-4, float32);
* a whole f32 train step (discrete actor over the image and vector keys; continuous
  over the vector key), every new parameter, the Adam moments, the return moments and
  the metrics at ``test_torch_dv3_train.py``'s limits (``F32``); the unroll's draws are
  the reference's split: one posterior draw over ``[T, B]`` from ``k_repr``, a prior
  draw per step from ``k_scan``;
* the train entry: DreamerV3 trains, checkpoints and resumes with the key set; the loops
  of DreamerV1 and DreamerV2 still refuse it, naming it.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dv3_agent import ACTIONS_DIM, DISCRETE, OBS_SPACE, REC, STOCH, TOL, _jitted_init, compose_pair, obs_batch, to_torch
from tests.test_torch_dv3_train import F32, METRICS, _adam_state, _param_diffs, build_train_pair, run_pair

DECOUPLED = ["algo.world_model.decoupled_rssm=True"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module")
def pair():
    """The JAX world model and actor, and the port's, over the same perturbed parameters."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.parallel.mesh import MeshContext, build_mesh
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax
    from sheeprl_tpu_torch.parallel.context import RunContext

    jcfg, tcfg = compose_pair(DECOUPLED)
    ctx = MeshContext(mesh=build_mesh(devices=jax.devices()[:1]), precision="fp32", seed=0)
    with _jitted_init():
        jwm, jactor, _, params, _ = jax_build_agent(ctx, ACTIONS_DIM, False, jcfg, OBS_SPACE)
    rng = np.random.default_rng(100)
    params = jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0.0, 0.05, x.shape)).astype(np.float32), jax.device_get(params))
    wm, actor, critic, target, _ = build_agent(RunContext(torch.device("cpu"), 0), ACTIONS_DIM, False, tcfg, OBS_SPACE)
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target}
    for name, state in params_from_jax(params, modules).items():
        modules[name].load_state_dict(state)
    return dict(jwm=jwm, jactor=jactor, params=params, wm=wm, actor=actor)


def test_representation_reads_the_embedding_alone(pair):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import DecoupledRSSM

    wm = pair["wm"]
    assert isinstance(wm.rssm, DecoupledRSSM) and wm.decoupled_rssm
    assert wm.rssm.representation_model.dense[0].in_features == wm.encoder.output_dim
    leaf = pair["params"]["world_model"]["params"]["rssm"]["representation_model"]["layers_0"]["Dense_0"]["kernel"]
    assert leaf.shape[0] == wm.encoder.output_dim


def test_vectorized_posterior_and_prior_step_match_jax(pair):
    from sheeprl_tpu.algos.dreamer_v3.agent import WorldModel

    rng = np.random.default_rng(1)
    T, b = 3, 4
    p = pair["params"]["world_model"]
    obs = {k: v.reshape(T, b, *v.shape[1:]) for k, v in obs_batch(rng, T * b).items()}
    apply = jax.jit(pair["jwm"].apply, static_argnames=("method",))
    jembed = apply(p, obs, method=WorldModel.encode)
    jlogits, jpost = apply(p, jembed, jax.random.PRNGKey(2), method=WorldModel.representation_from_embed)
    with torch.no_grad():
        embed = pair["wm"].encode(to_torch(obs))
        tlogits, tpost = pair["wm"].representation_from_embed(embed, draw=torch.from_numpy(np.array(jpost)))
        # the player's branch: the same posterior whatever recurrent state it is handed
        plogits, _ = pair["wm"].representation(torch.randn(T, b, REC), embed, sample=False)
    close(embed, jembed)
    close(tlogits, jlogits)
    close(plogits, jlogits)
    close(tpost, jpost)

    post = np.asarray(jpost).reshape(T, b, -1)[0]
    h = rng.normal(size=(b, REC)).astype(np.float32)
    action = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    is_first = np.array([[1.0], [0.0], [0.0], [1.0]], np.float32)
    jh, jprior, jprior_logits = jax.jit(lambda *a: pair["jwm"].apply(*a, method=WorldModel.dynamic))(
        p, post, h, action, is_first, jax.random.PRNGKey(3)
    )
    with torch.no_grad():
        th, tprior, tprior_logits = pair["wm"].dynamic(
            *(torch.from_numpy(a) for a in (post, h, action, is_first)), draw=torch.from_numpy(np.array(jprior))
        )
    close(th, jh)
    close(tprior_logits, jprior_logits)
    close(tprior, jprior)


def test_player_rollout_matches_jax(pair):
    """6 player steps on 4 envs with a reset of two envs at step 3, sampled actions."""
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as JaxPlayerState
    from sheeprl_tpu.algos.dreamer_v3.agent import make_player_step as jax_make_player_step
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, make_player_step

    b, rng = 4, np.random.default_rng(5)
    jstep = jax.jit(jax_make_player_step(pair["jwm"], pair["jactor"], ACTIONS_DIM, DISCRETE))
    tstep = make_player_step(pair["wm"], pair["actor"], ACTIONS_DIM, DISCRETE)
    zeros = lambda n: np.zeros((b, n), np.float32)  # noqa: E731
    jstate = JaxPlayerState(zeros(REC), zeros(STOCH * DISCRETE), zeros(2))
    tstate = PlayerState(*(torch.from_numpy(x) for x in jstate))
    jparams = {"world_model": pair["params"]["world_model"], "actor": pair["params"]["actor"]}
    for t in range(6):
        obs = obs_batch(rng, b)
        is_first = np.full((b, 1), 1.0 if t == 0 else 0.0, np.float32)
        if t == 3:
            is_first[[1, 3]] = 1.0
        jactions, _, jstate = jstep(jparams, jstate, obs, is_first, jax.random.PRNGKey(t))
        draws = (torch.from_numpy(np.array(jstate.stochastic_state).reshape(b, STOCH, DISCRETE)), [torch.from_numpy(np.array(a)) for a in jactions])
        with torch.no_grad():
            tactions, _, tstate = tstep(tstate, to_torch(obs), torch.from_numpy(is_first), draws=draws)
        close(tstate.recurrent_state, jstate.recurrent_state)
        close(tstate.stochastic_state, jstate.stochastic_state)
        np.testing.assert_array_equal(tactions[0].numpy().argmax(-1), np.asarray(jactions[0]).argmax(-1))


@pytest.fixture(scope="module", params=["discrete", "continuous"])
def f32_run(request):
    is_continuous = request.param == "continuous"
    pair = build_train_pair(is_continuous, "32-true", cnn=not is_continuous, extra=DECOUPLED)
    assert pair["cfg"].algo.world_model.decoupled_rssm
    return pair, run_pair(pair, is_continuous)


def test_decoupled_train_step_f32_new_parameters_match_jax(f32_run):
    pair, (jout, _) = f32_run
    diffs = _param_diffs(pair, jout[0])
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= F32["params"], (worst, diffs[worst])
    # the representation model trained: its gradient comes through the priors' KL
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    old = params_from_jax(pair["params"], pair["modules"])["world_model"]
    new = pair["modules"]["world_model"].state_dict()
    assert not torch.equal(new["rssm.repr_logits.weight"], old["rssm.repr_logits.weight"])


def test_decoupled_train_step_f32_optimizer_moments_match_jax(f32_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import parameter_list_from_jax

    pair, (jout, (opt, _, _)) = f32_run
    for name in ("world_model", "actor", "critic"):
        ref = _adam_state(jout[1][name])
        assert opt[name]["count"] == int(ref.count) == 1
        for moment in ("mu", "nu"):
            want = parameter_list_from_jax(getattr(ref, moment), pair["modules"][name], name)
            for got, exp in zip(opt[name][moment], want):
                atol = F32["mom_atol_of_max"] * exp.abs().max().item()
                torch.testing.assert_close(got, exp, rtol=F32["mom_rtol"], atol=atol, msg=lambda m: f"{name}.{moment}: {m}")


def test_decoupled_train_step_f32_moments_and_metrics_match_jax(f32_run):
    _, (jout, (_, moments, metrics)) = f32_run
    for k in ("low", "high"):
        np.testing.assert_allclose(moments[k].item(), float(jout[2][k]), rtol=1e-5, atol=1e-7)
    for name in METRICS:
        np.testing.assert_allclose(metrics[name].item(), float(jout[3][name]), rtol=F32["metric_rtol"], atol=1e-7, err_msg=name)


def test_decoupled_step_is_graph_safe_on_the_cpu_path():
    """The step reads its draws from ``TrainDraws`` only: two steps from the same state,
    batch and draws give the same bits (what a captured replay relies on)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg = compose(overrides=["exp=dreamer_v3_dummy", "env=discrete_dummy", "device=cpu", "mesh.precision=32-true", *DECOUPLED])
    outs = []
    for _ in range(2):
        wm, actor, critic, target, _ = build_agent(RunContext(torch.device("cpu"), 3), ACTIONS_DIM, False, cfg, OBS_SPACE)
        step, init = make_train_step(wm, actor, critic, target, cfg, ["rgb"], ["state"])
        T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
        gen = torch.Generator().manual_seed(1)
        data = {
            "rgb": torch.randint(0, 256, (T, B, 3, 32, 32), generator=gen, dtype=torch.uint8),
            "state": torch.randn(T, B, 10, generator=gen),
            "actions": torch.nn.functional.one_hot(torch.randint(0, 2, (T, B), generator=gen), 2).float(),
            "rewards": torch.randn(T, B, 1, generator=gen),
            "terminated": torch.zeros(T, B, 1),
            "is_first": torch.zeros(T, B, 1),
        }
        moments, metrics = step(init(), step.init_extra(), data, True, draws=step.sample_draws(T, B, gen, torch.device("cpu")))
        outs.append((wm.state_dict(), metrics))
    for k, v in outs[0][0].items():
        assert torch.equal(v, outs[1][0][k]), k
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k


def test_train_entry_trains_and_resumes_with_the_decoupled_rssm(tmp_path, monkeypatch):
    from pathlib import Path

    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    args = ["exp=dreamer_v3_dummy", "device=cpu", "env.sync_env=True", "buffer.memmap=False", f"log_root={tmp_path}", "checkpoint.every=32", *DECOUPLED]
    first = run(args)
    assert first.policy_steps == 64 and first.grad_steps > 0
    state = CheckpointManager.load(first.checkpoint)
    assert "rssm.repr_logits.weight" in state["params"]["world_model"]
    mid = next(p for p in CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints() if p.name == "ckpt_32")
    resumed = run([*args, f"checkpoint.resume_from={mid}"])
    assert resumed.policy_steps == 64 and resumed.grad_steps > 0
    assert evaluate([f"checkpoint_path={resumed.checkpoint}", "device=cpu", "env.capture_video=False"]).steps > 0


@pytest.mark.parametrize("exp", ["dreamer_v1_dummy", "dreamer_v2_dummy", "p2e_dv2_dummy"])
def test_the_other_loops_refuse_the_decoupled_rssm(tmp_path, monkeypatch, exp):
    """DreamerV1's and DreamerV2's references ignore the key: their loops refuse it."""
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(NotImplementedError, match="algo.world_model.decoupled_rssm"):
        run([f"exp={exp}", "device=cpu", "env.sync_env=True", f"log_root={tmp_path}", *DECOUPLED])
