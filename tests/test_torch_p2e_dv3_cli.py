"""Plan2Explore on DreamerV3 through the PyTorch port's train and eval entries on the CPU,
at the ``p2e_dv3_dummy`` exp's tiny size.

Explore (train, checkpoint with the replay buffer, evaluate with the exploration actor);
resume from a checkpoint, which restores every module, every optimizer state (one per
exploration critic among them), every target critic and every return moment: the
resumed run's checkpoint before it trains again equals the one it resumed from. Then
finetune from the exploration checkpoint once without and once with
``buffer.load_from_exploration``, and evaluate each finetuned checkpoint (the task
actor): the finetuning run trains the task slice and carries the task moments on,
keeps the untrained trees, their optimizer states and the exploration critics' moments
as it loaded them, and switches its player to the task actor at its first training
iteration. The finetuning config merge is held to the reference's (it takes the
exploration run's world model, ``decoupled_rssm`` with it); both packages refuse
``algo.world_model.decoupled_rssm`` for the exploration step, which in the reference
cannot unroll the decoupled RSSM; the entries ask for CUDA without ``device=cpu``.
"""

from pathlib import Path

import pytest
import torch

UNTRAINED = ("actor_exploration", "critics_exploration", "ensembles")
TASK = ("world_model", "actor_task", "critic_task")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def explore_args(tmp_path) -> list:
    return ["exp=p2e_dv3_dummy", "device=cpu", "env.sync_env=True", "buffer.memmap=False", f"log_root={tmp_path / 'logs'}"]


def finetune_args(tmp_path, ckpt, load: bool) -> list:
    return [
        *explore_args(tmp_path),
        "algo.name=p2e_dv3_finetuning",
        f"checkpoint.exploration_ckpt_path={ckpt}",
        f"buffer.load_from_exploration={load}",
        "algo.learning_starts=32",
        "checkpoint.every=16",
    ]


def equal_tree(a, b) -> bool:
    """Two checkpointed trees of tensors (and ints), equal leaf by leaf."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(equal_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, torch.as_tensor(b))
    return int(a) == int(b)


def test_explore_resume_finetune_evaluate(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    explored = run([*explore_args(tmp_path), "checkpoint.every=8"])
    assert explored.policy_steps == 64 and explored.grad_steps > 0 and explored.test_reward == 0.0
    expl = CheckpointManager.load(explored.checkpoint)
    assert "actor_type" not in expl and "rb" in expl
    assert list(expl["opt_states"]["critics_exploration"]) == ["intrinsic", "extrinsic"]
    assert set(expl["moments"]) == {"task", "expl"} and list(expl["moments"]["expl"]) == ["intrinsic", "extrinsic"]
    assert {k.split(".")[1] for k in expl["params"]["critics_exploration"]} == {"module", "target"}
    assert evaluate([f"checkpoint_path={explored.checkpoint}", "device=cpu", "env.capture_video=False"]).reward == 0.0

    # resumed from ckpt_32 (iteration 16) it trains again at iteration 25 (policy step 50):
    # its ckpt_48 holds what it loaded
    ckpts = {p.name: p for p in CheckpointManager(Path(explored.log_dir) / "checkpoints").list_checkpoints()}
    resumed = run([*explore_args(tmp_path), f"checkpoint.resume_from={ckpts['ckpt_32']}"])
    assert resumed.grad_steps > 0
    again = CheckpointManager.load(Path(resumed.log_dir) / "checkpoints" / "ckpt_48")
    loaded = CheckpointManager.load(ckpts["ckpt_32"])
    for key in ("params", "opt_states", "moments"):
        assert equal_tree(again[key], loaded[key]), key
    last = CheckpointManager.load(resumed.checkpoint)
    assert not equal_tree(last["moments"], loaded["moments"]) and not equal_tree(last["params"]["critics_exploration"], loaded["params"]["critics_exploration"])

    for load in (False, True):
        tuned = run(finetune_args(tmp_path, explored.checkpoint, load))
        assert tuned.policy_steps == 64 and tuned.grad_steps > 0 and tuned.test_reward == 0.0
        names = [CheckpointManager.load(p)["actor_type"] for p in CheckpointManager(Path(tuned.log_dir) / "checkpoints").list_checkpoints()]
        assert names == ["exploration", "task", "task", "task"]  # the first training iteration is 16 (policy step 32)
        state = CheckpointManager.load(tuned.checkpoint)
        assert set(state["params"]) == set(expl["params"]) and set(state["opt_states"]) == set(expl["opt_states"])
        for name in UNTRAINED:
            assert equal_tree(state["params"][name], expl["params"][name]), name
            assert equal_tree(state["opt_states"][name], expl["opt_states"][name]), name
        for name in TASK:
            assert not equal_tree(state["params"][name], expl["params"][name]), name
            assert int(state["opt_states"][name]["count"]) == int(expl["opt_states"][name]["count"]) + state["cumulative_grad_steps"]
        assert equal_tree(state["moments"]["expl"], expl["moments"]["expl"])
        assert not equal_tree(state["moments"]["task"], expl["moments"]["task"])
        result = evaluate([f"checkpoint_path={tuned.checkpoint}", "device=cpu", "env.capture_video=False"])
        assert result.reward == 0.0 and result.steps > 0


def test_both_packages_refuse_the_decoupled_rssm(tmp_path, monkeypatch):
    """The reference's exploration step calls the world model's ``dynamic`` with the
    coupled RSSM's arguments, which the decoupled RSSM does not take: it fails while the
    step is traced. The port refuses the key before it builds the step, naming it."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.algos.p2e_dv3 import agent as jax_agent
    from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration import make_train_step as jax_make_train_step
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import critic_configs
    from sheeprl_tpu_torch.cli import run
    from tests.test_torch_dv1_agent import jax_ctx
    from tests.test_torch_dv3_agent import OBS_SPACE, _jitted_init
    from tests.test_torch_dv3_train import make_batch

    overrides = ["exp=p2e_dv3_dummy", "env=discrete_dummy", "env.screen_size=64", "algo.per_rank_sequence_length=4", "algo.world_model.decoupled_rssm=True"]
    jcfg = jax_compose(overrides=overrides)
    with _jitted_init():
        jwm, jactor, jcritic, jens, params, _ = jax_agent.build_agent(jax_ctx(), (2,), False, jcfg, OBS_SPACE)
    jstep, jinit, jinit_moments = jax_make_train_step(jwm, jactor, jcritic, jens, jcfg, ["rgb"], ["state"], critic_configs(jcfg))
    batch = {k: jnp.asarray(v) for k, v in make_batch(0, False).items()}
    with pytest.raises(TypeError, match="positional argument"):
        jax.jit(jstep, static_argnums=(5,)).lower(params, jinit(params), jinit_moments(), batch, jax.random.PRNGKey(0), True)

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    with pytest.raises(NotImplementedError, match="algo.world_model.decoupled_rssm"):
        run([*explore_args(tmp_path), "algo.world_model.decoupled_rssm=True"])


def test_finetuning_config_merge_matches_the_reference(tmp_path):
    """The exploration run's critics, widths and env geometry reach the finetuning config
    in both packages alike."""
    from sheeprl_tpu.algos.p2e import load_exploration_config as jax_merge
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.p2e import load_exploration_config
    from sheeprl_tpu_torch.config.core import compose, save_config

    run_dir = tmp_path / "run" / "version_0"
    (run_dir / "checkpoints" / "ckpt_8").mkdir(parents=True)
    explored = compose(overrides=[
        "exp=p2e_dv3_dummy", "device=cpu", "algo.horizon=5", "algo.dense_units=16", "env.action_repeat=2",
        "algo.critics_exploration.extrinsic.weight=0.5", "algo.ensembles.n=4", "algo.world_model.stochastic_size=6",
    ])
    save_config(explored, run_dir / "config.yaml")
    overrides = ["exp=p2e_dv3_dummy", "algo.name=p2e_dv3_finetuning", f"checkpoint.exploration_ckpt_path={run_dir / 'checkpoints' / 'ckpt_8'}"]
    jcfg, tcfg = jax_compose(overrides=overrides), compose(overrides=[*overrides, "device=cpu"])
    jax_merge(jcfg)
    load_exploration_config(tcfg)
    for key in ("horizon", "dense_units", "world_model", "actor", "critic", "critics_exploration", "ensembles", "cnn_keys", "mlp_keys"):
        assert tcfg.algo[key] == jcfg.algo[key], key
    assert tcfg.env.action_repeat == jcfg.env.action_repeat == 2
    assert tcfg.algo.critics_exploration.extrinsic.weight == 0.5 and tcfg.algo.ensembles.n == 4


@pytest.mark.parametrize("name", ["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def test_entries_ask_for_cuda_by_default(tmp_path, monkeypatch, name):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.core import compose, save_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    args = ["exp=p2e_dv3_dummy", f"algo.name={name}", f"log_root={tmp_path}"]
    if "finetuning" in name:
        ckpt = tmp_path / "run" / "checkpoints" / "ckpt_1"
        ckpt.mkdir(parents=True)
        save_config(compose(overrides=["exp=p2e_dv3_dummy", "device=cpu"]), tmp_path / "run" / "config.yaml")
        args.append(f"checkpoint.exploration_ckpt_path={ckpt}")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        run(args)
