"""Plan2Explore on DreamerV1 and DreamerV2 through the PyTorch port's train and eval
entries on the CPU, at the ``p2e_dv{1,2}_dummy`` exps' tiny size.

For each: explore (train, checkpoint, evaluate with the exploration actor), then
finetune from the exploration checkpoint once without and once with
``buffer.load_from_exploration``, evaluate the finetuned checkpoint (the task actor), and
resume a finetuning run from a checkpoint before and from one after its player switched
to the task actor: the switch is checkpointed as ``actor_type`` and kept; a run told to
act with the task actor records it from its first checkpoint. A finetuning
checkpoint holds every module and optimizer state of the exploration run, the untrained
ones as they were loaded. The finetuning config merge is held to the reference's
``load_exploration_config`` on the same files, and every entry asks for CUDA without
``device=cpu``.
"""

from pathlib import Path

import pytest
import torch

UNTRAINED = {1: ("actor_exploration", "critic_exploration", "ensembles"), 2: ("actor_exploration", "critic_exploration", "target_critic_exploration", "ensembles")}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def explore_args(version: int, tmp_path) -> list:
    return [f"exp=p2e_dv{version}_dummy", "device=cpu", "env.sync_env=True", "buffer.memmap=False", f"log_root={tmp_path / 'logs'}"]


def finetune_args(version: int, tmp_path, ckpt, load: bool) -> list:
    return [
        *explore_args(version, tmp_path),
        f"algo.name=p2e_dv{version}_finetuning",
        f"checkpoint.exploration_ckpt_path={ckpt}",
        f"buffer.load_from_exploration={load}",
        "algo.total_steps=64",
        "algo.learning_starts=32",
        "checkpoint.every=16",
    ]


def stored_rows(rb_state) -> int:
    """The rows a checkpointed sequential buffer holds, over its per-env sub-buffers."""
    return sum(b["buffer"]["rewards"].shape[0] if b["full"] else b["pos"] for b in rb_state["buffers"])


def equal_states(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def equal_opt(a, b) -> bool:
    return int(a["count"]) == int(b["count"]) and all(torch.equal(x, y) for k in ("mu", "nu") for x, y in zip(a[k], b[k]))


@pytest.mark.parametrize("version", [1, 2])
def test_explore_finetune_resume_evaluate(tmp_path, monkeypatch, version):
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    explored = run(explore_args(version, tmp_path))
    assert explored.policy_steps == 64 and explored.grad_steps > 0 and explored.test_reward == 0.0
    expl = CheckpointManager.load(explored.checkpoint)
    assert "actor_type" not in expl and "rb" in expl
    assert evaluate([f"checkpoint_path={explored.checkpoint}", "device=cpu", "env.capture_video=False"]).reward == 0.0

    for load in (False, True):
        tuned = run(finetune_args(version, tmp_path, explored.checkpoint, load))
        assert tuned.policy_steps == 64 and tuned.grad_steps > 0 and tuned.test_reward == 0.0
        ckpts = CheckpointManager(Path(tuned.log_dir) / "checkpoints").list_checkpoints()
        assert [p.name for p in ckpts] == ["ckpt_16", "ckpt_32", "ckpt_48", "ckpt_64"]
        # the player switches at the first training iteration (iteration 16, policy step 32)
        assert [CheckpointManager.load(p)["actor_type"] for p in ckpts] == ["exploration", "task", "task", "task"]
        state = CheckpointManager.load(tuned.checkpoint)
        assert set(state["params"]) == set(expl["params"]) and set(state["opt_states"]) == set(expl["opt_states"])
        for name in UNTRAINED[version]:
            assert equal_states(state["params"][name], expl["params"][name]), name
            if name in expl["opt_states"]:
                assert equal_opt(state["opt_states"][name], expl["opt_states"][name]), name
        for name in ("world_model", "actor_task", "critic_task"):
            assert not equal_states(state["params"][name], expl["params"][name]), name
            assert int(state["opt_states"][name]["count"]) == int(expl["opt_states"][name]["count"]) + state["cumulative_grad_steps"]
        result = evaluate([f"checkpoint_path={tuned.checkpoint}", "device=cpu", "env.capture_video=False"])
        assert result.reward == 0.0 and result.steps > 0

        # resumed before the switch it acts with the exploration actor until it trains;
        # resumed after it, with the task actor from its first step
        before = run([*finetune_args(version, tmp_path, explored.checkpoint, load), f"checkpoint.resume_from={ckpts[0]}"])
        names = [CheckpointManager.load(p)["actor_type"] for p in CheckpointManager(Path(before.log_dir) / "checkpoints").list_checkpoints()]
        assert names == ["exploration", "exploration", "task"]  # ckpt_32, ckpt_48, ckpt_64: it trains again at iteration 25
        after = run([*finetune_args(version, tmp_path, explored.checkpoint, load), f"checkpoint.resume_from={ckpts[1]}"])
        names = [CheckpointManager.load(p)["actor_type"] for p in CheckpointManager(Path(after.log_dir) / "checkpoints").list_checkpoints()]
        assert names == ["task", "task"]


def test_finetuning_starts_from_the_exploration_buffer(tmp_path, monkeypatch):
    """With ``buffer.load_from_exploration`` the finetuning replay holds the exploration
    run's rows before its own; without, only its own."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    explored = run(explore_args(2, tmp_path))
    explored_rows = stored_rows(CheckpointManager.load(explored.checkpoint)["rb"])
    rows = {load: stored_rows(CheckpointManager.load(run(finetune_args(2, tmp_path, explored.checkpoint, load)).checkpoint)["rb"]) for load in (False, True)}
    assert explored_rows >= 64 and rows[False] >= 64
    assert rows[True] == rows[False] + explored_rows


def test_finetuning_with_the_task_actor_records_it_from_the_start(tmp_path, monkeypatch):
    """With ``algo.player.actor_type=task`` the finetuning player acts with the task actor
    from its first step, and every checkpoint records it, as the reference's does."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    explored = run(explore_args(1, tmp_path))
    tuned = run([*finetune_args(1, tmp_path, explored.checkpoint, False), "algo.player.actor_type=task"])
    names = [CheckpointManager.load(p)["actor_type"] for p in CheckpointManager(Path(tuned.log_dir) / "checkpoints").list_checkpoints()]
    assert names == ["task", "task", "task", "task"]  # ckpt_16 precedes the first training iteration


def test_finetuning_config_merge_matches_the_reference(tmp_path):
    """The same exploration ``config.yaml`` merged into the same finetuning config by each
    package: every env and algo key the merge takes, and the env count where the buffer
    comes along, agree; a run on another env id is refused by both."""
    from sheeprl_tpu.algos.p2e import load_exploration_config as jax_merge
    from sheeprl_tpu.config.core import compose as jax_compose
    from sheeprl_tpu_torch.algos.p2e import load_exploration_config
    from sheeprl_tpu_torch.config.core import compose, save_config

    run_dir = tmp_path / "run" / "version_0"
    (run_dir / "checkpoints" / "ckpt_8").mkdir(parents=True)
    explored = compose(overrides=[
        "exp=p2e_dv2_dummy", "device=cpu", "algo.horizon=5", "algo.dense_units=16", "algo.gamma=0.9", "env.action_repeat=2",
        "env.num_envs=3", "env.clip_rewards=True", "algo.ensembles.n=4", "algo.world_model.stochastic_size=6",
    ])
    save_config(explored, run_dir / "config.yaml")
    ckpt = run_dir / "checkpoints" / "ckpt_8"
    for load in (False, True):
        overrides = ["exp=p2e_dv2_dummy", "algo.name=p2e_dv2_finetuning", f"checkpoint.exploration_ckpt_path={ckpt}", f"buffer.load_from_exploration={load}"]
        jcfg, tcfg = jax_compose(overrides=overrides), compose(overrides=[*overrides, "device=cpu"])
        jax_merge(jcfg)
        load_exploration_config(tcfg)
        for key in ("action_repeat", "clip_rewards", "screen_size", "frame_stack", "num_envs"):
            assert tcfg.env[key] == jcfg.env[key], key
        for key in ("gamma", "lmbda", "horizon", "dense_units", "mlp_layers", "world_model", "actor", "critic", "ensembles", "cnn_keys", "mlp_keys"):
            assert tcfg.algo[key] == jcfg.algo[key], key
        assert tcfg.algo.horizon == 5 and tcfg.algo.ensembles.n == 4 and tcfg.env.num_envs == (3 if load else 2)
    overrides = ["exp=p2e_dv2_dummy", "algo.name=p2e_dv2_finetuning", f"checkpoint.exploration_ckpt_path={ckpt}", "env.id=continuous_dummy"]
    for merge, cfg in ((jax_merge, jax_compose(overrides=overrides)), (load_exploration_config, compose(overrides=[*overrides, "device=cpu"]))):
        with pytest.raises(ValueError, match="different environment"):
            merge(cfg)


@pytest.mark.parametrize("name", ["dreamer_v1", "p2e_dv1_exploration", "p2e_dv1_finetuning", "p2e_dv2_exploration", "p2e_dv2_finetuning"])
def test_entries_ask_for_cuda_by_default(tmp_path, monkeypatch, name):
    from sheeprl_tpu_torch.config.core import compose, save_config
    from sheeprl_tpu_torch.cli import run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    exp = "dreamer_v1_dummy" if name == "dreamer_v1" else f"{name[:7]}_dummy"
    args = [f"exp={exp}", f"algo.name={name}", f"log_root={tmp_path}"]
    if "finetuning" in name:
        ckpt = tmp_path / "run" / "checkpoints" / "ckpt_1"
        ckpt.mkdir(parents=True)
        save_config(compose(overrides=[f"exp={exp}", "device=cpu"]), tmp_path / "run" / "config.yaml")
        args.append(f"checkpoint.exploration_ckpt_path={ckpt}")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        run(args)
