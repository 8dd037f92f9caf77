"""DreamerV3's pipelined player (``algos/dreamer_loop.py::PlayerActing`` through
``rollout/pipeline.py::PipelinedPlayer``) and its train entry on the env pool, on the CPU
at tiny sizes.

* Acting at depth 0 equals calling ``player_step`` directly on the same generator, bit
  for bit: the env actions, the stored actions and the player state; at depth 1 the
  player state advances at every call and each call returns the previous call's actions
  (the first call's twice).
* The train entry with ``env.pool.enabled=True`` and ``rollout.pipeline_depth=1`` beside
  the reference's (one JAX run of this file): the same policy steps, gradient steps,
  checkpoint names and logged metric names, ``Rollout/*`` among them, with the pool's
  counts.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_fault_e2e import DV3
from tests.torch_fault_common import Recorder, clean_fault_state  # noqa: F401  (an autouse fixture)

POOL = ["env.pool.enabled=True", "env.pool.num_workers=2", "rollout.pipeline_depth=1", "env.capture_video=False", "buffer.memmap=False"]
# the entries' run: vector observations only (no CNN for the reference's step to compile: ~60 s of the file's time, not ~105)
VECTOR = ["algo.cnn_keys.encoder=[]", "algo.cnn_keys.decoder=[]", "algo.mlp_keys.decoder=[state]"]


@pytest.fixture(autouse=True)
def few_threads(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    yield
    torch.set_num_threads(before)


def _player():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, build_agent, make_player_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs  # noqa: F401  (PlayerActing's)
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.context import make_run_context

    cfg = compose(overrides=DV3)
    ctx = make_run_context(cfg)
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)})
    world_model, actor, *_ = build_agent(ctx, [2], False, cfg, obs_space)
    step = make_player_step(world_model, actor, [2], cfg.algo.world_model.discrete_size)
    stoch = cfg.algo.world_model.stochastic_size * cfg.algo.world_model.discrete_size
    rec = cfg.algo.world_model.recurrent_model.recurrent_state_size
    state = PlayerState(torch.zeros(2, rec), torch.zeros(2, stoch), torch.zeros(2, 2))
    return cfg, step, state


def _obs(t: int):
    return {"rgb": np.full((2, 3, 64, 64), t, np.uint8), "state": np.full((2, 10), t, np.float32)}


@pytest.mark.parametrize("depth", [0, 1])
def test_acting_through_the_pipelined_player_equals_the_player_step(depth):
    from sheeprl_tpu_torch.algos.dreamer_loop import PlayerActing
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.rollout import PipelinedPlayer

    cfg, step, state = _player()
    cnn, mlp = ["rgb"], ["state"]
    acting = PlayerActing(step, state, cnn, mlp, torch.device("cpu"), torch.Generator().manual_seed(3), [2], False)
    player = PipelinedPlayer(None, acting.policy, acting.post, depth=depth)
    direct_state, direct_gen, direct = state, torch.Generator().manual_seed(3), []
    for t in range(5):
        is_first = np.full((2, 1), float(t == 0), np.float32)
        env_actions, stored = player.act(_obs(t), is_first, t)
        with torch.no_grad():
            acts, d_stored, direct_state = step(direct_state, prepare_obs(_obs(t), cnn, mlp, 2, torch.device("cpu")),
                                                torch.as_tensor(is_first), direct_gen)
        direct.append((acts[0].float().numpy().argmax(-1), d_stored.float().numpy()))
        want = direct[max(t - depth, 0)]
        np.testing.assert_array_equal(env_actions, want[0])
        np.testing.assert_array_equal(stored, want[1])
        assert stored.dtype == np.float32 and env_actions.dtype == np.int64
        # the player state advances at every policy call, at any depth
        for a, b in zip(acting.state, direct_state):
            assert torch.equal(a, b)


def test_the_train_entry_on_the_pool_at_depth_1_matches_the_reference(tmp_path, monkeypatch):
    import sheeprl_tpu.algos.dreamer_v3.dreamer_v3 as jax_dv3
    import sheeprl_tpu_torch.algos.dreamer_loop as dreamer_loop
    from sheeprl_tpu.checkpoint.manager import CheckpointManager as JaxCheckpointManager
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run

    logs = {"jax": Recorder(), "port": Recorder()}
    monkeypatch.setattr(jax_dv3, "get_logger", lambda cfg, log_dir: logs["jax"])
    monkeypatch.setattr(dreamer_loop, "get_logger", lambda cfg, log_dir: logs["port"])
    jax_run([*[o for o in DV3 if o != "device=cpu"], *VECTOR, *POOL, f"log_root={tmp_path / 'jax'}"])
    result = run([*DV3, *VECTOR, *POOL, f"log_root={tmp_path / 'port'}"])

    def ckpts(root, manager):
        return {p.name: {k: int(manager.load(p)[k]) for k in ("iter_num", "policy_step", "cumulative_grad_steps")}
                for p in sorted(root.rglob("checkpoints/ckpt_*"), key=lambda p: int(p.name.split("_")[1]))}

    port_ckpts = ckpts(tmp_path / "port", CheckpointManager)
    assert port_ckpts == ckpts(tmp_path / "jax", JaxCheckpointManager)
    assert list(port_ckpts) == ["ckpt_32", "ckpt_64", "ckpt_96"] and result.policy_steps == 96
    assert port_ckpts["ckpt_96"]["cumulative_grad_steps"] == result.grad_steps
    names = {k: [(step, sorted(m)) for step, m in log.logged] for k, log in logs.items()}
    assert names["port"] == names["jax"]
    rollout = [{k: v for k, v in m.items() if k.startswith("Rollout/")} for _, m in logs["port"].logged]
    assert all(len(r) == 6 for r in rollout)
    assert rollout[-1]["Rollout/env_steps"] == 48.0 and rollout[-1]["Rollout/num_workers"] == 2.0
    assert rollout[-1]["Rollout/worker_restarts"] == 0.0
    assert Path(result.log_dir).name == "version_0"
