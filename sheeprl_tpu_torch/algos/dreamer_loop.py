"""The Dreamer training loop and the pieces of the train step that the Dreamers
(``algos/dreamer_v{1,2,3}``) and Plan2Explore (``algos/p2e_dv{1,2}``) share.

The step's pieces (besides ``loop_common.grads``): ``zero_draws`` and ``fill_draws`` (a step's noise, made in bulk on the device, in place),
the actor's draws (``actor_noise_kind``, ``actor_draw_shapes``, ``act``), the decoders'
and heads' unit-variance Gaussian likelihoods (``gaussian_lp``, ``observation_lp``), the
player's exploration schedule, ``evaluate_actor`` (the greedy test episode of the
DreamerV1/V2 and P2E evaluations) and ``capture_step``/``make_captured_step`` (the step over static inputs, captured as a
CUDA graph on a card by ``utils/graphs.py``, eager on the CPU).

The loop, ``run_loop(ctx, cfg, setup)``: act in the vector env, store the rows, run each
iteration's gradient steps as one block of the captured step (``utils/blocks.py``) over
batches gathered on the device from its replay ring (``buffer.device``,
``data/device_buffer.py``) or prefetched from the host buffer, log, checkpoint, resume
and test. An algorithm hands it its modules, optimizer states, captured step, player and
buffer as a ``LoopParts``; a P2E finetuning run also the exploration run's checkpoint to
start from and the task player to switch to. It refuses the reference's keys the port
does not have (``loop_common.refuse_unported``). Its ``TrainingMonitor`` (``obs/monitor.py``),
made before the step is built, times the reference loop's phases and logs each flush.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, parse_actions_dim
from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS, TestResult, prepare_obs, test
from sheeprl_tpu_torch.algos.loop_common import REGISTERS, TrainResult, grads, refuse_unported, register_last_checkpoint, update_module  # noqa: F401  (the Dreamers import them from here)
from sheeprl_tpu_torch.algos.ppo.ppo import Optimizer
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import save_config
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import make_device_replay
from sheeprl_tpu_torch.distributions import Independent, Normal
from sheeprl_tpu_torch.obs import TrainingMonitor, replay_age_metrics
from sheeprl_tpu_torch.utils.env import make_env, make_vector_env
from sheeprl_tpu_torch.utils.graphs import StepGraph, tree_tensors
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import make_aggregator, record_episode_stats
from sheeprl_tpu_torch.utils.timer import Timer
from sheeprl_tpu_torch.utils.utils import Ratio, exploration_amount


def zero_draws(shapes: NamedTuple, device: torch.device) -> NamedTuple:
    """Float32 zeros of ``shapes`` (``draw_shapes``): a named tuple of the same type whose
    fields are shapes or tuples of shapes."""
    return type(shapes)(*(
        tuple(torch.zeros(s, device=device) for s in f) if isinstance(f[0], tuple) else torch.zeros(f, device=device)
        for f in shapes
    ))


def fill_draws(out: NamedTuple, kinds: Sequence[str], generator: Optional[torch.Generator]) -> NamedTuple:
    """Write noise into ``out``'s float32 tensors in place, field by field from one
    generator stream: ``kinds[i]`` is field i's noise, ``gumbel`` (``-log(-log(u))``, as
    ``gumbel_noise``), ``normal`` or ``uniform`` (in ``[1e-5, 1 - 1e-5]``, as the
    truncated normal draws it)."""
    tiny = torch.finfo(torch.float32).tiny
    for field, kind in zip(out, kinds):
        for t in field if isinstance(field, tuple) else (field,):
            if kind == "gumbel":
                t.uniform_(generator=generator).clamp_(tiny, 1.0).log_().neg_().log_().neg_()
            elif kind == "normal":
                t.normal_(generator=generator)
            else:
                t.uniform_(generator=generator).mul_(1 - 2e-5).add_(1e-5)
    return out


@torch.no_grad()
def copy_tree_(live: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Copy ``new``'s tensors into ``live``'s in place, key by key through nested dicts
    (P2E-DV3's return moments: ``{"task": {...}, "expl": {name: {...}}}``)."""
    for k, v in live.items():
        if isinstance(v, torch.Tensor):
            v.copy_(new[k])
        else:
            copy_tree_(v, new[k])


def load_opt_states(live: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """Load checkpointed optimizer states into ``live`` in place, name by name: an
    optimizer's state (it holds a ``count``) by ``Optimizer.load_state``, a dict of them
    (P2E-DV3's exploration critics) entry by entry."""
    for name, state in live.items():
        if "count" in state:
            Optimizer.load_state(state, saved[name])
        else:
            load_opt_states(state, saved[name])


def capture_step(run, state: Sequence[torch.Tensor], draw_shapes, sample_draws, T: int, B: int, generator, cost_name: Optional[str] = None):
    """``make_step(example_inputs) -> (step, draw)`` for ``make_device_replay``: a train
    step over static inputs, captured as a CUDA graph on a card (``utils/graphs.py``).

    ``run(batch, update_target, draws)`` is one step: it updates ``state`` (every tensor
    the step changes: parameters, optimizer states, ...) in place and returns its metrics.
    The inputs are the step table (``[2B + 1]`` int64: the replay indices and the target
    flag, or ``[1]``: the flag), the batch (host replay) or the ring's ``gather`` (device
    replay, read inside the step), and the draws (zeros of ``draw_shapes(T, B)``), which
    ``draw(draws)`` writes from ``generator`` (``sample_draws(T, B, generator, device,
    out=draws)``) before each step. ``cost_name``: the name the perf plane counts the
    step under (``obs/perf.py``)."""

    def make_step(example: Dict[str, Any]):
        gather = example.get("gather")
        device = example["table"].device
        inputs = {k: v for k, v in example.items() if k != "gather"}
        inputs["draws"] = zero_draws(draw_shapes(T, B), device)

        def fn(inp):
            table = inp["table"]
            batch = gather(table[:B], table[B : 2 * B]) if gather is not None else inp["batch"]
            return run(batch, table[-1] != 0, inp["draws"])

        step = StepGraph(fn, inputs, list(state), cost_name=cost_name)
        return step, lambda out: sample_draws(T, B, generator, device, out=out)

    return make_step


def make_captured_step(train_step, modules: Dict[str, torch.nn.Module], opt_states, extra, T: int, B: int, generator, cost_name: Optional[str] = None):
    """``capture_step`` for a Dreamer step ``train_step(opt_states, extra, batch,
    update_target, draws=...) -> (new_extra, metrics)``: each step updates the
    parameters, ``opt_states`` and ``extra`` (the further tensors the step carries, such
    as DreamerV3's return moments; DreamerV2's is empty) in place and returns its
    metrics."""

    def run(batch, update_target, draws):
        new_extra, metrics = train_step(opt_states, extra, batch, update_target, draws=draws)
        copy_tree_(extra, new_extra)
        return metrics

    state = [p for m in modules.values() for p in m.parameters()] + tree_tensors(opt_states) + tree_tensors(extra)
    return capture_step(run, state, train_step.draw_shapes, train_step.sample_draws, T, B, generator, cost_name)


def actor_noise_kind(actor) -> str:
    """The noise a DreamerV2-style actor samples from: Gumbel noise per discrete head,
    the truncated normal's uniform noise, or normal noise."""
    if not actor.is_continuous:
        return "gumbel"
    return "uniform" if actor.distribution == "trunc_normal" else "normal"


def actor_draw_shapes(horizon: int, rows: int, actions_dim: Sequence[int], actor_noise: str) -> Tuple[Tuple[int, ...], ...]:
    """The shapes of an imagination's action draws: one per discrete head, or one for the
    continuous action."""
    heads = list(actions_dim) if actor_noise == "gumbel" else [int(sum(actions_dim))]
    return tuple((horizon, rows, d) for d in heads)


def act(actor, latent: torch.Tensor, noise) -> torch.Tensor:
    """The actor's sampled action from ``latent`` under the injected ``noise``,
    concatenated over the heads."""
    acts = actor(latent, draws=noise)[0] if actor.is_continuous else actor(latent, gumbels=noise)[0]
    return torch.cat(acts, -1)


def gaussian_lp(mean: torch.Tensor, x: torch.Tensor, dims: int) -> torch.Tensor:
    """The log-density of ``x`` under a unit-variance Gaussian at ``mean``, summed over the
    last ``dims`` dims."""
    return Independent(Normal(mean, torch.ones_like(mean)), dims).log_prob(x)


def observation_lp(recon: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor], cnn_keys, mlp_keys) -> torch.Tensor:
    """The decoders' unit-variance Gaussian log-likelihood of the batch's observations
    (images as ``x / 255 - 0.5``), summed over the keys: ``[T, B]``."""
    T, B = data["rewards"].shape[:2]
    lp = 0.0
    for k in cnn_keys:
        target = data[k].float() / 255.0 - 0.5
        lp = lp + gaussian_lp(recon[k], target.reshape(T, B, -1, *target.shape[-2:]), 3)
    for k in mlp_keys:
        lp = lp + gaussian_lp(recon[k], data[k], 1)
    return lp


def exploration_schedule(actor_cfg):
    """The player's exploration amount at a policy step, from ``algo.actor``."""
    return lambda step: exploration_amount(
        actor_cfg.get("expl_amount", 0.0), actor_cfg.get("expl_decay", 0.0), actor_cfg.get("expl_min", 0.0), step
    )


def evaluate_actor(ctx, cfg: Dict[str, Any], ckpt_path: str, build, make_player, actor_key: str, stoch_size: int) -> TestResult:
    """One greedy test episode of the checkpoint's world model with its ``actor_key``
    actor. ``build(ctx, actions_dim, is_continuous, cfg, obs_space)`` returns the
    algorithm's modules by name; ``make_player`` is its ``make_player_step``; the player
    state's stochastic part is ``stoch_size`` wide."""
    log_dir = get_log_dir(cfg)
    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    is_continuous, actions_dim = parse_actions_dim(act_space)

    modules = build(ctx, actions_dim, is_continuous, cfg, obs_space)
    world_model, actor = modules["world_model"], modules[actor_key]
    params = CheckpointManager.load(ckpt_path, map_location=ctx.device)["params"]
    world_model.load_state_dict(params["world_model"])
    actor.load_state_dict(params[actor_key])
    world_model.eval()
    actor.eval()

    rec_size = cfg.algo.world_model.recurrent_model.recurrent_state_size
    act_dim_sum = int(sum(actions_dim))

    def player_state_init(n: int) -> PlayerState:
        zeros = lambda d: torch.zeros((n, d), device=ctx.device)  # noqa: E731
        return PlayerState(zeros(rec_size), zeros(stoch_size), zeros(act_dim_sum))

    result = test(make_player(world_model, actor, actions_dim, is_continuous), player_state_init, ctx, cfg, log_dir)
    print(f"Test/cumulative_reward: {result.reward}")
    print(f"Test/episode_steps: {result.steps}")
    print(f"Test/player_steps_per_second: {result.steps / result.seconds}")
    return result


class LoopParts(NamedTuple):
    """What an algorithm hands ``run_loop``."""

    modules: Dict[str, torch.nn.Module]  # checkpointed as ``params``, loaded in place on resume
    opt_states: Dict[str, Any]
    extra_state: Dict[str, torch.Tensor]  # further tensors the step updates, checkpointed by name
    make_step: Callable  # makes the captured step, for make_device_replay
    player_step: Callable  # (state, obs, is_first, generator[, expl_amount=exploration(policy_step)])
    rb: Any  # the host replay buffer
    count_offset: int  # the target-critic cadence's (utils/blocks.py::target_flags)
    clip_reward: Callable[[np.ndarray], np.ndarray]  # applied where env.clip_rewards is set
    exploration: Optional[Callable[[int], float]]  # the player's exploration amount at a policy step
    # A checkpoint's state a run that does not resume starts from (P2E finetuning: the
    # exploration run's): its modules and optimizer states load in place, its replay
    # buffer where buffer.load_from_exploration, and the player acts from the first step.
    start_state: Optional[Dict[str, Any]] = None
    # The player the loop switches to at its first training iteration and tests with
    # (P2E finetuning: the task actor's); the choice is checkpointed as ``actor_type``.
    task_player: Optional[Callable] = None


def sequential_buffer(cfg, num_envs: int, obs_keys: Sequence[str], log_dir: str) -> EnvIndependentReplayBuffer:
    """The loops' sequential replay: one sub-buffer per env, ``buffer.size`` rows in all."""
    return EnvIndependentReplayBuffer(
        max(int(cfg.buffer.size) // max(num_envs, 1), 1),
        n_envs=num_envs,
        obs_keys=obs_keys,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None,
        buffer_cls=SequentialReplayBuffer,
    )


#: the phases of DreamerV3's reference loop (``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``);
#: its other Dreamer loops time none
PHASES = ("player", "buffer_add", "dispatch", "env_step", "checkpoint", "drain")


def run_loop(
    ctx, cfg, setup: Callable[..., LoopParts], aggregator_keys=AGGREGATOR_KEYS, handled: Sequence[str] = (), phases: Sequence[str] = ()
) -> TrainResult:
    """The Dreamer training loop: act in the vector env, store the rows, run each
    iteration's gradient steps as one block of the captured step, log, checkpoint,
    resume and test. ``setup(obs_space, actions_dim, is_continuous, log_dir, train_gen)``
    builds the algorithm's part (``LoopParts``); ``train_gen`` is the generator of the
    step's draws; ``aggregator_keys`` names the metrics the loop logs; ``handled`` the
    keys of ``refuse_unported``'s list that the algorithm reads itself; ``phases`` the
    ``Time/phase_*`` blocks the reference's loop times (DreamerV3's: ``PHASES``)."""
    refuse_unported(cfg, handled)
    device = ctx.device
    log_dir = get_log_dir(cfg)
    save_config(cfg, Path(log_dir) / "config.yaml")
    logger = get_logger(cfg, log_dir)
    timer = Timer(disabled=bool(cfg.metric.get("disable_timer", False)))
    # before the step is built: its capture is counted, and its cost model with it
    monitor = TrainingMonitor(cfg, log_dir, timer, device, phases=phases)

    envs = make_vector_env(cfg, cfg.seed, 0, log_dir if cfg.env.capture_video else None)
    obs_space = envs.single_observation_space
    act_space = envs.single_action_space
    is_continuous, actions_dim = parse_actions_dim(act_space)
    act_dim_sum = int(sum(actions_dim))
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    num_envs = cfg.env.num_envs
    # DreamerV1's Gaussian state has no classes
    stoch_size = cfg.algo.world_model.stochastic_size * cfg.algo.world_model.get("discrete_size", 1)
    rec_size = cfg.algo.world_model.recurrent_model.recurrent_state_size
    player_gen, train_gen = ctx.rng(), ctx.rng()

    def player_state_init(n: int) -> PlayerState:
        zeros = lambda d: torch.zeros((n, d), device=device)  # noqa: E731
        return PlayerState(zeros(rec_size), zeros(stoch_size), zeros(act_dim_sum))

    try:
        parts = setup(obs_space, actions_dim, is_continuous, log_dir, train_gen)
        rb = parts.rb
        rb.seed(cfg.seed)
        # The gradient steps: the train step captured once as a CUDA graph on a card
        # (eager on the CPU), replayed as one block per iteration over batches gathered on
        # the device from its replay ring (buffer.device) or prefetched from the host.
        dispatcher, mirror, prefetcher, run_block, rb_add = make_device_replay(
            ctx, cfg, rb, cnn_keys, mlp_keys, obs_space, act_dim_sum, parts.make_step,
            cfg.algo.critic.get("per_rank_target_network_update_freq", 1), parts.count_offset,
        )
    except BaseException:  # a failed capture raises: stop the env workers first
        monitor.close()
        envs.close()
        raise
    modules, opt_states, player_step = parts.modules, parts.opt_states, parts.player_step
    # with a task player: which player acts (checkpointed); the player starts with the
    # config's actor (``algo.player.actor_type``)
    actor_type = cfg.algo.player.get("actor_type", "exploration") if parts.task_player is not None else "exploration"
    rb_lock = prefetcher.lock if prefetcher is not None else contextlib.nullcontext()

    aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
    aggregator.keep(set(aggregator_keys) | set(cfg.metric.aggregator.get("metrics", {})))
    ckpt_manager = CheckpointManager(Path(log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)

    policy_steps_per_iter = num_envs * cfg.env.action_repeat
    total_steps = int(cfg.algo.total_steps)
    num_iters = max(total_steps // policy_steps_per_iter, 1) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0

    start_iter, policy_step, last_log, last_checkpoint, cumulative_grad_steps = 1, 0, 0, 0, 0
    resume_from = cfg.checkpoint.get("resume_from")
    # on the host: the replay buffer stays there
    state = CheckpointManager.load(resume_from) if resume_from else parts.start_state
    if state is not None:
        # in place: the captured step reads these tensors where they are
        for name, module in modules.items():
            module.load_state_dict(state["params"][name])
        load_opt_states(opt_states, state["opt_states"])
        copy_tree_(parts.extra_state, state)
    if resume_from:
        ratio.load_state_dict(state["ratio"])
        start_iter = state["iter_num"] + 1
        policy_step = state["policy_step"]
        last_log = state.get("last_log", 0)
        last_checkpoint = state.get("last_checkpoint", 0)
        cumulative_grad_steps = state.get("cumulative_grad_steps", 0)
        learning_starts += start_iter
        actor_type = state.get("actor_type", actor_type)
    if state is not None and "rb" in state and (cfg.buffer.checkpoint if resume_from else cfg.buffer.get("load_from_exploration")):
        rb.load_state_dict(state["rb"])
        if mirror is not None:
            mirror.load_from(rb)
    if parts.task_player is not None and actor_type == "task":
        player_step = parts.task_player
    # the first iterations act at random, unless the run starts from trained modules
    random_prefill = state is None
    state, parts = None, parts._replace(start_state=None)  # loaded: let the buffer's copy go

    # Pending-row storage, as the reference: row t holds obs_t with the reward and flags
    # received on arriving at it (zeros and is_first=1 after a reset); the action taken
    # from obs_t is filled in just before the row is committed. At an episode's end an
    # extra row stores the true final observation with a zero action.
    def obs_row(o, idxs=None):
        row = {}
        for k in cnn_keys:
            v = np.asarray(o[k]) if idxs is None else np.asarray(o[k])[idxs]
            row[k] = v.reshape(1, v.shape[0], -1, *v.shape[-2:])
        for k in mlp_keys:
            v = np.asarray(o[k], dtype=np.float32) if idxs is None else np.asarray(o[k], dtype=np.float32)[idxs]
            row[k] = v.reshape(1, v.shape[0], -1)
        return row

    obs, _ = envs.reset(seed=cfg.seed)
    player_state = player_state_init(num_envs)
    step_data = obs_row(obs)
    step_data["rewards"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["terminated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["truncated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["is_first"] = np.ones((1, num_envs, 1), np.float32)
    is_first_np = np.ones((num_envs, 1), dtype=np.float32)
    prefill_iters = max(learning_starts - 1, 0)

    run_grad_steps, last_path = 0, None
    env_seconds_total, train_seconds = 0.0, 0.0
    run_start = time.perf_counter()
    try:
        for iter_num in range(start_iter, num_iters + 1):
            monitor.advance()
            env_time = 0.0
            env_t0 = time.perf_counter()
            with timer("Time/env_interaction_time"), monitor.phase("player"):
                if iter_num <= learning_starts and random_prefill:
                    sampled = np.stack([act_space.sample() for _ in range(num_envs)])
                    if is_continuous:
                        stored_actions = env_actions = sampled.astype(np.float32)
                    else:
                        sampled = sampled.reshape(num_envs, -1)
                        stored_actions = np.concatenate(
                            [np.eye(d, dtype=np.float32)[sampled[:, i]] for i, d in enumerate(actions_dim)], -1
                        )
                        env_actions = sampled.squeeze(-1) if len(actions_dim) == 1 else sampled
                    player_state = player_state._replace(actions=torch.as_tensor(stored_actions, device=device))
                else:
                    with torch.no_grad():
                        obs_t = prepare_obs(obs, cnn_keys, mlp_keys, num_envs, device)
                        expl = {} if parts.exploration is None else {"expl_amount": parts.exploration(policy_step)}
                        acts, stored, player_state = player_step(
                            player_state, obs_t, torch.as_tensor(is_first_np, device=device), player_gen, **expl
                        )
                        acts_np = [a.float().cpu().numpy() for a in acts]
                        stored_actions = stored.float().cpu().numpy()
                    if is_continuous:
                        env_actions = acts_np[0]
                    elif len(actions_dim) == 1:
                        env_actions = acts_np[0].argmax(-1)
                    else:
                        env_actions = np.stack([a.argmax(-1) for a in acts_np], -1)
                step_data["actions"] = stored_actions.reshape(1, num_envs, -1)
                with monitor.phase("buffer_add"):
                    rb_add(step_data, validate_args=cfg.buffer.validate_args)
            env_time += time.perf_counter() - env_t0

            if iter_num >= learning_starts:
                if parts.task_player is not None and actor_type != "task":
                    actor_type, player_step = "task", parts.task_player
                grad_steps = ratio((policy_step + policy_steps_per_iter - prefill_iters * policy_steps_per_iter))
                if grad_steps > 0:
                    train_t0 = time.perf_counter()
                    with monitor.phase("dispatch"):
                        run_block(grad_steps, cumulative_grad_steps, stage_next=iter_num < num_iters)
                    cumulative_grad_steps += grad_steps
                    run_grad_steps += grad_steps
                    train_seconds += time.perf_counter() - train_t0

            env_t0 = time.perf_counter()
            with timer("Time/env_interaction_time"), monitor.phase("env_step"):
                next_obs, reward, terminated, truncated, info = envs.step(env_actions)
                if cfg.env.clip_rewards:
                    reward = parts.clip_reward(reward)
                done = np.logical_or(terminated, truncated)
                reward = np.asarray(reward, dtype=np.float32).reshape(num_envs, 1)
                # the true final observation of an ending episode (same-step autoreset
                # returns the reset one; the final one is in info["final_obs"])
                real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
                if done.any() and "final_obs" in info:
                    for i in np.nonzero(done)[0]:
                        if info["final_obs"][i] is not None:
                            for k in obs_keys:
                                real_next_obs[k][i] = np.asarray(info["final_obs"][i][k])
                step_data = obs_row(next_obs)
                step_data["rewards"] = reward.reshape(1, num_envs, 1).copy()
                step_data["terminated"] = terminated.astype(np.float32).reshape(1, num_envs, 1)
                step_data["truncated"] = truncated.astype(np.float32).reshape(1, num_envs, 1)
                step_data["is_first"] = np.zeros((1, num_envs, 1), np.float32)
                done_idxs = np.nonzero(done)[0].tolist()
                if done_idxs:
                    reset_data = obs_row(real_next_obs, idxs=done_idxs)
                    reset_data["rewards"] = step_data["rewards"][:, done_idxs]
                    reset_data["terminated"] = step_data["terminated"][:, done_idxs]
                    reset_data["truncated"] = step_data["truncated"][:, done_idxs]
                    reset_data["actions"] = np.zeros((1, len(done_idxs), act_dim_sum), np.float32)
                    reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
                    rb_add(reset_data, indices=done_idxs, validate_args=cfg.buffer.validate_args)
                    for k in ("rewards", "terminated", "truncated"):
                        step_data[k][:, done_idxs] = 0.0
                    step_data["is_first"][:, done_idxs] = 1.0
                is_first_np = done.astype(np.float32).reshape(num_envs, 1)
                obs = next_obs
                policy_step += policy_steps_per_iter
                record_episode_stats(aggregator, info)
            env_time += time.perf_counter() - env_t0
            env_seconds_total += env_time

            if (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every) or (
                iter_num == num_iters and cfg.checkpoint.save_last
            ):
                ckpt_state = {
                    "params": {name: m.state_dict() for name, m in modules.items()},
                    "opt_states": opt_states,
                    **parts.extra_state,
                    "ratio": ratio.state_dict(),
                    "iter_num": iter_num,
                    "policy_step": policy_step,
                    "last_log": last_log,
                    "last_checkpoint": policy_step,
                    "cumulative_grad_steps": cumulative_grad_steps,
                }
                if parts.task_player is not None:
                    ckpt_state["actor_type"] = actor_type
                with monitor.phase("checkpoint"):
                    if cfg.buffer.checkpoint:
                        with rb_lock:
                            ckpt_state["rb"] = rb.state_dict()
                    last_path = str(ckpt_manager.save(policy_step, ckpt_state))
                last_checkpoint = policy_step

            if logger is not None and (policy_step - last_log >= cfg.metric.log_every or iter_num == num_iters or cfg.dry_run):
                # the window's only blocking copy: every block's last metrics at once
                with monitor.phase("drain"):
                    dispatcher.drain(aggregator)
                metrics = aggregator.compute()
                window_sps = dispatcher.pop_window_sps()
                if window_sps is not None:
                    metrics["Time/sps_train"] = window_sps
                metrics["Time/sps_env_interaction"] = policy_steps_per_iter / env_time if env_time > 0 else 0.0
                metrics["Params/replay_ratio"] = cumulative_grad_steps / policy_step if policy_step > 0 else 0.0
                if parts.exploration is not None:
                    metrics["Params/exploration_amount"] = parts.exploration(policy_step)
                metrics.update(replay_age_metrics(rb))  # its index sampling notes the ages on either path
                monitor.log_metrics(logger, metrics, policy_step)
                aggregator.reset()
                last_log = policy_step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        monitor.close()
        envs.close()
        if prefetcher is not None:
            prefetcher.close()
    seconds = time.perf_counter() - run_start
    test_reward = None
    if cfg.algo.run_test:
        test_reward = test(parts.task_player or player_step, player_state_init, ctx, cfg, log_dir).reward
        if logger is not None:
            logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step)
    register_last_checkpoint(cfg, log_dir)
    if logger is not None:
        logger.close()
    return TrainResult(log_dir, policy_step, run_grad_steps, last_path, seconds, train_seconds, env_seconds_total, test_reward)
