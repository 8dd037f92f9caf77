"""SAC training (counterpart of ``sheeprl_tpu/algos/sac/sac.py``): the update, the train
loop that SAC, DroQ and SAC-AE share (``run_sac_loop``) and SAC's entry ``main``.

The update (``make_sac_update``, the reference's ``make_sac_step_fn``): the critic step
on a target from the target critic and a fresh next action, then the actor against the
UPDATED critic, then the temperature, then the target critic's EMA where the step's flag
is set (``(count + 1) % target_network_frequency == 0``, ``utils/blocks.py::
target_flags``). Each optimizer is the PPO port's ``make_optimizer`` (optax semantics),
as the reference reuses PPO's. The two action draws are standard normals, an input.

The loop (``run_sac_loop``): random actions while the prefill lasts (a resumed run keeps
its policy), then the policy (through ``rollout/pipeline.py::PipelinedPlayer`` for SAC,
which reads ``rollout.pipeline_depth``); ``Ratio`` decides each iteration's gradient
steps, offset by the prefill; the block is dispatched before the envs step, or after
the first row lands when the buffer is still empty; the stored next observation is the
episode's final one where it ended; a truncated episode still bootstraps (``dones`` is
the termination). An iteration's gradient steps are replays of the captured step
(``utils/graphs.py``) as a K-step block (``utils/blocks.py``) over batches prefetched
from the host ``ReplayBuffer`` or gathered on the device from a ``DeviceTransitionRing``
(``buffer.device``, ``data/device_buffer.py::make_transition_replay``): the counterpart
of the reference's scanned host block and its donated ring block
(``FusedRingDispatcher``). Checkpoints hold the agent, the optimizer states, the ratio,
the counters and (``buffer.checkpoint``) the buffer; a resume rebuilds the ring from it.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_loop import capture_step, fill_draws, load_opt_states
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import ema_target
from sheeprl_tpu_torch.algos.loop_common import TrainResult, grads, refuse_unported
from sheeprl_tpu_torch.algos.ppo.ppo import Optimizer, make_optimizer
from sheeprl_tpu_torch.algos.sac.agent import action_dim, build_agent, vector_dim
from sheeprl_tpu_torch.algos.sac.loss import actor_loss, alpha_loss, critic_loss
from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, env_actions, test, vector_rows
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import save_config
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import make_transition_replay
from sheeprl_tpu_torch.rollout import PipelinedPlayer, rollout_metrics
from sheeprl_tpu_torch.utils.env import make_vector_env
from sheeprl_tpu_torch.utils.graphs import tree_tensors
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import make_aggregator, record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import Timer
from sheeprl_tpu_torch.utils.utils import Ratio

METRICS = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")


class SACDraws(NamedTuple):
    """One SAC step's standard-normal draws: the next action's and the new action's."""

    next: Any
    new: Any


def make_optimizers(cfg, max_grad_norm: float = 0.0, names: Sequence[str] = ("actor", "critic", "alpha")) -> Dict[str, Optimizer]:
    """``algo.<name>.optimizer`` for each name (``alpha``: never clipped)."""
    return {n: make_optimizer(cfg.algo[n].optimizer, 0.0 if n == "alpha" else max_grad_norm) for n in names}


def init_opt_states(opts: Dict[str, Optimizer], params: Dict[str, Sequence[torch.Tensor]]) -> Dict[str, Any]:
    return {n: opts[n].init(list(params[n])) for n in opts}


def tanh_sample(actor, obs: torch.Tensor, noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(action, log-prob summed over the action)`` of the actor's tanh-Normal at ``obs``
    under the standard-normal ``noise``."""
    mean, log_std = actor(obs)
    act, logp = actor.dist(mean, log_std).sample_and_log_prob(noise=noise)
    return act, logp.sum(-1, keepdim=True)


def td_target(actor, target_critic, batch: Dict[str, torch.Tensor], next_obs, alpha, gamma: float, noise) -> torch.Tensor:
    """``r + (1 - done) * gamma * (min_i Q'_i(s', a') - alpha * log pi(a'|s'))``, no
    gradient."""
    with torch.no_grad():
        next_act, next_logp = tanh_sample(actor, next_obs, noise)
        q_next = torch.amin(target_critic(next_obs, next_act), 0)
        return batch["rewards"] + (1.0 - batch["dones"]) * gamma * (q_next - alpha * next_logp)


def actor_and_alpha_step(agent, opts, opt_states, actor_in: torch.Tensor, q_fn: Callable, noise, target_entropy: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The actor's step on ``alpha * log pi - q_fn(actor_in, a)`` (the temperature as it
    stands), then the temperature's step on the actor's log-probs; both in place.
    Returns the two losses."""
    alpha = agent.log_alpha.detach().exp()
    new_act, logp = tanh_sample(agent.actor, actor_in, noise)
    al = actor_loss(alpha, logp, q_fn(actor_in, new_act))
    a_params = list(agent.actor.parameters())
    opts["actor"].update(a_params, grads(al, a_params), opt_states["actor"])
    tl = alpha_loss(agent.log_alpha, logp, target_entropy)
    opts["alpha"].update([agent.log_alpha], grads(tl, [agent.log_alpha]), opt_states["alpha"])
    return al.detach(), tl.detach()


def make_sac_update(agent, cfg, act_dim: int):
    """``(update, opts, opt_states)``: ``update(opt_states, batch, update_target, draws)``
    is one SAC gradient step in place on ``agent`` and ``opt_states``; ``batch`` holds
    ``obs``, ``next_obs``, ``actions`` ``[B, ...]`` and ``rewards``, ``dones`` ``[B,
    1]``; ``draws`` a ``SACDraws`` of ``[B, act_dim]`` normals. Returns the losses by
    name."""
    opts = make_optimizers(cfg, cfg.algo.get("max_grad_norm", 0.0) or 0.0)
    opt_states = init_opt_states(opts, {"actor": agent.actor.parameters(), "critic": agent.critic.parameters(), "alpha": [agent.log_alpha]})
    gamma, tau, target_entropy = float(cfg.algo.gamma), float(cfg.algo.tau), -float(act_dim)

    def update(opt_states, batch, update_target, draws) -> Dict[str, torch.Tensor]:
        alpha = agent.log_alpha.detach().exp()
        obs, next_obs = batch["obs"], batch["next_obs"]
        target = td_target(agent.actor, agent.critic_target, batch, next_obs, alpha, gamma, draws.next)
        c_params = list(agent.critic.parameters())
        cl = critic_loss(agent.critic(obs, batch["actions"]), target)
        opts["critic"].update(c_params, grads(cl, c_params), opt_states["critic"])
        # the actor against the critic just updated, as the reference
        al, tl = actor_and_alpha_step(agent, opts, opt_states, obs, lambda o, a: torch.amin(agent.critic(o, a), 0), draws.new, target_entropy)
        if not isinstance(update_target, torch.Tensor):
            update_target = torch.full((), bool(update_target), device=cl.device)
        ema_target(list(agent.critic_target.parameters()), c_params, tau, update_target)
        return dict(zip(METRICS, (cl.detach(), al, tl)))

    return update, opts, opt_states


def transition_draws(draw_shapes: Callable, kinds: Sequence[str]):
    """``(draw_shapes(T, B), sample_draws)`` in ``dreamer_loop.capture_step``'s form for a
    step whose draws do not depend on ``T``."""

    def sample_draws(T, B, generator, device, out):
        return fill_draws(out, kinds, generator)

    return draw_shapes, sample_draws


def make_sac_step_factory(agent, update, opt_states, batch_size: int, act_dim: int, generator):
    """``make_step`` for ``make_transition_replay``: SAC's update captured over static
    inputs (``dreamer_loop.capture_step``), its two normal draws written from
    ``generator`` before each replay."""
    shapes, sample = transition_draws(lambda T, B: SACDraws((B, act_dim), (B, act_dim)), ("normal", "normal"))
    state = list(agent.parameters()) + tree_tensors(opt_states)

    def run(batch, update_target, draws):
        return update(opt_states, batch, update_target, draws)

    factory = capture_step(run, state, shapes, sample, 1, batch_size, generator)
    return lambda example: (*factory(example), None)


# --------------------------------------------------------------------------- the loop


class SACParts(NamedTuple):
    """What an algorithm of the SAC family hands ``run_sac_loop``."""

    agent: torch.nn.Module  # checkpointed as ``params``, loaded in place on resume
    opt_states: Dict[str, Any]
    obs_spec: Tuple[Tuple[int, ...], Any]  # an observation row's shape and numpy dtype
    to_rows: Callable[[Dict[str, np.ndarray]], np.ndarray]  # [n, ...] observations -> rows
    policy: Callable[[torch.Tensor, torch.Generator], torch.Tensor]  # rows -> sampled tanh actions
    greedy: Callable[[torch.Tensor], torch.Tensor]  # rows -> tanh of the actor's mean
    make_step: Callable  # for make_transition_replay: example inputs -> (step, draw, select)
    target_update_freq: int = 1
    count_offset: int = 1
    tail: int = 0  # samples the block hands ``run_tail`` (DroQ: the actor's batch)
    run_tail: Optional[Callable[[Any], Tuple[Sequence[str], torch.Tensor]]] = None


def refuse_precision_override(cfg) -> None:
    """DroQ and SAC-AE compute in ``mesh.precision``'s dtype, as the reference's loops do:
    an ``algo.precision`` that asks for another one is refused."""
    precision = str(cfg.algo.get("precision", "mesh") or "mesh")
    if precision != "mesh":
        raise NotImplementedError(
            f"algo.precision={precision}: {cfg.algo.name} computes in mesh.precision's dtype, as the reference's does"
        )


def run_sac_loop(ctx, cfg, setup: Callable[..., SACParts], aggregator_keys=AGGREGATOR_KEYS, pipelined: bool = False, prefill_on_resume: bool = False) -> TrainResult:
    """The SAC family's train loop. ``setup(ctx, cfg, obs_space, act_space)`` returns the
    algorithm's ``SACParts``. ``prefill_on_resume``: a resumed run acts randomly again
    while ``learning_starts`` lasts (SAC-AE's reference does; SAC's and DroQ's keep the
    policy)."""
    # only SAC's loop reads rollout.pipeline_depth; DroQ's and SAC-AE's act synchronously, as their references do
    refuse_unported(cfg, handled=("rollout.pipeline_depth",) if pipelined else ())
    device = ctx.device
    log_dir = get_log_dir(cfg)
    save_config(cfg, Path(log_dir) / "config.yaml")
    logger = get_logger(cfg, log_dir)
    timer = Timer(disabled=bool(cfg.metric.get("disable_timer", False)))
    envs = make_vector_env(cfg, cfg.seed, 0, log_dir if cfg.env.capture_video else None)
    prefetcher = None
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        act_dim = action_dim(act_space, cfg.algo.name)
        parts = setup(ctx, cfg, obs_space, act_space)
        agent, opt_states = parts.agent, parts.opt_states
        num_envs = int(cfg.env.num_envs)
        rb = ReplayBuffer(
            max(int(cfg.buffer.size) // num_envs, 1),
            num_envs,
            obs_keys=("obs",),
            memmap=cfg.buffer.memmap,
            memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None,
        )
        rb.seed(cfg.seed)
        specs = {"obs": parts.obs_spec, "next_obs": parts.obs_spec, "actions": ((act_dim,), np.float32),
                 "rewards": ((1,), np.float32), "dones": ((1,), np.float32)}
        ring, prefetcher, run_block, rb_add = make_transition_replay(
            ctx, cfg, rb, specs, parts.make_step, parts.target_update_freq, parts.count_offset, parts.tail
        )
        dispatcher = run_block.dispatcher
        aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
        aggregator.keep(set(aggregator_keys) | set(cfg.metric.aggregator.get("metrics", {})))
        ckpt_manager = CheckpointManager(Path(log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
        ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)

        policy_steps_per_iter = num_envs
        num_iters = max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1) if not cfg.dry_run else 1
        learning_starts = int(cfg.algo.learning_starts) // policy_steps_per_iter if not cfg.dry_run else 0
        prefill_iters = max(learning_starts - 1, 0)
        start_iter, policy_step, last_log, last_checkpoint, grad_count = 1, 0, 0, 0, 0
        resumed = bool(cfg.checkpoint.get("resume_from"))
        if resumed:
            state = CheckpointManager.load(cfg.checkpoint.resume_from)
            agent.load_state_dict(state["params"])
            load_opt_states(opt_states, state["opt_state"])
            ratio.load_state_dict(state["ratio"])
            start_iter = state["iter_num"] + 1
            policy_step = state["policy_step"]
            last_log = state.get("last_log", 0)
            last_checkpoint = state.get("last_checkpoint", 0)
            grad_count = state.get("cumulative_grad_steps", 0)
            learning_starts += start_iter
            if cfg.buffer.checkpoint and "rb" in state:
                rb.load_state_dict(state["rb"])
                if ring is not None and len(rb) > 0:
                    ring.load_from_dense({k: rb._buf[k] for k in specs})
        start_grad_count, last_path = grad_count, None

        player_gen = ctx.rng()
        depth = int((cfg.get("rollout") or {}).get("pipeline_depth", 0) or 0) if pipelined else 0
        player = PipelinedPlayer(
            envs,
            lambda rows: (parts.policy(rows, player_gen),),
            lambda fetched: (env_actions(fetched[0], act_space), fetched[0]),
            depth=depth,
        )
        low, high = act_space.low, act_space.high
        rescale = np.isfinite(low).all() and np.isfinite(high).all()

        obs, _ = envs.reset(seed=cfg.seed)
        train_seconds, env_seconds = 0.0, 0.0
        run_start = time.perf_counter()

        def dispatch(grad_steps: int, stage_next: bool) -> None:
            nonlocal grad_count, train_seconds
            t0 = time.perf_counter()
            with timer("Time/train_time"):
                tail = run_block(grad_steps, grad_count, stage_next)
                if parts.run_tail is not None:
                    dispatcher.track(parts.run_tail(tail))
            grad_count += grad_steps
            train_seconds += time.perf_counter() - t0

        for iter_num in range(start_iter, num_iters + 1):
            env_t0 = time.perf_counter()
            with timer("Time/env_interaction_time"):
                if iter_num <= learning_starts and (prefill_on_resume or not resumed):
                    actions = np.stack([act_space.sample() for _ in range(num_envs)])
                    tanh_actions = 2 * (actions - low) / (high - low) - 1 if rescale else actions
                else:
                    rows = torch.from_numpy(parts.to_rows(obs)).to(device)
                    actions, tanh_actions = player.act(rows)
            env_time = time.perf_counter() - env_t0

            grad_steps, deferred = 0, False
            if iter_num >= learning_starts:
                # offset by the prefill, so that the governor does not ask for the whole
                # prefill's worth of gradient steps at once
                grad_steps = max(ratio(policy_step + policy_steps_per_iter - prefill_iters * policy_steps_per_iter), 0)
                if grad_steps > 0:
                    if rb.empty:
                        deferred = True  # rows carry next_obs: the first lands after the env step
                    else:
                        dispatch(grad_steps, iter_num < num_iters)

            env_t0 = time.perf_counter()
            with timer("Time/env_interaction_time"):
                next_obs, reward, terminated, truncated, info = player.env_step(actions)
                done = np.logical_or(terminated, truncated)
                real_next = {k: np.asarray(v).copy() for k, v in next_obs.items()}
                if done.any() and "final_obs" in info:
                    for i in np.nonzero(done)[0]:
                        if info["final_obs"][i] is not None:
                            for k in real_next:
                                real_next[k][i] = np.asarray(info["final_obs"][i][k])
                rb_add(
                    {
                        "obs": parts.to_rows(obs)[None],
                        "next_obs": parts.to_rows(real_next)[None],
                        "actions": np.asarray(tanh_actions, np.float32).reshape(1, num_envs, -1),
                        "rewards": np.asarray(reward, np.float32).reshape(1, num_envs, 1),
                        # a truncated episode still bootstraps: dones is the termination
                        "dones": np.asarray(terminated, np.float32).reshape(1, num_envs, 1),
                    },
                    validate_args=cfg.buffer.validate_args,
                )
                obs = next_obs
                policy_step += policy_steps_per_iter
                record_episode_stats(aggregator, info)
            env_time += time.perf_counter() - env_t0
            env_seconds += env_time

            if deferred:
                dispatch(grad_steps, iter_num < num_iters)

            if logger is not None and (policy_step - last_log >= cfg.metric.log_every or iter_num == num_iters or cfg.dry_run):
                dispatcher.drain(aggregator)
                metrics = aggregator.compute()
                window_sps = dispatcher.pop_window_sps()
                if window_sps is not None:
                    metrics["Time/sps_train"] = window_sps
                metrics["Time/sps_env_interaction"] = policy_steps_per_iter / env_time if env_time > 0 else 0.0
                metrics["Params/replay_ratio"] = grad_count / policy_step if policy_step > 0 else 0.0
                metrics.update(rollout_metrics(envs))
                metrics.update(timer.to_dict())
                logger.log_metrics(metrics, policy_step)
                aggregator.reset()
                last_log = policy_step

            if (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every) or (
                iter_num == num_iters and cfg.checkpoint.save_last
            ):
                state = {
                    "params": agent.state_dict(),
                    "opt_state": opt_states,
                    "ratio": ratio.state_dict(),
                    "iter_num": iter_num,
                    "policy_step": policy_step,
                    "last_log": last_log,
                    "last_checkpoint": policy_step,
                    "cumulative_grad_steps": grad_count,
                }
                if cfg.buffer.checkpoint:
                    state["rb"] = rb.state_dict()
                last_path = str(ckpt_manager.save(policy_step, state))
                last_checkpoint = policy_step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        envs.close()
    seconds = time.perf_counter() - run_start
    test_reward = None
    if cfg.algo.run_test:
        test_reward = test(parts.greedy, parts.to_rows, ctx, cfg, log_dir).reward
        if logger is not None:
            logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step)
    if logger is not None:
        logger.close()
    return TrainResult(log_dir, policy_step, grad_count - start_grad_count, last_path, seconds, train_seconds, env_seconds, test_reward)


# --------------------------------------------------------------------------- SAC


def sac_parts(ctx, cfg, obs_space, act_space) -> SACParts:
    """SAC's agent, optimizers and captured update over the vector keys."""
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    if not mlp_keys:
        raise ValueError("SAC reads vector observations only: set algo.mlp_keys.encoder")
    act_dim = action_dim(act_space)
    agent = build_agent(ctx, act_space, obs_space, cfg)
    update, _, opt_states = make_sac_update(agent, cfg, act_dim)
    return SACParts(
        agent=agent,
        opt_states=opt_states,
        obs_spec=((vector_dim(obs_space, mlp_keys),), np.float32),
        to_rows=lambda o: vector_rows(o, mlp_keys),
        policy=lambda rows, gen: sample_tanh(agent.actor, rows, gen),
        greedy=lambda rows: torch.tanh(agent.actor(rows)[0]),
        make_step=make_sac_step_factory(agent, update, opt_states, cfg.algo.per_rank_batch_size, act_dim, ctx.rng()),
        target_update_freq=max(int(cfg.algo.critic.get("target_network_frequency", 1)), 1),
    )


@torch.no_grad()
def sample_tanh(actor, rows: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    mean, log_std = actor(rows)
    return actor.dist(mean, log_std).sample(generator=generator)


@register_algorithm(name="sac")
def main(ctx, cfg) -> TrainResult:
    return run_sac_loop(ctx, cfg, sac_parts, pipelined=True)
