"""Decoupled SAC (counterpart of ``sheeprl_tpu/algos/sac/sac_decoupled.py``). In its
default ``distributed.mode=thread`` the player and the learner run as two threads of one
process, each launching on a CUDA stream of its own (``algos/decoupled.py``); with
``distributed.mode=sebulba`` they run as placed processes (``distributed/sebulba.py``).

* **The player** (``PlayerThread``) steps the envs and owns the replay buffer and the
  ``Ratio``. It acts on its own copy of the actor, seeded draws of its own, and adopts,
  without blocking, the newest publication whose copy has finished on the card
  (``publish.ready``; they finish in the order of the learner's stream), newer ones
  waiting for a later iteration. Once the governor grants
  gradient steps it samples them after this iteration's rows landed: the ``[G, B, ...]``
  block on the host, or with ``buffer.device=True`` the ``[G, B]`` (env, row) indices of
  the device ring, drawn as the host buffer draws them (the reference samples inside
  its jitted step; here ``rb`` is never read outside the player). Each item carries the
  iteration's counters, the staleness of the parameters it acted with and, at the
  checkpoint cadence, a snapshot of ``ratio`` and (``buffer.checkpoint``) of ``rb``.
* **The ring** (``buffer.device=True``): the player writes each row on a write stream of
  its own, the learner's blocks read the ring on the learner's stream, and a
  ``StreamFence`` orders the two on the card: a block waits for the writes queued
  before it (its item's rows among them), a write for the blocks queued before it, so
  no block reads a row that is half written. The acting stream never waits for a block.
* **The learner** (the calling thread, on its own stream) replays SAC's captured step
  as a block per item (the coupled entry's update: ``sac.py::sac_parts``), publishes a
  copy of the actor (``publish.publish``: the copy and an event on the learner's stream),
  drains the metrics at the log cadence and writes the checkpoints in the reference's
  layout, ``rb`` only from the player's snapshot.

Not ported: the reference's training guard and its emergency save (``fault.autoresume``
is refused), its flight recorder, strict mode and monitor (refused).
"""

from __future__ import annotations

import copy
import os
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from sheeprl_tpu_torch.algos.decoupled import PlayerThread, StreamFence, on_stream, player_generator, role_stream, run_placed
from sheeprl_tpu_torch.algos.dreamer_loop import load_opt_states
from sheeprl_tpu_torch.algos.loop_common import TrainResult, decoupled_handled, refuse_unported
from sheeprl_tpu_torch.algos.sac.agent import action_dim
from sheeprl_tpu_torch.algos.sac.sac import sac_parts, sample_tanh
from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, env_actions, test
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import save_config
from sheeprl_tpu_torch.data.buffers import ReplayBuffer, to_device
from sheeprl_tpu_torch.data.device_buffer import make_transition_dispatcher
from sheeprl_tpu_torch.distributed.placement import placement_from_cfg
from sheeprl_tpu_torch.distributed.publish import adopt, evict_and_put, make_stamp, publish, staleness_steps, take_newest_ready
from sheeprl_tpu_torch.distributed.transport import maybe_digest
from sheeprl_tpu_torch.rollout import PipelinedPlayer
from sheeprl_tpu_torch.utils.env import make_vector_env
from sheeprl_tpu_torch.obs import TrainingMonitor
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import make_aggregator, record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import Timer
from sheeprl_tpu_torch.utils.utils import Ratio

MAX_PENDING = 8  # unfinished publications the player keeps (a backlog on the learner's stream)


@register_algorithm(name="sac_decoupled", decoupled=True)
def main(ctx, cfg) -> TrainResult:
    refuse_unported(cfg, handled=decoupled_handled(cfg))
    spec = placement_from_cfg(cfg)
    if spec.is_sebulba:  # placed processes (distributed/sebulba.py)
        return run_placed(ctx, cfg, spec, "sac")
    device = ctx.device
    log_dir = get_log_dir(cfg)
    save_config(cfg, Path(log_dir) / "config.yaml")
    logger = get_logger(cfg, log_dir)
    timer = Timer(disabled=bool(cfg.metric.get("disable_timer", False)))
    monitor = TrainingMonitor(cfg, log_dir, timer, device, phases=("dispatch",))
    envs = make_vector_env(cfg, cfg.seed, 0, log_dir if cfg.env.capture_video else None)
    player = None
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        act_dim = action_dim(act_space)
        parts = sac_parts(ctx, cfg, obs_space, act_space)
        agent, opt_states = parts.agent, parts.opt_states
        num_envs = int(cfg.env.num_envs)
        batch_size = int(cfg.algo.per_rank_batch_size)
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
        ring, dispatcher = make_transition_dispatcher(ctx, cfg, rb, specs, parts.make_step, parts.target_update_freq, parts.count_offset)
        aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
        aggregator.keep(set(AGGREGATOR_KEYS) | set(cfg.metric.aggregator.get("metrics", {})))
        agg_lock = threading.Lock()  # the player records episode stats, the learner reads and resets
        ckpt_manager = CheckpointManager(Path(log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
        ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)

        num_iters = max(int(cfg.algo.total_steps) // num_envs, 1) if not cfg.dry_run else 1
        learning_starts = int(cfg.algo.learning_starts) // num_envs if not cfg.dry_run else 0
        prefill_iters = max(learning_starts - 1, 0)
        start_iter, policy_step0, last_log, last_checkpoint, grad_count = 1, 0, 0, 0, 0
        resumed = bool(cfg.checkpoint.get("resume_from"))
        if resumed:
            state = CheckpointManager.load(cfg.checkpoint.resume_from)
            agent.load_state_dict(state["params"])
            load_opt_states(opt_states, state["opt_state"])
            ratio.load_state_dict(state["ratio"])
            start_iter = state["iter_num"] + 1
            policy_step0 = state["policy_step"]
            last_log = state.get("last_log", 0)
            last_checkpoint = state.get("last_checkpoint", 0)
            grad_count = state.get("cumulative_grad_steps", 0)
            learning_starts += start_iter
            if cfg.buffer.checkpoint and "rb" in state:
                rb.load_state_dict(state["rb"])
                if ring is not None and len(rb) > 0:
                    ring.load_from_dense({k: rb._buf[k] for k in specs})
                    ring.load_stamps(rb)
        start_grad_count, last_path = grad_count, None

        # the player's own actor: the learner's captured step updates agent.actor in place
        player_actor = copy.deepcopy(agent.actor).requires_grad_(False)
        param_q: "queue.Queue[Any]" = queue.Queue(maxsize=2)
        fence = StreamFence()
        low, high = act_space.low, act_space.high
        rescale = np.isfinite(low).all() and np.isfinite(high).all()

        def play(thread: PlayerThread) -> None:
            """The env and buffer role (the reference's ``player()``)."""
            gen = player_generator(cfg, device)
            acting = PipelinedPlayer(envs, lambda rows: (sample_tanh(player_actor, rows, gen),),
                                     lambda fetched: (env_actions(fetched[0], act_space), fetched[0]))
            own = list(player_actor.parameters())
            write_stream = role_stream(device)
            stamp, pending = None, []
            policy_step, last_ckpt = policy_step0, last_checkpoint
            obs, _ = envs.reset(seed=cfg.seed)
            for iter_num in range(start_iter, num_iters + 1):
                if thread.stop.is_set():
                    return
                try:  # the publications since the last adoption, oldest first
                    while True:
                        pending.append(param_q.get_nowait())
                except queue.Empty:
                    pass
                del pending[:-MAX_PENDING]
                pub = take_newest_ready(pending)
                if pub is not None:
                    adopt(pub, own)
                    stamp = pub.stamp
                env_t0 = time.perf_counter()
                with timer("Time/env_interaction_time"):
                    if iter_num <= learning_starts and not resumed:
                        actions = np.stack([act_space.sample() for _ in range(num_envs)])
                        tanh_actions = 2 * (actions - low) / (high - low) - 1 if rescale else actions
                    else:
                        actions, tanh_actions = acting.act(torch.from_numpy(parts.to_rows(obs)).to(device))
                    next_obs, reward, terminated, truncated, info = envs.step(actions)
                    done = np.logical_or(terminated, truncated)
                    real_next = {k: np.asarray(v).copy() for k, v in next_obs.items()}
                    if done.any() and "final_obs" in info:
                        for i in np.nonzero(done)[0]:
                            if info["final_obs"][i] is not None:
                                for k in real_next:
                                    real_next[k][i] = np.asarray(info["final_obs"][i][k])
                    data = {
                        "obs": parts.to_rows(obs)[None],
                        "next_obs": parts.to_rows(real_next)[None],
                        "actions": np.asarray(tanh_actions, np.float32).reshape(1, num_envs, -1),
                        "rewards": np.asarray(reward, np.float32).reshape(1, num_envs, 1),
                        # a truncated episode still bootstraps: dones is the termination
                        "dones": np.asarray(terminated, np.float32).reshape(1, num_envs, 1),
                    }
                    if ring is not None:
                        with fence.hold(write_stream):
                            ring.add_step(data, rb._pos)
                    rb.add(data, validate_args=cfg.buffer.validate_args)
                    obs = next_obs
                    policy_step += num_envs
                    with agg_lock:
                        record_episode_stats(aggregator, info)
                env_time = time.perf_counter() - env_t0

                grad_steps, block = 0, None
                if iter_num >= learning_starts:
                    # offset by the prefill, as the coupled loop; a resume can make it negative
                    grad_steps = max(ratio(policy_step - prefill_iters * num_envs), 0)
                    if grad_steps > 0:
                        block = rb.sample_idx(batch_size, grad_steps) if ring is not None else rb.sample(batch_size, n_samples=grad_steps)
                snapshot = None
                if (cfg.checkpoint.every > 0 and policy_step - last_ckpt >= cfg.checkpoint.every) or (
                    iter_num == num_iters and cfg.checkpoint.save_last
                ):
                    snapshot = {"ratio": ratio.state_dict()}
                    if cfg.buffer.checkpoint:
                        snapshot["rb"] = rb.state_dict()
                    last_ckpt = policy_step
                item = {"iter_num": iter_num, "grad_steps": grad_steps, "block": block, "policy_step": policy_step,
                        "env_time": env_time, "ckpt": snapshot, "staleness": staleness_steps(stamp, policy_step)}
                if not thread.put(item):
                    return

        player = PlayerThread("sac-player", play, device)
        learner_stream = role_stream(device)
        actor_params = list(agent.actor.parameters())
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # both streams start after the setup's work
        train_seconds, env_seconds, policy_step, publish_seq = 0.0, 0.0, policy_step0, 0
        run_start = time.perf_counter()
        player.start()
        with on_stream(learner_stream):
            for iter_num in range(start_iter, num_iters + 1):
                monitor.advance()
                item = player.take()
                policy_step, env_time, grad_steps = item["policy_step"], item["env_time"], item["grad_steps"]
                env_seconds += env_time
                if item["staleness"] is not None:
                    with agg_lock:
                        aggregator.update("Sebulba/param_staleness_steps", float(item["staleness"]))
                if grad_steps > 0:
                    t0 = time.perf_counter()
                    with timer("Time/train_time"), monitor.phase("dispatch"):
                        if ring is not None:
                            with fence.hold(learner_stream):
                                dispatcher.dispatch(*item["block"], grad_count)
                        else:
                            maybe_digest(f"sac:{item['iter_num']}", item["block"])
                            dispatcher.dispatch(to_device(item["block"], device), grad_count)
                        publish_seq += 1
                        evict_and_put(param_q, publish(actor_params, make_stamp(publish_seq, grad_count + grad_steps, policy_step)))
                    train_seconds += time.perf_counter() - t0
                    grad_count += grad_steps

                if logger is not None and (policy_step - last_log >= cfg.metric.log_every or iter_num == num_iters or cfg.dry_run):
                    with agg_lock:
                        dispatcher.drain(aggregator)
                        metrics = aggregator.compute()
                        aggregator.reset()
                    window_sps = dispatcher.pop_window_sps()
                    if window_sps is not None:
                        metrics["Time/sps_train"] = window_sps
                    metrics["Time/sps_env_interaction"] = num_envs / env_time if env_time > 0 else 0.0
                    metrics["Params/replay_ratio"] = grad_count / policy_step if policy_step > 0 else 0.0
                    monitor.log_metrics(logger, metrics, policy_step)
                    last_log = policy_step

                if item["ckpt"] is not None:
                    state: Dict[str, Any] = {
                        "params": agent.state_dict(),
                        "opt_state": opt_states,
                        "ratio": item["ckpt"]["ratio"],
                        "iter_num": iter_num,
                        "policy_step": policy_step,
                        "last_log": last_log,
                        "last_checkpoint": policy_step,
                        "cumulative_grad_steps": grad_count,
                    }
                    if "rb" in item["ckpt"]:
                        state["rb"] = item["ckpt"]["rb"]
                    last_path = str(ckpt_manager.save(policy_step, state))
                    last_checkpoint = policy_step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - run_start
    finally:
        if player is not None:
            player.close()
        monitor.close()
        if player is None or not player.alive:  # a player stuck in envs.step keeps them
            envs.close()
    player.check_closed()
    test_reward = None
    if cfg.algo.run_test:
        test_reward = test(parts.greedy, parts.to_rows, ctx, cfg, log_dir).reward
        if logger is not None:
            logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step)
    if logger is not None:
        logger.close()
    return TrainResult(log_dir, policy_step, grad_count - start_grad_count, last_path, seconds, train_seconds, env_seconds, test_reward)
