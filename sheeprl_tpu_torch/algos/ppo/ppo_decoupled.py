"""Decoupled PPO (counterpart of ``sheeprl_tpu/algos/ppo/ppo_decoupled.py``). In its
default ``distributed.mode=thread`` the player and the learner run as two threads of one
process, each launching on a CUDA stream of its own (``algos/decoupled.py``); with
``distributed.mode=sebulba`` they run as placed processes (``distributed/sebulba.py``).

* **The player** (``PlayerThread``) runs the coupled loop's rollout (``ppo.py::
  PPOActing`` at depth 0, with draws of its own): the truncation bootstrap, then GAE on
  the device, and queues the batch with an event recorded on its stream after it
  (``publish.handoff``). Then it waits for the learner's publication of the update that
  batch feeds, and its stream waits on the publication's event, before it acts again.
* **The learner** (the calling thread, on its own stream) waits on the batch's event,
  anneals ``clip_coef`` and ``ent_coef``, launches the coupled entry's captured update
  (``PPOTrainFns.launch_update``), publishes, and only then reads the losses back, so
  the player's next rollout overlaps the host's part of the update. It logs
  ``Time/sps_train``, ``Time/sps_env_interaction``, ``Params/lr`` and
  ``Sebulba/param_staleness_steps``, writes the coupled entry's checkpoints and ends
  each update at the training guard's boundary (``PPOFamilyLoop.end_update``).

Why the player acts on the learner's parameters, which the captured update overwrites
in place, without a copy: the two roles alternate, and events order them on the card.
The player reads the parameters only between its stream's wait on publication k (an
event recorded on the learner's stream after update k) and the event it records after
rollout k + 1's batch, on which the learner's stream waits before update k + 1. So no
update runs while the player reads them, and no rollout acts on a half-written update.
A publication therefore carries no tensors, only its event and stamp.

Against the reference's coupled entry, the reference's decoupled one computes the same
update from the same rollout; it differs in where the draws come from (its player's
own key chain) and in what it logs (``Sebulba/param_staleness_steps``; neither logs the
``Rollout/*`` counters of an env pool). Not ported: strict mode (refused).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any

import torch

from sheeprl_tpu_torch.algos.decoupled import PlayerThread, on_stream, player_generator, role_stream, run_placed
from sheeprl_tpu_torch.algos.loop_common import TrainResult, decoupled_handled
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.ppo import PPOActing, PPOFamilyLoop, PPOTrainFns, annealed_coefs, refuse_ppo_unported
from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, test
from sheeprl_tpu_torch.distributed.placement import placement_from_cfg
from sheeprl_tpu_torch.distributed.publish import evict_and_put, handoff, make_stamp, receive, staleness_steps
from sheeprl_tpu_torch.distributed.transport import maybe_digest
from sheeprl_tpu_torch.utils.metric import record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm


@register_algorithm(name="ppo_decoupled", decoupled=True)
def main(ctx, cfg) -> TrainResult:
    # a memmapped rollout among them, as the coupled entry
    refuse_ppo_unported(cfg, pipelined=False, handled=decoupled_handled(cfg))
    spec = placement_from_cfg(cfg)
    if spec.is_sebulba:  # placed processes (distributed/sebulba.py)
        return run_placed(ctx, cfg, spec, "ppo")
    device = ctx.device
    agg_lock = threading.Lock()  # the player records episode stats, the learner reads and resets
    loop = PPOFamilyLoop(ctx, cfg, AGGREGATOR_KEYS, agg_lock, phases=("dispatch",))
    envs = loop.envs
    player = None
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
        agent = build_agent(ctx, act_space, obs_space, cfg)
        fns = PPOTrainFns(ctx, agent, cfg, obs_keys, loop.num_updates)
        loop.resume(agent, fns.opt_state)
        train_gen = ctx.rng()
        param_q: "queue.Queue[Any]" = queue.Queue(maxsize=2)
        num_envs = int(cfg.env.num_envs)

        def play(thread: PlayerThread) -> None:
            """The env-facing role (the reference's ``player()``)."""
            acting = PPOActing(cfg, fns, envs, player_generator(cfg, device))
            policy_step, stamp = loop.policy_step, None

            def on_step(info):
                nonlocal policy_step
                policy_step += num_envs
                with agg_lock:
                    record_episode_stats(loop.aggregator, info)

            obs, _ = envs.reset(seed=cfg.seed)
            for update in range(loop.start_update, loop.num_updates + 1):
                if thread.stop.is_set():
                    return
                env_t0 = time.perf_counter()
                with loop.timer("Time/env_interaction_time"):
                    obs = acting.collect(obs, on_step)
                env_time = time.perf_counter() - env_t0
                data = acting.batch(obs)
                item = {"update": update, "data": data, "ready": handoff(list(data.values()), device), "policy_step": policy_step,
                        "env_time": env_time, "staleness": staleness_steps(stamp, policy_step)}
                if not thread.put(item):
                    return
                # the update this batch feeds, before acting again (the reference's wait)
                pub = thread.get_from(param_q)
                if pub is None:
                    return
                receive(pub, device)
                stamp = pub.stamp

        player = PlayerThread("ppo-player", play, device)
        learner_stream = role_stream(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # both streams start after the setup's work
        grad_steps, train_seconds, env_seconds = 0, 0.0, 0.0
        run_start = time.perf_counter()
        player.start()
        with on_stream(learner_stream):
            for update in range(loop.start_update, loop.num_updates + 1):
                loop.monitor.advance()
                item = player.take()
                receive(item["ready"], device)
                data = item["data"]
                maybe_digest(f"ppo:{item['update']}", data)
                loop.policy_step, env_time = item["policy_step"], item["env_time"]
                env_seconds += env_time
                if item["staleness"] is not None:
                    with agg_lock:
                        loop.aggregator.update("Sebulba/param_staleness_steps", float(item["staleness"]))
                train_t0 = time.perf_counter()
                with loop.timer("Time/train_time"), loop.monitor.phase("dispatch"):
                    losses = fns.launch_update(data, fns.permutations(train_gen), *annealed_coefs(cfg, update, loop.num_updates))
                    stamp = make_stamp(update, update * fns.grad_steps_per_update, loop.policy_step)
                    evict_and_put(param_q, handoff([], device, stamp))
                    train_metrics = fns.losses(losses)
                train_time = time.perf_counter() - train_t0
                train_seconds += train_time
                grad_steps += fns.grad_steps_per_update
                with agg_lock:
                    for k, v in train_metrics.items():
                        loop.aggregator.update(k, v)
                loop.end_update(update, agent, fns.opt_state, lambda: {
                    "Time/sps_train": fns.grad_steps_per_update / train_time if train_time > 0 else 0.0,
                    "Time/sps_env_interaction": loop.policy_steps_per_iter / env_time if env_time > 0 else 0.0,
                    "Params/lr": fns.lr_at(update * fns.grad_steps_per_update),
                })
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - run_start
    finally:
        if player is not None:
            player.close()
        loop.monitor.close()
        if player is None or not player.alive:  # a player stuck in envs.step keeps them
            envs.close()
    player.check_closed()
    return loop.finish(lambda: test(agent, ctx, cfg, loop.log_dir).reward, grad_steps, seconds, train_seconds, env_seconds)
