"""A2C (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``): the PPO agent and rollout,
and one full-batch gradient step per rollout with ``algo.loss_reduction`` (``sum`` in
the config) and the ``rmsprop_tf`` optimizer. The step is captured once as a CUDA graph
(``ppo.MinibatchUpdate``; eager on the CPU) over the whole rollout, one replay per
update. The loop acts synchronously, as the reference's does."""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.loop_common import TrainResult, grads
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import (
    CapturedGAE,
    MinibatchUpdate,
    PPOFamilyLoop,
    Rollout,
    flat_batch,
    make_optimizer,
    refuse_ppo_unported,
    truncation_bootstrap,
)
from sheeprl_tpu_torch.algos.ppo.utils import env_actions, log_prob_and_entropy, prepare_obs, sample_actions, test
from sheeprl_tpu_torch.utils.graphs import tree_tensors
from sheeprl_tpu_torch.utils.metric import record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import normalize_tensor

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}


class A2CTrainFns:
    """A2C's act, value, GAE and update functions over ``agent``'s parameters and the
    optimizer state ``opt_state`` (the reference's ``make_a2c_train_fn`` and its jitted
    act, value and GAE functions). The reference casts no observation to the compute
    dtype here; its layers do."""

    def __init__(self, ctx, agent, cfg, obs_keys: Sequence[str], capture: bool = True):
        self.agent, self.cfg, self.obs_keys, self.capture = agent, cfg, list(obs_keys), capture
        self.batch_n = cfg.algo.rollout_steps * cfg.env.num_envs
        self.opt = make_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm)
        self.params = list(agent.parameters())
        self.opt_state = self.opt.init(self.params)
        self._update = None
        self.gae_fn = CapturedGAE(cfg)
        self._rows = torch.arange(self.batch_n, device=ctx.device)[None]

    @torch.no_grad()
    def act(self, obs: Dict[str, torch.Tensor], generator=None, draws=None):
        actor_out, value = self.agent(obs)
        env_act, stored, logprob = sample_actions(actor_out, self.agent.is_continuous, generator=generator, draws=draws)
        return env_act, stored, logprob, value[..., 0]

    @torch.no_grad()
    def values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.agent(obs)[1][..., 0]

    def loss(self, data: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        algo, reduction = self.cfg.algo, self.cfg.algo.loss_reduction
        actor_out, new_values = self.agent({k: data[k] for k in self.obs_keys})
        logprob, entropy = log_prob_and_entropy(actor_out, data["actions"], self.agent.is_continuous)
        adv = normalize_tensor(data["advantages"]) if algo.normalize_advantages else data["advantages"]
        obj = logprob * adv
        pg = -(obj.mean() if reduction == "mean" else obj.sum())
        vf = value_loss(new_values[..., 0], data["values"], data["returns"], 0.0, False, reduction)
        total = pg + algo.vf_coef * vf + algo.ent_coef * entropy_loss(entropy, reduction)
        return total, torch.stack([pg, vf]).detach()

    def step(self, data: Dict[str, torch.Tensor], idx: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
        total, metrics = self.loss({k: v[idx] for k, v in data.items()})
        self.opt.update(self.params, grads(total, self.params), self.opt_state)
        return metrics

    def train_fn(self, data: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One full-batch gradient step over ``data`` (``[N, ...]`` per key)."""
        if self._update is None:
            state = self.params + tree_tensors(self.opt_state)
            self._update = MinibatchUpdate(self.step, data, (self.batch_n,), state, self.capture)
        out = self._update(data, self._rows, torch.zeros(2)).cpu()
        return dict(zip(("Loss/policy_loss", "Loss/value_loss"), out.tolist()))


@register_algorithm(name="a2c")
def main(ctx, cfg) -> TrainResult:
    refuse_ppo_unported(cfg, pipelined=False)
    device = ctx.device
    loop = PPOFamilyLoop(ctx, cfg, AGGREGATOR_KEYS)
    envs = loop.envs
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        obs_keys = cnn_keys + mlp_keys
        agent = build_agent(ctx, act_space, obs_space, cfg)
        is_continuous, action_dims = agent.is_continuous, agent.action_dims
        fns = A2CTrainFns(ctx, agent, cfg, obs_keys)
        loop.resume(agent, fns.opt_state)
        num_envs, T = cfg.env.num_envs, cfg.algo.rollout_steps
        n_act = action_dims[0] if is_continuous else len(action_dims)
        rollout = Rollout(T, num_envs, obs_space, cnn_keys, mlp_keys, device, {"actions": (n_act,), "values": (), "rewards": (), "dones": ()})
        player_gen = ctx.rng()

        def host_values(o):
            return fns.values(prepare_obs(o, cnn_keys, mlp_keys, device)).float().cpu().numpy()

        obs, _ = envs.reset(seed=cfg.seed)
        grad_steps, train_seconds, env_seconds = 0, 0.0, 0.0
        run_start = time.perf_counter()
        for update in range(loop.start_update, loop.num_updates + 1):
            env_t0 = time.perf_counter()
            with loop.timer("Time/env_interaction_time"):
                for t in range(T):
                    env_act, _, _, value = fns.act(rollout.put_obs(t, obs), player_gen)
                    act_np = env_act.cpu().numpy()
                    next_obs, reward, terminated, truncated, info = envs.step(env_actions(act_np, is_continuous, action_dims, act_space))
                    reward = np.asarray(reward, dtype=np.float32).reshape(num_envs)
                    boot = truncation_bootstrap(info, truncated, obs_keys, host_values)
                    if boot is not None:
                        reward[boot[0]] += cfg.algo.gamma * boot[1]
                    host = rollout.host
                    host["actions"][t] = act_np.reshape(num_envs, -1)
                    host["values"][t] = value.float().cpu().numpy()
                    host["rewards"][t] = reward
                    host["dones"][t] = np.logical_or(terminated, truncated)
                    obs = next_obs
                    loop.policy_step += num_envs
                    record_episode_stats(loop.aggregator, info)
            env_time = time.perf_counter() - env_t0
            env_seconds += env_time

            train_t0 = time.perf_counter()
            with loop.timer("Time/train_time"):
                local = rollout.tensors()
                next_value = fns.values(prepare_obs(obs, cnn_keys, mlp_keys, device))[:, None]
                returns, advantages = fns.gae_fn(local["rewards"][..., None], local["values"][..., None], local["dones"][..., None], next_value)
                train_metrics = fns.train_fn(flat_batch(local, returns, advantages, [*obs_keys, "actions", "values"]))
            train_time = time.perf_counter() - train_t0
            train_seconds += train_time
            grad_steps += 1
            for k, v in train_metrics.items():
                loop.aggregator.update(k, v)
            loop.end_update(update, agent, fns.opt_state, lambda: {
                "Time/sps_train": 1.0 / train_time if train_time > 0 else 0.0,
                "Time/sps_env_interaction": loop.policy_steps_per_iter / env_time if env_time > 0 else 0.0,
            })
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        envs.close()
    seconds = time.perf_counter() - run_start
    return loop.finish(lambda: test(agent, ctx, cfg, loop.log_dir).reward, grad_steps, seconds, train_seconds, env_seconds)
