"""Recurrent PPO training (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``).

The rollout carries the sequence model's state per env (reset at episode starts; the
attention model's window also at every rollout's start). The update runs BPTT over the
fixed ``[rollout_steps, num_envs]`` sequences from the rollout's initial state, in
minibatches of whole env sequences: ``update_epochs`` permutations of the envs, each
cut into ``per_rank_num_batches`` minibatches. The minibatch step is captured once
(``ppo.MinibatchUpdate``; eager on the CPU) and replayed per minibatch with its env
indices written in place. As in the reference, the policy and value losses are means
whatever ``loss_reduction`` says (the entropy's follows it), the entropy term takes the
config's ``ent_coef`` (its annealed value is unused), no schedule anneals the learning
rate, and the loop acts synchronously.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.loop_common import TrainResult
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.ppo import (
    CapturedGAE,
    MinibatchUpdate,
    PPOFamilyLoop,
    Rollout,
    annealed_coefs,
    make_optimizer,
    refuse_ppo_unported,
    stack_metrics,
    update_agent,
)
from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, TestResult, env_actions, log_prob_and_entropy, prepare_obs, sample_actions
from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, make_zero_state
from sheeprl_tpu_torch.obs.health import health_enabled, module_slices
from sheeprl_tpu_torch.utils.graphs import tree_tensors
from sheeprl_tpu_torch.utils.metric import record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.utils import normalize_tensor

def onehot_actions(act: np.ndarray, action_dims: Sequence[int], is_continuous: bool) -> np.ndarray:
    """The previous action as the sequence model reads it: one-hot per discrete head
    (concatenated), or the continuous action."""
    if is_continuous:
        return act.astype(np.float32)
    acts = act.reshape(act.shape[0], -1).astype(int)
    return np.concatenate([np.eye(d, dtype=np.float32)[acts[:, i]] for i, d in enumerate(action_dims)], -1)


class RecurrentPPOTrainFns:
    """Recurrent PPO's act and update functions over ``agent``'s parameters and the
    optimizer state ``opt_state`` (the reference's ``make_ppo_recurrent_train_fn`` and
    its jitted act and GAE functions)."""

    def __init__(self, ctx, agent, cfg, obs_keys: Sequence[str], capture: bool = True):
        num_envs = cfg.env.num_envs
        self.num_batches = max(int(cfg.algo.per_rank_num_batches), 1)
        if num_envs % self.num_batches != 0:
            raise ValueError(
                f"env.num_envs ({num_envs}) must be divisible by algo.per_rank_num_batches "
                f"({self.num_batches}): every sequence minibatch of the captured update has the same shape."
            )
        self.agent, self.cfg, self.obs_keys, self.capture = agent, cfg, list(obs_keys), capture
        self.device, self.num_envs = ctx.device, num_envs
        self.mb_envs = num_envs // self.num_batches
        self.grad_steps_per_update = cfg.algo.update_epochs * self.num_batches
        self.opt = make_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm)
        self.params = list(agent.parameters())
        self.opt_state = self.opt.init(self.params)
        self.gae_fn = CapturedGAE(cfg)
        self._update: Optional[MinibatchUpdate] = None
        self.health_slices = module_slices(agent, {"actor_heads": "actor_heads_{}"}) if health_enabled(cfg) else None
        self.metric_names = list(self.LOSSES)

    @torch.no_grad()
    def act(self, obs, prev_actions, is_first, state, generator=None, draws=None):
        """``(env_actions, logprob, value, new_state)`` of one env step."""
        actor_out, value, new_state = self.agent.step(obs, prev_actions, is_first, state)
        env_act, _, logprob = sample_actions(actor_out, self.agent.is_continuous, generator=generator, draws=draws)
        return env_act, logprob, value[..., 0], new_state

    LOSSES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")

    def loss(self, batch: Dict[str, torch.Tensor], initial_state, clip_coef) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        algo = self.cfg.algo
        actor_out, values = self.agent({k: batch[k] for k in self.obs_keys}, batch["prev_actions"], batch["is_first"], initial_state)
        logprob, entropy = log_prob_and_entropy(actor_out, batch["actions"], self.agent.is_continuous)
        adv = normalize_tensor(batch["advantages"]) if algo.normalize_advantages else batch["advantages"]
        pg = policy_loss(logprob, batch["logprobs"], adv, clip_coef, "mean")
        vf = value_loss(values[..., 0], batch["values"], batch["returns"], clip_coef, algo.clip_vloss, "mean")
        ent = entropy_loss(entropy, algo.loss_reduction)
        aux = {"policy_entropy": entropy.mean(), "value_mean": values.mean()} if self.health_slices is not None else {}
        return pg + algo.vf_coef * vf + algo.ent_coef * ent, torch.stack([pg, vf, -ent]).detach(), aux

    def minibatch_step(self, data: Dict[str, torch.Tensor], idx: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
        batch = {k: v[:, idx] for k, v in data.items() if k not in ("c0", "h0")}
        total, metrics, aux = self.loss(batch, (data["c0"][idx], data["h0"][idx]), coefs[0])
        health = update_agent(self.opt, self.params, self.opt_state, total, self.health_slices, aux)
        return stack_metrics(self, self.LOSSES, metrics, health)

    def permutations(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        """``[update_epochs, num_envs]``: one permutation of the envs per epoch."""
        return torch.stack([
            torch.randperm(self.num_envs, generator=generator, device=self.device) for _ in range(self.cfg.algo.update_epochs)
        ])

    def train_fn(self, seq_data: Dict[str, torch.Tensor], c0: torch.Tensor, h0: torch.Tensor, perms: torch.Tensor, clip_coef: float, ent_coef: float) -> Dict[str, float]:
        """One update over ``seq_data`` (``[T, num_envs, ...]`` per key) from the initial
        state ``(c0, h0)`` in the env minibatches of ``perms`` (``[update_epochs,
        num_envs]``). Returns the mean losses."""
        data = {**seq_data, "c0": c0, "h0": h0}
        if self._update is None:
            state = self.params + tree_tensors(self.opt_state)
            self._update = MinibatchUpdate(self.minibatch_step, data, (self.mb_envs,), state, self.capture, "ppo_recurrent/train_fn")
        coefs = torch.tensor([clip_coef, ent_coef], dtype=torch.float32)
        out = self._update(data, perms.reshape(-1, self.mb_envs), coefs).cpu()
        return dict(zip(self.metric_names, out.tolist()))


def test(agent, ctx, cfg, log_dir: str, greedy: bool = True) -> TestResult:
    """One greedy single-env evaluation episode, the sequence model's state carried."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, log_dir, "test")()
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    device, gen = ctx.device, ctx.rng()
    state = make_zero_state(cfg, device)(1)
    prev = torch.zeros((1, int(sum(agent.action_dims))), device=device)
    is_first = torch.ones((1, 1), device=device)
    obs, _ = env.reset(seed=cfg.seed)
    done, cum_reward, steps = False, 0.0, 0
    start = time.perf_counter()
    try:
        while not done:
            with torch.no_grad():
                obs_t = prepare_obs({k: np.asarray(v)[None] for k, v in obs.items()}, cnn_keys, mlp_keys, device)
                actor_out, _, state = agent.step(obs_t, prev, is_first, state)
                act = sample_actions(actor_out, agent.is_continuous, greedy, gen)[0].cpu().numpy()
            prev = torch.as_tensor(onehot_actions(act, agent.action_dims, agent.is_continuous), device=device)
            is_first = torch.zeros((1, 1), device=device)
            if agent.is_continuous:
                env_action = act[0]
            elif len(agent.action_dims) == 1:
                env_action = int(act[0, 0])
            else:
                env_action = act[0]
            obs, reward, terminated, truncated, _ = env.step(env_action)
            done = bool(terminated or truncated)
            cum_reward += float(reward)
            steps += 1
    finally:
        env.close()
    return TestResult(cum_reward, steps, time.perf_counter() - start)


@register_algorithm(name="ppo_recurrent")
def main(ctx, cfg) -> TrainResult:
    refuse_ppo_unported(cfg, pipelined=False)
    precision = str(cfg.algo.get("precision", "mesh") or "mesh")
    if precision != "mesh":
        raise NotImplementedError(
            f"algo.precision={precision}: recurrent PPO computes in mesh.precision's dtype, as the reference's does"
        )
    device = ctx.device
    loop = PPOFamilyLoop(ctx, cfg, AGGREGATOR_KEYS, phases=("dispatch",))
    envs = loop.envs
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        obs_keys = cnn_keys + mlp_keys
        agent = build_agent(ctx, act_space, obs_space, cfg)
        is_continuous, action_dims = agent.is_continuous, agent.action_dims
        act_sum = int(sum(action_dims))
        fns = RecurrentPPOTrainFns(ctx, agent, cfg, obs_keys)
        loop.resume(agent, fns.opt_state)
        num_envs, T = cfg.env.num_envs, cfg.algo.rollout_steps
        n_act = action_dims[0] if is_continuous else len(action_dims)
        rollout = Rollout(T, num_envs, obs_space, cnn_keys, mlp_keys, device, {
            "actions": (n_act,), "prev_actions": (act_sum,), "is_first": (1,), "logprobs": (), "values": (), "rewards": (), "dones": (),
        })
        player_gen, train_gen = ctx.rng(), ctx.rng()
        zero_state = make_zero_state(cfg, device)
        is_attention = cfg.algo.get("sequence_model", "lstm") == "attention"
        state = zero_state(num_envs)
        prev_stored = np.zeros((num_envs, act_sum), dtype=np.float32)
        is_first_np = np.ones((num_envs, 1), dtype=np.float32)
        dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731

        obs, _ = envs.reset(seed=cfg.seed)
        grad_steps, train_seconds, env_seconds = 0, 0.0, 0.0
        run_start = time.perf_counter()
        for update in range(loop.start_update, loop.num_updates + 1):
            loop.monitor.advance()
            if is_attention:  # the attention context never crosses a rollout's start
                state = zero_state(num_envs)
            c0, h0 = state
            env_t0 = time.perf_counter()
            with loop.timer("Time/env_interaction_time"):
                for t in range(T):
                    obs_t = rollout.put_obs(t, obs)
                    env_act, logprob, value, state = fns.act(obs_t, dev(prev_stored), dev(is_first_np), state, player_gen)
                    act_np = env_act.cpu().numpy()
                    next_obs, reward, terminated, truncated, info = envs.step(env_actions(act_np, is_continuous, action_dims, act_space))
                    done = np.logical_or(terminated, truncated)
                    reward = np.asarray(reward, dtype=np.float32).reshape(num_envs)
                    # V(final obs) under the new state, with this step's previous action (an env
                    # that the env pool restarted has no final observation and no bootstrap)
                    idx = np.nonzero(truncated & info["_final_obs"])[0] if "final_obs" in info else np.zeros(0, np.int64)
                    if idx.size:
                        final_obs = {k: np.stack([np.asarray(info["final_obs"][i][k]) for i in idx]) for k in obs_keys}
                        sub_state = tuple(s[dev(idx)] for s in state)
                        _, _, v_final, _ = fns.act(prepare_obs(final_obs, cnn_keys, mlp_keys, device), dev(prev_stored[idx]),
                                                   torch.zeros((len(idx), 1), device=device), sub_state, player_gen)
                        reward[idx] += cfg.algo.gamma * v_final.float().cpu().numpy()
                    host = rollout.host
                    host["actions"][t] = act_np.reshape(num_envs, -1)
                    host["prev_actions"][t], host["is_first"][t] = prev_stored, is_first_np
                    host["logprobs"][t], host["values"][t] = logprob.float().cpu().numpy(), value.float().cpu().numpy()
                    host["rewards"][t], host["dones"][t] = reward, done
                    prev_stored = onehot_actions(act_np, action_dims, is_continuous)
                    prev_stored[done] = 0.0
                    is_first_np = done.astype(np.float32).reshape(num_envs, 1)
                    obs = next_obs
                    loop.policy_step += num_envs
                    record_episode_stats(loop.aggregator, info)
            env_time = time.perf_counter() - env_t0
            env_seconds += env_time

            train_t0 = time.perf_counter()
            with loop.timer("Time/train_time"), loop.monitor.phase("dispatch"):
                local = rollout.tensors()
                obs_t = prepare_obs(obs, cnn_keys, mlp_keys, device)
                next_value = fns.act(obs_t, dev(prev_stored), dev(is_first_np), state, player_gen)[2]
                returns, advantages = fns.gae_fn(local["rewards"][..., None], local["values"][..., None], local["dones"][..., None], next_value[:, None])
                seq_data = {k: local[k] for k in (*obs_keys, "actions", "prev_actions", "is_first", "logprobs", "values")}
                seq_data["returns"], seq_data["advantages"] = returns[..., 0], advantages[..., 0]
                train_metrics = fns.train_fn(seq_data, c0, h0, fns.permutations(train_gen), *annealed_coefs(cfg, update, loop.num_updates))
            train_time = time.perf_counter() - train_t0
            train_seconds += train_time
            grad_steps += fns.grad_steps_per_update
            for k, v in train_metrics.items():
                loop.aggregator.update(k, v)
            loop.end_update(update, agent, fns.opt_state, lambda: {
                "Time/sps_train": fns.grad_steps_per_update / train_time if train_time > 0 else 0.0,
                "Time/sps_env_interaction": loop.policy_steps_per_iter / env_time if env_time > 0 else 0.0,
            })
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        loop.close()
    seconds = time.perf_counter() - run_start
    return loop.finish(lambda: test(agent, ctx, cfg, loop.log_dir).reward, grad_steps, seconds, train_seconds, env_seconds)
