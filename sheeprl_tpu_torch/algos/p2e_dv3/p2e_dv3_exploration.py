"""P2E on DreamerV3, the exploration run (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``): the gradient step
``make_train_step`` and the training entry ``main`` (``algos/dreamer_loop.py::run_loop``).

One call runs, in the reference's order:

1. DreamerV3's world-model update (``dreamer_v3.py::world_model_loss``), with the reward
   and continue heads on latents whose gradient is stopped; the RSSM unroll runs through
   the ``layernorm_gru`` kernels;
2. the ensembles' update: from ``[posterior, recurrent state, action]`` each member
   predicts the next posterior (``algos/p2e::ensemble_loss``, a squared error);
3. the exploration actor, on one imagination of its own: its advantage sums, over the
   exploration critics, ``weight / sum(weights)`` times the advantage normalised by that
   critic's own return moments, each critic's rewards the ensembles' disagreement
   (``intrinsic``) or the reward head's mean (``task``); then each exploration critic,
   with its own loss, Adam state and EMA target;
4. the task actor and critic on a second imagination, as DreamerV3's step.

The return moments are ``{"task": {...}, "expl": {name: {...}}}``. A discrete actor's
objective is REINFORCE on the stopped trajectory, so its imaginations run without
autograd; a continuous actor's gradient crosses both (the GRU backward kernel at ``T *
B`` rows, ``horizon`` times per imagination). Randomness: one ``TrainDraws``, each
imagination with draws of its own.

The reference's step unrolls the coupled RSSM and fails on the decoupled one; the port
refuses ``algo.world_model.decoupled_rssm`` here, naming the key.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_loop import (
    LoopParts,
    TrainResult,
    actor_noise_kind,
    fill_draws,
    grads,
    make_captured_step,
    run_loop,
    sequential_buffer,
    update_module,
    zero_draws,
)
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    critic_loss,
    draw_shapes as dv3_draw_shapes,
    ema_target,
    imagine,
    imagined_continues,
    lambda_returns,
    policy_loss,
    world_model_loss,
)
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, update_moments
from sheeprl_tpu_torch.algos.p2e import acting_actor, ensemble_loss, intrinsic_reward
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, critic_configs, make_player_step
from sheeprl_tpu_torch.algos.p2e_dv3.utils import AGGREGATOR_KEYS
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.distributions import TwoHotEncodingDistribution
from sheeprl_tpu_torch.obs.health import StepHealth, health_enabled
from sheeprl_tpu_torch.utils.registry import register_algorithm

DECOUPLED = "algo.world_model.decoupled_rssm"


class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch, discrete] Gumbel noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch, discrete] ... and of the posteriors
    expl_actor0: Tuple[torch.Tensor, ...]  # the exploration imagination's first action, [T*B, d] per head
    expl_prior: torch.Tensor  # [horizon, T*B, stoch, discrete] its priors
    expl_actor: Tuple[torch.Tensor, ...]  # its actions, [horizon, T*B, d] per head
    task_actor0: Tuple[torch.Tensor, ...]  # the task imagination's
    task_prior: torch.Tensor
    task_actor: Tuple[torch.Tensor, ...]


def make_train_step(modules: Dict[str, torch.nn.Module], cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)`` over ``modules`` (``p2e_dv3/agent.py::
    build_agent``'s).

    ``train_step(opt_states, moments, data, update_target, draws=None, generator=None)``
    updates the trained modules' parameters and ``opt_states`` (``world_model``,
    ``actor_task``, ``critic_task``, ``actor_exploration``, ``critics_exploration``: one
    per critic, and ``ensembles``) in place, blends every target critic towards its
    updated critic where ``update_target`` (a bool or a 0-d bool tensor on the device)
    is set, and returns ``(new_moments, metrics)``, as DreamerV3's step does."""
    wm_cfg = cfg.algo.world_model
    if wm_cfg.get("decoupled_rssm", False):
        raise NotImplementedError(
            f"{DECOUPLED}=True: P2E-DV3's exploration step unrolls the coupled RSSM, as the reference's does "
            "(which fails on the decoupled one)"
        )
    stoch, discrete = wm_cfg.stochastic_size, wm_cfg.discrete_size
    stoch_size = stoch * discrete
    rec_size = wm_cfg.recurrent_model.recurrent_state_size
    horizon = cfg.algo.horizon
    gamma, lmbda = cfg.algo.gamma, cfg.algo.lmbda
    ent_coef = cfg.algo.actor.ent_coef
    tau = cfg.algo.critic.tau
    moments_cfg = cfg.algo.actor.moments
    intr_mult = cfg.algo.intrinsic_reward_multiplier
    world_model, ensembles = modules["world_model"], modules["ensembles"]
    actors = {k: modules[f"actor_{k}"] for k in ("exploration", "task")}
    critics = modules["critics_exploration"]
    configs = critic_configs(cfg)
    weights_sum = sum(c["weight"] for c in configs.values())
    is_continuous = actors["task"].is_continuous
    actions_dim = tuple(actors["task"].actions_dim)
    actor_noise = actor_noise_kind(actors["task"])
    cnn_keys, mlp_keys = list(cnn_keys), list(mlp_keys)

    wm_opt = make_optimizer(wm_cfg.optimizer, wm_cfg.clip_gradients)
    actor_opt = make_optimizer(cfg.algo.actor.optimizer, cfg.algo.actor.clip_gradients)
    critic_opt = make_optimizer(cfg.algo.critic.optimizer, cfg.algo.critic.clip_gradients)
    ens_opt = make_optimizer(cfg.algo.ensembles.optimizer, cfg.algo.ensembles.clip_gradients)
    params = {name: list(modules[name].parameters()) for name in ("world_model", "actor_task", "critic_task", "actor_exploration", "ensembles")}
    critic_params = {k: list(c["module"].parameters()) for k, c in critics.items()}
    target_pairs = [(list(modules["target_critic_task"].parameters()), params["critic_task"])]
    target_pairs += [(list(c["target"].parameters()), critic_params[k]) for k, c in critics.items()]
    opts = {"world_model": wm_opt, "actor_task": actor_opt, "critic_task": critic_opt, "actor_exploration": actor_opt, "ensembles": ens_opt}
    levels = torch.tensor([moments_cfg.percentile.low, moments_cfg.percentile.high], device=params["world_model"][0].device)

    health = health_enabled(cfg)  # read when the step is built (obs/health.py)

    def init_opt_states() -> Dict[str, Any]:
        states = {name: opts[name].init(params[name]) for name in ("world_model", "actor_task", "critic_task", "actor_exploration")}
        states["critics_exploration"] = {k: critic_opt.init(p) for k, p in critic_params.items()}
        states["ensembles"] = ens_opt.init(params["ensembles"])
        return states

    def init_extra() -> Dict[str, Any]:
        return {"task": init_moments(levels.device), "expl": {k: init_moments(levels.device) for k in configs}}

    def update(name: str, loss: torch.Tensor, opt_states, probe) -> torch.Tensor:
        return update_module(probe, name, opts[name], params[name], grads(loss, params[name]), opt_states[name])

    def moments_of(state, lambda_values):
        return update_moments(
            state,
            lambda_values,
            decay=moments_cfg.decay,
            max_=moments_cfg.max,
            percentile_low=moments_cfg.percentile.low,
            percentile_high=moments_cfg.percentile.high,
            levels=levels,
        )

    def draw_shapes(T: int, B: int) -> TrainDraws:
        # DreamerV3's step's draws, then a second imagination's
        dv3 = dv3_draw_shapes(T, B, horizon, stoch, discrete, actions_dim, actor_noise)
        return TrainDraws(*dv3, *dv3[2:])

    def train_step(
        opt_states: Dict[str, Any],
        moments: Dict[str, Any],
        data: Dict[str, torch.Tensor],
        update_target: bool | torch.Tensor,
        draws: Optional[TrainDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        T, B = data["rewards"].shape[:2]
        device = data["rewards"].device
        if draws is None:
            draws = draws_of(T, B, generator, device)
        probe = StepHealth() if health else None

        # ------------------------------------------------ 1. world model
        rec_loss, metrics, posts, recs = world_model_loss(
            world_model, wm_cfg, data, draws.wm_prior, draws.wm_post, cnn_keys, mlp_keys, detach_heads=True
        )
        update("world_model", rec_loss, opt_states, probe)
        posts, recs = posts.detach(), recs.detach()
        del rec_loss

        # ------------------------------------------------ 2. ensembles
        ens_loss = ensemble_loss(ensembles, torch.cat([posts, recs, data["actions"]], -1), posts[1:])
        update("ensembles", ens_loss, opt_states, probe)
        metrics["Loss/ensemble_loss"] = ens_loss.detach()
        del ens_loss

        latent0 = torch.cat([posts, recs], -1).reshape(T * B, -1)
        prior0, rec0 = posts.reshape(T * B, stoch_size), recs.reshape(T * B, rec_size)

        # ------------------------------------------------ 3. the exploration behaviour
        new_moments = {"expl": {}}
        with torch.set_grad_enabled(is_continuous):
            traj, imagined_actions = imagine(
                world_model, actors["exploration"], latent0, prior0, rec0, draws.expl_actor0, draws.expl_prior, draws.expl_actor, horizon
            )
            continues = imagined_continues(world_model, traj, data["terminated"])
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()
            advantage, lambdas = 0.0, {}
            for k, ccfg in configs.items():
                values = TwoHotEncodingDistribution(critics[k]["module"](traj), dims=1).mean
                if ccfg["reward_type"] == "intrinsic":
                    reward = intrinsic_reward(ensembles, torch.cat([traj.detach(), imagined_actions.detach()], -1), intr_mult)
                    metrics[f"Rewards/intrinsic_{k}"] = reward.detach().float().mean()
                else:
                    reward = TwoHotEncodingDistribution(world_model.reward(traj), dims=1).mean
                lambda_values = lambda_returns(reward, values, continues, gamma, lmbda)
                offset, invscale, new_moments["expl"][k] = moments_of(moments["expl"][k], lambda_values)
                normed = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
                advantage = advantage + normed * ccfg["weight"] / weights_sum
                lambdas[k] = lambda_values.detach()
                metrics[f"Values_exploration/predicted_values_{k}"] = values.detach().mean()
                metrics[f"Values_exploration/lambda_values_{k}"] = lambda_values.detach().mean()
        loss = policy_loss(actors["exploration"], traj, imagined_actions, advantage, discount, ent_coef)
        update("actor_exploration", loss, opt_states, probe)
        metrics["Loss/policy_loss_exploration"] = loss.detach()
        traj = traj.detach()
        del loss, advantage, values, reward
        for k in configs:
            value_loss = critic_loss(critics[k]["module"], critics[k]["target"], traj, lambdas[k], discount)
            critic_opt.update(critic_params[k], grads(value_loss, critic_params[k]), opt_states["critics_exploration"][k])
            metrics[f"Loss/value_loss_exploration_{k}"] = value_loss.detach()

        # ------------------------------------------------ 4. the task behaviour
        with torch.set_grad_enabled(is_continuous):
            traj, imagined_actions = imagine(
                world_model, actors["task"], latent0, prior0, rec0, draws.task_actor0, draws.task_prior, draws.task_actor, horizon
            )
            values = TwoHotEncodingDistribution(modules["critic_task"](traj), dims=1).mean
            rewards = TwoHotEncodingDistribution(world_model.reward(traj), dims=1).mean
            continues = imagined_continues(world_model, traj, data["terminated"])
            lambda_values = lambda_returns(rewards, values, continues, gamma, lmbda)
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()
        offset, invscale, new_moments["task"] = moments_of(moments["task"], lambda_values)
        advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
        loss = policy_loss(actors["task"], traj, imagined_actions, advantage, discount, ent_coef)
        update("actor_task", loss, opt_states, probe)
        metrics["Loss/policy_loss_task"] = loss.detach()
        traj, lambda_values = traj.detach(), lambda_values.detach()
        del loss, advantage, values, rewards
        value_loss = critic_loss(modules["critic_task"], modules["target_critic_task"], traj, lambda_values, discount)
        update("critic_task", value_loss, opt_states, probe)
        metrics["Loss/value_loss_task"] = value_loss.detach()

        if not isinstance(update_target, torch.Tensor):
            update_target = torch.full((), bool(update_target), device=device)
        for target, source in target_pairs:
            ema_target(target, source, tau, update_target)
        if probe is not None:
            metrics.update(probe.metrics({name: list(m.parameters()) for name, m in modules.items()}))
        return new_moments, metrics

    def draws_of(T: int, B: int, generator: Optional[torch.Generator], device: torch.device, out: Optional[TrainDraws] = None):
        if out is None:
            out = zero_draws(draw_shapes(T, B), device)
        kinds = ("gumbel", "gumbel", actor_noise, "gumbel", actor_noise, actor_noise, "gumbel", actor_noise)
        return fill_draws(out, kinds, generator)

    train_step.sample_draws = draws_of
    train_step.draw_shapes = draw_shapes
    train_step.init_extra = init_extra
    return train_step, init_opt_states


@register_algorithm(name="p2e_dv3_exploration")
def main(ctx, cfg) -> TrainResult:
    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        modules, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        train_step, init_opt_states = make_train_step(modules, cfg, cnn_keys, mlp_keys)
        opt_states, moments = init_opt_states(), train_step.init_extra()
        return LoopParts(
            modules=modules,
            opt_states=opt_states,
            extra_state={"moments": moments},
            make_step=make_captured_step(
                train_step, modules, opt_states, moments, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen,
                f"{cfg.algo.name}/train_block",
            ),
            player_step=make_player_step(modules["world_model"], modules[acting_actor(cfg)], actions_dim, cfg.algo.world_model.discrete_size),
            rb=sequential_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
            count_offset=0,
            clip_reward=lambda r: np.clip(r, -1, 1),
            exploration=None,
        )

    return run_loop(ctx, cfg, setup, AGGREGATOR_KEYS, handled=(DECOUPLED,))
