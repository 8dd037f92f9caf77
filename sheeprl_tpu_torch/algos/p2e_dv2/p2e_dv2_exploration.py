"""P2E on DreamerV2, the exploration run (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``): the gradient step
``make_train_step`` and the training entry ``main`` (``algos/dreamer_loop.py::run_loop``).

One call runs, in the reference's order: the hard copies of both critics into their
target critics where the step's flag is set (before any update, the cadence's
``count_offset=0``), then four phases:

1. DreamerV2's world-model update, with the reward and continue heads on latents whose
   gradient is stopped (the RSSM unroll through the ``layernorm_gru`` kernels);
2. the ensembles' update: from ``[posterior, recurrent state, action]`` each member
   predicts the next posterior (``algos/p2e::ensemble_loss_normal``);
3. the exploration actor and critic, on an imagination of the exploration actor that
   starts with the zero action, rewarded by the updated ensembles' disagreement and
   valued by the exploration target critic;
4. the task actor and critic, the same on an imagination of the task actor, rewarded by
   the world model's reward head and valued by the task target critic.

The actors' objective (``behaviour_loss``) is the reference's: for a continuous actor
dynamics backpropagation (the lambda-returns, whose gradient crosses the imagination:
the GRU backward kernel at ``T * B`` rows, ``horizon`` times per imagination); for a
discrete one REINFORCE on the stopped trajectory with the target critic's baseline and
no dynamics term, so its imagination runs without autograd and no backward kernel
reaches it. Randomness: one ``TrainDraws``, each imagination with draws of its own.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_loop import (
    LoopParts,
    TrainResult,
    actor_draw_shapes,
    actor_noise_kind,
    exploration_schedule,
    fill_draws,
    grads,
    make_captured_step,
    run_loop,
    zero_draws,
)
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import (
    continues_v2,
    critic_loss_v2,
    hard_copy,
    imagine_v2,
    make_buffer,
    reinforce_terms,
    unroll_v2,
    world_model_loss_v2,
)
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.p2e import OPTIMIZED, acting_actor, ensemble_loss_normal, intrinsic_reward, make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.p2e_dv2.utils import AGGREGATOR_KEYS
from sheeprl_tpu_torch.utils.registry import register_algorithm


class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch, discrete] Gumbel noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch, discrete] ... and of the posteriors
    expl_actor: Tuple[torch.Tensor, ...]  # the exploration imagination's action draws, [horizon, T*B, d] per head
    expl_prior: torch.Tensor  # [horizon, T*B, stoch, discrete] its priors
    task_actor: Tuple[torch.Tensor, ...]  # the task imagination's
    task_prior: torch.Tensor


def behaviour_loss(actor, traj, imagined_actions, lambda_values, baseline, discount, ent_coef: float) -> torch.Tensor:
    """P2E-DV2's actor objective: ``-mean(discount * (objective + ent_coef * entropy))``
    over ``traj[:-2]``, the objective the lambda-returns for a continuous actor, and
    ``log pi(a) * (lambda - baseline)`` (stopped) for a discrete one."""
    logpi, entropy = reinforce_terms(actor, traj, imagined_actions)
    if actor.is_continuous:
        objective = lambda_values[1:]
    else:
        objective = logpi * (lambda_values[1:] - baseline[:-2]).detach()
    return -torch.mean(discount[:-2] * (objective + ent_coef * entropy))


def make_train_step(modules: Dict[str, torch.nn.Module], cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)`` over ``modules`` (``p2e_dv2/agent.py::
    build_agent``'s).

    ``train_step(opt_states, extra, data, update_target, draws=None, generator=None)``
    copies each critic into its target where ``update_target`` (a bool or a 0-d bool
    tensor on the device) is set, updates the six trained modules' parameters and
    ``opt_states`` (one per name of ``OPTIMIZED``) in place and returns ``(extra,
    metrics)``, as DreamerV2's step does."""
    wm_cfg = cfg.algo.world_model
    stoch, discrete = wm_cfg.stochastic_size, wm_cfg.discrete_size
    rec_size = wm_cfg.recurrent_model.recurrent_state_size
    horizon = cfg.algo.horizon
    gamma, lmbda = cfg.algo.gamma, cfg.algo.lmbda
    ent_coef = cfg.algo.actor.ent_coef
    intr_mult = cfg.algo.intrinsic_reward_multiplier
    world_model, ensembles = modules["world_model"], modules["ensembles"]
    actors = {k: modules[f"actor_{k}"] for k in ("exploration", "task")}
    critics = {k: modules[f"critic_{k}"] for k in ("exploration", "task")}
    targets = {k: modules[f"target_critic_{k}"] for k in ("exploration", "task")}
    is_continuous = actors["task"].is_continuous
    actions_dim = tuple(actors["task"].actions_dim)
    actor_noise = actor_noise_kind(actors["task"])
    cnn_keys, mlp_keys = list(cnn_keys), list(mlp_keys)
    opts = make_optimizers(cfg)
    params = {name: list(modules[name].parameters()) for name in OPTIMIZED}
    target_pairs = [(list(targets[k].parameters()), params[f"critic_{k}"]) for k in ("task", "exploration")]

    def init_opt_states() -> Dict[str, Any]:
        return {name: opts[name].init(params[name]) for name in OPTIMIZED}

    def update(name: str, loss: torch.Tensor, opt_states) -> torch.Tensor:
        return opts[name].update(params[name], grads(loss, params[name]), opt_states[name])

    def draw_shapes(T: int, B: int) -> TrainDraws:
        img_actor = actor_draw_shapes(horizon, T * B, actions_dim, actor_noise)
        img_prior = (horizon, T * B, stoch, discrete)
        return TrainDraws((T, B, stoch, discrete), (T, B, stoch, discrete), img_actor, img_prior, img_actor, img_prior)

    def train_step(
        opt_states: Dict[str, Any],
        extra: Dict[str, torch.Tensor],
        data: Dict[str, torch.Tensor],
        update_target: bool | torch.Tensor,
        draws: Optional[TrainDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        T, B = data["rewards"].shape[:2]
        if draws is None:
            draws = draws_of(T, B, generator, data["rewards"].device)
        for target, source in target_pairs:
            hard_copy(target, source, update_target)

        # ------------------------------------------------ 1. world model
        unrolled = unroll_v2(world_model, data, (draws.wm_prior, draws.wm_post), cnn_keys, mlp_keys)
        rec_loss, metrics = world_model_loss_v2(world_model, wm_cfg, data, unrolled, cnn_keys, mlp_keys, gamma, detach_heads=True)
        update("world_model", rec_loss, opt_states)
        posts, recs = (x.detach() for x in unrolled[:2])
        del rec_loss, unrolled

        # ------------------------------------------------ 2. ensembles
        ens_loss = ensemble_loss_normal(ensembles, torch.cat([posts, recs, data["actions"]], -1), posts[1:])
        update("ensembles", ens_loss, opt_states)
        metrics["Loss/ensemble_loss"] = ens_loss.detach()
        del ens_loss

        # ------------------------------------------------ 3. and 4. the two behaviours
        prior0, rec0 = posts.reshape(T * B, stoch * discrete), recs.reshape(T * B, rec_size)
        for kind, actor_draws, prior_draws in (
            ("exploration", draws.expl_actor, draws.expl_prior),
            ("task", draws.task_actor, draws.task_prior),
        ):
            # a discrete actor's objective reads the trajectory stopped: no autograd here
            with torch.set_grad_enabled(is_continuous):
                traj, imagined_actions = imagine_v2(world_model, actors[kind], prior0, rec0, actor_draws, prior_draws, horizon)
                target_values = targets[kind](traj)
                if kind == "exploration":
                    rewards = intrinsic_reward(ensembles, torch.cat([traj.detach(), imagined_actions.detach()], -1), intr_mult)
                else:
                    rewards = world_model.reward(traj)
                continues = continues_v2(world_model, traj, data["terminated"], wm_cfg.use_continues, gamma, rewards)
                lambda_values = compute_lambda_values(rewards[:-1], target_values[:-1], continues[:-1], target_values[-1:], lmbda)
                discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], 0), 0).detach()
            if kind == "exploration":
                metrics["Rewards/intrinsic"] = rewards.detach().float().mean()
                metrics["Values_exploration/predicted_values"] = target_values.detach().mean()
                metrics["Values_exploration/lambda_values"] = lambda_values.detach().mean()
            policy_loss = behaviour_loss(actors[kind], traj, imagined_actions, lambda_values, target_values, discount, ent_coef)
            update(f"actor_{kind}", policy_loss, opt_states)
            metrics[f"Loss/policy_loss_{kind}"] = policy_loss.detach()
            del policy_loss, target_values, rewards, continues
            value_loss = critic_loss_v2(critics[kind], traj.detach(), lambda_values.detach(), discount)
            update(f"critic_{kind}", value_loss, opt_states)
            metrics[f"Loss/value_loss_{kind}"] = value_loss.detach()
        return extra, metrics

    def draws_of(T: int, B: int, generator: Optional[torch.Generator], device: torch.device, out: Optional[TrainDraws] = None):
        if out is None:
            out = zero_draws(draw_shapes(T, B), device)
        return fill_draws(out, ("gumbel", "gumbel", actor_noise, "gumbel", actor_noise, "gumbel"), generator)

    train_step.sample_draws = draws_of
    train_step.draw_shapes = draw_shapes
    train_step.init_extra = dict
    return train_step, init_opt_states


@register_algorithm(name="p2e_dv2_exploration")
def main(ctx, cfg) -> TrainResult:
    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        modules, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        train_step, init_opt_states = make_train_step(modules, cfg, cnn_keys, mlp_keys)
        opt_states, extra = init_opt_states(), train_step.init_extra()
        return LoopParts(
            modules=modules,
            opt_states=opt_states,
            extra_state={},
            make_step=make_captured_step(
                train_step, modules, opt_states, extra, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen
            ),
            player_step=make_player_step(modules["world_model"], modules[acting_actor(cfg)], actions_dim, is_continuous),
            rb=make_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
            count_offset=0,
            clip_reward=np.tanh,
            exploration=exploration_schedule(cfg.algo.actor),
        )

    return run_loop(ctx, cfg, setup, AGGREGATOR_KEYS)
