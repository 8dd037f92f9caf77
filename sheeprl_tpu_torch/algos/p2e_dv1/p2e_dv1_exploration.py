"""P2E on DreamerV1, the exploration run (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``): the gradient step
``make_train_step`` and the training entry ``main`` (``algos/dreamer_loop.py::run_loop``).

One call runs four phases, in the reference's order:

1. DreamerV1's world-model update, with the reward and continue heads on latents whose
   gradient is stopped;
2. the ensembles' update: from ``[posterior, recurrent state, action]`` each member
   predicts the next observation embedding (``algos/p2e::ensemble_loss_normal``);
3. the exploration actor and critic: DreamerV1's dynamics-backpropagation update on an
   imagination of the exploration actor, rewarded by the updated ensembles'
   disagreement (``intrinsic_reward``);
4. the task actor and critic: DreamerV1's update on an imagination of the task actor,
   rewarded by the world model's reward head.

Both imaginations run the updated world model; each critic values its trajectory before
its own update. Randomness: one ``TrainDraws``, each imagination with draws of its own.
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
    sequential_buffer,
    update_module,
    zero_draws,
)
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import behaviour_v1, critic_loss_v1, imagine_v1, unroll_v1, world_model_loss_v1
from sheeprl_tpu_torch.algos.p2e import OPTIMIZED, acting_actor, ensemble_loss_normal, intrinsic_reward, make_optimizers
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.p2e_dv1.utils import AGGREGATOR_KEYS
from sheeprl_tpu_torch.obs.health import StepHealth, health_enabled
from sheeprl_tpu_torch.utils.registry import register_algorithm

class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch] normal noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch] ... and of the posteriors
    expl_actor: Tuple[torch.Tensor, ...]  # the exploration imagination's action draws, [horizon, T*B, d] per head
    expl_prior: torch.Tensor  # [horizon, T*B, stoch] its priors
    task_actor: Tuple[torch.Tensor, ...]  # the task imagination's
    task_prior: torch.Tensor


def make_train_step(modules: Dict[str, torch.nn.Module], cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)`` over ``modules`` (``p2e_dv1/agent.py::
    build_agent``'s).

    ``train_step(opt_states, extra, data, update_target, draws=None, generator=None)``
    updates the six modules' parameters and ``opt_states`` (one per name of
    ``OPTIMIZED``) in place and returns ``(extra, metrics)``, as DreamerV1's step does
    (``update_target`` is not used: DreamerV1 has no target critic)."""
    wm_cfg = cfg.algo.world_model
    stoch = wm_cfg.stochastic_size
    rec_size = wm_cfg.recurrent_model.recurrent_state_size
    horizon = cfg.algo.horizon
    gamma, lmbda = cfg.algo.gamma, cfg.algo.lmbda
    intr_mult = cfg.algo.intrinsic_reward_multiplier
    world_model, ensembles = modules["world_model"], modules["ensembles"]
    actors = {k: modules[f"actor_{k}"] for k in ("exploration", "task")}
    critics = {k: modules[f"critic_{k}"] for k in ("exploration", "task")}
    actions_dim = tuple(actors["task"].actions_dim)
    actor_noise = actor_noise_kind(actors["task"])
    cnn_keys, mlp_keys = list(cnn_keys), list(mlp_keys)
    opts = make_optimizers(cfg)
    params = {name: list(modules[name].parameters()) for name in OPTIMIZED}

    health = health_enabled(cfg)  # read when the step is built (obs/health.py)

    def init_opt_states() -> Dict[str, Any]:
        return {name: opts[name].init(params[name]) for name in OPTIMIZED}

    def update(name: str, loss: torch.Tensor, opt_states, probe) -> torch.Tensor:
        return update_module(probe, name, opts[name], params[name], grads(loss, params[name]), opt_states[name])

    def draw_shapes(T: int, B: int) -> TrainDraws:
        img_actor = actor_draw_shapes(horizon, T * B, actions_dim, actor_noise)
        return TrainDraws((T, B, stoch), (T, B, stoch), img_actor, (horizon, T * B, stoch), img_actor, (horizon, T * B, stoch))

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
        probe = StepHealth() if health else None

        # ------------------------------------------------ 1. world model
        unrolled = unroll_v1(world_model, data, (draws.wm_prior, draws.wm_post), cnn_keys, mlp_keys)
        rec_loss, metrics = world_model_loss_v1(world_model, wm_cfg, data, unrolled, cnn_keys, mlp_keys, gamma, detach_heads=True)
        update("world_model", rec_loss, opt_states, probe)
        embed, posts, recs = (x.detach() for x in unrolled[:3])
        del rec_loss, unrolled

        # ------------------------------------------------ 2. ensembles
        ens_loss = ensemble_loss_normal(ensembles, torch.cat([posts, recs, data["actions"]], -1), embed[1:])
        update("ensembles", ens_loss, opt_states, probe)
        metrics["Loss/ensemble_loss"] = ens_loss.detach()
        del ens_loss

        # ------------------------------------------------ 3. and 4. the two behaviours
        prior0, rec0 = posts.reshape(T * B, stoch), recs.reshape(T * B, rec_size)
        for kind, actor_draws, prior_draws in (
            ("exploration", draws.expl_actor, draws.expl_prior),
            ("task", draws.task_actor, draws.task_prior),
        ):
            traj, actions = imagine_v1(world_model, actors[kind], prior0, rec0, actor_draws, prior_draws, horizon)
            if kind == "exploration":
                rewards = intrinsic_reward(ensembles, torch.cat([traj.detach(), actions.detach()], -1), intr_mult)
            else:
                rewards = world_model.reward(traj)
            values, lambda_values, discount, policy_loss = behaviour_v1(
                world_model, critics[kind], traj, rewards, wm_cfg.use_continues, gamma, lmbda
            )
            if kind == "exploration":
                metrics["Rewards/intrinsic"] = rewards.detach().float().mean()
                metrics["Values_exploration/predicted_values"] = values.detach().mean()
                metrics["Values_exploration/lambda_values"] = lambda_values.detach().mean()
            update(f"actor_{kind}", policy_loss, opt_states, probe)
            metrics[f"Loss/policy_loss_{kind}"] = policy_loss.detach()
            del policy_loss, values, rewards
            value_loss = critic_loss_v1(critics[kind], traj.detach(), lambda_values.detach(), discount)
            update(f"critic_{kind}", value_loss, opt_states, probe)
            metrics[f"Loss/value_loss_{kind}"] = value_loss.detach()
        if probe is not None:
            metrics.update(probe.metrics({name: list(m.parameters()) for name, m in modules.items()}))
        return extra, metrics

    def draws_of(T: int, B: int, generator: Optional[torch.Generator], device: torch.device, out: Optional[TrainDraws] = None):
        if out is None:
            out = zero_draws(draw_shapes(T, B), device)
        return fill_draws(out, ("normal", "normal", actor_noise, "normal", actor_noise, "normal"), generator)

    train_step.sample_draws = draws_of
    train_step.draw_shapes = draw_shapes
    train_step.init_extra = dict
    return train_step, init_opt_states


@register_algorithm(name="p2e_dv1_exploration")
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
                train_step, modules, opt_states, extra, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen,
                f"{cfg.algo.name}/train_block",
            ),
            player_step=make_player_step(modules["world_model"], modules[acting_actor(cfg)], actions_dim, is_continuous),
            rb=sequential_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
            count_offset=0,
            clip_reward=np.tanh,
            exploration=exploration_schedule(cfg.algo.actor),
        )

    return run_loop(ctx, cfg, setup, AGGREGATOR_KEYS)
