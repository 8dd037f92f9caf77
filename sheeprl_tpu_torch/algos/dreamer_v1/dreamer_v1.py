"""DreamerV1 training (counterpart of ``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``): the
gradient step ``make_train_step`` and the training entry ``main``, which runs the Dreamer
training loop (``algos/dreamer_loop.py::run_loop``) with the sequential replay.

One call runs, in the reference's order: the world-model update (the Gaussian RSSM
unrolled over the sequence, the ELBO of ``loss.py``), the imagination from every
posterior over ``horizon`` steps with the updated world model and the actor update, then
the critic update. Each loss is differentiated with ``torch.autograd.grad`` over its own
module's parameters.

What sets it apart from DreamerV2's step:

* no ``is_first`` reset in the unroll, and no target critic (the step takes the loop's
  target flag and ignores it);
* the imagined trajectory holds the ``horizon`` latents after the start, not the start
  itself; the actor sees each latent with its gradient stopped;
* the actor's loss is ``-mean(discount * lambda_values)``: pure dynamics
  backpropagation, through the whole imagination (the plain GRU's backward) back to the
  actor's sampled actions;
* the critic (the one being trained, before its update) values the trajectory, and it
  learns on ``traj[:-1]``.

Randomness: every draw of the step comes from one ``TrainDraws``: normal noise for the
Gaussian states, Gumbel noise for a discrete actor's samples and normal (or, for
``trunc_normal``, uniform) noise for a continuous one's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_loop import (
    LoopParts,
    TrainResult,
    act,
    actor_draw_shapes,
    actor_noise_kind,
    exploration_schedule,
    fill_draws,
    gaussian_lp,
    grads,
    make_captured_step,
    observation_lp,
    run_loop,
    sequential_buffer,
    update_module,
    zero_draws,
)
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v1.utils import AGGREGATOR_KEYS, compute_lambda_values
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.obs.health import StepHealth, health_enabled
from sheeprl_tpu_torch.distributions import BernoulliSafeMode, Independent, Normal
from sheeprl_tpu_torch.utils.registry import register_algorithm


class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch] normal noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch] ... and of the posteriors
    img_actor: Tuple[torch.Tensor, ...]  # per action head: [horizon, T*B, d], the action taken from each imagined state
    img_prior: torch.Tensor  # [horizon, T*B, stoch] imagined priors


def unroll_v1(world_model, data: Dict[str, torch.Tensor], noise: Tuple[torch.Tensor, torch.Tensor], cnn_keys, mlp_keys):
    """The Gaussian RSSM over the batch from a zero state, each step fed the previous
    action (a zero one first). Returns the embeddings, the posteriors and recurrent states
    ``[T, B, .]`` and the posterior and prior ``(mean, std)``."""
    T, B = data["rewards"].shape[:2]
    device = data["rewards"].device
    stoch, rec_size = world_model.rssm.stochastic_size, world_model.rssm.recurrent_state_size
    batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
    embed = world_model.encode({k: data[k] for k in [*cnn_keys, *mlp_keys]})
    post, rec = torch.zeros(B, stoch, device=device), torch.zeros(B, rec_size, device=device)
    recs, posts, post_ms, prior_ms = [], [], [], []
    for t in range(T):
        rec, post, _, p_ms, q_ms = world_model.dynamic(post, rec, batch_actions[t], embed[t], noise=(noise[0][t], noise[1][t]))
        recs.append(rec)
        posts.append(post)
        post_ms.append(p_ms)
        prior_ms.append(q_ms)
    stack = lambda ms: tuple(torch.stack(x) for x in zip(*ms))  # noqa: E731
    return embed, torch.stack(posts), torch.stack(recs), stack(post_ms), stack(prior_ms)


def world_model_loss_v1(world_model, wm_cfg, data, embed_posts_recs_ms, cnn_keys, mlp_keys, gamma: float, detach_heads: bool = False):
    """DreamerV1's ELBO over an unroll: ``(loss, metrics)``. ``detach_heads``: the reward
    and continue heads read the latents with their gradient stopped (P2E)."""
    _, posts, recs, post_ms, prior_ms = embed_posts_recs_ms
    latents = torch.cat([posts, recs], -1)
    head_in = latents.detach() if detach_heads else latents
    reward_lp = gaussian_lp(world_model.reward(head_in), data["rewards"], 1)
    continue_lp = None
    if wm_cfg.use_continues:
        continue_lp = Independent(BernoulliSafeMode(world_model.continues(head_in)), 1).log_prob((1.0 - data["terminated"]) * gamma)
    loss, metrics = reconstruction_loss(
        observation_lp(world_model.decode(latents), data, cnn_keys, mlp_keys),
        reward_lp,
        post_ms,
        prior_ms,
        wm_cfg.kl_free_nats,
        wm_cfg.kl_regularizer,
        continue_lp,
        wm_cfg.continue_scale_factor,
    )
    with torch.no_grad():
        metrics["State/post_entropy"] = Independent(Normal(*post_ms), 1).entropy().mean()
        metrics["State/prior_entropy"] = Independent(Normal(*prior_ms), 1).entropy().mean()
    return loss, metrics


def imagine_v1(world_model, actor, prior: torch.Tensor, rec: torch.Tensor, actor_noise, prior_noise, horizon: int):
    """DreamerV1's imagination from ``(prior, rec)`` ``[N, .]``: at each step the actor acts
    on the latent with its gradient stopped and the world model steps. Returns the
    ``horizon`` latents after the start ``[H, N, L]`` and the action taken at each step
    ``[H, N, A]`` (from the state before it)."""
    latent = torch.cat([prior, rec], -1)
    traj, actions = [], []
    for i in range(horizon):
        action = act(actor, latent.detach(), tuple(n[i] for n in actor_noise))
        prior, rec = world_model.imagination(prior, rec, action, noise=prior_noise[i])
        latent = torch.cat([prior, rec], -1)
        traj.append(latent)
        actions.append(action)
    return torch.stack(traj), torch.stack(actions)


def behaviour_v1(world_model, critic, traj: torch.Tensor, rewards: torch.Tensor, use_continues: bool, gamma: float, lmbda: float):
    """DreamerV1's targets over an imagined trajectory: the critic's values, the
    lambda-targets ``[H - 1, N, 1]`` and the discount (stopped), and the actor's loss
    ``-mean(discount * lambda_values)``."""
    values = critic(traj)
    continues = torch.sigmoid(world_model.continues(traj)) if use_continues else torch.ones_like(rewards) * gamma
    lambda_values = compute_lambda_values(rewards, values, continues, lmbda)
    discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], 0), 0).detach()
    return values, lambda_values, discount, -torch.mean(discount * lambda_values)


def critic_loss_v1(critic, traj: torch.Tensor, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The critic's Gaussian regression of the lambda-targets on ``traj[:-1]``."""
    return -torch.mean(discount[..., 0] * gaussian_lp(critic(traj[:-1]), lambda_values, 1))


def make_train_step(world_model, actor, critic, cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)``.

    ``train_step(opt_states, extra, data, update_target, draws=None, generator=None)``
    updates the three modules' parameters and ``opt_states`` in place and returns
    ``(extra, metrics)``, the metrics 0-d tensors on the device; ``extra`` (``{}``) and
    ``update_target`` are taken for the loop's call shape and not used. ``data`` holds
    ``[T, B, ...]`` tensors on the modules' device: the observation keys, ``actions``,
    ``rewards`` and ``terminated``. Without ``draws`` the step draws its noise from
    ``generator``; ``train_step.sample_draws(T, B, generator, device, out=None)`` makes
    the draws of a ``[T, B]`` batch and ``train_step.draw_shapes(T, B)`` gives their
    shapes."""
    wm_cfg = cfg.algo.world_model
    stoch = wm_cfg.stochastic_size
    rec_size = wm_cfg.recurrent_model.recurrent_state_size
    horizon = cfg.algo.horizon
    gamma, lmbda = cfg.algo.gamma, cfg.algo.lmbda
    actions_dim = tuple(actor.actions_dim)
    actor_noise = actor_noise_kind(actor)
    cnn_keys, mlp_keys = list(cnn_keys), list(mlp_keys)

    health = health_enabled(cfg)  # read when the step is built (obs/health.py)
    wm_opt = make_optimizer(wm_cfg.optimizer, wm_cfg.clip_gradients)
    actor_opt = make_optimizer(cfg.algo.actor.optimizer, cfg.algo.actor.clip_gradients)
    critic_opt = make_optimizer(cfg.algo.critic.optimizer, cfg.algo.critic.clip_gradients)
    wm_params = list(world_model.parameters())
    actor_params = list(actor.parameters())
    critic_params = list(critic.parameters())

    def init_opt_states() -> Dict[str, Any]:
        return {"world_model": wm_opt.init(wm_params), "actor": actor_opt.init(actor_params), "critic": critic_opt.init(critic_params)}

    def draw_shapes(T: int, B: int) -> TrainDraws:
        return TrainDraws(
            wm_prior=(T, B, stoch),
            wm_post=(T, B, stoch),
            img_actor=actor_draw_shapes(horizon, T * B, actions_dim, actor_noise),
            img_prior=(horizon, T * B, stoch),
        )

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

        # ------------------------------------------------ world model
        unrolled = unroll_v1(world_model, data, (draws.wm_prior, draws.wm_post), cnn_keys, mlp_keys)
        rec_loss, metrics = world_model_loss_v1(world_model, wm_cfg, data, unrolled, cnn_keys, mlp_keys, gamma)
        probe = StepHealth() if health else None
        metrics["Grads/world_model"] = update_module(probe, "world_model", wm_opt, wm_params, grads(rec_loss, wm_params), opt_states["world_model"])
        _, posts, recs, _, _ = unrolled
        del rec_loss, unrolled

        # ------------------------------------------------ imagination + actor
        traj, _ = imagine_v1(
            world_model, actor, posts.detach().reshape(T * B, stoch), recs.detach().reshape(T * B, rec_size),
            draws.img_actor, draws.img_prior, horizon,
        )
        _, lambda_values, discount, policy_loss = behaviour_v1(
            world_model, critic, traj, world_model.reward(traj), wm_cfg.use_continues, gamma, lmbda
        )
        metrics["Grads/actor"] = update_module(probe, "actor", actor_opt, actor_params, grads(policy_loss, actor_params), opt_states["actor"])
        metrics["Loss/policy_loss"] = policy_loss.detach()
        traj, lambda_values = traj.detach(), lambda_values.detach()
        del policy_loss

        # ------------------------------------------------ critic
        value_loss = critic_loss_v1(critic, traj, lambda_values, discount)
        metrics["Grads/critic"] = update_module(probe, "critic", critic_opt, critic_params, grads(value_loss, critic_params), opt_states["critic"])
        metrics["Loss/value_loss"] = value_loss.detach()
        if probe is not None:
            metrics.update(probe.metrics({"world_model": wm_params, "actor": actor_params, "critic": critic_params}))
        return extra, metrics

    def draws_of(T: int, B: int, generator: Optional[torch.Generator], device: torch.device, out: Optional[TrainDraws] = None):
        if out is None:
            out = zero_draws(draw_shapes(T, B), device)
        return fill_draws(out, ("normal", "normal", actor_noise, "normal"), generator)

    train_step.sample_draws = draws_of
    train_step.draw_shapes = draw_shapes
    train_step.init_extra = dict
    return train_step, init_opt_states


@register_algorithm(name="dreamer_v1")
def main(ctx, cfg) -> TrainResult:
    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        world_model, actor, critic, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
        modules = {"world_model": world_model, "actor": actor, "critic": critic}
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        train_step, init_opt_states = make_train_step(*modules.values(), cfg, cnn_keys, mlp_keys)
        opt_states, extra = init_opt_states(), train_step.init_extra()
        return LoopParts(
            modules=modules,
            opt_states=opt_states,
            extra_state={},
            make_step=make_captured_step(
                train_step, modules, opt_states, extra, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen,
                f"{cfg.algo.name}/train_block",
            ),
            player_step=make_player_step(world_model, actor, actions_dim, is_continuous),
            rb=sequential_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
            count_offset=0,
            clip_reward=np.tanh,
            exploration=exploration_schedule(cfg.algo.actor),
        )

    return run_loop(ctx, cfg, setup, AGGREGATOR_KEYS)
