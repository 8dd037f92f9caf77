"""DreamerV2 training (counterpart of ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``):
the gradient step ``make_train_step``, the replay buffer ``make_buffer`` and the training
entry ``main``, which runs the Dreamer training loop that DreamerV3 shares
(``algos/dreamer_loop.py::run_loop``).

One call runs, in the reference's order: the hard copy of the critic into the target
critic where the step's flag is set (before the update), the world-model update (the
RSSM unroll over the sequence, each step through the ``layernorm_gru`` kernels), the
imagination over ``horizon`` steps and the actor update, then the critic update. As in
the DreamerV3 port, each loss is differentiated with ``torch.autograd.grad`` over its
own module's parameters, and the imagination runs the world model after its update.

The reference's arithmetic, kept:

* ``is_first[0] = 1``, and the actions shifted right behind a zero action;
* unit-variance Gaussian likelihoods for the observations (images as ``x / 255 - 0.5``),
  the reward and the critic's value of the lambda-returns;
* KL balancing (``loss.py``); the continue head only with ``use_continues``, else a
  constant ``gamma``;
* the actor objective ``objective_mix * reinforce + (1 - objective_mix) * dynamics``.
  The dynamics term reads the lambda-returns, whose gradient crosses the whole
  imagination back to the actor's sampled actions; at ``objective_mix = 1`` it is
  multiplied by zero, but the backward still runs through every imagined step (the GRU
  backward kernel at ``T * B`` rows, ``horizon`` times), as the reference's does;
* three Adam optimizers with ``weight_decay`` as L2 added before Adam, clipped at
  ``clip_gradients``.

Randomness: every draw of the step comes from one ``TrainDraws``: Gumbel noise for the
categorical samples and normal (or, for ``trunc_normal``, uniform) noise for a continuous
actor; the loop makes it in bulk on the device, the parity tests from JAX's keys.

The step is graph-safe, as the DreamerV3 step is: the target flag is a tensor, the
copy a ``torch.where``, and the loop replays it as a CUDA graph on a card. Its target
cadence tests the count before the increment (``count_offset=0``): the copy happens on
the first gradient step.
"""

from __future__ import annotations

import os
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
from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v2.utils import compute_lambda_values
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.obs.health import StepHealth, health_enabled
from sheeprl_tpu_torch.data.buffers import EpisodeBuffer
from sheeprl_tpu_torch.distributions import BernoulliSafeMode, Independent, OneHotCategorical
from sheeprl_tpu_torch.utils.registry import register_algorithm


class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch, discrete] Gumbel noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch, discrete] ... and of the posteriors
    img_actor: Tuple[torch.Tensor, ...]  # per action head: [horizon, T*B, d], the action taken from each imagined state
    img_prior: torch.Tensor  # [horizon, T*B, stoch, discrete] imagined priors


def draw_shapes(T: int, B: int, horizon: int, stoch: int, discrete: int, actions_dim: Sequence[int], actor_noise: str) -> TrainDraws:
    """The shape of every draw of one step, as a ``TrainDraws`` of shapes."""
    return TrainDraws(
        wm_prior=(T, B, stoch, discrete),
        wm_post=(T, B, stoch, discrete),
        img_actor=actor_draw_shapes(horizon, T * B, actions_dim, actor_noise),
        img_prior=(horizon, T * B, stoch, discrete),
    )


@torch.no_grad()
def hard_copy(targets: Sequence[torch.Tensor], sources: Sequence[torch.Tensor], flag: bool | torch.Tensor) -> None:
    """The hard target copy, before the update, where ``flag`` (a bool or a 0-d tensor on
    the device) is set: a blend kept only where it is, the same bits as a copy under a
    host-side ``if``, and graph-safe."""
    if not isinstance(flag, torch.Tensor):
        flag = torch.full((), bool(flag), device=sources[0].device)
    for t, s in zip(targets, sources):
        t.copy_(torch.where(flag.bool(), s, t))


def unroll_v2(world_model, data: Dict[str, torch.Tensor], gumbels: Tuple[torch.Tensor, torch.Tensor], cnn_keys, mlp_keys):
    """The RSSM over the batch from a zero state (``is_first[0] = 1``, and each step fed
    the previous action, a zero one first). Returns the posteriors and recurrent states
    ``[T, B, .]`` and the posterior and prior logits ``[T, B, stoch, discrete]``."""
    T, B = data["rewards"].shape[:2]
    device = data["rewards"].device
    rssm = world_model.rssm
    is_first = data["is_first"].clone()
    is_first[0] = 1.0
    batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
    embed = world_model.encode({k: data[k] for k in [*cnn_keys, *mlp_keys]})  # [T, B, E]
    post = torch.zeros(B, rssm.stochastic_size * rssm.discrete_size, device=device)
    rec = torch.zeros(B, rssm.recurrent_state_size, device=device)
    recs, posts, post_logits, prior_logits = [], [], [], []
    for t in range(T):
        rec, post, _, post_l, prior_l = world_model.dynamic(
            post, rec, batch_actions[t], embed[t], is_first[t], gumbels=(gumbels[0][t], gumbels[1][t])
        )
        recs.append(rec)
        posts.append(post)
        post_logits.append(post_l)
        prior_logits.append(prior_l)
    shape = (T, B, rssm.stochastic_size, rssm.discrete_size)
    return torch.stack(posts), torch.stack(recs), torch.stack(post_logits).reshape(shape), torch.stack(prior_logits).reshape(shape)


def world_model_loss_v2(world_model, wm_cfg, data, unrolled, cnn_keys, mlp_keys, gamma: float, detach_heads: bool = False):
    """DreamerV2's world-model loss over an unroll (``unroll_v2``'s): ``(loss, metrics)``.
    ``detach_heads``: the reward and continue heads read the latents with their gradient
    stopped (P2E)."""
    posts, recs, post_logits, prior_logits = unrolled
    latents = torch.cat([posts, recs], -1)  # [T, B, L]
    head_in = latents.detach() if detach_heads else latents
    reward_lp = gaussian_lp(world_model.reward(head_in), data["rewards"], 1)
    continue_lp = None
    if wm_cfg.use_continues:
        continue_lp = Independent(BernoulliSafeMode(world_model.continues(head_in)), 1).log_prob((1.0 - data["terminated"]) * gamma)
    loss, metrics = reconstruction_loss(
        observation_lp(world_model.decode(latents), data, cnn_keys, mlp_keys),
        reward_lp,
        prior_logits,
        post_logits,
        wm_cfg.kl_balancing_alpha,
        wm_cfg.kl_free_nats,
        wm_cfg.kl_free_avg,
        wm_cfg.kl_regularizer,
        continue_lp,
        wm_cfg.discount_scale_factor,
    )
    with torch.no_grad():
        metrics["State/post_entropy"] = Independent(OneHotCategorical(post_logits), 1).entropy().mean()
        metrics["State/prior_entropy"] = Independent(OneHotCategorical(prior_logits), 1).entropy().mean()
    return loss, metrics


def imagine_v2(world_model, actor, prior: torch.Tensor, rec: torch.Tensor, actor_noise, prior_noise, horizon: int):
    """DreamerV2's imagination from ``(prior, rec)`` ``[N, .]``: at each step the actor acts
    on the latent with its gradient stopped and the world model steps. Returns the
    trajectory ``[H + 1, N, L]`` (the start first) and the actions ``[H + 1, N, A]``, a
    zero action first: ``actions[i + 1]`` is the one taken at ``traj[i]``."""
    latent = torch.cat([prior, rec], -1)
    traj, actions = [latent], []
    for i in range(horizon):
        action = act(actor, latent.detach(), tuple(n[i] for n in actor_noise))
        prior, rec = world_model.imagination(prior, rec, action, gumbel=prior_noise[i])
        latent = torch.cat([prior, rec], -1)
        traj.append(latent)
        actions.append(action)
    return torch.stack(traj), torch.stack([torch.zeros_like(actions[0]), *actions])


def continues_v2(world_model, traj: torch.Tensor, terminated: torch.Tensor, use_continues: bool, gamma: float, like: torch.Tensor):
    """The imagined continues: the batch's own first (``(1 - terminated) * gamma``), then
    the continue head's probabilities, where ``use_continues``; else ``gamma``."""
    if not use_continues:
        return torch.ones_like(like) * gamma
    true_continue0 = (1.0 - terminated).reshape(-1, 1) * gamma
    return torch.cat([true_continue0[None], torch.sigmoid(world_model.continues(traj))[1:]], 0)


def reinforce_terms(actor, traj: torch.Tensor, imagined_actions: torch.Tensor):
    """The actor's log-probability of the actions it took at ``traj[:-2]`` (gradient
    stopped at its inputs) ``[H - 1, N, 1]``, and its entropy there ``[H - 1, N, 1]``."""
    _, dists = actor(traj[:-2].detach())
    taken = imagined_actions[1:-1].detach()
    if actor.is_continuous:
        return dists[0].log_prob(taken).sum(-1, keepdim=True), dists[0].entropy().sum(-1)[..., None]
    logpis, offset = [], 0
    for d, n in zip(dists, actor.actions_dim):
        logpis.append(d.log_prob(taken[..., offset : offset + n]))
        offset += n
    return sum(logpis)[..., None], sum(d.entropy() for d in dists)[..., None]


def critic_loss_v2(critic, traj: torch.Tensor, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The critic's Gaussian regression of the lambda-returns on ``traj[:-1]``."""
    return -torch.mean(discount[:-1, ..., 0] * gaussian_lp(critic(traj[:-1]), lambda_values, 1))


def make_train_step(world_model, actor, critic, target_critic, cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)``.

    ``train_step(opt_states, extra, data, update_target, draws=None, generator=None)``
    updates the four modules' parameters and ``opt_states`` in place and returns
    ``(extra, metrics)``, the metrics 0-d tensors on the device. ``extra`` is the further
    state the step carries, which DreamerV2 has none of: ``train_step.init_extra()`` is
    ``{}``, handed back as it came, so that the step has DreamerV3's call shape. ``data`` holds ``[T, B, ...]`` tensors on the modules'
    device: the observation keys, ``actions``, ``rewards``, ``terminated`` and
    ``is_first``. ``update_target`` is a bool or a 0-d bool tensor on the device. Without
    ``draws`` the step draws its noise from ``generator``;
    ``train_step.sample_draws(T, B, generator, device, out=None)`` makes the draws of a
    ``[T, B]`` batch and ``train_step.draw_shapes(T, B)`` gives their shapes."""
    wm_cfg = cfg.algo.world_model
    stoch, discrete = wm_cfg.stochastic_size, wm_cfg.discrete_size
    stoch_size = stoch * discrete
    rec_size = wm_cfg.recurrent_model.recurrent_state_size
    horizon = cfg.algo.horizon
    gamma, lmbda = cfg.algo.gamma, cfg.algo.lmbda
    ent_coef = cfg.algo.actor.ent_coef
    objective_mix = cfg.algo.actor.objective_mix
    use_continues = wm_cfg.use_continues
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
    target_params = list(target_critic.parameters())

    def init_opt_states() -> Dict[str, Any]:
        return {
            "world_model": wm_opt.init(wm_params),
            "actor": actor_opt.init(actor_params),
            "critic": critic_opt.init(critic_params),
        }

    def train_step(
        opt_states: Dict[str, Any],
        extra: Dict[str, torch.Tensor],
        data: Dict[str, torch.Tensor],
        update_target: bool | torch.Tensor,
        draws: Optional[TrainDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        T, B = data["rewards"].shape[:2]
        device = data["rewards"].device
        if draws is None:
            draws = draws_of(T, B, generator, device)

        hard_copy(target_params, critic_params, update_target)

        # ------------------------------------------------ world model
        unrolled = unroll_v2(world_model, data, (draws.wm_prior, draws.wm_post), cnn_keys, mlp_keys)
        rec_loss, metrics = world_model_loss_v2(world_model, wm_cfg, data, unrolled, cnn_keys, mlp_keys, gamma)
        probe = StepHealth() if health else None
        metrics["Grads/world_model"] = update_module(probe, "world_model", wm_opt, wm_params, grads(rec_loss, wm_params), opt_states["world_model"])
        posts, recs = unrolled[:2]
        del rec_loss, unrolled

        # ------------------------------------------------ imagination + actor
        traj, imagined_actions = imagine_v2(
            world_model, actor, posts.detach().reshape(T * B, stoch_size), recs.detach().reshape(T * B, rec_size),
            draws.img_actor, draws.img_prior, horizon,
        )
        target_values = target_critic(traj)  # [H+1, TB, 1]
        rewards_img = world_model.reward(traj)
        continues = continues_v2(world_model, traj, data["terminated"], use_continues, gamma, rewards_img)
        lambda_values = compute_lambda_values(rewards_img[:-1], target_values[:-1], continues[:-1], target_values[-1:], lmbda)
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], 0), 0).detach()

        logpi, entropy = reinforce_terms(actor, traj, imagined_actions)
        dynamics = lambda_values[1:]
        reinforce = logpi * (lambda_values[1:] - target_values[:-2]).detach()
        objective = objective_mix * reinforce + (1 - objective_mix) * dynamics
        policy_loss = -torch.mean(discount[:-2] * (objective + ent_coef * entropy))
        metrics["Grads/actor"] = update_module(probe, "actor", actor_opt, actor_params, grads(policy_loss, actor_params), opt_states["actor"])
        metrics["Loss/policy_loss"] = policy_loss.detach()
        traj, lambda_values = traj.detach(), lambda_values.detach()
        del policy_loss, objective, dynamics, target_values, rewards_img

        # ------------------------------------------------ critic
        value_loss = critic_loss_v2(critic, traj, lambda_values, discount)
        metrics["Grads/critic"] = update_module(probe, "critic", critic_opt, critic_params, grads(value_loss, critic_params), opt_states["critic"])
        metrics["Loss/value_loss"] = value_loss.detach()
        if probe is not None:
            metrics.update(probe.metrics({"world_model": wm_params, "actor": actor_params, "critic": critic_params, "target_critic": target_params}))
        return extra, metrics

    def draws_of(T: int, B: int, generator: Optional[torch.Generator], device: torch.device, out: Optional[TrainDraws] = None):
        if out is None:
            out = zero_draws(draw_shapes(T, B, horizon, stoch, discrete, actions_dim, actor_noise), device)
        return fill_draws(out, ("gumbel", "gumbel", actor_noise, "gumbel"), generator)

    train_step.sample_draws = draws_of
    train_step.draw_shapes = lambda T, B: draw_shapes(T, B, horizon, stoch, discrete, actions_dim, actor_noise)
    train_step.init_extra = dict
    return train_step, init_opt_states


def make_buffer(cfg, num_envs: int, obs_keys: Sequence[str], log_dir: str):
    """``buffer.type``: ``sequential`` (the loops' per-env sequential buffer) or
    ``episode`` (whole episodes of at least a sequence's length, ``prioritize_ends``)."""
    buffer_type = str(cfg.buffer.get("type", "sequential")).lower()
    if buffer_type == "sequential":
        return sequential_buffer(cfg, num_envs, obs_keys, log_dir)
    if buffer_type == "episode":
        return EpisodeBuffer(
            max(int(cfg.buffer.size) // max(num_envs, 1), 1),
            minimum_episode_length=1 if cfg.dry_run else cfg.algo.per_rank_sequence_length,
            n_envs=num_envs,
            obs_keys=obs_keys,
            prioritize_ends=cfg.buffer.get("prioritize_ends", False),
            memmap=cfg.buffer.memmap,
            memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None,
        )
    raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {buffer_type}")


@register_algorithm(name="dreamer_v2")
def main(ctx, cfg) -> TrainResult:
    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        world_model, actor, critic, target_critic, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
        modules = {"world_model": world_model, "actor": actor, "critic": critic, "target_critic": target_critic}
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
            rb=make_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
            count_offset=0,
            clip_reward=np.tanh,
            exploration=exploration_schedule(cfg.algo.actor),
        )

    return run_loop(ctx, cfg, setup, merges_rollout=True)
