"""DreamerV3 training (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``): the gradient step
``make_train_step`` and the training entry ``main``, which runs the Dreamer training
loop ``run_loop`` that DreamerV2 shares (``algos/dreamer_loop.py``).

One call runs, in the reference's order: the world-model update (the 64-step RSSM
unroll as a Python loop, each step through the ``layernorm_gru`` kernels), the 15-step
imagination and the actor update, the critic update, the EMA of the target critic and
the update of the return moments.

What the reference gets from ``jax.value_and_grad`` over one parameter subtree, the port
gets from ``torch.autograd.grad`` over one module's parameter list, so the actor loss,
which runs the critic and the world model, leaves their parameters and their ``.grad``
untouched. The parameter versions are the reference's: imagination runs the world model
after its update, the actor loss reads the critic before its update, the critic target
reads the target critic before the EMA, and the EMA blends in the updated critic.

For a discrete actor no gradient crosses the imagination (the reference stops it at the
advantage and the trajectory), so the port runs the imagination without recording it.
For a continuous actor the objective is the advantage itself and the gradient flows back
through the imagined dynamics, which is where the GRU backward kernel runs at T*B rows.

Randomness: every draw of the step comes from one ``TrainDraws``: Gumbel noise for the
categorical samples (``argmax(logits + gumbel)``, as ``jax.random.categorical``) and
standard-normal (or uniform, for ``trunc_normal``) noise for a continuous actor. The
loop makes it in bulk on the device from a generator; the parity tests make it from
JAX's own keys.

The loop runs each iteration's gradient steps as one block (``utils/blocks.py``) of the
step captured once as a CUDA graph on a card (``utils/graphs.py``; eager on the CPU),
over batches gathered on the device from its replay ring (``buffer.device``,
``data/device_buffer.py``) or prefetched from the host buffer.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_loop import (
    LoopParts,
    TrainResult,
    fill_draws,
    grads,
    make_captured_step,
    run_loop,
    sequential_buffer,
    zero_draws,
)
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, update_moments
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.distributions import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.utils.registry import register_algorithm


class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch, discrete] Gumbel noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch, discrete] ... and of the posteriors
    actor0: Tuple[torch.Tensor, ...]  # per action head: the first imagined action's noise, [T*B, d]
    img_prior: torch.Tensor  # [horizon, T*B, stoch, discrete] imagined priors
    img_actor: Tuple[torch.Tensor, ...]  # per action head: [horizon, T*B, d]


def draw_shapes(
    T: int, B: int, horizon: int, stoch: int, discrete: int, actions_dim: Sequence[int], actor_noise: str
) -> TrainDraws:
    """The shape of every draw of one step, as a ``TrainDraws`` of shapes."""
    heads = list(actions_dim) if actor_noise == "gumbel" else [int(sum(actions_dim))]
    return TrainDraws(
        wm_prior=(T, B, stoch, discrete),
        wm_post=(T, B, stoch, discrete),
        actor0=tuple((T * B, d) for d in heads),
        img_prior=(horizon, T * B, stoch, discrete),
        img_actor=tuple((horizon, T * B, d) for d in heads),
    )


def sample_draws(
    T: int,
    B: int,
    horizon: int,
    stoch: int,
    discrete: int,
    actions_dim: Sequence[int],
    actor_noise: str,
    generator: Optional[torch.Generator],
    device: torch.device,
    out: Optional[TrainDraws] = None,
) -> TrainDraws:
    """Every draw of one step, made in bulk. ``actor_noise`` is ``gumbel`` (discrete
    heads), ``normal`` or ``uniform`` (continuous heads). With ``out`` (a ``TrainDraws``
    of float32 tensors of these shapes) the draws are written into it in place, as a
    captured step's static inputs are; the values are the same either way."""
    if out is None:
        out = zero_draws(draw_shapes(T, B, horizon, stoch, discrete, actions_dim, actor_noise), device)
    return fill_draws(out, ("gumbel", "gumbel", actor_noise, "gumbel", actor_noise), generator)


def make_train_step(world_model, actor, critic, target_critic, cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)``.

    ``train_step(opt_states, moments, data, update_target, draws=None, generator=None)``
    updates the four modules' parameters and ``opt_states`` in place and returns
    ``(new_moments, metrics)``. ``data`` holds ``[T, B, ...]`` tensors on the modules'
    device: the observation keys, ``actions``, ``rewards``, ``terminated`` and
    ``is_first``. ``update_target`` is a bool or a 0-d bool tensor on the device. Without
    ``draws``, the step draws its noise from ``generator``;
    ``train_step.sample_draws(T, B, generator, device, out=None)`` makes the draws of a
    ``[T, B]`` batch, ``train_step.draw_shapes(T, B)`` gives their shapes and
    ``train_step.init_extra()`` makes the first moments on the modules' device. The
    metrics are 0-d tensors on the device, read only when the loop logs.

    The step is graph-safe: it makes no host-to-device copy and no host sync, and reads
    every value that changes between steps (the optimizers' counts, the target flag, the
    draws) from a tensor, so ``utils/graphs.py`` can capture it once and replay it."""
    wm_cfg = cfg.algo.world_model
    stoch, discrete = wm_cfg.stochastic_size, wm_cfg.discrete_size
    stoch_size = stoch * discrete
    rec_size = wm_cfg.recurrent_model.recurrent_state_size
    horizon = cfg.algo.horizon
    gamma, lmbda = cfg.algo.gamma, cfg.algo.lmbda
    ent_coef = cfg.algo.actor.ent_coef
    is_continuous = actor.is_continuous
    actions_dim = tuple(actor.actions_dim)
    tau = cfg.algo.critic.tau
    moments_cfg = cfg.algo.actor.moments
    actor_noise = "gumbel" if not is_continuous else ("uniform" if actor.distribution == "trunc_normal" else "normal")
    cnn_keys, mlp_keys = list(cnn_keys), list(mlp_keys)

    wm_opt = make_optimizer(wm_cfg.optimizer, wm_cfg.clip_gradients)
    actor_opt = make_optimizer(cfg.algo.actor.optimizer, cfg.algo.actor.clip_gradients)
    critic_opt = make_optimizer(cfg.algo.critic.optimizer, cfg.algo.critic.clip_gradients)
    wm_params = list(world_model.parameters())
    actor_params = list(actor.parameters())
    critic_params = list(critic.parameters())
    target_params = list(target_critic.parameters())
    # the return moments' quantile levels, made once on the device (not in the step)
    levels = torch.tensor([moments_cfg.percentile.low, moments_cfg.percentile.high], device=wm_params[0].device)

    def init_opt_states() -> Dict[str, Any]:
        return {
            "world_model": wm_opt.init(wm_params),
            "actor": actor_opt.init(actor_params),
            "critic": critic_opt.init(critic_params),
        }

    def act(latent, noise):
        if is_continuous:
            return actor(latent, draws=noise)
        return actor(latent, gumbels=noise)

    def train_step(
        opt_states: Dict[str, Any],
        moments: Dict[str, torch.Tensor],
        data: Dict[str, torch.Tensor],
        update_target: bool | torch.Tensor,
        draws: Optional[TrainDraws] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        T, B = data["rewards"].shape[:2]
        device = data["rewards"].device
        if draws is None:
            draws = sample_draws(T, B, horizon, stoch, discrete, actions_dim, actor_noise, generator, device)
        batch_obs = {k: data[k] for k in cnn_keys + mlp_keys}
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)

        # ------------------------------------------------ world model
        embed = world_model.encode(batch_obs)  # [T, B, E]
        post = torch.zeros(B, stoch_size, device=device)
        rec = torch.zeros(B, rec_size, device=device)
        recs, posts, post_logits, prior_logits = [], [], [], []
        for t in range(T):
            rec, post, _, post_l, prior_l = world_model.dynamic(
                post, rec, batch_actions[t], embed[t], is_first[t], gumbels=(draws.wm_prior[t], draws.wm_post[t])
            )
            recs.append(rec)
            posts.append(post)
            post_logits.append(post_l)
            prior_logits.append(prior_l)
        recs, posts = torch.stack(recs), torch.stack(posts)
        latents = torch.cat([posts, recs], -1)  # [T, B, L]
        recon = world_model.decode(latents)
        obs_lp = 0.0
        for k in cnn_keys:
            target = data[k].float() / 255.0 - 0.5
            target = target.reshape(T, B, -1, *target.shape[-2:])
            obs_lp = obs_lp + MSEDistribution(recon[k], dims=3).log_prob(target)
        for k in mlp_keys:
            obs_lp = obs_lp + SymlogDistribution(recon[k], dims=1).log_prob(data[k])
        reward_lp = TwoHotEncodingDistribution(world_model.reward(latents), dims=1).log_prob(data["rewards"])
        continue_lp = Independent(BernoulliSafeMode(world_model.continues(latents)), 1).log_prob(1.0 - data["terminated"])
        post_logits_s = torch.stack(post_logits).reshape(T, B, stoch, discrete)
        prior_logits_s = torch.stack(prior_logits).reshape(T, B, stoch, discrete)
        rec_loss, metrics = reconstruction_loss(
            obs_lp,
            reward_lp,
            prior_logits_s,
            post_logits_s,
            wm_cfg.kl_dynamic,
            wm_cfg.kl_representation,
            wm_cfg.kl_free_nats,
            wm_cfg.kl_regularizer,
            continue_lp,
            wm_cfg.continue_scale_factor,
        )
        with torch.no_grad():
            metrics["State/post_entropy"] = Independent(OneHotCategorical(post_logits_s), 1).entropy().mean()
            metrics["State/prior_entropy"] = Independent(OneHotCategorical(prior_logits_s), 1).entropy().mean()
        metrics["Grads/world_model"] = wm_opt.update(wm_params, grads(rec_loss, wm_params), opt_states["world_model"])
        del rec_loss, recon, embed

        # ------------------------------------------------ imagination + actor
        latent0 = latents.detach().reshape(T * B, -1)
        prior = posts.detach().reshape(T * B, stoch_size)
        rec = recs.detach().reshape(T * B, rec_size)
        true_continue0 = (1.0 - data["terminated"]).reshape(T * B, 1)
        with torch.set_grad_enabled(is_continuous):
            action = torch.cat(act(latent0, draws.actor0)[0], -1)
            traj, imagined_actions = [latent0], [action]
            for i in range(horizon):
                prior, rec = world_model.imagination(prior, rec, action, gumbel=draws.img_prior[i])
                latent = torch.cat([prior, rec], -1)
                action = torch.cat(act(latent.detach(), tuple(n[i] for n in draws.img_actor))[0], -1)
                traj.append(latent)
                imagined_actions.append(action)
            traj = torch.stack(traj)  # [H+1, TB, L]
            imagined_actions = torch.stack(imagined_actions)  # [H+1, TB, A]

            values = TwoHotEncodingDistribution(critic(traj), dims=1).mean
            rewards_img = TwoHotEncodingDistribution(world_model.reward(traj), dims=1).mean
            continues = BernoulliSafeMode(world_model.continues(traj)).mode
            continues = torch.cat([true_continue0[None], continues[1:]], 0)

            # lambda-returns, a reverse scan over the imagined steps
            interm = rewards_img[1:] + continues[1:] * gamma * values[1:] * (1 - lmbda)
            carry, lambda_values = values[-1], [None] * horizon
            for t in reversed(range(horizon)):
                carry = interm[t] + continues[t + 1] * gamma * lmbda * carry
                lambda_values[t] = carry
            lambda_values = torch.stack(lambda_values)
            discount = (torch.cumprod(continues * gamma, 0) / gamma).detach()

        offset, invscale, new_moments = update_moments(
            moments,
            lambda_values,
            decay=moments_cfg.decay,
            max_=moments_cfg.max,
            percentile_low=moments_cfg.percentile.low,
            percentile_high=moments_cfg.percentile.high,
            levels=levels,
        )
        advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
        _, dists = actor(traj.detach())
        if is_continuous:
            objective = advantage
            entropy = ent_coef * dists[0].entropy().sum(-1)
        else:
            logpis, offset_a = [], 0
            for i, d in enumerate(dists):
                logpis.append(d.log_prob(imagined_actions[..., offset_a : offset_a + actions_dim[i]].detach())[:-1])
                offset_a += actions_dim[i]
            objective = sum(logpis)[..., None] * advantage.detach()
            entropy = ent_coef * sum(d.entropy() for d in dists)
        policy_loss = -torch.mean(discount[:-1] * (objective + entropy[:-1][..., None]))
        metrics["Grads/actor"] = actor_opt.update(actor_params, grads(policy_loss, actor_params), opt_states["actor"])
        metrics["Loss/policy_loss"] = policy_loss.detach()
        traj, lambda_values = traj.detach(), lambda_values.detach()
        del policy_loss, objective, advantage, values, rewards_img

        # ------------------------------------------------ critic
        qv = TwoHotEncodingDistribution(critic(traj[:-1]), dims=1)
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target_critic(traj[:-1]), dims=1).mean
        value_loss = torch.mean((-qv.log_prob(lambda_values) - qv.log_prob(target_values)) * discount[:-1][..., 0])
        metrics["Grads/critic"] = critic_opt.update(critic_params, grads(value_loss, critic_params), opt_states["critic"])
        metrics["Loss/value_loss"] = value_loss.detach()

        # EMA of the target critic towards the updated critic where the flag is set: the
        # blend is computed every step and kept only where it is, which gives the same
        # bits as blending in place under a host-side ``if``
        with torch.no_grad():
            if not isinstance(update_target, torch.Tensor):
                update_target = torch.full((), bool(update_target), device=device)
            blended = torch._foreach_mul(target_params, 1 - tau)
            torch._foreach_add_(blended, critic_params, alpha=tau)
            for p, b in zip(target_params, blended):
                p.copy_(torch.where(update_target.bool(), b, p))
        return new_moments, metrics

    def draws_of(T: int, B: int, generator: Optional[torch.Generator], device: torch.device, out: Optional[TrainDraws] = None):
        return sample_draws(T, B, horizon, stoch, discrete, actions_dim, actor_noise, generator, device, out=out)

    train_step.sample_draws = draws_of
    train_step.draw_shapes = lambda T, B: draw_shapes(T, B, horizon, stoch, discrete, actions_dim, actor_noise)
    train_step.init_extra = lambda: init_moments(levels.device)
    return train_step, init_opt_states


@register_algorithm(name="dreamer_v3")
def main(ctx, cfg) -> TrainResult:
    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        world_model, actor, critic, target_critic, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
        modules = {"world_model": world_model, "actor": actor, "critic": critic, "target_critic": target_critic}
        cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        train_step, init_opt_states = make_train_step(*modules.values(), cfg, cnn_keys, mlp_keys)
        opt_states, moments = init_opt_states(), train_step.init_extra()
        make_step = make_captured_step(
            train_step, modules, opt_states, moments, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen
        )
        return LoopParts(
            modules=modules,
            opt_states=opt_states,
            extra_state={"moments": moments},
            make_step=make_step,
            player_step=make_player_step(world_model, actor, actions_dim, cfg.algo.world_model.discrete_size),
            rb=sequential_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
            count_offset=1,
            clip_reward=lambda r: np.clip(r, -1, 1),
            exploration=None,
        )

    return run_loop(ctx, cfg, setup)
