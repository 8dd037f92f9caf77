"""DreamerV3 training (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``): the gradient step
``make_train_step`` and the training entry ``main``, which runs the Dreamer training
loop ``run_loop`` that DreamerV2 shares (``algos/dreamer_loop.py``).

One call runs, in the reference's order: the world-model update (the 64-step RSSM
unroll as a Python loop, each step through the ``layernorm_gru`` kernels; with the
decoupled RSSM, the whole posterior first as one call and then the prior chain alone),
the 15-step imagination and the actor update, the critic update, the EMA of the target
critic and the update of the return moments. The pieces (``world_model_loss``,
``imagine``, ``lambda_returns``, ``policy_loss``, ``critic_loss``, ``ema_target``) are
P2E-DV3's too.

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
    PHASES,
    REGISTERS,
    LoopParts,
    TrainResult,
    act,
    actor_noise_kind,
    fill_draws,
    grads,
    make_captured_step,
    run_loop,
    sequential_buffer,
    update_module,
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
from sheeprl_tpu_torch.obs.health import StepHealth, health_enabled
from sheeprl_tpu_torch.utils.registry import register_algorithm


class TrainDraws(NamedTuple):
    wm_prior: torch.Tensor  # [T, B, stoch, discrete] Gumbel noise of the RSSM priors
    wm_post: torch.Tensor  # [T, B, stoch, discrete] ... and of the posteriors (decoupled: of the one vectorized call)
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


def unroll(world_model, embed: torch.Tensor, batch_actions: torch.Tensor, is_first: torch.Tensor, wm_prior, wm_post, decoupled: bool):
    """The RSSM over a ``[T, B]`` batch from a zero carry: ``(posts, recs, post_logits,
    prior_logits)``, each ``[T, B, ...]``. Coupled, each step samples its prior and its
    posterior (``wm_prior[t]``, ``wm_post[t]``); decoupled, the whole posterior is one
    call on the embeddings (Gumbel noise ``wm_post``), and the unroll steps the prior
    chain alone, each from the previous step's posterior."""
    T, B = embed.shape[:2]
    rec = torch.zeros(B, world_model.rssm.recurrent_state_size, device=embed.device)
    recs, posts, post_logits, prior_logits = [], [], [], []
    if decoupled:
        post_l, post_sample = world_model.representation_from_embed(embed, gumbel=wm_post)
        posts = post_sample.flatten(-2)
        prev_posts = torch.cat([torch.zeros_like(posts[:1]), posts[:-1]], 0)
        for t in range(T):
            rec, _, prior_l = world_model.dynamic(prev_posts[t], rec, batch_actions[t], is_first[t], gumbel=wm_prior[t])
            recs.append(rec)
            prior_logits.append(prior_l)
        return posts, torch.stack(recs), post_l, torch.stack(prior_logits)
    post = torch.zeros(B, world_model.rssm.stochastic_size * world_model.rssm.discrete_size, device=embed.device)
    for t in range(T):
        rec, post, _, post_l, prior_l = world_model.dynamic(post, rec, batch_actions[t], embed[t], is_first[t], gumbels=(wm_prior[t], wm_post[t]))
        recs.append(rec)
        posts.append(post)
        post_logits.append(post_l)
        prior_logits.append(prior_l)
    return torch.stack(posts), torch.stack(recs), torch.stack(post_logits), torch.stack(prior_logits)


def world_model_loss(world_model, wm_cfg, data: Dict[str, torch.Tensor], wm_prior, wm_post, cnn_keys, mlp_keys, detach_heads: bool = False):
    """DreamerV3's world-model loss on a ``[T, B]`` batch (the unroll, the decoders'
    symlog/MSE likelihoods, the two-hot reward, the continue flag, the balanced KL):
    ``(loss, metrics, posts, recs)``. ``detach_heads``: the reward and continue heads
    read the latents with their gradient stopped (P2E-DV3)."""
    T, B = data["rewards"].shape[:2]
    stoch, discrete = wm_cfg.stochastic_size, wm_cfg.discrete_size
    is_first = data["is_first"].clone()
    is_first[0] = 1.0
    batch_actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], 0)
    embed = world_model.encode({k: data[k] for k in [*cnn_keys, *mlp_keys]})  # [T, B, E]
    posts, recs, post_logits, prior_logits = unroll(
        world_model, embed, batch_actions, is_first, wm_prior, wm_post, bool(wm_cfg.get("decoupled_rssm", False))
    )
    latents = torch.cat([posts, recs], -1)  # [T, B, L]
    recon = world_model.decode(latents)
    obs_lp = 0.0
    for k in cnn_keys:
        target = data[k].float() / 255.0 - 0.5
        target = target.reshape(T, B, -1, *target.shape[-2:])
        obs_lp = obs_lp + MSEDistribution(recon[k], dims=3).log_prob(target)
    for k in mlp_keys:
        obs_lp = obs_lp + SymlogDistribution(recon[k], dims=1).log_prob(data[k])
    head_in = latents.detach() if detach_heads else latents
    reward_lp = TwoHotEncodingDistribution(world_model.reward(head_in), dims=1).log_prob(data["rewards"])
    continue_lp = Independent(BernoulliSafeMode(world_model.continues(head_in)), 1).log_prob(1.0 - data["terminated"])
    post_logits_s = post_logits.reshape(T, B, stoch, discrete)
    prior_logits_s = prior_logits.reshape(T, B, stoch, discrete)
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
    return rec_loss, metrics, posts, recs


def imagine(world_model, actor, latent0, prior, rec, actor0, img_prior, img_actor, horizon: int):
    """``horizon`` prior-only steps of ``actor`` from ``latent0`` (its posterior ``prior``
    and recurrent state ``rec``), under the injected noise: ``(traj [H+1, TB, L],
    actions [H+1, TB, A])``. Each action reads its latent with the gradient stopped."""
    action = act(actor, latent0, actor0)
    traj, imagined_actions = [latent0], [action]
    for i in range(horizon):
        prior, rec = world_model.imagination(prior, rec, action, gumbel=img_prior[i])
        latent = torch.cat([prior, rec], -1)
        action = act(actor, latent.detach(), tuple(n[i] for n in img_actor))
        traj.append(latent)
        imagined_actions.append(action)
    return torch.stack(traj), torch.stack(imagined_actions)


def lambda_returns(rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, gamma: float, lmbda: float) -> torch.Tensor:
    """The lambda-returns of an imagined trajectory, a reverse scan: ``[H, TB, 1]``."""
    horizon = values.shape[0] - 1
    interm = rewards[1:] + continues[1:] * gamma * values[1:] * (1 - lmbda)
    carry, out = values[-1], [None] * horizon
    for t in reversed(range(horizon)):
        carry = interm[t] + continues[t + 1] * gamma * lmbda * carry
        out[t] = carry
    return torch.stack(out)


def imagined_continues(world_model, traj: torch.Tensor, terminated: torch.Tensor) -> torch.Tensor:
    """The continue flags of an imagined trajectory: the replay's at its start, the
    continue head's mode after. ``[H+1, TB, 1]``."""
    continues = BernoulliSafeMode(world_model.continues(traj)).mode
    return torch.cat([(1.0 - terminated).reshape(1, -1, 1), continues[1:]], 0)


def policy_loss(actor, traj: torch.Tensor, imagined_actions: torch.Tensor, advantage: torch.Tensor, discount: torch.Tensor, ent_coef: float) -> torch.Tensor:
    """DreamerV3's actor loss: the advantage itself (continuous: its gradient crosses the
    imagination) or REINFORCE, ``log pi(a) * advantage`` (stopped), plus the entropy
    bonus, weighted by the discount."""
    _, dists = actor(traj.detach())
    if actor.is_continuous:
        objective = advantage
        entropy = ent_coef * dists[0].entropy().sum(-1)
    else:
        logpis, offset = [], 0
        for i, d in enumerate(dists):
            dim = actor.actions_dim[i]
            logpis.append(d.log_prob(imagined_actions[..., offset : offset + dim].detach())[:-1])
            offset += dim
        objective = sum(logpis)[..., None] * advantage.detach()
        entropy = ent_coef * sum(d.entropy() for d in dists)
    return -torch.mean(discount[:-1] * (objective + entropy[:-1][..., None]))


def critic_loss(critic, target_critic, traj: torch.Tensor, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """The two-hot critic's loss toward the lambda-returns and the target critic's values."""
    qv = TwoHotEncodingDistribution(critic(traj[:-1]), dims=1)
    with torch.no_grad():
        target_values = TwoHotEncodingDistribution(target_critic(traj[:-1]), dims=1).mean
    return torch.mean((-qv.log_prob(lambda_values) - qv.log_prob(target_values)) * discount[:-1][..., 0])


@torch.no_grad()
def ema_target(target_params, critic_params, tau: float, update_target: torch.Tensor) -> None:
    """The EMA of the target critic towards the critic where the flag is set: the blend is
    computed every step and kept only where it is, which gives the same bits as
    blending in place under a host-side ``if``."""
    blended = torch._foreach_mul(target_params, 1 - tau)
    torch._foreach_add_(blended, critic_params, alpha=tau)
    for p, b in zip(target_params, blended):
        p.copy_(torch.where(update_target.bool(), b, p))


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

    With ``algo.world_model.decoupled_rssm`` the world model's posterior is one call over
    the batch (``wm_post`` its noise) and the unroll steps the priors alone (``unroll``).

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
    # the return moments' quantile levels, made once on the device (not in the step)
    levels = torch.tensor([moments_cfg.percentile.low, moments_cfg.percentile.high], device=wm_params[0].device)

    def init_opt_states() -> Dict[str, Any]:
        return {
            "world_model": wm_opt.init(wm_params),
            "actor": actor_opt.init(actor_params),
            "critic": critic_opt.init(critic_params),
        }

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

        # ------------------------------------------------ world model
        rec_loss, metrics, posts, recs = world_model_loss(world_model, wm_cfg, data, draws.wm_prior, draws.wm_post, cnn_keys, mlp_keys)
        probe = StepHealth() if health else None
        metrics["Grads/world_model"] = update_module(probe, "world_model", wm_opt, wm_params, grads(rec_loss, wm_params), opt_states["world_model"])
        del rec_loss

        # ------------------------------------------------ imagination + actor
        latent0 = torch.cat([posts, recs], -1).detach().reshape(T * B, -1)
        prior0 = posts.detach().reshape(T * B, stoch_size)
        rec0 = recs.detach().reshape(T * B, rec_size)
        with torch.set_grad_enabled(is_continuous):
            traj, imagined_actions = imagine(
                world_model, actor, latent0, prior0, rec0, draws.actor0, draws.img_prior, draws.img_actor, horizon
            )
            values = TwoHotEncodingDistribution(critic(traj), dims=1).mean
            rewards_img = TwoHotEncodingDistribution(world_model.reward(traj), dims=1).mean
            continues = imagined_continues(world_model, traj, data["terminated"])
            lambda_values = lambda_returns(rewards_img, values, continues, gamma, lmbda)
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
        loss = policy_loss(actor, traj, imagined_actions, advantage, discount, ent_coef)
        metrics["Grads/actor"] = update_module(probe, "actor", actor_opt, actor_params, grads(loss, actor_params), opt_states["actor"])
        metrics["Loss/policy_loss"] = loss.detach()
        traj, lambda_values = traj.detach(), lambda_values.detach()
        del loss, advantage, values, rewards_img

        # ------------------------------------------------ critic
        value_loss = critic_loss(critic, target_critic, traj, lambda_values, discount)
        metrics["Grads/critic"] = update_module(probe, "critic", critic_opt, critic_params, grads(value_loss, critic_params), opt_states["critic"])
        metrics["Loss/value_loss"] = value_loss.detach()
        if not isinstance(update_target, torch.Tensor):
            update_target = torch.full((), bool(update_target), device=device)
        ema_target(target_params, critic_params, tau, update_target)
        if probe is not None:
            params = {"world_model": wm_params, "actor": actor_params, "critic": critic_params, "target_critic": target_params}
            aux = {"critic_value_mean": lambda_values.mean(), "critic_value_std": lambda_values.std(correction=0)}
            metrics.update(probe.metrics(params, aux))
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
            train_step, modules, opt_states, moments, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen,
            f"{cfg.algo.name}/train_block",
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

    return run_loop(ctx, cfg, setup, handled=("algo.world_model.decoupled_rssm", REGISTERS), phases=PHASES)
