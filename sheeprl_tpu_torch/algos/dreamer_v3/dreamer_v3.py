"""DreamerV3 training (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``): the gradient step
``make_train_step`` and the training loop ``main``.

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

import contextlib
import os
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, build_agent, make_player_step, parse_actions_dim
from sheeprl_tpu_torch.algos.dreamer_v3.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import AGGREGATOR_KEYS, init_moments, prepare_obs, test, update_moments
from sheeprl_tpu_torch.algos.ppo.ppo import Optimizer, make_optimizer
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import save_config
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import make_device_replay
from sheeprl_tpu_torch.distributions import (
    BernoulliSafeMode,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.utils.env import make_vector_env
from sheeprl_tpu_torch.utils.graphs import StepGraph, tree_tensors
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import make_aggregator, record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import Timer
from sheeprl_tpu_torch.utils.utils import Ratio


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


def zero_draws(shapes: TrainDraws, device: torch.device) -> TrainDraws:
    """A ``TrainDraws`` of float32 zeros of ``shapes`` (``draw_shapes``)."""
    return TrainDraws(*(
        tuple(torch.zeros(s, device=device) for s in f) if isinstance(f[0], tuple) else torch.zeros(f, device=device)
        for f in shapes
    ))


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
    tiny = torch.finfo(torch.float32).tiny

    def fill(t: torch.Tensor, kind: str) -> None:
        if kind == "gumbel":  # -log(-log(u)), as gumbel_noise
            t.uniform_(generator=generator).clamp_(tiny, 1.0).log_().neg_().log_().neg_()
        elif kind == "normal":
            t.normal_(generator=generator)
        else:
            t.uniform_(generator=generator).mul_(1 - 2e-5).add_(1e-5)

    # one generator stream, in field order
    fill(out.wm_prior, "gumbel")
    fill(out.wm_post, "gumbel")
    for t in out.actor0:
        fill(t, actor_noise)
    fill(out.img_prior, "gumbel")
    for t in out.img_actor:
        fill(t, actor_noise)
    return out


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_train_step(world_model, actor, critic, target_critic, cfg, cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """Build ``(train_step, init_opt_states)``.

    ``train_step(opt_states, moments, data, update_target, draws=None, generator=None)``
    updates the four modules' parameters and ``opt_states`` in place and returns
    ``(new_moments, metrics)``. ``data`` holds ``[T, B, ...]`` tensors on the modules'
    device: the observation keys, ``actions``, ``rewards``, ``terminated`` and
    ``is_first``. ``update_target`` is a bool or a 0-d bool tensor on the device. Without
    ``draws``, the step draws its noise from ``generator``;
    ``train_step.sample_draws(T, B, generator, device, out=None)`` makes the draws of a
    ``[T, B]`` batch and ``train_step.draw_shapes(T, B)`` gives their shapes. The metrics are 0-d tensors on the device, read only when the loop
    logs.

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
        metrics["Grads/world_model"] = wm_opt.update(wm_params, _grads(rec_loss, wm_params), opt_states["world_model"])
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
        metrics["Grads/actor"] = actor_opt.update(actor_params, _grads(policy_loss, actor_params), opt_states["actor"])
        metrics["Loss/policy_loss"] = policy_loss.detach()
        traj, lambda_values = traj.detach(), lambda_values.detach()
        del policy_loss, objective, advantage, values, rewards_img

        # ------------------------------------------------ critic
        qv = TwoHotEncodingDistribution(critic(traj[:-1]), dims=1)
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(target_critic(traj[:-1]), dims=1).mean
        value_loss = torch.mean((-qv.log_prob(lambda_values) - qv.log_prob(target_values)) * discount[:-1][..., 0])
        metrics["Grads/critic"] = critic_opt.update(critic_params, _grads(value_loss, critic_params), opt_states["critic"])
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
    return train_step, init_opt_states


def make_captured_step(train_step, modules: Dict[str, torch.nn.Module], opt_states, moments, T: int, B: int, generator):
    """``make_step(example_inputs) -> (step, draw)`` for ``make_device_replay``: the
    train step over static inputs, captured as a CUDA graph on a card
    (``utils/graphs.py``). The inputs are the step table (``[2B + 1]`` int64: the replay
    indices and the target flag, or ``[1]``: the flag), the batch (host replay) or the
    ring's ``gather`` (device replay, read inside the step), and the draws, which
    ``draw(draws)`` writes from ``generator`` before each step. Each step updates the
    parameters, ``opt_states`` and ``moments`` in place and returns its metrics."""

    def make_step(example: Dict[str, Any]):
        gather = example.get("gather")
        device = example["table"].device
        inputs = {k: v for k, v in example.items() if k != "gather"}
        inputs["draws"] = zero_draws(train_step.draw_shapes(T, B), device)

        def fn(inp):
            table = inp["table"]
            batch = gather(table[:B], table[B : 2 * B]) if gather is not None else inp["batch"]
            new_moments, metrics = train_step(opt_states, moments, batch, table[-1] != 0, draws=inp["draws"])
            for k in moments:
                moments[k].copy_(new_moments[k])
            return metrics

        state = [p for m in modules.values() for p in m.parameters()] + tree_tensors(opt_states) + tree_tensors(moments)
        step = StepGraph(fn, inputs, state)
        return step, lambda out: train_step.sample_draws(T, B, generator, device, out=out)

    return make_step


# ---------------------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------------------

# (key, test on its value, what the reference does there that the port does not yet)
_NOT_PORTED = (
    ("rollout.pipeline_depth", lambda v: int(v or 0) > 0, "the pipelined player"),
    ("env.pool.enabled", bool, "the shared-memory env pool"),
    ("obs.enabled", bool, "the training monitor"),
    ("obs.health", bool, "the health diagnostics"),
    ("obs.flight_recorder", bool, "the flight recorder"),
    ("analysis.strict", bool, "strict mode"),
    ("fault.autoresume", bool, "the training guard"),
    ("model_manager.disabled", lambda v: v is not None and not v, "the model manager"),
    ("logger.name", lambda v: v not in (None, "tensorboard"), "the MLflow logger"),
    ("algo.world_model.decoupled_rssm", bool, "the decoupled RSSM"),
    ("mesh.devices", lambda v: v not in (None, 1, "auto"), "more than one device"),
    ("mesh.data", lambda v: v not in (None, -1, 1), "more than one device"),
    ("mesh.model", lambda v: v not in (None, 1), "tensor parallelism"),
    ("mesh.sequence", lambda v: v not in (None, 1), "sequence parallelism"),
)


def refuse_unported(cfg: Dict[str, Any]) -> None:
    """Raise, naming the key, when the config asks for a loop feature of the reference
    that the port does not have: such a key is never silently ignored."""
    for key, asks, what in _NOT_PORTED:
        node: Any = cfg
        for part in key.split("."):
            node = node.get(part) if isinstance(node, dict) else None
        if node is not None and asks(node):
            raise NotImplementedError(f"{key}={node!r} asks for {what}, which the PyTorch port does not have yet")


class TrainResult(NamedTuple):
    log_dir: str
    policy_steps: int
    grad_steps: int  # gradient steps of this run (a resumed run counts its own)
    checkpoint: Optional[str]  # the last checkpoint written, if any
    seconds: float  # wall time of the loop
    train_seconds: float  # wall time of dispatching the gradient steps (host side)
    env_seconds: float  # wall time of acting and env stepping
    test_reward: Optional[float]


@register_algorithm(name="dreamer_v3")
def main(ctx, cfg) -> TrainResult:
    refuse_unported(cfg)
    device = ctx.device
    log_dir = get_log_dir(cfg)
    save_config(cfg, Path(log_dir) / "config.yaml")
    logger = get_logger(cfg, log_dir)
    timer = Timer(disabled=bool(cfg.metric.get("disable_timer", False)))

    envs = make_vector_env(cfg, cfg.seed, 0, log_dir if cfg.env.capture_video else None)
    obs_space = envs.single_observation_space
    act_space = envs.single_action_space
    is_continuous, actions_dim = parse_actions_dim(act_space)
    act_dim_sum = int(sum(actions_dim))
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    num_envs = cfg.env.num_envs

    world_model, actor, critic, target_critic, _ = build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
    modules = {"world_model": world_model, "actor": actor, "critic": critic, "target_critic": target_critic}
    train_step, init_opt_states = make_train_step(world_model, actor, critic, target_critic, cfg, cnn_keys, mlp_keys)
    opt_states = init_opt_states()
    moments = init_moments(device)
    target_update_freq = cfg.algo.critic.per_rank_target_network_update_freq
    player_step = make_player_step(world_model, actor, actions_dim, cfg.algo.world_model.discrete_size)
    stoch_size = cfg.algo.world_model.stochastic_size * cfg.algo.world_model.discrete_size
    rec_size = cfg.algo.world_model.recurrent_model.recurrent_state_size
    player_gen, train_gen = ctx.rng(), ctx.rng()

    def player_state_init(n: int) -> PlayerState:
        zeros = lambda d: torch.zeros((n, d), device=device)  # noqa: E731
        return PlayerState(zeros(rec_size), zeros(stoch_size), zeros(act_dim_sum))

    rb = EnvIndependentReplayBuffer(
        max(int(cfg.buffer.size) // max(num_envs, 1), 1),
        n_envs=num_envs,
        obs_keys=obs_keys,
        memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None,
        buffer_cls=SequentialReplayBuffer,
    )
    rb.seed(cfg.seed)
    batch_size = cfg.algo.per_rank_batch_size
    seq_len = cfg.algo.per_rank_sequence_length
    # The gradient steps: the train step captured once as a CUDA graph on a card (eager
    # on the CPU), replayed as one block per iteration over batches gathered on the
    # device from its replay ring (buffer.device) or prefetched from the host buffer.
    make_step = make_captured_step(train_step, modules, opt_states, moments, seq_len, batch_size, train_gen)
    try:
        dispatcher, mirror, prefetcher, run_block, rb_add = make_device_replay(
            ctx, cfg, rb, cnn_keys, mlp_keys, obs_space, act_dim_sum, make_step, target_update_freq
        )
    except BaseException:  # a failed capture raises: stop the env workers first
        envs.close()
        raise
    rb_lock = prefetcher.lock if prefetcher is not None else contextlib.nullcontext()

    aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
    aggregator.keep(AGGREGATOR_KEYS | set(cfg.metric.aggregator.get("metrics", {})))
    ckpt_manager = CheckpointManager(Path(log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)

    policy_steps_per_iter = num_envs * cfg.env.action_repeat
    total_steps = int(cfg.algo.total_steps)
    num_iters = max(total_steps // policy_steps_per_iter, 1) if not cfg.dry_run else 1
    learning_starts = cfg.algo.learning_starts // policy_steps_per_iter if not cfg.dry_run else 0

    start_iter, policy_step, last_log, last_checkpoint, cumulative_grad_steps = 1, 0, 0, 0, 0
    resume_from = cfg.checkpoint.get("resume_from")
    if resume_from:
        state = CheckpointManager.load(resume_from)  # on the host: the replay buffer stays there
        # in place: the captured step reads these tensors where they are
        for name, module in modules.items():
            module.load_state_dict(state["params"][name])
        for name, opt_state in opt_states.items():
            Optimizer.load_state(opt_state, state["opt_states"][name])
        for k, v in moments.items():
            v.copy_(state["moments"][k])
        ratio.load_state_dict(state["ratio"])
        start_iter = state["iter_num"] + 1
        policy_step = state["policy_step"]
        last_log = state.get("last_log", 0)
        last_checkpoint = state.get("last_checkpoint", 0)
        cumulative_grad_steps = state.get("cumulative_grad_steps", 0)
        learning_starts += start_iter
        if cfg.buffer.checkpoint and "rb" in state:
            rb.load_state_dict(state["rb"])
            if mirror is not None:
                mirror.load_from(rb)

    # Pending-row storage, as the reference: row t holds obs_t with the reward and flags
    # received on arriving at it (zeros and is_first=1 after a reset); the action taken
    # from obs_t is filled in just before the row is committed. At an episode's end an
    # extra row stores the true final observation with a zero action.
    def obs_row(o, idxs=None):
        row = {}
        for k in cnn_keys:
            v = np.asarray(o[k]) if idxs is None else np.asarray(o[k])[idxs]
            row[k] = v.reshape(1, v.shape[0], -1, *v.shape[-2:])
        for k in mlp_keys:
            v = np.asarray(o[k], dtype=np.float32) if idxs is None else np.asarray(o[k], dtype=np.float32)[idxs]
            row[k] = v.reshape(1, v.shape[0], -1)
        return row

    obs, _ = envs.reset(seed=cfg.seed)
    player_state = player_state_init(num_envs)
    step_data = obs_row(obs)
    step_data["rewards"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["terminated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["truncated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["is_first"] = np.ones((1, num_envs, 1), np.float32)
    is_first_np = np.ones((num_envs, 1), dtype=np.float32)
    prefill_iters = max(learning_starts - 1, 0)

    run_grad_steps, last_path = 0, None
    env_seconds_total, train_seconds = 0.0, 0.0
    run_start = time.perf_counter()
    try:
        for iter_num in range(start_iter, num_iters + 1):
            env_time = 0.0
            env_t0 = time.perf_counter()
            with timer("Time/env_interaction_time"):
                if iter_num <= learning_starts and not resume_from:
                    sampled = np.stack([act_space.sample() for _ in range(num_envs)])
                    if is_continuous:
                        stored_actions = env_actions = sampled.astype(np.float32)
                    else:
                        sampled = sampled.reshape(num_envs, -1)
                        stored_actions = np.concatenate(
                            [np.eye(d, dtype=np.float32)[sampled[:, i]] for i, d in enumerate(actions_dim)], -1
                        )
                        env_actions = sampled.squeeze(-1) if len(actions_dim) == 1 else sampled
                    player_state = player_state._replace(actions=torch.as_tensor(stored_actions, device=device))
                else:
                    with torch.no_grad():
                        obs_t = prepare_obs(obs, cnn_keys, mlp_keys, num_envs, device)
                        acts, stored, player_state = player_step(
                            player_state, obs_t, torch.as_tensor(is_first_np, device=device), player_gen
                        )
                        acts_np = [a.float().cpu().numpy() for a in acts]
                        stored_actions = stored.float().cpu().numpy()
                    if is_continuous:
                        env_actions = acts_np[0]
                    elif len(actions_dim) == 1:
                        env_actions = acts_np[0].argmax(-1)
                    else:
                        env_actions = np.stack([a.argmax(-1) for a in acts_np], -1)
                step_data["actions"] = stored_actions.reshape(1, num_envs, -1)
                rb_add(step_data, validate_args=cfg.buffer.validate_args)
            env_time += time.perf_counter() - env_t0

            if iter_num >= learning_starts:
                grad_steps = ratio((policy_step + policy_steps_per_iter - prefill_iters * policy_steps_per_iter))
                if grad_steps > 0:
                    train_t0 = time.perf_counter()
                    run_block(grad_steps, cumulative_grad_steps, stage_next=iter_num < num_iters)
                    cumulative_grad_steps += grad_steps
                    run_grad_steps += grad_steps
                    train_seconds += time.perf_counter() - train_t0

            env_t0 = time.perf_counter()
            with timer("Time/env_interaction_time"):
                next_obs, reward, terminated, truncated, info = envs.step(env_actions)
                if cfg.env.clip_rewards:
                    reward = np.clip(reward, -1, 1)
                done = np.logical_or(terminated, truncated)
                reward = np.asarray(reward, dtype=np.float32).reshape(num_envs, 1)
                # the true final observation of an ending episode (same-step autoreset
                # returns the reset one; the final one is in info["final_obs"])
                real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
                if done.any() and "final_obs" in info:
                    for i in np.nonzero(done)[0]:
                        if info["final_obs"][i] is not None:
                            for k in obs_keys:
                                real_next_obs[k][i] = np.asarray(info["final_obs"][i][k])
                step_data = obs_row(next_obs)
                step_data["rewards"] = reward.reshape(1, num_envs, 1).copy()
                step_data["terminated"] = terminated.astype(np.float32).reshape(1, num_envs, 1)
                step_data["truncated"] = truncated.astype(np.float32).reshape(1, num_envs, 1)
                step_data["is_first"] = np.zeros((1, num_envs, 1), np.float32)
                done_idxs = np.nonzero(done)[0].tolist()
                if done_idxs:
                    reset_data = obs_row(real_next_obs, idxs=done_idxs)
                    reset_data["rewards"] = step_data["rewards"][:, done_idxs]
                    reset_data["terminated"] = step_data["terminated"][:, done_idxs]
                    reset_data["truncated"] = step_data["truncated"][:, done_idxs]
                    reset_data["actions"] = np.zeros((1, len(done_idxs), act_dim_sum), np.float32)
                    reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
                    rb_add(reset_data, indices=done_idxs, validate_args=cfg.buffer.validate_args)
                    for k in ("rewards", "terminated", "truncated"):
                        step_data[k][:, done_idxs] = 0.0
                    step_data["is_first"][:, done_idxs] = 1.0
                is_first_np = done.astype(np.float32).reshape(num_envs, 1)
                obs = next_obs
                policy_step += policy_steps_per_iter
                record_episode_stats(aggregator, info)
            env_time += time.perf_counter() - env_t0
            env_seconds_total += env_time

            if (cfg.checkpoint.every > 0 and policy_step - last_checkpoint >= cfg.checkpoint.every) or (
                iter_num == num_iters and cfg.checkpoint.save_last
            ):
                ckpt_state = {
                    "params": {name: m.state_dict() for name, m in modules.items()},
                    "opt_states": opt_states,
                    "moments": moments,
                    "ratio": ratio.state_dict(),
                    "iter_num": iter_num,
                    "policy_step": policy_step,
                    "last_log": last_log,
                    "last_checkpoint": policy_step,
                    "cumulative_grad_steps": cumulative_grad_steps,
                }
                if cfg.buffer.checkpoint:
                    with rb_lock:
                        ckpt_state["rb"] = rb.state_dict()
                last_path = str(ckpt_manager.save(policy_step, ckpt_state))
                last_checkpoint = policy_step

            if logger is not None and (policy_step - last_log >= cfg.metric.log_every or iter_num == num_iters or cfg.dry_run):
                # the window's only blocking copy: every block's last metrics at once
                dispatcher.drain(aggregator)
                metrics = aggregator.compute()
                window_sps = dispatcher.pop_window_sps()
                if window_sps is not None:
                    metrics["Time/sps_train"] = window_sps
                metrics["Time/sps_env_interaction"] = policy_steps_per_iter / env_time if env_time > 0 else 0.0
                metrics["Params/replay_ratio"] = cumulative_grad_steps / policy_step if policy_step > 0 else 0.0
                metrics.update({k: v for k, v in timer.to_dict().items()})
                logger.log_metrics(metrics, policy_step)
                aggregator.reset()
                last_log = policy_step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        envs.close()
        if prefetcher is not None:
            prefetcher.close()
    seconds = time.perf_counter() - run_start
    test_reward = None
    if cfg.algo.run_test:
        test_reward = test(player_step, player_state_init, ctx, cfg, log_dir).reward
        if logger is not None:
            logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step)
    if logger is not None:
        logger.close()
    return TrainResult(log_dir, policy_step, run_grad_steps, last_path, seconds, train_seconds, env_seconds_total, test_reward)
