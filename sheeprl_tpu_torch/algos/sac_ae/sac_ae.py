"""SAC-AE training (counterpart of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``).

The update (``make_sac_ae_update``, the reference's ``make_sac_ae_train_fn``), one
gradient step at cumulative count ``c``:

* the critic step, every step: one Adam over the encoder and the critics together, on
  the target from the target encoder, the actor and the target critics;
* the targets' EMA (critics at ``algo.critic.tau``, encoder at ``algo.encoder.tau``)
  where ``c % critic.per_rank_target_network_update_freq == 0``;
* the actor and temperature step on the (updated) encoder's features, no gradient into
  the encoder, where ``c % actor.per_rank_update_freq == 0``;
* the autoencoder step where ``c % decoder.per_rank_update_freq == 0``: the
  reconstruction of the bit-reduced frame plus an L2 penalty on the features, the
  encoder stepped by its own Adam (``algo.encoder.optimizer``) and the decoder by its
  Adam with weight decay as L2 (``algo.decoder.optimizer``).

The reference gates the three branches with ``lax.cond`` on the count before the step,
so a skipped branch leaves its parameters, its Adam moments AND its Adam count as they
were. A captured graph cannot branch on the host, so the port captures one graph per
pattern of the three cadences (two at the published 2, 2, 1) over the same static
inputs, and the block replays, step by step, the graph of the step's count
(``utils/blocks.py::make_train_block``'s ``select``). The replay holds uint8 frames;
the step divides them by 255.

``main``: ``sac/sac.py::run_sac_loop`` over the frames of ``algo.cnn_keys.encoder``
(frame-stacked keys and several keys concatenated along the channels). The reference's
SAC-AE loop acts synchronously, and replays its random prefill after a resume; so does
this one. The layers compute in ``mesh.precision``'s dtype, as the reference's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_loop import fill_draws, zero_draws
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import ema_target
from sheeprl_tpu_torch.algos.loop_common import grads
from sheeprl_tpu_torch.algos.sac.loss import critic_loss
from sheeprl_tpu_torch.algos.sac.sac import (
    METRICS,
    SACDraws,
    SACParts,
    actor_and_alpha_step,
    init_opt_states,
    make_optimizers,
    refuse_precision_override,
    run_sac_loop,
    sample_tanh,
    td_target,
)
from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS as SAC_KEYS
from sheeprl_tpu_torch.algos.sac.utils import pixel_rows
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, build_agent, frame_channels, preprocess_obs
from sheeprl_tpu_torch.utils.graphs import StepGraph, tree_tensors
from sheeprl_tpu_torch.utils.registry import register_algorithm

AGGREGATOR_KEYS = SAC_KEYS | {"Loss/reconstruction_loss"}
AE_METRICS = (*METRICS, "Loss/reconstruction_loss")
OPTIMIZED = ("actor", "critic", "alpha", "encoder", "decoder")


class Cadence(NamedTuple):
    """Which branches run at a step: the targets' EMA, the actor and temperature, the
    autoencoder."""

    target: bool
    actor: bool
    decoder: bool


def cadence_of(cfg) -> Callable[[int], Cadence]:
    """The step's ``Cadence`` from its cumulative count before it (the reference tests
    the count before the increment)."""
    algo = cfg.algo
    target_freq = int(algo.critic.per_rank_target_network_update_freq)
    actor_freq, decoder_freq = int(algo.actor.per_rank_update_freq), int(algo.decoder.per_rank_update_freq)
    return lambda count: Cadence(count % target_freq == 0, count % actor_freq == 0, count % decoder_freq == 0)


def cadence_period(cfg) -> int:
    algo = cfg.algo
    freqs = (algo.critic.per_rank_target_network_update_freq, algo.actor.per_rank_update_freq, algo.decoder.per_rank_update_freq)
    return math.lcm(*(int(f) for f in freqs))


def make_sac_ae_update(agent: SACAEAgent, cfg, act_dim: int):
    """``(update, opts, opt_states)``: ``update(opt_states, batch, cadence, draws)`` is
    one SAC-AE gradient step in place on ``agent`` and ``opt_states`` (``batch``:
    ``obs``/``next_obs`` uint8 ``[B, C, H, W]``, ``actions``, ``rewards``, ``dones``;
    ``draws``: a ``SACDraws`` of ``[B, act_dim]`` normals); a skipped branch touches
    nothing and reports a zero loss. The critic's optimizer covers the encoder and the
    critics (``opt_states["critic"]`` over ``encoder`` then ``critic`` parameters)."""
    algo = cfg.algo
    opts = make_optimizers(cfg, names=OPTIMIZED)
    enc, crit = list(agent.encoder.parameters()), list(agent.critic.parameters())
    opt_states = init_opt_states(opts, {
        "actor": agent.actor.parameters(), "critic": enc + crit, "alpha": [agent.log_alpha],
        "encoder": enc, "decoder": agent.decoder.parameters(),
    })
    gamma, target_entropy = float(algo.gamma), -float(act_dim)
    critic_tau, encoder_tau, l2_lambda = float(algo.critic.tau), float(algo.encoder.tau), float(algo.decoder.l2_lambda)

    def update(opt_states, batch, cadence: Cadence, draws) -> Dict[str, torch.Tensor]:
        alpha = agent.log_alpha.detach().exp()
        obs, next_obs = batch["obs"].float() / 255.0, batch["next_obs"].float() / 255.0
        with torch.no_grad():
            z_next = agent.target_encoder(next_obs)
        target = td_target(agent.actor, agent.target_critic, batch, z_next, alpha, gamma, draws.next)
        enc_crit = enc + crit
        cl = critic_loss(agent.critic(agent.encoder(obs), batch["actions"]), target)
        opts["critic"].update(enc_crit, grads(cl, enc_crit), opt_states["critic"])
        zero = torch.zeros((), device=cl.device)
        al = tl = rl = zero
        if cadence.target:
            on = torch.ones((), dtype=torch.bool, device=cl.device)
            ema_target(list(agent.target_critic.parameters()), crit, critic_tau, on)
            ema_target(list(agent.target_encoder.parameters()), enc, encoder_tau, on)
        if cadence.actor:
            with torch.no_grad():
                z = agent.encoder(obs)
            q_fn = lambda f, a: torch.amin(agent.critic(f, a), 0)  # noqa: E731
            al, tl = actor_and_alpha_step(agent, opts, opt_states, z, q_fn, draws.new, target_entropy)
        if cadence.decoder:
            z = agent.encoder(obs)
            recon = agent.decoder(z)
            mse = ((recon - preprocess_obs(batch["obs"], bits=5)) ** 2).mean()
            rl = mse + l2_lambda * (0.5 * (z**2).sum(-1)).mean()
            dec = list(agent.decoder.parameters())
            g = grads(rl, enc + dec)
            opts["encoder"].update(enc, g[: len(enc)], opt_states["encoder"])
            opts["decoder"].update(dec, g[len(enc):], opt_states["decoder"])
            rl = rl.detach()
        return dict(zip(AE_METRICS, (cl.detach(), al, tl, rl)))

    return update, opts, opt_states


def make_cadence_steps(update, state, opt_states, cfg, batch_size: int, act_dim: int, generator):
    """``make_step`` for ``make_transition_replay``: one captured step per pattern of
    the cadences over one period of the counts, all over the same static inputs, and
    ``select(count)``, the step of a count's pattern."""
    cadence, period = cadence_of(cfg), cadence_period(cfg)

    def make_step(example):
        gather = example.get("gather")
        device = example["table"].device
        inputs = {k: v for k, v in example.items() if k != "gather"}
        inputs["draws"] = zero_draws(SACDraws((batch_size, act_dim), (batch_size, act_dim)), device)
        B = batch_size

        def fn_for(pattern: Cadence):
            def fn(inp):
                table = inp["table"]
                batch = gather(table[:B], table[B : 2 * B]) if gather is not None else inp["batch"]
                return update(opt_states, batch, pattern, inp["draws"])

            return fn

        graphs: Dict[Cadence, StepGraph] = {}
        for phase in range(period):
            pattern = cadence(phase)
            if pattern not in graphs:
                graphs[pattern] = StepGraph(fn_for(pattern), inputs, state)
        select = lambda count: graphs[cadence(count % period)]  # noqa: E731
        return select(0), lambda out: fill_draws(out, ("normal", "normal"), generator), select

    return make_step


def sac_ae_parts(ctx, cfg, obs_space, act_space) -> SACParts:
    refuse_precision_override(cfg)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    agent = build_agent(ctx, act_space, obs_space, cfg)
    act_dim = int(np.prod(act_space.shape))
    update, _, opt_states = make_sac_ae_update(agent, cfg, act_dim)
    state = list(agent.parameters()) + tree_tensors(opt_states)
    c = frame_channels(obs_space, cnn_keys)
    h, w = obs_space[cnn_keys[0]].shape[-2:]

    def features(rows: torch.Tensor) -> torch.Tensor:
        return agent.encoder(rows.float() / 255.0)

    @torch.no_grad()
    def policy(rows: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return sample_tanh(agent.actor, features(rows), generator)

    return SACParts(
        agent=agent,
        opt_states=opt_states,
        obs_spec=((c, h, w), np.uint8),
        to_rows=lambda o: pixel_rows(o, cnn_keys),
        policy=policy,
        greedy=lambda rows: torch.tanh(agent.actor(features(rows))[0]),
        make_step=make_cadence_steps(update, state, opt_states, cfg, cfg.algo.per_rank_batch_size, act_dim, ctx.rng()),
    )


@register_algorithm(name="sac_ae")
def main(ctx, cfg):
    return run_sac_loop(ctx, cfg, sac_ae_parts, AGGREGATOR_KEYS, prefill_on_resume=True)
