"""DroQ training (counterpart of ``sheeprl_tpu/algos/droq/droq.py``): SAC with
Dropout + LayerNorm critics at a high replay ratio.

* ``DroQCriticEnsemble``: ``n`` critics of ``Dense -> Dropout -> LayerNorm -> ReLU``
  twice and a scalar head (``droq.py:68-74`` there), stacked ``[n, in, out]``. Flax's
  LayerNorm epsilon (1e-6, not torch's 1e-5). Dropout keeps an activation with
  probability ``1 - rate`` and scales it by ``1 / (1 - rate)``; which ones it keeps is
  an input: ``noise``, one uniform tensor ``[n, B, hidden]`` per layer, keeps where
  ``noise < 1 - rate``. Without ``noise`` the critics are deterministic.
* The update (``make_droq_update``, the reference's ``make_droq_step_fns``): the
  critic step on the shared target (the target critics deterministic) with its EMA at
  every step where the flag is set, and, once per iteration after the block, the actor
  and temperature step on a batch of its own against the critics' MEAN (with dropout),
  not their minimum.
* ``main``: ``run_sac_loop`` with the actor step as the block's tail. The reference's
  DroQ loop acts synchronously (it does not read ``rollout.pipeline_depth``), and so
  does this one. The layers compute in ``mesh.precision``'s dtype, as the reference's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.dreamer_loop import capture_step, fill_draws, zero_draws
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import ema_target
from sheeprl_tpu_torch.algos.loop_common import grads
from sheeprl_tpu_torch.algos.p2e import Ensembles
from sheeprl_tpu_torch.algos.sac.loss import critic_loss
from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent, action_dim, init_agent, vector_dim
from sheeprl_tpu_torch.algos.sac.sac import (
    SACParts,
    actor_and_alpha_step,
    init_opt_states,
    make_optimizers,
    refuse_precision_override,
    run_sac_loop,
    sac_params,
    sample_tanh,
    td_target,
    transition_draws,
)
from sheeprl_tpu_torch.algos.sac.utils import vector_rows
from sheeprl_tpu_torch.obs.health import StepHealth, global_norm, health_enabled, module_slices
from sheeprl_tpu_torch.utils.graphs import StepGraph, tree_tensors
from sheeprl_tpu_torch.utils.registry import register_algorithm


class DroQCriticEnsemble(Ensembles):
    def __init__(self, input_dim: int, n: int = 2, hidden_size: int = 256, dropout: float = 0.01):
        super().__init__(n, input_dim, 1, dense_units=hidden_size, mlp_layers=2, activation="relu", layer_norm=True, norm_eps=1e-6)
        self.dropout = float(dropout)
        self.hidden_size = hidden_size

    def forward(self, obs: torch.Tensor, action: torch.Tensor, noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``[n, B, 1]`` float32; ``noise``: the dropout draws, or None (deterministic)."""
        h = torch.cat([obs, action.to(obs.dtype)], -1).reshape(1, -1, obs.shape[-1] + action.shape[-1])
        keep = 1.0 - self.dropout
        for i in range(2):
            h = self.dense[i](h)
            if noise is not None and self.dropout > 0:
                h = torch.where(noise[i] < keep, h / keep, torch.zeros_like(h))
            h = F.relu(self.norms[i](h))
        return self.dense[2](h).float()


class DroQDraws(NamedTuple):
    """A DroQ step's draws: a standard-normal action draw ``[B, act]`` and the critics'
    dropout noise, two uniform ``[n, B, hidden]``."""

    action: Any
    dropout: Any


def draw_shapes(batch_size: int, act_dim: int, n: int, hidden: int) -> DroQDraws:
    return DroQDraws((batch_size, act_dim), ((n, batch_size, hidden), (n, batch_size, hidden)))


DRAW_KINDS = ("normal", "uniform")


def build_agent(ctx, action_space: Any, obs_space: Any, cfg: Any) -> SACAgent:
    """DroQ's agent over ``algo.mlp_keys.encoder``, in ``mesh.precision``'s dtype."""
    act_dim = action_dim(action_space, "DroQ")
    obs_dim = vector_dim(obs_space, cfg.algo.mlp_keys.encoder)
    actor = SACActor(obs_dim, act_dim, cfg.algo.actor.hidden_size)
    critic = DroQCriticEnsemble(obs_dim + act_dim, cfg.algo.critic.n, cfg.algo.critic.hidden_size, cfg.algo.critic.dropout)
    return init_agent(SACAgent(actor, critic, cfg.algo.alpha.alpha), ctx, ctx.compute_dtype)


def make_droq_update(agent: SACAgent, cfg, act_dim: int):
    """``(critic_update, actor_update, opts, opt_states)``, in place on ``agent`` and
    ``opt_states``:

    * ``critic_update(opt_states, batch, update_target, draws)``: one critic step and
      its EMA where ``update_target`` (``DroQDraws``: the next action's, the critics'
      dropout); returns ``{"Loss/value_loss"}``;
    * ``actor_update(opt_states, obs, draws)``: the actor and temperature step on the
      critics' mean (``DroQDraws``: the new action's, the critics' dropout); returns
      ``{"Loss/policy_loss", "Loss/alpha_loss"}``."""
    opts = make_optimizers(cfg)
    opt_states = init_opt_states(opts, {"actor": agent.actor.parameters(), "critic": agent.critic.parameters(), "alpha": [agent.log_alpha]})
    gamma, tau, target_entropy = float(cfg.algo.gamma), float(cfg.algo.tau), -float(act_dim)
    health = health_enabled(cfg)  # read when the steps are built (obs/health.py)
    # the reference's critic step reports {"critic": grads}: a single-key tree, unwrapped
    # into the critic's own modules
    critic_slices = module_slices(agent.critic, {"dense": "Dense_{}", "norms": "LayerNorm_{}"}) if health else None

    def critic_update(opt_states, batch, update_target, draws) -> Dict[str, torch.Tensor]:
        alpha = agent.log_alpha.detach().exp()
        target = td_target(agent.actor, agent.critic_target, batch, batch["next_obs"], alpha, gamma, draws.action)
        c_params = list(agent.critic.parameters())
        qs = agent.critic(batch["obs"], batch["actions"], draws.dropout)
        cl = critic_loss(qs, target)
        g = grads(cl, c_params)
        if critic_slices is None:
            opts["critic"].update(c_params, g, opt_states["critic"])
        else:
            _, update_norms = opts["critic"].update(c_params, g, opt_states["critic"], update_norms=True)
        if not isinstance(update_target, torch.Tensor):
            update_target = torch.full((), bool(update_target), device=cl.device)
        ema_target(list(agent.critic_target.parameters()), c_params, tau, update_target)
        metrics = {"Loss/value_loss": cl.detach()}
        if critic_slices is not None:
            # the parameter norms and the finite fraction are the actor step's: in the
            # reference's block its metrics replace the critic steps' same names
            for name, sl in critic_slices.items():
                metrics[f"Health/grad_norm/{name}"] = global_norm(g[sl])
                metrics[f"Health/update_norm/{name}"] = torch.linalg.vector_norm(update_norms[sl])
            metrics["Health/target_q_mean"] = target.mean()
        return metrics

    def actor_update(opt_states, obs, draws) -> Dict[str, torch.Tensor]:
        # DroQ trains the actor on the critics' mean, not their minimum
        q_fn = lambda o, a: agent.critic(o, a, draws.dropout).mean(0)  # noqa: E731
        probe = StepHealth() if health else None
        al, tl = actor_and_alpha_step(agent, opts, opt_states, obs, q_fn, draws.action, target_entropy, probe)
        metrics = {"Loss/policy_loss": al, "Loss/alpha_loss": tl}
        if probe is not None:
            metrics.update(probe.metrics(sac_params(agent)))
        return metrics

    return critic_update, actor_update, opts, opt_states


class ActorTail:
    """DroQ's once-per-iteration actor step over static inputs: ``table`` (``[2B]``
    (env, row) pairs, device replay) or ``batch`` (``{"obs": [B, obs_dim]}``, host
    replay) and the draws; captured as a CUDA graph on a card (``utils/graphs.py``),
    eager on the CPU. ``__call__(tail)`` writes a block's tail sample (index rows ``[1,
    2B]`` or ``{key: [1, B, ...]}`` tensors) and the draws (``draw(draws)``: from
    ``generator`` unless replaced), replays the step and returns its metric names and
    values."""

    def __init__(self, actor_update, state, opt_states, gather, obs_spec, batch_size: int, shapes: DroQDraws, generator, device):
        self.gather, self.batch_size = gather, batch_size
        self.draw = lambda out: fill_draws(out, DRAW_KINDS, generator)
        inputs: Dict[str, Any] = {"draws": zero_draws(shapes, device)}
        if gather is not None:
            inputs["table"] = torch.zeros(2 * batch_size, dtype=torch.int64, device=device)
        else:
            inputs["batch"] = {"obs": torch.zeros((batch_size, *obs_spec[0]), device=device)}

        def fn(inp):
            B = self.batch_size
            obs = gather(inp["table"][:B], inp["table"][B:])["obs"] if gather is not None else inp["batch"]["obs"]
            return actor_update(opt_states, obs, inp["draws"])

        self.step = StepGraph(fn, inputs, state, cost_name="droq/train_actor_fn")

    def __call__(self, tail) -> Tuple[Sequence[str], torch.Tensor]:
        inputs = self.step.inputs
        with torch.no_grad():
            if self.gather is not None:
                inputs["table"].copy_(torch.as_tensor(np.asarray(tail[0]), dtype=torch.int64), non_blocking=True)
            else:
                inputs["batch"]["obs"].copy_(tail["obs"][0], non_blocking=True)
        self.draw(inputs["draws"])
        metrics = self.step()
        names = list(metrics)
        return names, torch.stack([metrics[k].detach().float() for k in names])


def droq_parts(ctx, cfg, obs_space, act_space) -> SACParts:
    refuse_precision_override(cfg)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    if not mlp_keys:
        raise ValueError("DroQ reads vector observations only: set algo.mlp_keys.encoder")
    act_dim = action_dim(act_space, "DroQ")
    agent = build_agent(ctx, act_space, obs_space, cfg)
    critic_update, actor_update, _, opt_states = make_droq_update(agent, cfg, act_dim)
    B = cfg.algo.per_rank_batch_size
    shapes = draw_shapes(B, act_dim, cfg.algo.critic.n, cfg.algo.critic.hidden_size)
    obs_spec = ((vector_dim(obs_space, mlp_keys),), np.float32)
    state = list(agent.parameters()) + tree_tensors(opt_states)
    gen = ctx.rng()
    draws_fn = transition_draws(lambda T, B_: shapes, DRAW_KINDS)
    tail: Dict[str, ActorTail] = {}

    def make_step(example):
        # the perf plane's names: the reference's host-replay functions, or its fused block
        ring = example.get("gather") is not None
        critic_name = "droq/fused_block_k1" if ring else "droq/train_critics_fn"
        factory = capture_step(lambda batch, flag, draws: critic_update(opt_states, batch, flag, draws), state, *draws_fn, 1, B, gen, critic_name)
        # the actor's step reads the same replay as the critics' (the ring or a batch)
        tail["step"] = ActorTail(actor_update, state, opt_states, example.get("gather"), obs_spec, B, shapes, gen, example["table"].device)
        return (*factory(example), None)

    make_step.tail = tail  # the actor's step once made (chip_smoke.py replaces its draws)

    return SACParts(
        agent=agent,
        opt_states=opt_states,
        obs_spec=obs_spec,
        to_rows=lambda o: vector_rows(o, mlp_keys),
        policy=lambda rows, g: sample_tanh(agent.actor, rows, g),
        greedy=lambda rows: torch.tanh(agent.actor(rows)[0]),
        make_step=make_step,
        target_update_freq=max(int(cfg.algo.critic.get("target_network_frequency", 1)), 1),
        tail=1,
        run_tail=lambda sample: tail["step"](sample),
    )


@register_algorithm(name="droq")
def main(ctx, cfg):
    return run_sac_loop(ctx, cfg, droq_parts, phases=("dispatch", "env_step", "buffer_add"))
