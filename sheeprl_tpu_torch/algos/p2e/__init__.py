"""Plan2Explore's shared pieces (counterpart of ``sheeprl_tpu/algos/p2e/__init__.py``).

* ``Ensembles``: the disagreement ensemble, N MLPs as one module whose weights are
  stacked ``[N, in, out]``, so that every member's layer is one batched product (the
  JAX package's ``build_ensembles``/``ensemble_apply``, its ``jax.vmap`` over stacked
  parameter trees). Its parameters are one list: the global-norm clip of its optimizer
  sees the whole ensemble, as optax's does over the stacked tree.
* ``ensemble_loss_normal``: the members' unit-variance Gaussian negative log-likelihood
  of the next target, summed over the members (P2E on DreamerV1 and DreamerV2);
  ``ensemble_loss``: their squared error (P2E on DreamerV3).
* ``intrinsic_reward``: the members' disagreement, their population variance (``ddof``
  0), averaged over the features.
* ``load_exploration_config``: a finetuning run takes the exploration run's env geometry
  and model widths from its saved config.

And what P2E on DreamerV1, DreamerV2 and DreamerV3 share around their steps: the modules'
constructors (``build_ensembles``, ``fresh_copy``), the optimizers (``OPTIMIZED``,
``make_optimizers``), which actor acts and which one is tested (``acting_actor``,
``evaluated_actor``), and a finetuning run's loop parts (``finetuning_parts``).
"""

from __future__ import annotations

import copy
import math
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_loop import LoopParts, exploration_schedule, make_captured_step
from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import load_config
from sheeprl_tpu_torch.models.blocks import _activation, flax_layer_norm, set_compute_dtype

__all__ = [
    "OPTIMIZED",
    "Ensembles",
    "acting_actor",
    "build_ensembles",
    "ensemble_loss",
    "ensemble_loss_normal",
    "evaluated_actor",
    "finetuning_parts",
    "fresh_copy",
    "intrinsic_reward",
    "load_exploration_config",
    "make_optimizers",
]

# the optimizer states' names, as the checkpoint keeps them
OPTIMIZED = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")


class StackedLinear(nn.Module):
    """N dense layers: ``weight [N, in, out]`` (Flax's kernel layout, one per member) and
    ``bias [N, out]``. ``x [N or 1, M, in] -> [N, M, out]`` in the compute dtype, the
    product rounded to it before the bias is added, as ``Linear`` does."""

    compute_dtype = torch.float32

    def __init__(self, n: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return torch.matmul(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)[:, None, :]


class StackedLayerNorm(nn.Module):
    """N LayerNorms over the last axis (``weight``/``bias`` ``[N, d]``), with Flax's
    statistics as ``models/blocks.py::LayerNorm`` takes them."""

    compute_dtype = torch.float32

    def __init__(self, n: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, dim))
        self.bias = nn.Parameter(torch.zeros(n, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_layer_norm(x, self.weight[:, None, :], self.bias[:, None, :], self.eps, self.compute_dtype)


class Ensembles(nn.Module):
    """N MLPs of ``mlp_layers`` x ``dense_units`` (LayerNorm where ``layer_norm``, then
    the activation) and an ``output_dim`` head, with stacked weights. ``forward(x)``:
    one input ``[..., input_dim]`` for every member -> ``[N, ..., output_dim]`` in the
    compute dtype. Children are named as the reference's tree (``dense.<i>``,
    ``norms.<i>``), so ``params_from_jax`` carries it by rule."""

    def __init__(
        self,
        n: int,
        input_dim: int,
        output_dim: int,
        dense_units: int = 400,
        mlp_layers: int = 4,
        activation: str = "elu",
        layer_norm: bool = False,
        norm_eps: float = 1e-5,
    ):
        super().__init__()
        self.n = n
        self.act = _activation(activation)
        sizes = [input_dim, *(dense_units,) * mlp_layers]
        self.dense = nn.ModuleList(StackedLinear(n, a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.dense.append(StackedLinear(n, sizes[-1], output_dim))
        self.norms = nn.ModuleList(StackedLayerNorm(n, dense_units, norm_eps) for _ in range(mlp_layers)) if layer_norm else None
        self.n_hidden = mlp_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(1, -1, x.shape[-1])
        for i, layer in enumerate(self.dense):
            h = layer(h)
            if i < self.n_hidden:
                if self.norms is not None:
                    h = self.norms[i](h)
                if self.act is not None:
                    h = self.act(h)
        return h.reshape(self.n, *lead, h.shape[-1])

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's default initialisation, member by member: kernels truncated
        lecun-normal (``std = sqrt(1 / fan_in) / .8796``, cut at two std), biases 0,
        LayerNorms 1 and 0."""
        for layer in self.dense:
            std = math.sqrt(1.0 / layer.weight.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            layer.bias.zero_()
        for norm in self.norms or ():
            norm.weight.fill_(1.0)
            norm.bias.zero_()


def ensemble_loss_normal(ensembles: Ensembles, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each member's unit-variance Gaussian negative log-likelihood of ``targets`` ``[T -
    1, B, D]`` from its predictions on ``inputs[:-1]`` (``inputs`` ``[T, B, in]``), a mean
    over the rows, summed over the members."""
    preds = ensembles(inputs)[:, :-1]  # [N, T-1, B, D]
    dim = targets.shape[-1]
    nll = 0.5 * torch.sum((preds - targets[None]) ** 2, -1) + 0.5 * dim * math.log(2 * math.pi)
    return nll.mean((1, 2)).sum()


def ensemble_loss(ensembles: Ensembles, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each member's squared error of ``targets`` ``[T - 1, B, D]`` from its predictions
    on ``inputs[:-1]``, summed over the features (``-MSEDistribution(preds, 1).log_prob``),
    a mean over the rows, summed over the members."""
    preds = ensembles(inputs)[:, :-1]  # [N, T-1, B, D]
    return torch.sum((preds - targets[None]) ** 2, -1).mean((1, 2)).sum()


def intrinsic_reward(ensembles: Ensembles, inputs: torch.Tensor, multiplier: float) -> torch.Tensor:
    """The disagreement reward: the members' population variance of their predictions on
    ``inputs`` (gradient stopped), averaged over the features, times ``multiplier``:
    ``[..., 1]``. The variance is taken in float32 and rounded to the predictions' type,
    as ``jnp.var`` returns it."""
    preds = ensembles(inputs.detach())
    var = preds.float().var(0, correction=0).to(preds.dtype)
    return var.float().mean(-1, keepdim=True).to(preds.dtype) * multiplier


def load_exploration_config(cfg) -> Any:
    """Load the exploration run's config (``config.yaml`` of the run that wrote
    ``checkpoint.exploration_ckpt_path``) and make ``cfg`` build the same models on the
    same env: its env geometry and its model keys replace ``cfg``'s, and with
    ``buffer.load_from_exploration`` (and a checkpointed buffer) its env count. Raises
    where the env id differs. Returns the exploration config."""
    ckpt_path = Path(cfg.checkpoint.exploration_ckpt_path)
    run_dir = ckpt_path.parent.parent if ckpt_path.is_dir() else ckpt_path.parent
    cfg_path = run_dir / "config.yaml"
    if not cfg_path.is_file():
        cfg_path = ckpt_path.parent / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"No config.yaml found alongside exploration checkpoint {ckpt_path}")
    exploration_cfg = load_config(cfg_path)
    if exploration_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the "
            f"exploration you want to finetune. Got '{cfg.env.id}', but the environment "
            f"used during exploration was {exploration_cfg.env.id}."
        )
    for key in (
        "frame_stack",
        "screen_size",
        "action_repeat",
        "grayscale",
        "clip_rewards",
        "frame_stack_dilation",
        "max_episode_steps",
        "reward_as_observation",
        "max_pitch",
        "min_pitch",
        "sticky_jump",
        "sticky_attack",
        "break_speed_multiplier",
    ):
        if key in exploration_cfg.env:
            cfg.env[key] = exploration_cfg.env[key]
    for key in (
        "gamma",
        "lmbda",
        "horizon",
        "layer_norm",
        "dense_units",
        "mlp_layers",
        "dense_act",
        "cnn_act",
        "unimix",
        "hafner_initialization",
        "world_model",
        "actor",
        "critic",
        "critics_exploration",
        "ensembles",
        "cnn_keys",
        "mlp_keys",
        "intrinsic_reward_multiplier",
    ):
        if key in exploration_cfg.algo:
            cfg.algo[key] = exploration_cfg.algo[key]
    if cfg.buffer.get("load_from_exploration") and exploration_cfg.buffer.checkpoint:
        cfg.env.num_envs = exploration_cfg.env.num_envs
    return exploration_cfg


def build_ensembles(ctx, cfg, input_dim: int, output_dim: int, activation: str, layer_norm: bool) -> Ensembles:
    """``algo.ensembles``' members (``activation``, a LayerNorm at eps 1e-5 after each
    hidden layer where ``layer_norm``) with Flax's default initialisation, from
    ``ctx.rng()``, computing in ``ctx.compute_dtype``, on ``ctx.device``."""
    ens_cfg = cfg.algo.ensembles
    ens = Ensembles(ens_cfg.n, input_dim, output_dim, ens_cfg.dense_units, ens_cfg.mlp_layers, activation, layer_norm)
    ens.reset_parameters(ctx.rng(device="cpu"))
    return set_compute_dtype(ens, ctx.compute_dtype).to(ctx.device)


def fresh_copy(module: nn.Module, ctx, init: Callable[[nn.Module, torch.Generator], None]) -> nn.Module:
    """A module of ``module``'s build, initialised anew by ``init(module, generator)``
    from ``ctx.rng()``, on ``ctx.device``."""
    new = copy.deepcopy(module).to("cpu")
    init(new, ctx.rng(device="cpu"))
    return new.to(ctx.device)


def make_optimizers(cfg) -> Dict[str, Any]:
    """One optimizer per name of ``OPTIMIZED``: both actors take ``algo.actor``'s, both
    critics ``algo.critic``'s."""
    a = cfg.algo
    actor = make_optimizer(a.actor.optimizer, a.actor.clip_gradients)
    critic = make_optimizer(a.critic.optimizer, a.critic.clip_gradients)
    return {
        "world_model": make_optimizer(a.world_model.optimizer, a.world_model.clip_gradients),
        "actor_task": actor,
        "critic_task": critic,
        "actor_exploration": actor,
        "critic_exploration": critic,
        "ensembles": make_optimizer(a.ensembles.optimizer, a.ensembles.clip_gradients),
    }


def acting_actor(cfg) -> str:
    """The module name of the actor the player acts with (``algo.player.actor_type``)."""
    return "actor_exploration" if cfg.algo.player.get("actor_type", "exploration") == "exploration" else "actor_task"


def evaluated_actor(cfg) -> str:
    """The actor an evaluation tests: a finetuning run's task actor, else the acting one."""
    return "actor_task" if "finetuning" in cfg.algo.name else acting_actor(cfg)


def start_state(cfg) -> Optional[Dict[str, Any]]:
    """The exploration checkpoint a finetuning run starts from; None for a resumed run,
    which the loop restores from its own checkpoint."""
    if cfg.checkpoint.get("resume_from"):
        return None
    return CheckpointManager.load(cfg.checkpoint.exploration_ckpt_path)


def finetuning_parts(
    ctx, cfg, build, make_expl_step, make_task_step, task_slice, make_player, make_buffer, obs_space, actions_dim, is_continuous,
    log_dir, train_gen, moments: bool = False,
) -> LoopParts:
    """The loop's parts of a P2E finetuning run: every module and optimizer state of the
    exploration run (its ``make_expl_step``'s layout), and the captured task step
    (``make_task_step``) over the ``task_slice`` of them. ``moments``: the steps carry
    DreamerV3's return moments (P2E-DV3), checkpointed as ``moments``: the task's go on
    in the task step, the exploration critics' are kept as they were loaded."""
    modules, _ = build(ctx, actions_dim, is_continuous, cfg, obs_space)
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    expl_step, init_all = make_expl_step(modules, cfg, cnn_keys, mlp_keys)
    opt_states = init_all()
    task_modules = {k: modules[v] for k, v in task_slice.items()}
    train_step, _ = make_task_step(*task_modules.values(), cfg, cnn_keys, mlp_keys)
    task_opt = {k: opt_states[v] for k, v in task_slice.items() if v in opt_states}  # the same states, by the step's names
    if moments:
        extra_state = {"moments": expl_step.init_extra()}
        extra = extra_state["moments"]["task"]
    else:
        extra_state, extra = {}, train_step.init_extra()
    world_model = modules["world_model"]
    return LoopParts(
        modules=modules,
        opt_states=opt_states,
        extra_state=extra_state,
        make_step=make_captured_step(
            train_step, task_modules, task_opt, extra, cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, train_gen,
            f"{cfg.algo.name}/train_block",
        ),
        player_step=make_player(world_model, modules[acting_actor(cfg)], actions_dim, is_continuous),
        rb=make_buffer(cfg, cfg.env.num_envs, cnn_keys + mlp_keys, log_dir),
        count_offset=0,
        clip_reward=np.tanh,
        exploration=exploration_schedule(cfg.algo.actor),
        start_state=start_state(cfg),
        task_player=make_player(world_model, modules["actor_task"], actions_dim, is_continuous),
    )
