"""PPO training (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py``): the optimizers of
every algorithm of the port (``Optimizer``, ``make_optimizer``), ``PPOTrainFns`` (the
act, value, GAE and update functions) and the training entry ``main``.

``make_optimizer`` builds the same update as the reference's optax chain, not as
``torch.optim`` would: gradients clipped by their global norm as
``optax.clip_by_global_norm`` does (``g * max_norm / norm`` when ``norm >= max_norm``,
with no epsilon), Adam's ``weight_decay`` as L2 added to the gradient before the Adam
scaling, AdamW's decay added after it, Adam's bias correction applied to both moments,
and ``rmsprop_tf`` with ``eps`` inside the square root. The state (step count and the
per-parameter moments) is a plain dict, saved with the checkpoint.

The step count is a 0-d int64 tensor on the parameters' device, and Adam's bias
corrections ``1 - b**count`` are computed on the device from it, so an update captured
in a CUDA graph corrects each replay by its own count. A learning-rate schedule
(``lr_schedule``: PPO's ``anneal_lr``, optax's ``polynomial_schedule``) is computed on
the device from the same count, so a replayed update anneals as the reference's does.
``load_state`` copies a saved state into a live one in place (an older checkpoint's
count is a Python int). ``inject_lr`` (a population's learning-rate sweep,
``engine/population.py``; the counterpart of ``optax.inject_hyperparams``) keeps the
learning rate as a 0-d float32 tensor ``lr`` in the state, so each member's state
carries its own rate under one update program; without it the rate is a Python float
and the update is as it was.

The update (``PPOTrainFns.train_fn``, the reference's one jitted call): the minibatch
step over static inputs (the rollout, the minibatch's indices, the clip and entropy
coefficients) is captured once as a CUDA graph (``utils/graphs.py``; eager on the CPU)
and replayed ``update_epochs x num_minibatches`` times per update, the indices written
in place before each replay from the epochs' permutations. The permutations are an
input: the loop draws them on the device from a generator; the tests hand in the ones
``jax.random.permutation`` makes from the reference's keys.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.loop_common import REGISTERS, TrainResult, grads, refuse_unported, register_last_checkpoint
from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.loss import entropy_loss, policy_loss, value_loss
from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, env_actions, log_prob_and_entropy, prepare_obs, sample_actions, test
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import save_config
from sheeprl_tpu_torch.precision import train_policy
from sheeprl_tpu_torch.rollout import PipelinedPlayer, rollout_metrics
from sheeprl_tpu_torch.utils.env import make_vector_env
from sheeprl_tpu_torch.obs import TrainingMonitor
from sheeprl_tpu_torch.obs.health import StepHealth, health_enabled, module_slices
from sheeprl_tpu_torch.utils.graphs import StepGraph, tree_tensors
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import make_aggregator, record_episode_stats
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import Timer
from sheeprl_tpu_torch.utils.utils import gae, polynomial_decay

OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop_tf")


class Optimizer:
    """One optax-style gradient transformation over a fixed list of parameters:
    ``state = opt.init(params)``, then ``opt.update(params, grads, state)`` updates the
    parameters and the state in place and returns the gradients' global norm before
    clipping. With ``update_norms=True`` it returns ``(norm, update_norms)``: the
    latter the float32 norm of the delta applied to each parameter (``[len(params)]``;
    the ``Health/update_norm`` diagnostics), computed from the update the optimizer
    already holds, with no copy of a parameter."""

    def __init__(
        self, name: str, lr: float, max_grad_norm: float = 0.0, lr_schedule: Optional[Callable] = None, inject_lr: bool = False, **hp: Any
    ):
        if name not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer: {name}")
        if inject_lr and lr_schedule is not None:
            raise ValueError("inject_lr (population lr sweep) and a lr schedule are mutually exclusive")
        self.name = name
        self.inject_lr = bool(inject_lr)
        self.lr = float(lr)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        # count (0-d tensor, the updates before this one) -> lr (0-d float32 tensor)
        self.lr_schedule = lr_schedule
        self.hp = hp

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        device = params[0].device if len(params) else None
        state: Dict[str, Any] = {"count": torch.zeros((), dtype=torch.int64, device=device)}
        if self.inject_lr:
            state["lr"] = torch.tensor(self.lr, dtype=torch.float32, device=device)
        if self.name in ("adam", "adamw", "rmsprop_tf"):
            state["nu"] = zeros()
        if self.name in ("adam", "adamw") or (self.name == "rmsprop_tf" and self.hp["centered"]):
            state["mu"] = zeros()
        if self.name in ("sgd", "rmsprop_tf"):
            state["trace"] = zeros()
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any], update_norms: bool = False):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        g = [t.clone() for t in grads]
        if self.max_grad_norm > 0:
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            torch._foreach_mul_(g, scale)
        if self.lr_schedule is not None:  # evaluated at the count before this update, as optax's
            lr_t = self.lr_schedule(state["count"])
        elif self.inject_lr:
            lr_t = state["lr"]
        state["count"].add_(1)
        count, lr, hp = state["count"], self.lr, self.hp
        float_lr = self.lr_schedule is None and not self.inject_lr
        applied: List[torch.Tensor] = []  # the norms of the deltas, where asked for

        def delta_norms(direction: List[torch.Tensor], scaled: bool) -> None:
            # the delta is -lr * direction (scaled) or direction itself
            if update_norms:
                n = torch.stack(torch._foreach_norm(direction)).float()
                applied.append(n * (abs(lr) if float_lr else lr_t.abs()) if scaled else n)

        def apply_(updates: List[torch.Tensor]) -> None:  # params += -lr * updates
            if float_lr:
                torch._foreach_add_(params, updates, alpha=-lr)
            else:
                torch._foreach_add_(params, torch._foreach_mul(updates, -lr_t))
        if self.name in ("adam", "adamw"):
            b1, b2 = hp["betas"]
            if self.name == "adam" and hp["weight_decay"]:
                torch._foreach_add_(g, params, alpha=hp["weight_decay"])
            mu, nu = state["mu"], state["nu"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            # the bias corrections in float32 on the device, as optax computes them
            denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - torch.pow(b2, count)))
            torch._foreach_add_(denom, hp["eps"])
            upd = torch._foreach_div(torch._foreach_div(mu, 1 - torch.pow(b1, count)), denom)
            if self.name == "adamw" and hp["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=hp["weight_decay"])
            delta_norms(upd, True)
            apply_(upd)
        elif self.name == "sgd":
            trace = state["trace"]
            torch._foreach_mul_(trace, hp["momentum"])
            torch._foreach_add_(trace, g)
            delta_norms(trace, True)
            apply_(trace)
        else:  # rmsprop_tf: eps inside the square root, then lr, then the momentum trace
            decay = hp["alpha"]
            nu = state["nu"]
            torch._foreach_mul_(nu, decay)
            torch._foreach_addcmul_(nu, g, g, value=1 - decay)
            if hp["centered"]:
                mu = state["mu"]
                torch._foreach_mul_(mu, decay)
                torch._foreach_add_(mu, g, alpha=1 - decay)
                var = torch._foreach_sub(nu, torch._foreach_mul(mu, mu))
            else:
                var = [n.clone() for n in nu]
            torch._foreach_add_(var, hp["eps"])
            upd = torch._foreach_div(g, torch._foreach_sqrt(var))
            torch._foreach_mul_(upd, -lr if float_lr else -lr_t)
            trace = state["trace"]
            torch._foreach_mul_(trace, hp["momentum"])
            torch._foreach_add_(trace, upd)
            delta_norms(trace, False)
            torch._foreach_add_(params, trace)
        return (norm, applied[0]) if update_norms else norm

    @staticmethod
    @torch.no_grad()
    def load_state(state: Dict[str, Any], saved: Dict[str, Any]) -> None:
        """Copy ``saved`` (a checkpointed state, on any device) into ``state`` in place,
        so that tensors a captured graph reads keep their addresses. A saved ``count``
        may be a Python int (checkpoints written before the count lived on the device)."""
        if set(saved) != set(state):
            raise ValueError(f"optimizer state keys {sorted(saved)} do not match {sorted(state)}")
        state["count"].fill_(int(saved["count"]))
        if "lr" in state:
            state["lr"].fill_(float(saved["lr"]))
        for key in state:
            if key not in ("count", "lr"):
                if len(saved[key]) != len(state[key]):
                    raise ValueError(f"optimizer state '{key}' holds {len(saved[key])} tensors, expected {len(state[key])}")
                for dst, src in zip(state[key], saved[key]):
                    dst.copy_(src)  # across devices: a checkpoint loads on the host


def polynomial_schedule(init_value: float, end_value: float, power: float, transition_steps: int) -> Callable:
    """``optax.polynomial_schedule`` on the device: ``count`` (a 0-d integer tensor) ->
    ``(init - end) * (1 - min(count, steps) / steps) ** power + end`` in float32."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        frac = 1 - count.clamp(0, transition_steps).float() / transition_steps
        return (init_value - end_value) * frac**power + end_value

    return schedule


def make_optimizer(opt_cfg: Dict[str, Any], max_grad_norm: float, lr_schedule: Optional[Callable] = None, inject_lr: bool = False) -> Optimizer:
    """The optimizer an ``optimizer`` config section asks for (``name``: adam | adamw |
    sgd | rmsprop_tf), with global-norm clipping when ``max_grad_norm > 0``, and the
    learning rate of ``lr_schedule`` (a count -> lr function) where one is given, or in
    the state (``inject_lr``)."""
    name = opt_cfg.get("name", "adam")
    lr = opt_cfg.get("lr", 1e-3)
    if name == "adam":
        betas = opt_cfg.get("betas", [0.9, 0.999])
        # the reference passes only b1 to optax.adam: b2 stays at optax's 0.999
        hp = dict(betas=(float(betas[0]), 0.999), eps=opt_cfg.get("eps", 1e-8), weight_decay=opt_cfg.get("weight_decay", 0.0))
    elif name == "adamw":
        hp = dict(betas=(0.9, 0.999), eps=opt_cfg.get("eps", 1e-8), weight_decay=opt_cfg.get("weight_decay", 0.0))
    elif name == "sgd":
        hp = dict(momentum=opt_cfg.get("momentum", 0.0))
    elif name == "rmsprop_tf":
        hp = dict(
            alpha=opt_cfg.get("alpha", 0.99),
            eps=opt_cfg.get("eps", 1e-8),
            centered=opt_cfg.get("centered", False),
            momentum=opt_cfg.get("momentum", 0.0),
        )
    else:
        raise ValueError(f"Unknown optimizer: {name}")
    return Optimizer(name, lr, max_grad_norm, lr_schedule, inject_lr, **hp)


def update_agent(opt: Optimizer, params: List[torch.Tensor], opt_state: Dict[str, Any], total: torch.Tensor, slices: Optional[Dict[str, slice]], aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One optimizer step of a one-optimizer agent from ``total``'s gradient. With
    ``slices`` (the agent's modules, ``obs/health.py::module_slices``; where
    ``obs.health`` is on) it returns the step's ``Health/*``: per-module norms of the
    gradients, new parameters and updates, and the means of ``aux``."""
    g = grads(total, params)
    if slices is None:
        opt.update(params, g, opt_state)
        return {}
    probe = StepHealth()
    for name, sl in slices.items():
        probe.grads(name, g[sl])
    _, update_norms = opt.update(params, g, opt_state, update_norms=True)
    for name, sl in slices.items():
        probe.updates(name, update_norms[sl])
    return probe.metrics({name: params[sl] for name, sl in slices.items()}, aux)


def stack_metrics(fns, losses: Sequence[str], values: torch.Tensor, health: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A step's metrics as one float32 tensor: the losses ``values``, then ``health``'s;
    their names go to ``fns.metric_names``."""
    fns.metric_names = [*losses, *health]
    return torch.cat([values, torch.stack(list(health.values()))]) if health else values


class MinibatchUpdate:
    """An update as replays of one gradient step over static inputs: ``data`` (the
    rollout, ``[N, ...]`` per key), ``idx`` (the minibatch's rows) and ``coefs`` (the
    annealed clip and entropy coefficients). ``step(data, idx, coefs)`` updates the
    parameters and optimizer state (``state``) in place and returns its metrics as one
    float32 tensor. With ``capture`` the step is a ``StepGraph`` (a CUDA graph on a
    card, eager on the CPU); without, it runs eagerly on any device. ``cost_name``: the
    name the perf plane counts each step under (``obs/perf.py``)."""

    def __init__(
        self, step: Callable, data: Dict[str, torch.Tensor], index_shape: Sequence[int], state: Sequence[torch.Tensor], capture: bool = True,
        cost_name: Optional[str] = None,
    ):
        device = next(iter(data.values())).device
        self.inputs = {
            "data": {k: torch.zeros_like(v) for k, v in data.items()},
            "idx": torch.zeros(tuple(index_shape), dtype=torch.int64, device=device),
            "coefs": torch.zeros(2, device=device),
        }
        self.fn = lambda inp: step(inp["data"], inp["idx"], inp["coefs"])
        self.graph = StepGraph(self.fn, self.inputs, list(state), cost_name=cost_name) if capture else None

    def __call__(self, data: Dict[str, torch.Tensor], index_rows: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
        """One step per row of ``index_rows``; the mean of their metrics."""
        with torch.no_grad():
            for k, v in self.inputs["data"].items():
                v.copy_(data[k])
            self.inputs["coefs"].copy_(coefs)
        total = None
        for row in index_rows:
            self.inputs["idx"].copy_(row)
            out = (self.graph() if self.graph is not None else self.fn(self.inputs)).detach()
            total = out.clone() if total is None else total.add_(out)
        return total / len(index_rows)


class CapturedGAE:
    """``(returns, advantages)`` of a ``[T, n_envs, 1]`` rollout (``utils.gae`` at
    ``algo``'s gamma and lambda), its reverse loop captured once over static inputs (eager
    on the CPU); the outputs are overwritten by the next call."""

    def __init__(self, cfg):
        self.algo = cfg.algo
        self.graph: Optional[StepGraph] = None

    def __call__(self, rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, next_value: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        args = {"r": rewards, "v": values, "d": dones, "nv": next_value}
        if self.graph is None:
            algo = self.algo
            self.graph = StepGraph(
                lambda i: gae(i["r"], i["v"], i["d"], i["nv"], algo.rollout_steps, algo.gamma, algo.gae_lambda),
                {k: torch.zeros_like(v) for k, v in args.items()},
            )
        with torch.no_grad():
            for k, v in args.items():
                self.graph.inputs[k].copy_(v)
            return self.graph()


class PPOTrainFns:
    """The PPO functions of the train loop (the reference's jitted ones): ``act``,
    ``values``, ``gae_fn`` and ``train_fn`` over ``agent``'s parameters and the
    optimizer state ``opt_state``. ``capture=False`` runs the update eagerly on a card
    too (the graph's parity check). ``inject_lr``: the learning rate lives in the
    optimizer state (a population's sweep). With ``obs.health`` each minibatch step also
    returns the reference's ``Health/*`` (``metric_names`` names the step's outputs).
    ``cost_name``: the perf plane's name for the captured step (``<algo>/train_fn``)."""

    LOSSES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")

    def __init__(
        self, ctx, agent, cfg, obs_keys: Sequence[str], num_updates: int, capture: bool = True, inject_lr: bool = False,
        cost_name: Optional[str] = None,
    ):
        if cfg.algo.per_rank_batch_size <= 0:
            raise ValueError("algo.per_rank_batch_size must be positive")
        num_envs, rollout_steps = cfg.env.num_envs, cfg.algo.rollout_steps
        batch_n = rollout_steps * num_envs
        if batch_n % cfg.algo.per_rank_batch_size != 0:
            raise ValueError(
                f"algo.rollout_steps*env.num_envs ({batch_n}) must be divisible by "
                f"algo.per_rank_batch_size ({cfg.algo.per_rank_batch_size}): every minibatch "
                "of the captured update has the same shape."
            )
        self.agent, self.cfg, self.obs_keys, self.capture = agent, cfg, list(obs_keys), capture
        self.device = ctx.device
        self.batch_n = batch_n
        self.mb_size = cfg.algo.per_rank_batch_size
        self.num_minibatches = batch_n // self.mb_size
        self.grad_steps_per_update = cfg.algo.update_epochs * self.num_minibatches
        self.lr_schedule = None
        if cfg.algo.anneal_lr:
            if inject_lr:
                raise ValueError(
                    "algo.anneal_lr=True cannot combine with a population learning-rate "
                    "sweep (the swept rate is a per-member constant in the optimizer state)"
                )
            self.lr_schedule = polynomial_schedule(cfg.algo.optimizer.lr, 1e-8, 1.0, num_updates * self.grad_steps_per_update)
        self.opt = make_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm, self.lr_schedule, inject_lr)
        self.params = list(agent.parameters())
        self.opt_state = self.opt.init(self.params)
        self.compute_dtype = train_policy(cfg, ctx)
        self._update: Optional[MinibatchUpdate] = None
        self.gae_fn = CapturedGAE(cfg)
        self.health_slices = module_slices(agent, {"actor_heads": "actor_head_{}"}) if health_enabled(cfg) else None
        self.metric_names = list(self.LOSSES)
        self.cost_name = cost_name if cost_name is not None else f"{cfg.algo.name}/train_fn"

    def cast_obs(self, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Float observations cast to the compute dtype (``cast_obs``, ``ppo.py:166-173``
        of the reference); images (uint8) pass as they are."""
        return {k: v.to(self.compute_dtype) if v.is_floating_point() else v for k, v in obs.items()}

    @torch.no_grad()
    def act(self, obs: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None, draws=None):
        """``(env_actions, stored_actions, logprob, value)`` of one policy step."""
        actor_out, value = self.agent(self.cast_obs(obs))
        env_act, stored, logprob = sample_actions(actor_out, self.agent.is_continuous, generator=generator, draws=draws)
        return env_act, stored, logprob, value[..., 0]

    @torch.no_grad()
    def values(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.agent(self.cast_obs(obs))[1][..., 0]

    def loss(self, mb: Dict[str, torch.Tensor], clip_coef, ent_coef) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The total loss, ``[policy, value, entropy]`` losses (the last negated, as the
        reference logs it) and, with health on, the policy entropy and value statistics."""
        algo = self.cfg.algo
        actor_out, new_values = self.agent(self.cast_obs({k: mb[k] for k in self.obs_keys}))
        new_logprob, entropy = log_prob_and_entropy(actor_out, mb["actions"], self.agent.is_continuous)
        adv = mb["advantages"]
        if algo.normalize_advantages:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = policy_loss(new_logprob, mb["logprobs"], adv, clip_coef, algo.loss_reduction)
        vf = value_loss(new_values[..., 0], mb["values"], mb["returns"], clip_coef, algo.clip_vloss, algo.loss_reduction)
        ent = entropy_loss(entropy, algo.loss_reduction)
        aux = {}
        if self.health_slices is not None:
            aux = {"policy_entropy": entropy.mean(), "value_mean": new_values.mean(), "value_std": new_values.std(correction=0)}
        return pg + algo.vf_coef * vf + ent_coef * ent, torch.stack([pg, vf, -ent]).detach(), aux

    def minibatch_step(self, data: Dict[str, torch.Tensor], idx: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
        mb = {k: v[idx] for k, v in data.items()}
        total, metrics, aux = self.loss(mb, coefs[0], coefs[1])
        health = update_agent(self.opt, self.params, self.opt_state, total, self.health_slices, aux)
        return stack_metrics(self, self.LOSSES, metrics, health)

    def permutations(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        """``[update_epochs, N]``: one permutation of the rollout's rows per epoch."""
        return torch.stack([
            torch.randperm(self.batch_n, generator=generator, device=self.device) for _ in range(self.cfg.algo.update_epochs)
        ])

    def train_fn(self, data: Dict[str, torch.Tensor], perms: torch.Tensor, clip_coef: float, ent_coef: float) -> Dict[str, float]:
        """One update: ``update_epochs`` sweeps over ``data`` (``[N, ...]`` per key) in
        the minibatches of ``perms`` (``[update_epochs, N]``). Returns the mean losses."""
        return self.losses(self.launch_update(data, perms, clip_coef, ent_coef))

    def launch_update(self, data: Dict[str, torch.Tensor], perms: torch.Tensor, clip_coef: float, ent_coef: float) -> torch.Tensor:
        """``train_fn``'s update, launched without waiting for it: its mean losses stay a
        tensor on the device (``losses`` reads them)."""
        return self.launch_update_coefs(data, perms, torch.tensor([clip_coef, ent_coef], dtype=torch.float32))

    def launch_update_coefs(self, data: Dict[str, torch.Tensor], perms: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
        """``launch_update`` with the clip and entropy coefficients as one ``[2]`` float32
        tensor, which may already lie on the device (the Anakin engine's, so that no
        host copy waits on the stream)."""
        if tuple(perms.shape) != (self.cfg.algo.update_epochs, self.batch_n):
            raise ValueError(f"perms has shape {tuple(perms.shape)}, expected (update_epochs, N) = {(self.cfg.algo.update_epochs, self.batch_n)}")
        if self._update is None:
            state = self.params + tree_tensors(self.opt_state)
            self._update = MinibatchUpdate(self.minibatch_step, data, (self.mb_size,), state, self.capture, self.cost_name)
        return self._update(data, perms.reshape(-1, self.mb_size), coefs)

    def losses(self, out: torch.Tensor) -> Dict[str, float]:
        """The update's mean metrics by name (its losses, then ``Health/*``)."""
        return dict(zip(self.metric_names, out.cpu().tolist()))

    def lr_at(self, grad_step: int) -> float:
        """The learning rate after ``grad_step`` gradient steps (``Params/lr``)."""
        if self.lr_schedule is None:
            return float(self.cfg.algo.optimizer.lr)
        return float(self.lr_schedule(torch.tensor(grad_step)))


def refuse_ppo_unported(cfg, pipelined: bool, registers: bool = False, handled: Sequence[str] = ()) -> None:
    """The reference's keys that the PPO family's loops do not have: ``refuse_unported``'s
    list, and a memmapped rollout (the port keeps the rollout in memory and on the
    device). ``pipelined``: the loop runs the pipelined player (PPO's); A2C's and
    recurrent PPO's act synchronously, as the reference's do. ``registers``: the loop
    registers its last checkpoint (PPO's, as the reference's ``ppo.py``). ``handled``: other
    keys the loop reads itself."""
    handled = tuple(handled) + (("rollout.pipeline_depth",) if pipelined else ()) + ((REGISTERS,) if registers else ())
    refuse_unported(cfg, handled=handled)
    if cfg.buffer.get("memmap", False):
        raise NotImplementedError("buffer.memmap=True: the PPO family's rollout lives in memory and on the device in the PyTorch port")


class Rollout:
    """One rollout of ``T`` steps over ``N`` envs: the observations on the device (the
    policy reads them there), the rest on the host until ``tensors``."""

    def __init__(self, T: int, N: int, obs_space, cnn_keys, mlp_keys, device: torch.device, host_keys: Dict[str, Tuple[int, ...]]):
        self.T, self.N, self.device = T, N, device
        self.cnn_keys, self.mlp_keys = list(cnn_keys), list(mlp_keys)
        self.obs = {k: torch.zeros((T, N, *obs_space[k].shape), dtype=torch.uint8 if k in cnn_keys else torch.float32, device=device)
                    for k in self.cnn_keys + self.mlp_keys}
        self.host = {k: np.zeros((T, N, *shape), np.float32) for k, shape in host_keys.items()}

    def put_obs(self, t: int, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Write step ``t``'s observations to the device; returns them there."""
        with torch.no_grad():
            for k, buf in self.obs.items():
                buf[t].copy_(torch.as_tensor(np.asarray(obs[k], dtype=np.uint8 if k in self.cnn_keys else np.float32)))
        return {k: buf[t] for k, buf in self.obs.items()}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every key of the rollout on the device, ``[T, N, ...]``."""
        return {**self.obs, **{k: torch.from_numpy(v).to(self.device) for k, v in self.host.items()}}


def flat_batch(rollout: Dict[str, torch.Tensor], returns: torch.Tensor, advantages: torch.Tensor, keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The update's data: ``keys`` of the rollout with the returns and advantages, the
    step and env axes flattened into one."""
    data = {k: rollout[k] for k in keys}
    data["returns"], data["advantages"] = returns[..., 0], advantages[..., 0]
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in data.items()}


def truncation_bootstrap(info: Dict[str, Any], truncated: np.ndarray, obs_keys: Sequence[str], values: Callable) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(env indices, V(final obs))`` of the envs whose episode was truncated this step,
    for ``gamma * V`` to fold into their rewards; ``values(obs dict)`` -> host array."""
    if not truncated.any() or "final_obs" not in info:
        return None
    idx = np.nonzero(truncated)[0]
    final_obs = {k: np.stack([np.asarray(info["final_obs"][i][k]) for i in idx]) for k in obs_keys}
    return idx, values(final_obs)


class PPOFamilyLoop:
    """What the PPO family's train loops share around their rollouts: the log dir,
    logger, training monitor (``obs/monitor.py``; ``close()`` it before the envs),
    vector env, aggregator, checkpoints and resume, and the logging and checkpoint
    cadences. ``phases``: the monitor's phases, the reference loop's (None: every one
    the loop names)."""

    def __init__(self, ctx, cfg, aggregator_keys, agg_lock=None, phases: Optional[Sequence[str]] = None):
        self.ctx, self.cfg = ctx, cfg
        # held around the aggregator's reads where another thread feeds it (ppo_decoupled)
        self.agg_lock = agg_lock if agg_lock is not None else contextlib.nullcontext()
        self.log_dir = get_log_dir(cfg)
        save_config(cfg, Path(self.log_dir) / "config.yaml")
        self.logger = get_logger(cfg, self.log_dir)
        self.timer = Timer(disabled=bool(cfg.metric.get("disable_timer", False)))
        self.monitor = TrainingMonitor(cfg, self.log_dir, self.timer, ctx.device, phases=phases)
        self.envs = make_vector_env(cfg, cfg.seed, 0, self.log_dir if cfg.env.capture_video else None)
        self.aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
        self.aggregator.keep(set(aggregator_keys) | set(cfg.metric.aggregator.get("metrics", {})))
        self.ckpt_manager = CheckpointManager(Path(self.log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
        self.policy_steps_per_iter = int(cfg.env.num_envs * cfg.algo.rollout_steps)
        self.num_updates = max(int(cfg.algo.total_steps) // self.policy_steps_per_iter, 1) if not cfg.dry_run else 1
        self.start_update, self.policy_step, self.last_log, self.last_checkpoint = 1, 0, 0, 0
        self.last_path: Optional[str] = None

    def resume(self, agent: torch.nn.Module, opt_state: Dict[str, Any]) -> None:
        """Load ``checkpoint.resume_from`` into the agent and optimizer state in place."""
        path = self.cfg.checkpoint.get("resume_from")
        if not path:
            return
        state = CheckpointManager.load(path)
        agent.load_state_dict(state["params"])
        Optimizer.load_state(opt_state, state["opt_state"])
        self.start_update = state["update"] + 1
        self.policy_step = state["policy_step"]
        self.last_log = state.get("last_log", 0)
        self.last_checkpoint = state.get("last_checkpoint", 0)

    def end_update(self, update: int, agent, opt_state, metrics: Callable[[], Dict[str, float]]) -> None:
        """Log at the cadence (``metrics()`` adds the timing keys) and checkpoint."""
        cfg = self.cfg
        if self.logger is not None and (self.policy_step - self.last_log >= cfg.metric.log_every or update == self.num_updates or cfg.dry_run):
            with self.agg_lock:
                out = self.aggregator.compute()
                self.aggregator.reset()
            out.update(metrics())
            out.update(rollout_metrics(self.envs))
            self.monitor.log_metrics(self.logger, out, self.policy_step)
            self.last_log = self.policy_step
        if (cfg.checkpoint.every > 0 and self.policy_step - self.last_checkpoint >= cfg.checkpoint.every) or (
            update == self.num_updates and cfg.checkpoint.save_last
        ):
            state = {
                "params": agent.state_dict(),
                "opt_state": opt_state,
                "update": update,
                "policy_step": self.policy_step,
                "last_log": self.last_log,
                "last_checkpoint": self.policy_step,
            }
            with self.monitor.phase("checkpoint"):
                self.last_path = str(self.ckpt_manager.save(self.policy_step, state))
            self.last_checkpoint = self.policy_step

    def close(self) -> None:
        """The monitor, then the vector env (a loop's teardown)."""
        self.monitor.close()
        self.envs.close()

    def finish(self, test_fn: Callable[[], float], grad_steps: int, seconds: float, train_seconds: float, env_seconds: float) -> TrainResult:
        test_reward = None
        if self.cfg.algo.run_test:
            test_reward = test_fn()
            if self.logger is not None:
                self.logger.log_metrics({"Test/cumulative_reward": test_reward}, self.policy_step)
        register_last_checkpoint(self.cfg, self.log_dir)
        if self.logger is not None:
            self.logger.close()
        return TrainResult(self.log_dir, self.policy_step, grad_steps, self.last_path, seconds, train_seconds, env_seconds, test_reward)


def annealed_coefs(cfg, update: int, num_updates: int, clip_coef: Optional[float] = None, ent_coef: Optional[float] = None) -> Tuple[float, float]:
    """The update's clip and entropy coefficients (``algo.anneal_clip_coef``,
    ``algo.anneal_ent_coef``: linear decay to 0 over the run's updates) from the config's
    initial values, or the given ones (a population member's sweep)."""
    clip_coef = cfg.algo.clip_coef if clip_coef is None else clip_coef
    ent_coef = cfg.algo.ent_coef if ent_coef is None else ent_coef
    if cfg.algo.anneal_clip_coef:
        clip_coef = polynomial_decay(update, initial=clip_coef, final=0.0, max_decay_steps=num_updates)
    if cfg.algo.anneal_ent_coef:
        ent_coef = polynomial_decay(update, initial=ent_coef, final=0.0, max_decay_steps=num_updates)
    return clip_coef, ent_coef


class PPOActing:
    """PPO's acting side (the coupled loop's and ``ppo_decoupled``'s player's): a rollout
    of ``algo.rollout_steps`` steps of every env through the pipelined player (``depth``)
    with ``generator``'s draws, the truncation bootstrap folded into the rewards, then
    the update's batch with GAE on the device."""

    def __init__(self, cfg, fns: PPOTrainFns, envs, generator: Optional[torch.Generator], depth: int = 0, phase: Optional[Callable] = None):
        self.cfg, self.fns, self.envs = cfg, fns, envs
        self.phase = phase if phase is not None else (lambda name: contextlib.nullcontext())
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        self.cnn_keys, self.mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
        self.obs_keys = self.cnn_keys + self.mlp_keys
        is_continuous, action_dims = fns.agent.is_continuous, fns.agent.action_dims
        n_act = action_dims[0] if is_continuous else len(action_dims)
        self.rollout = Rollout(cfg.algo.rollout_steps, cfg.env.num_envs, obs_space, self.cnn_keys, self.mlp_keys, fns.device,
                               {"actions": (n_act,), "logprobs": (), "values": (), "rewards": (), "dones": ()})

        def policy(obs_t):
            env_act, _, logprob, value = fns.act(obs_t, generator)
            return env_act, logprob, value

        def post(fetched):
            return env_actions(fetched[0], is_continuous, action_dims, act_space), fetched

        self.player = PipelinedPlayer(envs, policy, post, depth=depth)

    def prepare(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return prepare_obs(obs, self.cnn_keys, self.mlp_keys, self.fns.device)

    def collect(self, obs: Dict[str, np.ndarray], on_step: Callable[[Dict[str, Any]], None]) -> Dict[str, np.ndarray]:
        """One rollout from ``obs``; ``on_step(info)`` after each env step. Returns the
        observations that follow it."""
        cfg, rollout, num_envs = self.cfg, self.rollout, self.cfg.env.num_envs
        host_values = lambda o: self.fns.values(self.prepare(o)).float().cpu().numpy()  # noqa: E731
        for t in range(rollout.T):
            with self.phase("player"):
                obs_t = rollout.put_obs(t, obs)
                actions, (act_np, logprob_np, value_np) = self.player.act(obs_t)
            with self.phase("env_step"):
                next_obs, reward, terminated, truncated, info = self.player.env_step(actions)
            if cfg.env.clip_rewards:
                reward = np.clip(reward, -1, 1)
            reward = np.asarray(reward, dtype=np.float32).reshape(num_envs)
            boot = truncation_bootstrap(info, truncated, self.obs_keys, host_values)
            if boot is not None:
                reward[boot[0]] += cfg.algo.gamma * boot[1]
            with self.phase("buffer_add"):
                host = rollout.host
                host["actions"][t] = act_np.reshape(num_envs, -1)
                host["logprobs"][t], host["values"][t] = logprob_np, value_np
                host["rewards"][t] = reward
                host["dones"][t] = np.logical_or(terminated, truncated)
            obs = next_obs
            on_step(info)
        return obs

    def batch(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The update's data from the last rollout and the observations after it."""
        local = self.rollout.tensors()
        next_value = self.fns.values(self.prepare(obs))[:, None]
        returns, advantages = self.fns.gae_fn(local["rewards"][..., None], local["values"][..., None], local["dones"][..., None], next_value)
        return flat_batch(local, returns, advantages, [*self.obs_keys, "actions", "logprobs", "values"])


@register_algorithm(name="ppo")
def main(ctx, cfg) -> TrainResult:
    """PPO's train loop: act through the pipelined player, fold the truncation bootstrap
    into the rewards, GAE on the device, then the captured update. ``algo.anakin=True``
    hands the run to the Anakin engine (``engine/anakin.py``)."""
    from sheeprl_tpu_torch.engine.anakin import anakin_enabled, ppo_anakin

    if anakin_enabled(cfg):
        return ppo_anakin(ctx, cfg)
    refuse_ppo_unported(cfg, pipelined=True, registers=True)
    device = ctx.device
    loop = PPOFamilyLoop(ctx, cfg, AGGREGATOR_KEYS)
    envs = loop.envs
    try:
        obs_space, act_space = envs.single_observation_space, envs.single_action_space
        obs_keys = list(cfg.algo.cnn_keys.encoder) + list(cfg.algo.mlp_keys.encoder)
        agent = build_agent(ctx, act_space, obs_space, cfg)
        fns = PPOTrainFns(ctx, agent, cfg, obs_keys, loop.num_updates)
        loop.resume(agent, fns.opt_state)
        player_gen, train_gen = ctx.rng(), ctx.rng()
        depth = int((cfg.get("rollout") or {}).get("pipeline_depth", 0) or 0)
        acting = PPOActing(cfg, fns, envs, player_gen, depth=depth, phase=loop.monitor.phase)

        def on_step(info):
            loop.policy_step += cfg.env.num_envs
            record_episode_stats(loop.aggregator, info)

        obs, _ = envs.reset(seed=cfg.seed)
        grad_steps, train_seconds, env_seconds = 0, 0.0, 0.0
        run_start = time.perf_counter()
        for update in range(loop.start_update, loop.num_updates + 1):
            loop.monitor.advance()
            env_t0 = time.perf_counter()
            with loop.timer("Time/env_interaction_time"):
                obs = acting.collect(obs, on_step)
            env_time = time.perf_counter() - env_t0
            env_seconds += env_time

            train_t0 = time.perf_counter()
            with loop.timer("Time/train_time"), loop.monitor.phase("dispatch"):
                data = acting.batch(obs)
                train_metrics = fns.train_fn(data, fns.permutations(train_gen), *annealed_coefs(cfg, update, loop.num_updates))
            train_time = time.perf_counter() - train_t0
            train_seconds += train_time
            grad_steps += fns.grad_steps_per_update
            for k, v in train_metrics.items():
                loop.aggregator.update(k, v)
            loop.end_update(update, agent, fns.opt_state, lambda: {
                "Time/sps_train": fns.grad_steps_per_update / train_time if train_time > 0 else 0.0,
                "Time/sps_env_interaction": loop.policy_steps_per_iter / env_time if env_time > 0 else 0.0,
                "Params/lr": fns.lr_at(update * fns.grad_steps_per_update),
            })
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        loop.close()
    seconds = time.perf_counter() - run_start
    return loop.finish(lambda: test(agent, ctx, cfg, loop.log_dir).reward, grad_steps, seconds, train_seconds, env_seconds)
