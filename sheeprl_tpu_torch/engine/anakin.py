"""The Anakin training mode (counterpart of ``sheeprl_tpu/engine/anakin.py``): env
stepping, acting, transition writes and the update on the device, replayed from
captured CUDA graphs with no host sync inside a dispatch.

The environment is a batched env on the device (``envs/batched``), so there is no
player round trip and no host env stepping: per dispatch the host only replays graphs
and keeps its counters. The PPO and SAC entries (``algos/ppo/ppo.py::main``,
``algos/sac/sac.py::main``) hand over to this module when ``algo.anakin=True``:

* PPO (``PPOAnakin``): one iteration is the ``rollout_steps`` rollout (the acting step
  captured once and replayed per env step, writing step ``t`` of the trajectory through
  a step index on the device), the bootstrap value, GAE (``CapturedGAE``) and the
  unchanged update of ``PPOTrainFns`` (``MinibatchUpdate``'s captured minibatch step
  replayed per minibatch). Given the same collected batch and permutations the Anakin
  update is the host loop's update bit for bit. ``dones`` is ``terminated or
  truncated``, with no truncation bootstrap, as in the reference's iteration.
* SAC (``SACAnakin``): one iteration steps the envs, writes the transition row into a
  ``DeviceTransitionRing`` at ``rows_added % capacity`` and runs ``replay_ratio``
  gradient steps (``make_sac_update``) on batches sampled and gathered on the device;
  the target-update flag comes from the gradient-step counter on the device. A
  dispatch of ``anakin_steps_per_dispatch`` iterations replays the iteration's graph
  that many times. There is one graph per ``(grad_per_step, train)`` signature: the
  training one and the prefill's (uniform random actions, no update); a shorter tail
  dispatch replays the training graph fewer times. The reference compiles one program
  per ``(steps, grad_per_step, train)``; capturing one iteration instead keeps the
  capture seconds and the graph memory independent of the dispatch's length.

Every member of a population (``engine/population.py``) is one such object with its own
graphs, replayed back to back.

Draws: the acting noise, the reset draws, the permutations (PPO) and the ring indices
and update noise (SAC) come from each member's generators, registered with its graphs,
or are injected (``injected=True``: the tests hand in the reference's draws, and a card
holds a captured dispatch to its eager one on the same draws).

Metrics (``Loss/*``, the episode sums) stay on the device per dispatch and are fetched
once per log window (``AnakinFutures.drain``). Checkpoints hold the reference's layout:
``carry`` (parameters, optimizer states, env states, observations, generator states,
episode accumulators; SAC adds the ring, unless ``buffer.checkpoint=False``, and its
counters), ``update``/``iter_num``, ``policy_step``, ``last_log`` and
``last_checkpoint``; a population's carry is stacked under a leading member axis.
"""

from __future__ import annotations

import functools
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.loop_common import TrainResult, refuse_host_env_keys, refuse_unported
from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
from sheeprl_tpu_torch.config.core import save_config
from sheeprl_tpu_torch.engine.population import (
    member_generators,
    population_rows,
    population_spec,
    set_injected_lr,
    slice_member,
    stack_members,
)
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.batched import make_batched_env
from sheeprl_tpu_torch.fault.guard import TrainingGuard
from sheeprl_tpu_torch.obs import TrainingMonitor
from sheeprl_tpu_torch.obs.health import health_enabled
from sheeprl_tpu_torch.utils.graphs import StepGraph
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import make_aggregator
from sheeprl_tpu_torch.utils.timer import Timer

def anakin_enabled(cfg) -> bool:
    """The mode gate the PPO and SAC entries test before their host loop."""
    return bool(cfg.algo.get("anakin", False))


def anakin_env(cfg):
    """The batched env and its params from the config; an env the engine cannot step on
    the device raises: the user asked for the fused mode explicitly."""
    if not bool((cfg.env.get("jax") or {}).get("enabled", False)):
        raise ValueError(
            "algo.anakin=True needs an on-device JAX environment: pick one with "
            "env=jax_cartpole / jax_pendulum / jax_mountain_car (or set "
            "env.jax.enabled=True with env.jax.env_id for a gymnax env)."
        )
    env = make_batched_env(cfg.env.jax.get("env_id") or cfg.env.id)
    return env, env.default_params()


def anakin_mlp_key(cfg) -> str:
    """The batched envs expose one flat vector observation: the one configured MLP key."""
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    if cnn_keys or len(mlp_keys) != 1:
        raise ValueError(
            "algo.anakin=True supports exactly one MLP observation key and no CNN "
            f"keys (the jax envs are flat-vector); got cnn={cnn_keys} mlp={mlp_keys}."
        )
    return mlp_keys[0]


# --------------------------------------------------------------------- episodes
def init_episode_stats(num_envs: int, device: Any = None) -> Dict[str, torch.Tensor]:
    """Per-env running returns and lengths, and the dispatch window's sums."""
    return {
        "ep_return": torch.zeros((num_envs,), dtype=torch.float32, device=device),
        "ep_len": torch.zeros((num_envs,), dtype=torch.int32, device=device),
        "return_sum": torch.zeros((), dtype=torch.float32, device=device),
        "len_sum": torch.zeros((), dtype=torch.float32, device=device),
        "count": torch.zeros((), dtype=torch.float32, device=device),
    }


def reset_episode_sums(stats: Dict[str, torch.Tensor]) -> None:
    for k in ("return_sum", "len_sum", "count"):
        stats[k].zero_()


def update_episode_stats(stats: Dict[str, torch.Tensor], reward: torch.Tensor, done: torch.Tensor) -> None:
    """One batched env step's bookkeeping, in place: accumulate the running returns and
    lengths, fold the finished episodes into the window's sums, reset their envs."""
    ep_return = stats["ep_return"] + reward
    ep_len = stats["ep_len"] + 1
    d = done.to(torch.float32)
    stats["return_sum"].add_(torch.sum(ep_return * d))
    stats["len_sum"].add_(torch.sum(ep_len.to(torch.float32) * d))
    stats["count"].add_(torch.sum(d))
    stats["ep_return"].copy_(ep_return * (1.0 - d))
    stats["ep_len"].copy_(ep_len * (1 - done.to(torch.int32)))


def episode_metrics(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The window's sums, copied (the accumulators are reset by the next dispatch)."""
    return {
        "Episodes/return_sum": stats["return_sum"].clone(),
        "Episodes/len_sum": stats["len_sum"].clone(),
        "Episodes/count": stats["count"].clone(),
    }


class AnakinFutures:
    """The dispatches' metrics, kept on the device until the log window drains them in
    one blocking fetch: the episode sums become ``Rewards/rew_avg`` and
    ``Game/ep_len_avg``, every other key feeds the aggregator, and the window's wall
    time gives ``Time/sps_env_interaction`` and ``Time/sps_train``.

    A metric is a 0-d tensor (one run) or a ``[K]`` tensor (a population). For the
    latter the plain key logs the mean across members, and ``population_rows`` adds
    ``Population/<key>/member_<m>``, ``/median`` and ``/best``; ``Rewards/rew_avg`` and
    ``Game/ep_len_avg`` come from each member's own episode sums (a member without a
    finished episode in the window is skipped)."""

    def __init__(self):
        self._pending: List[Dict[str, Any]] = []
        self._window_env_steps = 0
        self._window_grad_steps = 0
        self._window_t0 = 0.0

    def track(self, metrics: Dict[str, Any], env_steps: int, grad_steps: int) -> None:
        if not self._pending and self._window_env_steps == 0:
            self._window_t0 = time.perf_counter()
        self._pending.append(metrics)
        self._window_env_steps += env_steps
        self._window_grad_steps += grad_steps

    def _fetch(self) -> List[Dict[str, np.ndarray]]:
        """Every pending metric on the host, through one copy."""
        if not self._pending:
            return []
        leaves = [(i, k, torch.as_tensor(v)) for i, tree in enumerate(self._pending) for k, v in tree.items()]
        flat = torch.cat([v.detach().reshape(-1).to(torch.float32) for _, _, v in leaves]).cpu().numpy()
        out: List[Dict[str, np.ndarray]] = [{} for _ in self._pending]
        pos = 0
        for i, k, v in leaves:
            out[i][k] = flat[pos : pos + v.numel()].reshape(v.shape)
            pos += v.numel()
        self._pending.clear()
        return out

    def drain(self, aggregator) -> Dict[str, float]:
        """Fetch the window's metrics, feed ``aggregator`` (may be None) and return the
        window's rates and ``Population/*`` rows."""
        fetched = self._fetch()
        ret_sum = len_sum = count = 0.0  # scalars, or [K] member vectors
        window: Dict[str, list] = {}
        for tree in fetched:
            ret_sum = ret_sum + np.asarray(tree.pop("Episodes/return_sum", 0.0), np.float64)
            len_sum = len_sum + np.asarray(tree.pop("Episodes/len_sum", 0.0), np.float64)
            count = count + np.asarray(tree.pop("Episodes/count", 0.0), np.float64)
            for k, v in tree.items():
                arr = np.asarray(v)
                if arr.ndim == 0:
                    if aggregator is not None:
                        aggregator.update(k, float(arr))
                else:
                    if aggregator is not None:
                        aggregator.update(k, float(arr.mean()))
                    window.setdefault(k, []).append(arr)
        elapsed = max(time.perf_counter() - self._window_t0, 1e-9)
        out: Dict[str, float] = {}
        for k, arrs in window.items():
            out.update(population_rows(k, np.mean(np.stack(arrs), axis=0)))
        if np.ndim(count) == 0:
            if count > 0 and aggregator is not None:
                aggregator.update("Rewards/rew_avg", float(ret_sum / count))
                aggregator.update("Game/ep_len_avg", float(len_sum / count))
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                rew = np.where(count > 0, ret_sum / np.maximum(count, 1e-9), np.nan)
                length = np.where(count > 0, len_sum / np.maximum(count, 1e-9), np.nan)
            if np.isfinite(rew).any():
                if aggregator is not None:
                    aggregator.update("Rewards/rew_avg", float(np.nanmean(rew)))
                    aggregator.update("Game/ep_len_avg", float(np.nanmean(length)))
                out.update(population_rows("Rewards/rew_avg", rew))
                out.update(population_rows("Game/ep_len_avg", length))
        if self._window_env_steps > 0:
            out["Time/sps_env_interaction"] = self._window_env_steps / elapsed
        if self._window_grad_steps > 0:
            out["Time/sps_train"] = self._window_grad_steps / elapsed
        self._window_env_steps = 0
        self._window_grad_steps = 0
        return out


def reset_envs(env, env_params, num_envs: int, generator: Optional[torch.Generator], device: Any = None, draws: Optional[torch.Tensor] = None):
    """Fresh episodes for ``num_envs`` envs: the state (its own contiguous tensors, which
    the captured steps update in place) and the observations."""
    if draws is None:
        draws = env.reset_draws(env_params, (num_envs,), generator, device)
    state, obs = env.reset(env_params, draws)
    return type(state)(*(s.clone() for s in state)), obs.clone()


def program(
    fn: Callable[[Any], Any], inputs: Any, state: Sequence[torch.Tensor], generators: Sequence[torch.Generator], capture: bool,
    cost_name: Optional[str] = None,
) -> Callable[[], Any]:
    """``fn(inputs)`` as a callable: a ``StepGraph`` (a CUDA graph on a card, eager on the
    CPU) or, with ``capture=False``, the eager function (the card's parity check).
    Building it draws nothing: the capture's warm-up steps advance the generators, whose
    states are put back as ``state`` is, so a run's draws do not depend on when its
    graphs were captured (a population captures every member's before the first
    dispatch)."""
    if not capture:
        return lambda: fn(inputs)
    saved = [g.get_state() for g in generators]
    graph = StepGraph(fn, inputs, list(state), generators=list(generators), cost_name=cost_name)
    for g, s in zip(generators, saved):
        g.set_state(s)
    return graph


@torch.no_grad()
def _load_tensors(dst: Sequence[torch.Tensor], src: Sequence[Any]) -> None:
    for d, s in zip(dst, src):
        d.copy_(torch.as_tensor(s))


class _Member:
    """What the PPO and SAC members share: the env state, the observations, the episode
    accumulators and the generators, and their part of the carry."""

    def _init_env(self, ctx, cfg, env, env_params, generators: Sequence[torch.Generator], reset_draws=None) -> None:
        self.device = ctx.device
        self.env, self.env_params = env, env_params
        self.num_envs = int(cfg.env.num_envs)
        self.generators = list(generators)
        self.state, self.obs = reset_envs(env, env_params, self.num_envs, self.generators[0], self.device, reset_draws)
        self.stats = init_episode_stats(self.num_envs, self.device)
        act_space = env.action_space(env_params)
        self.rescale = isinstance(act_space, spaces.Box) and bool(np.isfinite(act_space.low).all() and np.isfinite(act_space.high).all())
        if isinstance(act_space, spaces.Box):
            self.act_low = torch.as_tensor(act_space.low, dtype=torch.float32, device=self.device)
            self.act_high = torch.as_tensor(act_space.high, dtype=torch.float32, device=self.device)

    def _env_state(self) -> List[torch.Tensor]:
        return [*self.state, self.obs, *self.stats.values()]

    @torch.no_grad()
    def _adopt(self, state, next_obs: torch.Tensor) -> None:
        torch._foreach_copy_(list(self.state), list(state))
        self.obs.copy_(next_obs)

    def _env_carry(self) -> Dict[str, Any]:
        return {
            "env_state": dict(self.state._asdict()),
            "obs": self.obs,
            "generators": [g.get_state() for g in self.generators],
            "episode_stats": self.stats,
        }

    def _load_env_carry(self, carry: Dict[str, Any]) -> None:
        _load_tensors(list(self.state), [carry["env_state"][k] for k in self.state._fields])
        _load_tensors([self.obs], [carry["obs"]])
        _load_tensors(list(self.stats.values()), [carry["episode_stats"][k] for k in self.stats])
        for g, s in zip(self.generators, carry["generators"]):
            g.set_state(torch.as_tensor(s).cpu().clone())  # its own storage: set_state crashes on a view of a stacked carry


# -------------------------------------------------------------------------- PPO
class PPOAnakin(_Member):
    """One member's PPO Anakin state and programs (the reference's
    ``make_ppo_anakin_iteration`` and its carry).

    ``generators``: ``[acting, update]``; the acting one draws the actions and the
    resets inside the rollout's graph, the update's the epochs' permutations.
    ``injected``: the rollout reads its draws from ``inputs`` (``[T, ...]``: ``actions``,
    the sampling's noise per head, and ``reset``, the envs' reset draws), which the
    caller fills before ``iterate``. ``capture=False``: every program runs
    eagerly (a card's parity check)."""

    def __init__(self, ctx, cfg, env, env_params, obs_key: str, num_updates: int, generators: Optional[Sequence[torch.Generator]] = None,
                 capture: bool = True, inject_lr: bool = False, injected: bool = False, reset_draws: Optional[torch.Tensor] = None):
        from sheeprl_tpu_torch.algos.ppo.agent import build_agent
        from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainFns
        from sheeprl_tpu_torch.algos.ppo.utils import draw_shapes

        self.cfg, self.obs_key, self.capture, self.injected = cfg, obs_key, capture, injected
        obs_space = spaces.Dict({obs_key: env.observation_space(env_params)})
        self.agent = build_agent(ctx, env.action_space(env_params), obs_space, cfg)
        # the perf plane counts the update's replays under the reference's dispatch name
        dispatch_name = "anakin/ppo_pop_dispatch" if population_spec(cfg, "ppo").enabled else "anakin/ppo_dispatch"
        self.fns = PPOTrainFns(ctx, self.agent, cfg, [obs_key], num_updates, capture=capture, inject_lr=inject_lr, cost_name=dispatch_name)
        self._init_env(ctx, cfg, env, env_params, generators if generators is not None else [ctx.rng(), ctx.rng()], reset_draws)
        T, N = int(cfg.algo.rollout_steps), self.num_envs
        self.T = T
        agent = self.agent
        self.is_continuous = agent.is_continuous
        self.discrete_scalar = not agent.is_continuous and len(agent.action_dims) == 1
        self.clip_act = agent.is_continuous and self.rescale
        n_act = agent.action_dims[0] if agent.is_continuous else len(agent.action_dims)
        dev = self.device
        self.traj = {
            obs_key: torch.zeros((T, *self.obs.shape), device=dev),
            "actions": torch.zeros((T, N, n_act), device=dev),
            "logprobs": torch.zeros((T, N), device=dev),
            "values": torch.zeros((T, N), device=dev),
            "rewards": torch.zeros((T, N), device=dev),
            "dones": torch.zeros((T, N), device=dev),
        }
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.inputs: Dict[str, Any] = {"t": self.t}
        if injected:
            with torch.no_grad():
                shapes = draw_shapes(agent(self.fns.cast_obs({obs_key: self.obs}))[0], agent.is_continuous)
            self.inputs["actions"] = [torch.zeros((T, *s), device=dev) for s in shapes]
            self.inputs["reset"] = torch.zeros((T, N, len(env.reset_bounds(env_params)[0])), device=dev)
        self._rollout_step: Optional[Callable] = None
        self._bootstrap: Optional[Callable] = None
        self.last_batch: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def _act_step(self, inp: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        from sheeprl_tpu_torch.algos.ppo.utils import sample_actions

        t, obs, N = inp["t"], self.obs, self.num_envs
        actor_out, value = self.agent(self.fns.cast_obs({self.obs_key: obs}))
        draws = [d.index_select(0, t)[0] for d in inp["actions"]] if self.injected else None
        env_act, stored, logprob = sample_actions(actor_out, self.is_continuous, generator=self.generators[0], draws=draws)
        if self.clip_act:
            env_actions = torch.clamp(env_act, self.act_low, self.act_high)
        elif self.discrete_scalar:
            env_actions = env_act[..., 0].to(torch.int32)
        else:
            env_actions = env_act
        reset = inp["reset"].index_select(0, t)[0] if self.injected else None
        state, next_obs, reward, done, _ = self.env.step_autoreset(self.env_params, self.state, env_actions, self.generators[0], reset)
        if self.cfg.env.clip_rewards:
            reward = torch.clamp(reward, -1, 1)
        update_episode_stats(self.stats, reward, done)
        row = {
            self.obs_key: obs,
            "actions": stored.reshape(N, -1).to(torch.float32),
            "logprobs": logprob.reshape(N),
            "values": value[..., 0],
            "rewards": reward.to(torch.float32),
            "dones": done.to(torch.float32),
        }
        for k, v in row.items():
            self.traj[k].index_copy_(0, t, v[None].to(self.traj[k].dtype))
        self._adopt(state, next_obs)
        t.add_(1)
        return {}

    def _programs(self) -> None:
        state = [*self._env_state(), self.t, *self.traj.values()]
        self._rollout_step = program(self._act_step, self.inputs, state, self.generators[:1], self.capture)
        self._bootstrap = program(lambda i: {"v": self.fns.values({self.obs_key: i["obs"]})[:, None]}, {"obs": self.obs}, (), (), self.capture)

    def iterate(self, coefs: torch.Tensor, perms: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One iteration: the rollout, GAE and the update with ``coefs`` (``[2]``, the
        clip and entropy coefficients, on the device). ``perms``: the epochs'
        permutations (default: drawn from the update's generator). Returns the
        iteration's metrics, tensors on the device."""
        from sheeprl_tpu_torch.algos.ppo.ppo import flat_batch

        with torch.no_grad():
            reset_episode_sums(self.stats)
            self.t.zero_()
        if self._rollout_step is None:
            self._programs()
        for _ in range(self.T):
            self._rollout_step()
        next_value = self._bootstrap()["v"]
        traj = self.traj
        returns, advantages = self.fns.gae_fn(traj["rewards"][..., None], traj["values"][..., None], traj["dones"][..., None], next_value)
        data = flat_batch(traj, returns, advantages, [self.obs_key, "actions", "logprobs", "values"])
        self.last_batch = data
        if perms is None:
            perms = self.fns.permutations(self.generators[1])
        out = self.fns.launch_update_coefs(data, perms, coefs)
        # the losses, then Health/* where obs.health is on
        return {**{name: out[i] for i, name in enumerate(self.fns.metric_names)}, **episode_metrics(self.stats)}

    def carry(self) -> Dict[str, Any]:
        """The member's state, as the checkpoint's ``carry`` holds it (references)."""
        return {"params": self.agent.state_dict(), "opt_state": self.fns.opt_state, **self._env_carry()}

    def load_carry(self, carry: Dict[str, Any]) -> None:
        """Copy ``carry`` into the member's tensors in place (their addresses, which the
        captured graphs read, stay)."""
        from sheeprl_tpu_torch.algos.ppo.ppo import Optimizer

        self.agent.load_state_dict(carry["params"])
        Optimizer.load_state(self.fns.opt_state, carry["opt_state"])
        self._load_env_carry(carry)


def coef_table(cfg, clip0: float, ent0: float, num_updates: int, device: Any) -> torch.Tensor:
    """``[num_updates, 2]`` float32: each update's clip and entropy coefficients from the
    member's initial values (``annealed_coefs``), on the device once, so that no
    iteration copies from the host."""
    from sheeprl_tpu_torch.algos.ppo.ppo import annealed_coefs

    rows = [annealed_coefs(cfg, update, num_updates, clip0, ent0) for update in range(1, num_updates + 1)]
    return torch.tensor(rows, dtype=torch.float32).to(device)


class _Run:
    """What the two entries share: the log dir, logger, timer, aggregator, checkpoints,
    the training guard (``fault/guard.py``), the drained log window and the population's
    static rows."""

    def __init__(self, ctx, cfg, aggregator_keys, pop):
        self.ctx, self.cfg, self.pop = ctx, cfg, pop
        self.log_dir = get_log_dir(cfg)
        save_config(cfg, Path(self.log_dir) / "config.yaml")
        self.logger = get_logger(cfg, self.log_dir)
        self.timer = Timer(disabled=bool(cfg.metric.get("disable_timer", False)))
        self.monitor = TrainingMonitor(cfg, self.log_dir, self.timer, ctx.device)
        self.aggregator = make_aggregator(cfg.metric.aggregator.get("metrics", {}), disabled=cfg.metric.get("log_level", 1) == 0)
        self.aggregator.keep(set(aggregator_keys) | set(cfg.metric.aggregator.get("metrics", {})))
        self.ckpt_manager = CheckpointManager(Path(self.log_dir) / "checkpoints", keep_last=cfg.checkpoint.keep_last)
        self.guard = TrainingGuard(cfg, self.log_dir)
        self.futures = AnakinFutures()
        self.policy_step, self.last_log, self.last_checkpoint = 0, 0, 0
        self.last_path: Optional[str] = None
        self.dispatch_seconds = 0.0

    def track(self, member_metrics: List[Dict[str, torch.Tensor]], env_steps: int, grad_steps: int) -> None:
        """One dispatch's metrics, stacked over the members for a population."""
        if self.pop.enabled:
            metrics = {k: torch.stack([m[k] for m in member_metrics]) for k in member_metrics[0]}
        else:
            metrics = member_metrics[0]
        k = len(member_metrics)
        self.futures.track(metrics, env_steps * k, grad_steps * k)

    def log(self, extra: Dict[str, float]) -> None:
        out = self.futures.drain(self.aggregator)  # the window's only blocking fetch
        out.update(self.aggregator.compute())
        out.update(extra)
        for name, values in self.pop.sweep.items():  # the sweep table is static: log it with every flush
            for m, v in enumerate(values):
                out[f"Population/Params/{name}/member_{m}"] = float(v)
        self.monitor.log_metrics(self.logger, out, self.policy_step)
        self.aggregator.reset()
        self.last_log = self.policy_step

    def save(self, members: Sequence[Any], counters: Dict[str, int], carry_of: Callable[[Any], Dict[str, Any]]) -> str:
        carries = [carry_of(m) for m in members]
        carry = stack_members(carries) if self.pop.enabled else carries[0]
        state = {"carry": carry, **counters, "policy_step": self.policy_step, "last_log": self.last_log, "last_checkpoint": self.policy_step}
        with self.monitor.phase("checkpoint"):
            self.last_path = str(self.ckpt_manager.save(self.policy_step, state))
        self.last_checkpoint = self.policy_step
        return self.last_path

    def load(self) -> Optional[Dict[str, Any]]:
        path = self.cfg.checkpoint.get("resume_from")
        if not path:
            return None
        state = CheckpointManager.load(path)
        self.policy_step = state["policy_step"]
        self.last_log = state.get("last_log", 0)
        self.last_checkpoint = state.get("last_checkpoint", 0)
        return state

    def member_carry(self, state: Dict[str, Any], m: int) -> Dict[str, Any]:
        return slice_member(state["carry"], m) if self.pop.enabled else state["carry"]

    def finish(self, test_fn: Callable[[], float], grad_steps: int, seconds: float) -> TrainResult:
        test_reward = None
        if self.cfg.algo.run_test:
            test_reward = test_fn()
            if self.logger is not None:
                self.logger.log_metrics({"Test/cumulative_reward": test_reward}, self.policy_step)
        if self.logger is not None:
            self.logger.close()
        # acting and updating are one device program here: the host seconds of the dispatches are all train seconds
        return TrainResult(self.log_dir, self.policy_step, grad_steps, self.last_path, seconds, self.dispatch_seconds, 0.0, test_reward)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_ppo_members(ctx, cfg, env, env_params, obs_key: str, num_updates: int, pop, capture: bool = True):
    """``(members, coefficient tables)`` of a run: one ``PPOAnakin``, or one per member of
    a population. Member 0 takes the plain run's draws (its agent's init, its
    generators) first; members ``m > 0`` get the next init draws and generators of
    their own. A swept learning rate is stamped into each member's optimizer state."""
    size = pop.size if pop.enabled else 1
    sweeps_lr = pop.enabled and pop.sweeps_lr("optimizer.lr")
    members = [PPOAnakin(ctx, cfg, env, env_params, obs_key, num_updates, capture=capture, inject_lr=sweeps_lr)]
    gens = member_generators(members[0].generators, ctx.seed, size)
    for m in range(1, size):
        members.append(PPOAnakin(ctx, cfg, env, env_params, obs_key, num_updates, gens[m], capture=capture, inject_lr=sweeps_lr))
    if sweeps_lr:
        for m, lr in enumerate(pop.values("optimizer.lr", cfg.algo.optimizer.lr)):
            set_injected_lr(members[m].fns.opt_state, lr)
    clip0 = pop.values("clip_coef", cfg.algo.clip_coef) if pop.enabled else [float(cfg.algo.clip_coef)]
    ent0 = pop.values("ent_coef", cfg.algo.ent_coef) if pop.enabled else [float(cfg.algo.ent_coef)]
    return members, [coef_table(cfg, clip0[m], ent0[m], num_updates, ctx.device) for m in range(size)]


def ppo_anakin(ctx, cfg) -> TrainResult:
    """The Anakin PPO entry (``algo.anakin=True``), called by ``algos/ppo/ppo.py::main``.
    With ``algo.population.size=K`` (or a sweep) K members train in each dispatch."""
    from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS, test

    refuse_unported(cfg, handled=("algo.anakin",))
    refuse_host_env_keys(cfg, "the Anakin engine")
    env, env_params = anakin_env(cfg)
    obs_key = anakin_mlp_key(cfg)
    pop = population_spec(cfg, "ppo")
    run = _Run(ctx, cfg, AGGREGATOR_KEYS, pop)
    num_envs, rollout_steps = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1) if not cfg.dry_run else 1
    sweeps_lr = pop.enabled and pop.sweeps_lr("optimizer.lr")
    try:
        members, tables = build_ppo_members(ctx, cfg, env, env_params, obs_key, num_updates, pop)

        start_update = 1
        state = run.load()
        if state is not None:
            for m, member in enumerate(members):
                member.load_carry(run.member_carry(state, m))
            start_update = state["update"] + 1
        fns = members[0].fns
        grad_steps = 0
        run_start = time.perf_counter()
        for update in range(start_update, num_updates + 1):
            run.monitor.advance()
            t0 = time.perf_counter()
            with run.timer("Time/train_time"), run.monitor.phase("dispatch"):
                metrics = [member.iterate(tables[m][update - 1]) for m, member in enumerate(members)]
            run.dispatch_seconds += time.perf_counter() - t0
            run.track(metrics, policy_steps_per_iter, fns.grad_steps_per_update)
            run.policy_step += policy_steps_per_iter
            grad_steps += fns.grad_steps_per_update
            if run.logger is not None and (run.policy_step - run.last_log >= cfg.metric.log_every or update == num_updates or cfg.dry_run):
                run.log({} if sweeps_lr else {"Params/lr": fns.lr_at(update * fns.grad_steps_per_update)})
            save_ckpt = functools.partial(run.save, members, {"update": update}, PPOAnakin.carry)
            if (cfg.checkpoint.every > 0 and run.policy_step - run.last_checkpoint >= cfg.checkpoint.every) or (
                update == num_updates and cfg.checkpoint.save_last
            ):
                save_ckpt()
            run.guard.boundary(run.policy_step, save_ckpt)
        _sync(ctx.device)
    finally:
        run.monitor.close()
    seconds = time.perf_counter() - run_start
    # a population's greedy test episode runs member 0's policy (the run's own generators)
    return run.finish(lambda: test(members[0].agent, ctx, cfg, run.log_dir).reward, grad_steps, seconds)


# -------------------------------------------------------------------------- SAC
class SACAnakin(_Member):
    """One member's SAC Anakin state and programs (the reference's
    ``make_sac_anakin_dispatch`` and its carry).

    ``ring``: the ``DeviceTransitionRing`` whose layout (and sampling) the member uses;
    ``arrays``: the member's ring arrays (a population's are views of
    ``ring.population_arrays``; default: ``ring.arrays``). ``generators``: ``[draws]``,
    the acting noise, the prefill's actions, the resets, the ring indices and the update
    noise. ``injected``: up to ``injected_steps`` iterations read their draws from
    ``inputs`` (``act`` ``[S, N, A]``, the policy's noise or the prefill's env actions;
    ``reset`` ``[S, N, k]``; per gradient step ``envs``/``rows`` ``[S, G, B]`` and
    ``next``/``new`` ``[S, G, B, A]``)."""

    def __init__(self, ctx, cfg, env, env_params, obs_key: str, ring, generators: Optional[Sequence[torch.Generator]] = None,
                 arrays: Optional[Dict[str, torch.Tensor]] = None, capture: bool = True, inject: Sequence[str] = (),
                 injected: bool = False, injected_steps: int = 0, reset_draws: Optional[torch.Tensor] = None):
        from sheeprl_tpu_torch.algos.sac.agent import build_agent
        from sheeprl_tpu_torch.algos.sac.sac import make_sac_update

        self.cfg, self.obs_key, self.capture, self.injected = cfg, obs_key, capture, injected
        act_space = env.action_space(env_params)
        obs_space = spaces.Dict({obs_key: env.observation_space(env_params)})
        self.agent = build_agent(ctx, act_space, obs_space, cfg)
        self.act_dim = int(np.prod(act_space.shape))
        self.update, _, self.opt_states = make_sac_update(self.agent, cfg, self.act_dim, inject)
        self._init_env(ctx, cfg, env, env_params, generators if generators is not None else [ctx.rng()], reset_draws)
        self.ring = ring
        self.arrays = arrays if arrays is not None else ring.arrays
        self.write_row = ring.make_scan_writer()
        self.batch_size = int(cfg.algo.per_rank_batch_size)
        self.sample_gather = ring.make_sample_gather(self.batch_size)
        self.target_freq = max(int(cfg.algo.critic.get("target_network_frequency", 1)), 1)
        dev = self.device
        self.rows_added = torch.zeros((), dtype=torch.int64, device=dev)
        self.gstep = torch.zeros((), dtype=torch.int64, device=dev)
        self.it = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.loss_sum = torch.zeros((3,), device=dev)
        # Health/* sums (obs.health), made at a program's first, eager, call
        self.health = health_enabled(cfg)
        self.health_sum: Dict[str, torch.Tensor] = {}
        self.inputs: Dict[str, Any] = {"it": self.it}
        if injected:
            S, N, B, A = injected_steps, self.num_envs, self.batch_size, self.act_dim
            G = int(round(float(cfg.algo.replay_ratio)))
            self.inputs.update(
                act=torch.zeros((S, N, A), device=dev),
                reset=torch.zeros((S, N, len(env.reset_bounds(env_params)[0])), device=dev),
                envs=torch.zeros((S, G, B), dtype=torch.int64, device=dev),
                rows=torch.zeros((S, G, B), dtype=torch.int64, device=dev),
                next=torch.zeros((S, G, B, A), device=dev),
                new=torch.zeros((S, G, B, A), device=dev),
            )
        self._programs: Dict[tuple, Callable] = {}

    def _iteration(self, inp: Dict[str, Any], grad_per_step: int, train: bool) -> Dict[str, torch.Tensor]:
        from sheeprl_tpu_torch.algos.sac.sac import SACDraws

        it, obs, gen, N = inp["it"], self.obs, self.generators[0], self.num_envs
        pick = lambda k: inp[k].index_select(0, it)[0]  # noqa: E731  (this iteration's injected draws)
        with torch.no_grad():
            if train:
                mean, log_std = self.agent.actor(obs)
                tanh_act = self.agent.actor.dist(mean, log_std).sample(generator=gen, noise=pick("act") if self.injected else None)
            else:
                raw = pick("act") if self.injected else self.env.sample_action(self.env_params, (N,), gen, self.device)
                tanh_act = 2 * (raw - self.act_low) / (self.act_high - self.act_low) - 1 if self.rescale else raw
            env_act = self.act_low + (tanh_act + 1) * 0.5 * (self.act_high - self.act_low) if self.rescale else tanh_act
            reset = pick("reset") if self.injected else None
            state, next_obs, reward, done, info = self.env.step_autoreset(self.env_params, self.state, env_act, gen, reset)
            if self.cfg.env.clip_rewards:
                reward = torch.clamp(reward, -1, 1)
            update_episode_stats(self.stats, reward, done)
            rows = {
                "obs": obs,
                # the finishing episode's true last observation (the auto-reset swapped next_obs)
                "next_obs": info["final_obs"],
                "actions": tanh_act,
                "rewards": reward[:, None].to(torch.float32),
                # a truncated episode still bootstraps: dones is the termination
                "dones": info["terminated"][:, None].to(torch.float32),
            }
            self.write_row(self.arrays, rows, self.rows_added)
            self.rows_added.add_(1)
            self._adopt(state, next_obs)
        if train and grad_per_step > 0:
            filled = torch.clamp(self.rows_added, max=self.ring.capacity)
            total = None
            health_total: Dict[str, torch.Tensor] = {}
            for g in range(grad_per_step):
                idx = (pick("envs")[g], pick("rows")[g]) if self.injected else None
                if self.health and idx is None:
                    idx = self.ring.sample_indices(filled, gen, self.batch_size)  # the draws sample_gather makes
                batch = self.sample_gather(self.arrays, filled, gen, idx)
                flag = torch.remainder(self.gstep + 1, self.target_freq) == 0
                if self.injected:
                    draws = SACDraws(pick("next")[g], pick("new")[g])
                else:
                    shape = (self.batch_size, self.act_dim)
                    draws = SACDraws(torch.randn(shape, generator=gen, device=self.device), torch.randn(shape, generator=gen, device=self.device))
                m = self.update(self.opt_states, batch, flag, draws)
                with torch.no_grad():
                    self.gstep.add_(1)
                    losses = torch.stack([m["Loss/value_loss"], m["Loss/policy_loss"], m["Loss/alpha_loss"]])
                    total = losses if total is None else total + losses
                    if self.health:
                        # the sampled rows' ages: the ring writes every env's row at slot
                        # rows_added % capacity, so a row's age is its distance behind
                        ages = torch.remainder(self.rows_added - 1 - idx[1], self.ring.capacity)
                        m = {**m, "Health/replay_age_mean": ages.float().mean(), "Health/replay_age_max": ages.max().float()}
                        for k, v in m.items():
                            if k.startswith("Health/"):
                                health_total[k] = v if k not in health_total else health_total[k] + v
            with torch.no_grad():
                self.loss_sum.add_(total / grad_per_step)
                for k, v in health_total.items():
                    if k not in self.health_sum:
                        self.health_sum[k] = torch.zeros((), device=self.device)
                    self.health_sum[k].add_(v / grad_per_step)
        with torch.no_grad():
            it.add_(1)
        return {}

    def _program(self, grad_per_step: int, train: bool) -> Callable:
        sig = (grad_per_step, train)
        if sig not in self._programs:
            from sheeprl_tpu_torch.utils.graphs import tree_tensors

            state = [*self.agent.parameters(), *tree_tensors(self.opt_states), *self._env_state(), *self.arrays.values(),
                     self.rows_added, self.gstep, self.it, self.loss_sum]
            fn = lambda inp: self._iteration(inp, grad_per_step, train)  # noqa: E731
            name = f"anakin/{'sac_pop' if population_spec(self.cfg, 'sac').enabled else 'sac'}_dispatch_{1}x{grad_per_step}{'t' if train else 'p'}"
            self._programs[sig] = program(fn, self.inputs, state, self.generators, self.capture, name)
        return self._programs[sig]

    def dispatch(self, steps: int, grad_per_step: int, train: bool) -> Dict[str, torch.Tensor]:
        """``steps`` iterations (replays of the signature's program); returns the
        dispatch's metrics, tensors on the device (losses: the mean over its
        iterations)."""
        with torch.no_grad():
            reset_episode_sums(self.stats)
            self.it.zero_()
            self.loss_sum.zero_()
        prog = self._program(grad_per_step, train)  # captured from the zeroed counters
        with torch.no_grad():
            for t in self.health_sum.values():  # after a first program's warm-up calls
                t.zero_()
        for _ in range(steps):
            prog()
        out = episode_metrics(self.stats)
        if train and grad_per_step > 0:
            mean = self.loss_sum / steps
            out.update({"Loss/value_loss": mean[0], "Loss/policy_loss": mean[1], "Loss/alpha_loss": mean[2]})
            out.update({k: v / steps for k, v in self.health_sum.items()})
        return out

    def carry(self, with_ring: bool = True) -> Dict[str, Any]:
        out = {"params": self.agent.state_dict(), "opt_state": self.opt_states, **self._env_carry(),
               "rows_added": self.rows_added, "gstep": self.gstep}
        if with_ring:
            out["ring"] = self.arrays
        return out

    def load_carry(self, carry: Dict[str, Any]) -> None:
        """Copy ``carry`` in place; without its ``ring`` (``buffer.checkpoint=False``) the
        ring restarts empty and ``rows_added`` from 0."""
        from sheeprl_tpu_torch.algos.dreamer_loop import load_opt_states

        self.agent.load_state_dict(carry["params"])
        load_opt_states(self.opt_states, carry["opt_state"])
        self._load_env_carry(carry)
        _load_tensors([self.gstep], [carry["gstep"]])
        with torch.no_grad():
            if "ring" in carry:
                _load_tensors(list(self.arrays.values()), [carry["ring"][k] for k in self.arrays])
                _load_tensors([self.rows_added], [carry["rows_added"]])
            else:
                for a in self.arrays.values():
                    a.zero_()
                self.rows_added.zero_()


def sac_ring(cfg, env, env_params, device: Any):
    """The SAC engine's ring layout: ``buffer.size // num_envs`` rows per env of flat
    ``obs``, ``next_obs``, ``actions``, ``rewards`` and ``dones``."""
    from sheeprl_tpu_torch.data.device_buffer import DeviceTransitionRing, resolve_store_dtype

    num_envs = int(cfg.env.num_envs)
    obs_dim = int(np.prod(env.observation_space(env_params).shape))
    act_dim = int(np.prod(env.action_space(env_params).shape))
    capacity = max(int(cfg.buffer.size) // max(num_envs, 1), 1)
    specs = {
        "obs": ((obs_dim,), np.float32),
        "next_obs": ((obs_dim,), np.float32),
        "actions": ((act_dim,), np.float32),
        "rewards": ((1,), np.float32),
        "dones": ((1,), np.float32),
    }
    return DeviceTransitionRing(capacity, num_envs, specs, device, resolve_store_dtype(cfg.buffer.get("store_dtype")))


def sac_grad_per_step(cfg) -> int:
    replay_ratio = float(cfg.algo.replay_ratio)
    grad_per_step = int(round(replay_ratio))
    if grad_per_step < 1 or abs(replay_ratio - grad_per_step) > 1e-9:
        raise ValueError(
            f"algo.anakin=True needs an integer algo.replay_ratio >= 1 (the fused "
            f"scan runs a static number of gradient steps per env step); got "
            f"{replay_ratio}."
        )
    return grad_per_step


def build_sac_members(ctx, cfg, env, env_params, obs_key: str, pop, capture: bool = True) -> List[SACAnakin]:
    """A run's ``SACAnakin`` members (one, or one per member of a population) over one
    ring layout; a population's rings are allocated at the stacked shape, member ``m``'s
    the view ``[m]``. Member 0 takes the plain run's draws first; a swept learning rate
    is stamped into each member's optimizer state."""
    size = pop.size if pop.enabled else 1
    ring = sac_ring(cfg, env, env_params, ctx.device)
    inject = tuple(n for n in ("actor", "critic", "alpha") if f"{n}.optimizer.lr" in pop.sweep)
    arrays = [ring.arrays]
    if pop.enabled:
        stacked = ring.population_arrays(size)
        arrays = [{k: v[m] for k, v in stacked.items()} for m in range(size)]
        ring.arrays = arrays[0]  # the single ring's own planes are freed
    members = [SACAnakin(ctx, cfg, env, env_params, obs_key, ring, arrays=arrays[0], capture=capture, inject=inject)]
    gens = member_generators(members[0].generators, ctx.seed, size)
    for m in range(1, size):
        members.append(SACAnakin(ctx, cfg, env, env_params, obs_key, ring, gens[m], arrays=arrays[m], capture=capture, inject=inject))
    for n in inject:
        for m, lr in enumerate(pop.sweep[f"{n}.optimizer.lr"]):
            set_injected_lr(members[m].opt_states[n], lr)
    return members


def sac_anakin(ctx, cfg) -> TrainResult:
    """The Anakin SAC entry (``algo.anakin=True``), called by ``algos/sac/sac.py::main``.
    With ``algo.population.size=K`` K members, each with its own ring, train in each
    dispatch."""
    from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS, test, vector_rows

    refuse_unported(cfg, handled=("algo.anakin",))
    refuse_host_env_keys(cfg, "the Anakin engine")
    env, env_params = anakin_env(cfg)
    obs_key = anakin_mlp_key(cfg)
    pop = population_spec(cfg, "sac")
    grad_per_step = sac_grad_per_step(cfg)
    if not isinstance(env.action_space(env_params), spaces.Box):
        raise ValueError("SAC anakin needs a continuous (Box) jax env, e.g. env=jax_pendulum")
    run = _Run(ctx, cfg, AGGREGATOR_KEYS, pop)
    try:
        members = build_sac_members(ctx, cfg, env, env_params, obs_key, pop)

        num_envs = int(cfg.env.num_envs)
        num_iters = max(int(cfg.algo.total_steps) // max(num_envs, 1), 1) if not cfg.dry_run else 1
        prefill_steps = int(cfg.algo.learning_starts) // max(num_envs, 1) if not cfg.dry_run else 0
        prefill_steps = min(prefill_steps, num_iters - 1) if num_iters > 1 else 0
        steps_per_dispatch = max(int(cfg.algo.anakin_steps_per_dispatch), 1) if not cfg.dry_run else 1
        with_ring = bool(cfg.buffer.checkpoint)

        iter_num, resumed = 0, False
        state = run.load()
        if state is not None:
            for m, member in enumerate(members):
                member.load_carry(run.member_carry(state, m))
            iter_num, resumed = state["iter_num"], True

        grad_steps = 0
        run_start = time.perf_counter()

        def dispatch(steps: int, train: bool) -> None:
            nonlocal iter_num, grad_steps
            gps = grad_per_step if train else 0
            run.monitor.advance()
            t0 = time.perf_counter()
            with run.timer("Time/train_time" if train else "Time/env_interaction_time"), run.monitor.phase("dispatch"):
                metrics = [member.dispatch(steps, gps, train) for member in members]
            run.dispatch_seconds += time.perf_counter() - t0
            run.track(metrics, steps * num_envs, steps * gps)
            run.policy_step += steps * num_envs
            iter_num += steps
            grad_steps += steps * gps

        def save_ckpt() -> str:
            return run.save(members, {"iter_num": iter_num}, lambda mb: mb.carry(with_ring))

        def boundary(final: bool) -> None:
            if run.logger is not None and (run.policy_step - run.last_log >= cfg.metric.log_every or final or cfg.dry_run):
                run.log({"Params/replay_ratio": grad_per_step} if run.policy_step > 0 else {})
            if (cfg.checkpoint.every > 0 and run.policy_step - run.last_checkpoint >= cfg.checkpoint.every) or (final and cfg.checkpoint.save_last):
                save_ckpt()
            run.guard.boundary(run.policy_step, save_ckpt)

        # the prefill: one dispatch of uniform random actions (a resumed run keeps its policy and skips it)
        if prefill_steps > 0 and iter_num < prefill_steps and not resumed:
            dispatch(prefill_steps - iter_num, False)
            run.guard.boundary(run.policy_step, save_ckpt)
        while iter_num < num_iters:
            dispatch(min(steps_per_dispatch, num_iters - iter_num), True)
            boundary(iter_num >= num_iters)
        _sync(ctx.device)
    finally:
        run.monitor.close()
    seconds = time.perf_counter() - run_start
    actor = members[0].agent.actor
    greedy = lambda rows: torch.tanh(actor(rows)[0])  # noqa: E731
    return run.finish(lambda: test(greedy, lambda o: vector_rows(o, [obs_key]), ctx, cfg, run.log_dir).reward, grad_steps, seconds)
