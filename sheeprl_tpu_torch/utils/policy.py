"""Checkpoint to act function, for serving (counterpart of ``sheeprl_tpu/utils/policy.py``).

``load_policy`` rebuilds the agent a checkpoint was trained with (from the run's saved
config), loads the checkpoint (checksum-verified), takes the policy parameters out of it
and returns a :class:`LoadedPolicy`: a batched act function ``act_fn(params, obs_dict,
draws=None) -> actions`` that the server replays from one CUDA graph per batch bucket.
``params`` is a dict of tensors named as the module's ``state_dict``; the act function
runs the module on them through ``torch.func.functional_call``, as the reference runs
``agent.apply(params, ...)``, so a precision tier swaps the dict and nothing else.

Servable families:

* ``ppo``: ``ppo``, ``ppo_decoupled``, ``a2c``: dict observations through the shared
  encoder; greedy takes each distribution's mode. Only the actor's path runs (the
  reference's compiler drops the unused critic).
* ``sac``: ``sac``, ``sac_decoupled``: vector observations concatenated; the action is
  ``tanh(mean)`` rescaled to the env's bounds (the reference's eval-time policy).
* ``ppo_recurrent``, stateful: ``act_fn(params, obs, is_first, state, draws=None) ->
  (actions, new_state)``, ``state = {"rnn": carry, "prev": previous action}`` (one-hot
  per discrete head, raw when continuous; float32 at every tier). The server keeps it on
  the device per session (``serve/state_cache.py``).

Each act function takes its draws as an optional input, as every sampling function of the
port does (``algos/ppo/utils.py::sample_actions``); ``greedy=True``, the default, draws
nothing. Discrete actions come out int32, as the reference's do. Dreamer, DroQ and
SAC-AE policies are refused with the reference's message.

``extract_policy_params``: a host loop's checkpoint holds ``params`` at its top; an Anakin
run's (``engine/anakin.py``) keeps them in its ``carry``, and a population's carry adds a
leading member axis, of which member 0 (the run's own generators) is the one evaluation
and serving use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

#: algo name -> servable family
PPO_FAMILY = ("ppo", "ppo_decoupled", "a2c")
SAC_FAMILY = ("sac", "sac_decoupled")
RECURRENT_PPO_FAMILY = ("ppo_recurrent",)


def policy_family(algo_name: str) -> str:
    """The act-fn family for ``algo_name``; raises for world-model policies."""
    if algo_name in PPO_FAMILY:
        return "ppo"
    if algo_name in SAC_FAMILY:
        return "sac"
    if algo_name in RECURRENT_PPO_FAMILY:
        return "ppo_recurrent"
    raise ValueError(
        f"algorithm {algo_name!r} has no act-fn builder: only "
        f"{', '.join(PPO_FAMILY + SAC_FAMILY + RECURRENT_PPO_FAMILY)} can be "
        "evaluated/served through this path (world-model policies rebuild "
        "through their own evaluate entries)"
    )


def extract_policy_params(state: Dict[str, Any], cfg: Any, algo: str) -> Any:
    """The policy's parameters from a loaded checkpoint, whatever the run's layout."""
    if "params" in state:
        return state["params"]
    if "carry" not in state:
        raise KeyError(f"{algo}: the checkpoint has no 'params' (keys: {sorted(state)})")
    params = state["carry"]["params"]
    from sheeprl_tpu_torch.engine.population import PopulationSpec, slice_member

    if PopulationSpec.from_cfg(cfg, algo).enabled:
        params = slice_member(params, 0)
    return params


@dataclass
class LoadedPolicy:
    """A served policy: the act function, the parameters it takes, the module they
    belong to, and what a caller needs to feed it (the observation template) and read
    its output (the action metadata)."""

    algo: str
    family: str
    act_fn: Callable[..., Any]
    params: Dict[str, Any]  # exactly what act_fn's first argument expects
    module: nn.Module = field(repr=False)  # whose state_dict keys ``params`` has
    device: torch.device
    obs_template: Dict[str, Tuple[Tuple[int, ...], str]]  # key -> (shape, dtype name)
    is_continuous: bool
    action_dims: List[int]
    cfg: Any = field(repr=False, default=None)
    precision: str = "f32"  # serving tier: f32 | bf16 | int8
    greedy: bool = True
    stateful: bool = False  # act_fn threads per-session state (the recurrent family)
    zero_state_fn: Optional[Callable[[int], Any]] = field(repr=False, default=None)
    # the entries of ``params`` the act function reads (None: all): the PPO family's act
    # path leaves the critic out
    act_keys: Optional[frozenset] = field(repr=False, default=None)

    def zero_obs(self, batch: int) -> Dict[str, np.ndarray]:
        """A zero observation batch of the template's shapes and dtypes."""
        return {k: np.zeros((batch, *shape), dtype=np.dtype(dtype)) for k, (shape, dtype) in self.obs_template.items()}

    def obs_tensors(self, obs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy observation batch as tensors on the policy's device, in the
        template's dtypes."""
        return {k: torch.as_tensor(np.asarray(obs[k], dtype=np.dtype(dt))).to(self.device) for k, (_, dt) in self.obs_template.items()}

    @property
    def samples(self) -> bool:
        """Whether the act function draws: never greedy, never the SAC family, which
        serves ``tanh(mean)``."""
        return not self.greedy and self.family != "sac"

    def make_draws(self, batch: int, generator: Optional[torch.Generator]) -> Optional[List[torch.Tensor]]:
        """One sampling's draws for ``batch`` rows from ``generator`` (None where the act
        function does not sample)."""
        if not self.samples:
            return None
        from sheeprl_tpu_torch.algos.ppo.utils import make_draws

        shapes = [(batch, 2 * self.action_dims[0])] if self.is_continuous else [(batch, d) for d in self.action_dims]
        like = [torch.empty(s, device=self.device) for s in shapes]
        return make_draws(like, self.is_continuous, generator)


class _Bound(nn.Module):
    """``fn(*args)`` as the forward of a module whose children are ``module``'s own (the
    same objects, so the same ``state_dict`` keys): ``functional_call`` on it runs
    ``fn`` over a dict of parameters, as Flax's ``apply(params, ..., method=)`` does."""

    def __init__(self, module: nn.Module, fn: Callable[..., Any]):
        super().__init__()
        for name, child in module.named_children():
            self.add_module(name, child)
        self.fn = fn

    def forward(self, *args: Any) -> Any:
        return self.fn(*args)


def _discrete(env_act: torch.Tensor, is_continuous: bool) -> torch.Tensor:
    return env_act if is_continuous else env_act.to(torch.int32)


def _ppo_act_fn(agent, greedy: bool):
    from sheeprl_tpu_torch.algos.ppo.utils import sample_actions

    def actor(obs):
        pre_actor = agent.actor_backbone(agent.feature_extractor(obs))
        heads = [agent.actor_head] if agent.is_continuous else agent.actor_heads
        return [h(pre_actor).float() for h in heads]

    bound = _Bound(agent, actor)

    def act_fn(params, obs, draws=None):
        actor_out = functional_call(bound, params, (obs,))
        env_act, _, _ = sample_actions(actor_out, agent.is_continuous, greedy=greedy, draws=draws)
        return _discrete(env_act, agent.is_continuous)

    return act_fn


def _recurrent_ppo_act_fn(agent, greedy: bool):
    """Stateful act function: one recurrent step per request batch. The previous action
    is encoded as the training loop encodes it (one-hot per discrete head, raw when
    continuous); an episode's first step needs no zeroing on the host, because the
    agent's step masks the carry and the previous action by ``is_first``. The new state
    is float32, so the cache keeps one dtype across precision tiers."""
    from sheeprl_tpu_torch.algos.ppo.utils import sample_actions

    dims = [int(d) for d in agent.action_dims]
    bound = _Bound(agent, lambda obs, prev, is_first, rnn: agent.step(obs, prev, is_first, rnn, value=False))

    def act_fn(params, obs, is_first, state, draws=None):
        actor_out, _, new_rnn = functional_call(bound, params, (obs, state["prev"], is_first, state["rnn"]))
        env_act, _, _ = sample_actions(actor_out, agent.is_continuous, greedy=greedy, draws=draws)
        if agent.is_continuous:
            prev = env_act.float()
        else:
            prev = torch.cat([F.one_hot(env_act[..., i], d).float() for i, d in enumerate(dims)], -1)
        new_state = {"rnn": tuple(x.float() for x in new_rnn), "prev": prev}
        return _discrete(env_act, agent.is_continuous), new_state

    return act_fn


def _sac_act_fn(actor, mlp_keys: List[str], act_space, device: torch.device):
    low = np.asarray(act_space.low, np.float32)
    high = np.asarray(act_space.high, np.float32)
    rescale = bool(np.isfinite(low).all() and np.isfinite(high).all())
    low_t, span_t = torch.as_tensor(low, device=device), torch.as_tensor(high - low, device=device)

    def act_fn(params, obs, draws=None):
        x = torch.cat([obs[k].reshape(obs[k].shape[0], -1) if obs[k].dim() > 1 else obs[k][:, None] for k in mlp_keys], -1)
        mean, _ = functional_call(actor, params, (x,))
        act = torch.tanh(mean)
        if rescale:
            act = low_t + (act + 1.0) * 0.5 * span_t
        return act

    return act_fn


def _obs_template(obs_space, cnn_keys: List[str], mlp_keys: List[str]) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Per key, the (shape, dtype) the act function takes: images as the env gives them
    (uint8), vectors float32."""
    template: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for k in cnn_keys:
        template[k] = (tuple(obs_space[k].shape), str(np.dtype(obs_space[k].dtype)))
    for k in mlp_keys:
        template[k] = (tuple(obs_space[k].shape), "float32")
    return template


def build_policy(ctx, cfg, obs_space, act_space, greedy: bool = True) -> Tuple[LoadedPolicy, nn.Module]:
    """The agent and act function for ``cfg.algo.name`` over explicit spaces, on
    ``ctx.device``. Returns ``(policy, agent)``: the agent is the whole module a
    checkpoint's ``params`` load into (SAC's actor, critics and ``log_alpha``);
    ``policy.params`` holds the act function's part of its tensors (the SAC family's
    actor), sharing their storage, so loading the agent in place loads the policy."""
    algo = cfg.algo.name
    family = policy_family(algo)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder) if family in ("ppo", "ppo_recurrent") else []
    stateful, zero_state_fn = False, None
    if family == "ppo":
        from sheeprl_tpu_torch.algos.ppo.agent import build_agent

        agent = build_agent(ctx, act_space, obs_space, cfg)
        module, act_fn = agent, _ppo_act_fn(agent, greedy)
        is_continuous, action_dims = bool(agent.is_continuous), [int(d) for d in agent.action_dims]
    elif family == "ppo_recurrent":
        from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, make_zero_state

        agent = build_agent(ctx, act_space, obs_space, cfg)
        module, act_fn = agent, _recurrent_ppo_act_fn(agent, greedy)
        is_continuous, action_dims = bool(agent.is_continuous), [int(d) for d in agent.action_dims]
        stateful = True
        zero_rnn, act_sum, device = make_zero_state(cfg, ctx.device), int(sum(action_dims)), ctx.device

        def zero_state_fn(n: int) -> Dict[str, Any]:
            return {"rnn": zero_rnn(n), "prev": torch.zeros((n, act_sum), device=device)}

    else:
        from sheeprl_tpu_torch.algos.sac.agent import build_agent

        agent = build_agent(ctx, act_space, obs_space, cfg)
        module, act_fn = agent.actor, _sac_act_fn(agent.actor, mlp_keys, act_space, ctx.device)
        is_continuous, action_dims = True, [int(np.prod(act_space.shape))]
    params = dict(module.state_dict())
    act_keys = None if family == "sac" else frozenset(k for k in params if not k.startswith("critic."))
    policy = LoadedPolicy(
        algo=algo,
        family=family,
        act_fn=act_fn,
        params=params,
        module=module,
        device=ctx.device,
        obs_template=_obs_template(obs_space, cnn_keys, mlp_keys),
        is_continuous=is_continuous,
        action_dims=action_dims,
        cfg=cfg,
        greedy=greedy,
        stateful=stateful,
        zero_state_fn=zero_state_fn,
        act_keys=act_keys,
    )
    return policy, agent


def _tier(precision: Any) -> str:
    key = str(precision if precision is not None else "f32").lower()
    if key in ("", "none", "null", "f32", "fp32", "float32"):
        return "f32"
    if key in ("bf16", "bfloat16"):
        return "bf16"
    if key == "int8":
        return "int8"
    raise ValueError(f"Unknown serve precision {precision!r}; expected f32, bf16 or int8")


def wrap_policy_precision(policy: LoadedPolicy, precision: Any) -> LoadedPolicy:
    """Apply a serving precision tier to a built or loaded policy, in place:

    * ``f32`` (or None): the checkpoint serves as it stands;
    * ``bf16``: floating-point parameters cast to bfloat16 (the compute dtype must be
      bfloat16 already: :func:`load_policy` sets ``algo.precision`` before the build);
    * ``int8``: every parameter whose reference leaf is a 2-D Dense kernel becomes an
      :class:`~sheeprl_tpu_torch.precision.quantize.Int8Weight`, and the act function
      dequantizes the ones it reads (``act_keys``) on each call (weights only;
      activations stay float)."""
    tier = _tier(precision)
    if tier == "bf16":
        policy.params = {k: v.to(torch.bfloat16) if torch.is_floating_point(v) else v for k, v in policy.params.items()}
    elif tier == "int8":
        from sheeprl_tpu_torch.algos.dreamer_v3.params import dense_kernels, reference_ndim
        from sheeprl_tpu_torch.precision import dequantize_params, quantize_params

        kernels = {k for k, n in reference_ndim(policy.module).items() if n == 2 and k in policy.params}
        other = sorted(kernels - set(dense_kernels(policy.module)))
        if other:
            raise NotImplementedError(f"int8: the reference leaves of {other} are 2-D but not Dense kernels, whose layout the port quantizes")
        policy.params = quantize_params(policy.params, kernels)
        base_act_fn, keys = policy.act_fn, policy.act_keys

        def act_fn(params, *rest, **kwargs):  # the same trailing arguments, stateless or stateful
            used = params if keys is None else {k: params[k] for k in keys}
            return base_act_fn(dequantize_params(used), *rest, **kwargs)

        policy.act_fn = act_fn
    policy.precision = tier
    return policy


@torch.no_grad()
def parity_stamp(policy: LoadedPolicy, reference: LoadedPolicy, n_obs: int = 256, seed: int = 0) -> Dict[str, Any]:
    """Greedy-action agreement between a reduced-precision policy and its float32
    reference on seeded random observations: the parity report the server stamps into
    its ready file, its pong and its summary."""
    from sheeprl_tpu_torch.precision import action_agreement

    rng = np.random.default_rng(seed)
    obs: Dict[str, np.ndarray] = {}
    for k, (shape, dtype) in policy.obs_template.items():
        if np.issubdtype(np.dtype(dtype), np.integer):
            obs[k] = rng.integers(0, 256, size=(n_obs, *shape)).astype(np.dtype(dtype))
        else:
            obs[k] = rng.standard_normal((n_obs, *shape)).astype(np.dtype(dtype))
    # a sampling policy: the same draws on both sides, as the reference gives both one key
    draws = policy.make_draws(n_obs, torch.Generator(device=policy.device).manual_seed(seed))
    ref_draws = None if draws is None else [d.to(reference.device) for d in draws]
    if policy.stateful:
        # An episode's first step on both sides: zero state, is_first = 1.
        is_first = torch.ones((n_obs, 1), device=policy.device)
        got = policy.act_fn(policy.params, policy.obs_tensors(obs), is_first, policy.zero_state_fn(n_obs), draws)[0]
        want = reference.act_fn(reference.params, reference.obs_tensors(obs), is_first.to(reference.device), reference.zero_state_fn(n_obs), ref_draws)[0]
    else:
        got = policy.act_fn(policy.params, policy.obs_tensors(obs), draws)
        want = reference.act_fn(reference.params, reference.obs_tensors(obs), ref_draws)
    return {
        "precision": policy.precision,
        "reference": reference.precision,
        "n_obs": int(n_obs),
        "action_agreement": float(action_agreement(want, got, continuous=policy.is_continuous)),
    }


def load_policy(ctx, cfg, ckpt_path: str, greedy: bool = True, precision: Optional[str] = None) -> LoadedPolicy:
    """Spaces from the run's env, the agent rebuilt, the checkpoint loaded onto
    ``ctx.device`` (checksum-verified), the policy's parameters taken out of it.

    ``cfg`` is the run's saved config (changed in place: no video, one env).
    ``precision`` is the serving tier (``serve.precision``): None keeps the run's own
    ``algo.precision``; ``bf16`` builds the agent at bfloat16 compute and casts the
    loaded parameters; ``f32`` and ``int8`` build it at float32 (int8 then quantizes
    the loaded kernels, :func:`wrap_policy_precision`). As in the reference, the
    recurrent family computes at ``mesh.precision`` whatever the tier."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.utils.env import make_env

    cfg.env.capture_video = False
    cfg.env.num_envs = 1
    if precision is not None:
        cfg.algo.precision = "bf16" if _tier(precision) == "bf16" else "f32"
    env = make_env(cfg, cfg.seed, 0, None, "serve")()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    policy, agent = build_policy(ctx, cfg, obs_space, act_space, greedy=greedy)
    state = CheckpointManager.load(ckpt_path, map_location=ctx.device)
    agent.load_state_dict(extract_policy_params(state, cfg, policy.family))
    if precision is not None:
        policy = wrap_policy_precision(policy, precision)
    return policy
