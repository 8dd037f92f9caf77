"""Recurrent PPO agent (counterpart of ``sheeprl_tpu/algos/ppo_recurrent/agent.py``):
encoder -> (pre-RNN MLP) -> sequence model -> (post-RNN MLP) -> actor heads and critic.
The sequence model's input is the encoded observation beside the previous action,
zeroed at an episode's first step.

Two sequence models (``algo.sequence_model``):

* ``lstm``: Flax's ``OptimizedLSTMCell`` (``LSTMCell`` here): gates ``i, f, g, o``, the
  input kernels ``ii..io`` without bias, the hidden kernels ``hi..ho`` with one; the
  carry ``(c, h)`` is zeroed where ``is_first``. Over a sequence the input projection
  of every step is one product, then the steps run in order.
* ``attention``: causal windowed self-attention over the rollout, masked at episode
  starts (``ops/ring_attention.py::reference_attention``). Acting carries a rolling
  window of the last ``attn_window`` projected inputs and their validity, reset at
  episode starts; the loop resets it at every rollout's start, so acting and training
  see the same contexts.

As in the reference, the layers compute in ``mesh.precision``'s dtype (the run
context's), the heads' outputs are cast to float32, and children keep the reference's
names (``cell``, ``attn_*``, ``pre_mlp``, ``post_mlp``, ``actor_heads_<i>`` ->
``actor_heads.<i>``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import flax_default_init
from sheeprl_tpu_torch.algos.ppo.agent import make_encoder, make_heads, parse_action_space
from sheeprl_tpu_torch.models.blocks import MLP, LayerNorm, Linear, MultiEncoder, set_compute_dtype
from sheeprl_tpu_torch.ops.ring_attention import reference_attention

GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``. ``project(x)`` is the input kernels' product for any
    number of steps; ``forward((c, h), x_proj)`` one step from it."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        for g in GATES:
            setattr(self, f"i{g}_" if g == "f" else f"i{g}", Linear(input_size, hidden_size, bias=False))
            setattr(self, f"h{g}", Linear(hidden_size, hidden_size))

    def _input(self, g: str) -> Linear:
        return getattr(self, "if_" if g == "f" else f"i{g}")

    def project(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.ii.compute_dtype
        return F.linear(x.to(dt), torch.cat([self._input(g).weight for g in GATES]).to(dt))

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x_proj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c, h = carry
        dt = self.hi.compute_dtype
        hidden = [getattr(self, f"h{g}") for g in GATES]
        dense_h = F.linear(h.to(dt), torch.cat([m.weight for m in hidden]).to(dt)) + torch.cat([m.bias for m in hidden]).to(dt)
        i, f, g, o = (dense_h + x_proj).chunk(4, -1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return new_c, torch.sigmoid(o) * torch.tanh(new_c)


class RecurrentPPOAgent(nn.Module):
    def __init__(
        self,
        encoder: MultiEncoder,
        action_dims: Sequence[int],
        is_continuous: bool,
        dense_units: int = 64,
        mlp_layers: int = 1,
        dense_act: str = "tanh",
        layer_norm: bool = False,
        lstm_hidden_size: int = 64,
        pre_rnn_mlp: bool = False,
        post_rnn_mlp: bool = False,
        sequence_model: str = "lstm",
        attn_heads: int = 4,
        attn_window: int = 64,
    ):
        super().__init__()
        if sequence_model not in ("lstm", "attention"):
            raise ValueError(f"algo.sequence_model must be lstm or attention, got {sequence_model!r}")
        self.action_dims, self.is_continuous = tuple(action_dims), is_continuous
        self.sequence_model, self.attn_heads, self.attn_window = sequence_model, attn_heads, attn_window
        self.feature_extractor = encoder
        x_dim = encoder.output_dim + int(sum(action_dims))
        if pre_rnn_mlp:
            self.pre_mlp = MLP(x_dim, (dense_units,), activation=dense_act, layer_norm=layer_norm)
            x_dim = dense_units
        self.pre_rnn_mlp, self.post_rnn_mlp = pre_rnn_mlp, post_rnn_mlp
        h = lstm_hidden_size
        if sequence_model == "attention":
            self.attn_in = Linear(x_dim, h)
            self.attn_q, self.attn_k, self.attn_v, self.attn_out = (Linear(h, h) for _ in range(4))
            self.attn_ln = LayerNorm(h, eps=1e-6)  # flax.linen.LayerNorm's default epsilon
        else:
            self.cell = LSTMCell(x_dim, h)
        feat = h
        if post_rnn_mlp:
            self.post_mlp = MLP(h, (dense_units,), activation=dense_act, layer_norm=layer_norm)
            feat = dense_units
        self.actor_backbone = MLP(feat, (dense_units,) * mlp_layers, activation=dense_act, layer_norm=layer_norm)
        self.actor_heads = make_heads(self.actor_backbone.output_dim, action_dims, is_continuous)
        self.critic = MLP(feat, (dense_units,) * mlp_layers, 1, activation=dense_act, layer_norm=layer_norm)

    def _heads(self, hidden: torch.Tensor, value: bool = True) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        feat = self.post_mlp(hidden) if self.post_rnn_mlp else hidden
        pre_actor = self.actor_backbone(feat)
        return [h(pre_actor).float() for h in self.actor_heads], self.critic(feat).float() if value else None

    def _rnn_input(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor) -> torch.Tensor:
        feat = self.feature_extractor(obs)
        x = torch.cat([feat, prev_actions.to(feat.dtype)], -1)
        return self.pre_mlp(x) if self.pre_rnn_mlp else x

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], self.attn_heads, x.shape[-1] // self.attn_heads)

    def step(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, is_first: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor], value: bool = True):
        """One env step (``[B, ...]`` inputs, ``is_first`` ``[B, 1]``): ``(actor_out,
        value, new_state)``; ``value=False`` skips the critic (the value is None), as
        serving does."""
        x = self._rnn_input(obs, (1 - is_first) * prev_actions)
        if self.sequence_model == "attention":
            window, valid = state  # [B, W, H], [B, W]
            xp = self.attn_in(x)
            window = (1 - is_first[..., None]) * window
            valid = (1 - is_first) * valid
            window = torch.cat([window[:, 1:], xp[:, None].to(window.dtype)], 1)
            valid = torch.cat([valid[:, 1:], torch.ones_like(valid[:, :1])], 1)
            q = self._split_heads(self.attn_q(xp))[:, None]
            k = self._split_heads(self.attn_k(window.to(xp.dtype)))
            v = self._split_heads(self.attn_v(window.to(xp.dtype)))
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(k.shape[-1])
            s = torch.where(valid[:, None, None, :] > 0, s, torch.finfo(torch.float32).min)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())
            out = self.attn_ln(xp + self.attn_out(o.reshape(xp.shape[0], -1).to(xp.dtype)))
            actor_out, v = self._heads(out.float(), value)
            return actor_out, v, (window, valid)
        c, h = ((1 - is_first) * s for s in state)
        c, h = self.cell((c, h), self.cell.project(x))
        actor_out, v = self._heads(h.float(), value)
        return actor_out, v, (c, h)

    def forward(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, is_first: torch.Tensor, initial_state: Tuple[torch.Tensor, torch.Tensor]):
        """A sequence (``[T, B, ...]`` inputs) from ``initial_state``, the carry reset
        where ``is_first``: ``(actor_out, values)`` over ``[T, B]``. The attention model
        ignores ``initial_state``: its context starts at the rollout's start."""
        xs = self._rnn_input(obs, prev_actions * (1 - is_first))
        if self.sequence_model == "attention":
            T, B = xs.shape[:2]
            xp = self.attn_in(xs)
            xbt = xp.transpose(0, 1)
            q, k, v = (self._split_heads(m(xbt)) for m in (self.attn_q, self.attn_k, self.attn_v))
            segs = torch.cumsum(is_first[..., 0], 0).transpose(0, 1).to(torch.int32)
            o = reference_attention(q, k, v, causal=True, segment_ids=segs, window=self.attn_window)
            o = o.reshape(B, T, -1).transpose(0, 1).to(xp.dtype)
            return self._heads(self.attn_ln(xp + self.attn_out(o)).float())
        proj = self.cell.project(xs)
        c, h = initial_state
        outs = []
        for t in range(xs.shape[0]):
            c, h = (1 - is_first[t]) * c, (1 - is_first[t]) * h
            c, h = self.cell((c, h), proj[t])
            outs.append(h)
        return self._heads(torch.stack(outs).float())


def make_zero_state(cfg, device: torch.device):
    """``n -> `` a zero carry for ``n`` envs: the LSTM's ``(c, h)``, or the attention
    model's ``(window [n, W, H], valid [n, W])``."""
    h = cfg.algo.rnn.lstm.hidden_size
    if cfg.algo.get("sequence_model", "lstm") == "attention":
        w = int(cfg.algo.attention.window)
        return lambda n: (torch.zeros((n, w, h), device=device), torch.zeros((n, w), device=device))
    return lambda n: (torch.zeros((n, h), device=device), torch.zeros((n, h), device=device))


def build_agent(ctx, action_space, obs_space, cfg) -> RecurrentPPOAgent:
    """The agent on ``ctx.device``, computing in ``ctx.compute_dtype`` (the reference's
    recurrent agent reads ``mesh.precision``, not ``algo.precision``), initialised as
    Flax's defaults (the LSTM's hidden kernels orthogonal) from ``ctx.rng()``."""
    is_continuous, dims = parse_action_space(action_space)
    attn = cfg.algo.get("attention", {})
    agent = RecurrentPPOAgent(
        make_encoder(cfg, obs_space),
        dims,
        is_continuous,
        dense_units=cfg.algo.dense_units,
        mlp_layers=cfg.algo.mlp_layers,
        dense_act=cfg.algo.dense_act,
        layer_norm=cfg.algo.layer_norm,
        lstm_hidden_size=cfg.algo.rnn.lstm.hidden_size,
        pre_rnn_mlp=cfg.algo.rnn.pre_rnn_mlp.apply,
        post_rnn_mlp=cfg.algo.rnn.post_rnn_mlp.apply,
        sequence_model=cfg.algo.get("sequence_model", "lstm"),
        attn_heads=int(attn.get("num_heads", 4)),
        attn_window=int(attn.get("window", 64)),
    )
    gen = ctx.rng(device="cpu")
    flax_default_init(agent, gen)
    if agent.sequence_model == "lstm":
        with torch.no_grad():
            for g in GATES:
                nn.init.orthogonal_(getattr(agent.cell, f"h{g}").weight, generator=gen)
    return set_compute_dtype(agent, ctx.compute_dtype).to(ctx.device)
