"""Optimizers (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py::make_optimizer``; the PPO
algorithm itself is not ported).

``make_optimizer`` builds the same update as the reference's optax chain, not as
``torch.optim`` would: gradients clipped by their global norm as
``optax.clip_by_global_norm`` does (``g * max_norm / norm`` when ``norm >= max_norm``,
with no epsilon), Adam's ``weight_decay`` as L2 added to the gradient before the Adam
scaling, AdamW's decay added after it, Adam's bias correction applied to both moments,
and ``rmsprop_tf`` with ``eps`` inside the square root. The state (step count and the
per-parameter moments) is a plain dict, saved with the checkpoint.

The step count is a 0-d int64 tensor on the parameters' device, and Adam's bias
corrections ``1 - b**count`` are computed on the device from it, so an update captured
in a CUDA graph corrects each replay by its own count. ``load_state`` copies a saved
state into a live one in place (an older checkpoint's count is a Python int).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop_tf")


class Optimizer:
    """One optax-style gradient transformation over a fixed list of parameters:
    ``state = opt.init(params)``, then ``opt.update(params, grads, state)`` updates the
    parameters and the state in place and returns the gradients' global norm before
    clipping."""

    def __init__(self, name: str, lr: float, max_grad_norm: float = 0.0, **hp: Any):
        if name not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer: {name}")
        self.name = name
        self.lr = float(lr)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.hp = hp

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        device = params[0].device if len(params) else None
        state: Dict[str, Any] = {"count": torch.zeros((), dtype=torch.int64, device=device)}
        if self.name in ("adam", "adamw", "rmsprop_tf"):
            state["nu"] = zeros()
        if self.name in ("adam", "adamw") or (self.name == "rmsprop_tf" and self.hp["centered"]):
            state["mu"] = zeros()
        if self.name in ("sgd", "rmsprop_tf"):
            state["trace"] = zeros()
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict[str, Any]) -> torch.Tensor:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        g = [t.clone() for t in grads]
        if self.max_grad_norm > 0:
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
            torch._foreach_mul_(g, scale)
        state["count"].add_(1)
        count, lr, hp = state["count"], self.lr, self.hp
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
            torch._foreach_add_(params, upd, alpha=-lr)
        elif self.name == "sgd":
            trace = state["trace"]
            torch._foreach_mul_(trace, hp["momentum"])
            torch._foreach_add_(trace, g)
            torch._foreach_add_(params, trace, alpha=-lr)
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
            torch._foreach_mul_(upd, -lr)
            trace = state["trace"]
            torch._foreach_mul_(trace, hp["momentum"])
            torch._foreach_add_(trace, upd)
            torch._foreach_add_(params, trace)
        return norm

    @staticmethod
    @torch.no_grad()
    def load_state(state: Dict[str, Any], saved: Dict[str, Any]) -> None:
        """Copy ``saved`` (a checkpointed state, on any device) into ``state`` in place,
        so that tensors a captured graph reads keep their addresses. A saved ``count``
        may be a Python int (checkpoints written before the count lived on the device)."""
        if set(saved) != set(state):
            raise ValueError(f"optimizer state keys {sorted(saved)} do not match {sorted(state)}")
        state["count"].fill_(int(saved["count"]))
        for key in state:
            if key != "count":
                if len(saved[key]) != len(state[key]):
                    raise ValueError(f"optimizer state '{key}' holds {len(saved[key])} tensors, expected {len(state[key])}")
                for dst, src in zip(state[key], saved[key]):
                    dst.copy_(src)  # across devices: a checkpoint loads on the host


def make_optimizer(opt_cfg: Dict[str, Any], max_grad_norm: float) -> Optimizer:
    """The optimizer an ``optimizer`` config section asks for (``name``: adam | adamw |
    sgd | rmsprop_tf), with global-norm clipping when ``max_grad_norm > 0``."""
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
    return Optimizer(name, lr, max_grad_norm, **hp)
