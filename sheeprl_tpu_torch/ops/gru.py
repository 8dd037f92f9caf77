"""LayerNorm-GRU gate step: plain PyTorch version and the hand-written CUDA kernels.

The RSSM's recurrent step is ``h' = GRUGates(LayerNorm(concat(x, h) @ W), h)``. The
matmul stays with ``torch`` (cuBLAS); everything after it (LayerNorm over the fused
``3H`` projection, the three gate nonlinearities and the state blend) is one kernel
forward and one backward, ``csrc/layernorm_gru.cu``, the counterparts of the JAX
package's Pallas kernels (``sheeprl_tpu/ops/gru.py::_fused_fwd`` and ``_fused_bwd``).

* ``layernorm_gru_reference`` is the plain version: the same math in ``torch`` ops, with
  float32 statistics and the two-pass variance ``mean((p - mean)^2)``. Its backward is
  autograd through it (``layernorm_gru_backward_reference``). The CPU path and the tests
  use them, and ``chip_smoke.py`` holds the kernels against them on the card.
* ``layernorm_gru`` is the wrapper. On CPU tensors it returns the plain version; on CUDA
  tensors it launches the forward kernel or raises, and counts the launch in
  ``layernorm_gru.launches``. When autograd records, it goes through
  ``LayerNormGRUFunction``, which saves ``(proj, h, gamma, beta)`` and whose backward is
  ``layernorm_gru_backward``: the backward kernel, counted in
  ``layernorm_gru_backward.launches``.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from sheeprl_tpu_torch.ops._build import load_kernel_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD = None  # the bound C functions, set at their first launch
_BWD = None
# The backward's CTAs take tiles of consecutive rows, so that the dgamma/dbeta partials
# stay at most this many rows of [3H] however large the batch.
MAX_TILES = 128


def _fwd_kernel():
    """Build or load ``csrc/layernorm_gru.cu`` once and declare the C signature of
    ``layernorm_gru_fwd(proj, h, gamma, beta, out, batch, hidden, eps, dtype, stream)``."""
    global _FWD
    if _FWD is None:
        fn = load_kernel_library("layernorm_gru").layernorm_gru_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FWD = fn
    return _FWD


def _bwd_kernel():
    """The C signature of ``layernorm_gru_bwd(proj, h, gamma, beta, g, dproj, dh, dgamma,
    dbeta, partials, batch, hidden, rows_per_tile, eps, dtype, stream)``."""
    global _BWD
    if _BWD is None:
        fn = load_kernel_library("layernorm_gru").layernorm_gru_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def _ln(p: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    mean = p.mean(-1, keepdim=True)
    var = (p - mean).square().mean(-1, keepdim=True)
    return (p - mean) * torch.rsqrt(var + eps) * gamma + beta


def _gates(n: torch.Tensor, h: torch.Tensor, hidden: int) -> torch.Tensor:
    reset = torch.sigmoid(n[..., :hidden])
    cand = torch.tanh(reset * n[..., hidden : 2 * hidden])
    update = torch.sigmoid(n[..., 2 * hidden :] - 1.0)
    return update * cand + (1.0 - update) * h


def layernorm_gru_reference(
    proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """``h' = GRUGates(LN(proj) * gamma + beta, h)`` in plain ``torch`` ops.

    ``proj``: ``[..., 3H]``; ``h``: ``[..., H]``; ``gamma``/``beta``: ``[3H]``. The math
    runs in float32; the result has ``h``'s dtype."""
    n = _ln(proj.float(), gamma.float(), beta.float(), eps)
    return _gates(n, h.float(), h.shape[-1]).to(h.dtype)


def layernorm_gru_backward_reference(
    proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, g: torch.Tensor, eps: float = 1e-3
):
    """``(dproj, dh, dgamma, dbeta)`` for the upstream gradient ``g``: autograd through
    ``layernorm_gru_reference``, the plain version of the backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (proj, h, gamma, beta)]
        out = layernorm_gru_reference(*leaves, eps)
        return torch.autograd.grad(out, leaves, g)


def _on_device(t: torch.Tensor):
    return contextlib.nullcontext() if t.get_device() == torch.cuda.current_device() else torch.cuda.device(t.device)


def _check(proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> None:
    if proj.dim() != 2 or h.dim() != 2:
        raise ValueError(f"layernorm_gru kernel takes proj [B, 3H] and h [B, H]; got {tuple(proj.shape)}, {tuple(h.shape)}")
    batch, hidden = h.shape
    if tuple(proj.shape) != (batch, 3 * hidden):
        raise ValueError(f"proj must be [B, 3H] = [{batch}, {3 * hidden}]; got {tuple(proj.shape)}")
    if tuple(gamma.shape) != (3 * hidden,) or tuple(beta.shape) != (3 * hidden,):
        raise ValueError(f"gamma/beta must be [{3 * hidden}]; got {tuple(gamma.shape)}, {tuple(beta.shape)}")
    if proj.dtype not in _DTYPE_CODES or h.dtype != proj.dtype:
        raise TypeError(f"proj and h must share float32 or bfloat16; got {proj.dtype}, {h.dtype}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError(f"gamma/beta must be float32; got {gamma.dtype}, {beta.dtype}")
    tensors = (proj, h, gamma, beta)
    if any(t.device != proj.device for t in tensors):
        raise ValueError("proj, h, gamma and beta must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("layernorm_gru kernel takes contiguous tensors")


def _check_grad(h: torch.Tensor, g: torch.Tensor) -> None:
    if g.shape != h.shape or g.dtype != h.dtype or g.device != h.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {h.dtype} tensor of h's shape {tuple(h.shape)} on {h.device}")


def _launch_fwd(proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    _check(proj, h, gamma, beta)
    batch, hidden = h.shape
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    with _on_device(proj):
        err = _fwd_kernel()(
            proj.data_ptr(),
            h.data_ptr(),
            gamma.data_ptr(),
            beta.data_ptr(),
            out.data_ptr(),
            batch,
            hidden,
            float(eps),
            _DTYPE_CODES[proj.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"layernorm_gru_fwd launch failed with CUDA error {err}")
    layernorm_gru.launches += 1
    return out


class LayerNormGRUFunction(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel, then the backward kernel on
    the saved ``(proj, h, gamma, beta)``, which it recomputes the gates from."""

    @staticmethod
    def forward(ctx, proj, h, gamma, beta, eps):
        ctx.save_for_backward(proj, h, gamma, beta)
        ctx.eps = eps
        return _launch_fwd(proj, h, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        proj, h, gamma, beta = ctx.saved_tensors
        return (*layernorm_gru_backward(proj, h, gamma, beta, g.contiguous(), ctx.eps), None)


def layernorm_gru(
    proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """The fused gate step: the CUDA kernels for CUDA tensors (differentiable through
    ``LayerNormGRUFunction`` when autograd records), the plain version on the CPU."""
    if proj.device.type == "cpu":
        return layernorm_gru_reference(proj, h, gamma, beta, eps)
    if proj.device.type != "cuda":
        raise ValueError(f"layernorm_gru runs on cuda or cpu tensors, not {proj.device.type}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (proj, h, gamma, beta)):
        return LayerNormGRUFunction.apply(proj, h, gamma, beta, eps)
    return _launch_fwd(proj, h, gamma, beta, eps)


def layernorm_gru_backward(
    proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, g: torch.Tensor, eps: float = 1e-3
):
    """``(dproj, dh, dgamma, dbeta)`` of the gate step for the upstream gradient ``g``
    (``h``'s shape and type): the backward kernel for CUDA tensors, autograd through the
    plain version on the CPU. ``dproj``/``dh`` take the inputs' type, ``dgamma``/``dbeta``
    are float32, summed over the rows in a fixed order."""
    if proj.device.type == "cpu":
        return layernorm_gru_backward_reference(proj, h, gamma, beta, g, eps)
    if proj.device.type != "cuda":
        raise ValueError(f"layernorm_gru_backward runs on cuda or cpu tensors, not {proj.device.type}")
    _check(proj, h, gamma, beta)
    _check_grad(h, g)
    batch, hidden = h.shape
    rows_per_tile = -(-batch // MAX_TILES)
    n_tiles = -(-batch // rows_per_tile)
    dproj, dh = torch.empty_like(proj), torch.empty_like(h)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    partials = torch.empty(2 * n_tiles * 3 * hidden, dtype=torch.float32, device=proj.device)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    with _on_device(proj):
        err = _bwd_kernel()(
            proj.data_ptr(),
            h.data_ptr(),
            gamma.data_ptr(),
            beta.data_ptr(),
            g.data_ptr(),
            dproj.data_ptr(),
            dh.data_ptr(),
            dgamma.data_ptr(),
            dbeta.data_ptr(),
            partials.data_ptr(),
            batch,
            hidden,
            rows_per_tile,
            float(eps),
            _DTYPE_CODES[proj.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"layernorm_gru_bwd launch failed with CUDA error {err} (B={batch}, H={hidden})")
    layernorm_gru_backward.launches += 1
    return dproj, dh, dgamma, dbeta


layernorm_gru.launches = 0
layernorm_gru_backward.launches = 0
