"""LayerNorm-GRU gate step: plain PyTorch version and the hand-written CUDA kernel.

The RSSM's recurrent step is ``h' = GRUGates(LayerNorm(concat(x, h) @ W), h)``. The
matmul stays with ``torch`` (cuBLAS); everything after it (LayerNorm over the fused
``3H`` projection, the three gate nonlinearities and the state blend) is one kernel,
``csrc/layernorm_gru.cu``, the counterpart of the JAX package's Pallas kernel
(``sheeprl_tpu/ops/gru.py::_fused_fwd``).

* ``layernorm_gru_reference`` is the plain version: the same math in ``torch`` ops, with
  float32 statistics and the two-pass variance ``mean((p - mean)^2)``. The CPU path and
  the tests use it, and ``chip_smoke.py`` holds the kernel against it on the card.
* ``layernorm_gru`` is the wrapper. On CPU tensors it returns the plain version; on CUDA
  tensors it launches the kernel or raises, and counts the launch in
  ``layernorm_gru.launches``. Forward only: the backward kernel comes with training.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from sheeprl_tpu_torch.ops._build import load_kernel_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD = None  # the bound C function, set at the first launch


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "layernorm_gru has no backward kernel yet: call it under torch.no_grad() or torch.inference_mode()"
        )


def layernorm_gru(
    proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """The fused gate step: the CUDA kernel for CUDA tensors, the plain version on the CPU."""
    if proj.device.type == "cpu":
        return layernorm_gru_reference(proj, h, gamma, beta, eps)
    if proj.device.type != "cuda":
        raise ValueError(f"layernorm_gru runs on cuda or cpu tensors, not {proj.device.type}")
    _check(proj, h, gamma, beta)
    batch, hidden = h.shape
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    on_device = contextlib.nullcontext() if proj.get_device() == torch.cuda.current_device() else torch.cuda.device(proj.device)
    with on_device:
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


layernorm_gru.launches = 0
