"""Fused RSSM step: plain PyTorch version and the hand-written CUDA kernels.

``h' = GRUGates(LayerNorm(xh @ w) * gamma + beta, h)`` with the ``[B, K] @ [K, 3H]``
product inside the kernel, forward and backward (``csrc/rssm_step.cu``): the
counterparts of the JAX package's Pallas kernels ``sheeprl_tpu/ops/rssm_step.py::
_fused_step_fwd`` and ``_fused_step_bwd``. No model calls the step; the RSSM scan
benchmark (``sheeprl_tpu_torch/benchmarks/fused_step_bench.py``) does.

* ``gru_step_reference`` is the plain version: the product of ``xh`` and ``w`` taken in
  float32 (exact products of bf16 operands, float32 sums, as JAX's
  ``preferred_element_type=float32``), then the port's own LayerNorm and gates
  (``ops/gru.py``). Its backward is autograd through it (``gru_step_backward_reference``).
* ``gru_step`` is the wrapper. On CPU tensors it returns the plain version; on CUDA
  tensors it launches the forward kernel or raises, and counts the launch in
  ``gru_step.launches``. When autograd records, it goes through ``GRUStepFunction``,
  which saves ``(xh, h, w, gamma, beta)`` and whose backward is ``gru_step_backward``:
  the backward kernel, counted in ``gru_step_backward.launches``.

The step has no module and no parameters of its own: its operands are tensors in the
JAX layout (``w`` is ``[K, 3H]``), so the tests hand both packages the same numpy arrays
and ``algos/dreamer_v3/params.py::params_from_jax`` has nothing to carry.

Types: ``xh`` and ``w`` share float32 or bfloat16; ``h`` is float32 or bfloat16 and the
result takes its type; ``gamma`` and ``beta`` share float32 or bfloat16. The gradients
take their operands' types (``dgamma``/``dbeta`` are summed in float32 first), and the
kernel rounds ``dp`` to ``xh``'s type before both products, as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from sheeprl_tpu_torch.ops._build import load_kernel_library
from sheeprl_tpu_torch.ops.gru import _check_grad, _gates, _ln, _on_device

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = None  # the bound C functions, set at their first launch

# The kernel's geometry (csrc/rssm_step.cu): a block owns 32 hidden units, a cluster
# holds at most 16 blocks, rows go in tiles of 16, and K streams through shared memory
# in TMA boxes (K % 8 == 0, 16-byte rows), three stages of 128 rows of w for bf16 and of
# 32 for float32; a block has 232,448 bytes of shared memory on sm_90.
UNITS_PER_BLOCK = 32
MAX_CLUSTER = 16
ROWS_PER_TILE = 16
K_TILE = {2: 128, 4: 32}  # by itemsize
STAGES = 3
SMEM_LIMIT = 232448


def smem_bytes(batch: int, in_features: int, itemsize: int, backward: bool) -> int:
    """Shared memory of one block of the kernel (``smem_layout`` in the source): the
    stages of the w tile [BK, 96] and of the xh tile [16, BK] in the operands' type, the
    projection [16, 96] and the row statistics in float32; the backward adds the gate
    gradients [16, 96], dgamma/dbeta and gamma/beta [4, 96], dp for every row [B rounded
    up to 16, 96 + 16 bytes] in the operands' type and its share of dxh [16, K] in
    float32; last, one 8-byte mbarrier per stage and 1,024 bytes to align the base.

    At (B, K) = (16, 1024): the forward 50,712 bytes in float32 and 93,720 in bfloat16,
    the backward 130,328 and 170,264; at B = 256 the backward 226,328 and 220,184."""
    cols, bk = 3 * UNITS_PER_BLOCK, K_TILE[itemsize]
    total = STAGES * (bk * cols + ROWS_PER_TILE * bk) * itemsize + ROWS_PER_TILE * cols * 4 + 2 * 4 * ROWS_PER_TILE * 4
    if backward:
        padded = -(-batch // ROWS_PER_TILE) * ROWS_PER_TILE
        total += ROWS_PER_TILE * cols * 4 + 4 * cols * 4 + padded * (cols + 16 // itemsize) * itemsize + ROWS_PER_TILE * in_features * 4
    return total + 8 * STAGES + 1024


def unsupported_reason(batch: int, in_features: int, hidden: int, itemsize: int = 4):
    """Why the kernels cannot take this shape, or None when they can."""
    if batch <= 0 or in_features <= 0 or hidden <= 0:
        return f"empty shape (B={batch}, K={in_features}, H={hidden})"
    if in_features % 8:
        return f"K={in_features} is not a multiple of 8 (xh and w stream in 16-byte pieces)"
    if hidden % UNITS_PER_BLOCK or hidden // UNITS_PER_BLOCK > MAX_CLUSTER:
        return f"H={hidden} is not a multiple of {UNITS_PER_BLOCK} up to {UNITS_PER_BLOCK * MAX_CLUSTER} (one cluster of at most {MAX_CLUSTER} blocks of {UNITS_PER_BLOCK} units)"
    need = smem_bytes(batch, in_features, itemsize, backward=True)
    if need > SMEM_LIMIT:
        return f"the backward needs {need} bytes of shared memory per block, over {SMEM_LIMIT} (B={batch}, K={in_features})"
    return None


def fused_step_supported(batch: int, in_features: int, hidden: int, itemsize: int = 4) -> bool:
    """The port's budget, in place of the JAX package's 12 MB VMEM envelope: H a multiple
    of 32 up to 512 (the cluster of H / 32 blocks that shares a row's LayerNorm holds at
    most 16), K a multiple of 8, and the backward's shared memory within one block's
    232,448 bytes. Size S, (16, 1024, 512), takes 130,328 bytes in float32 and 170,264 in
    bfloat16 (the backward); B = 256 at K = 1024 takes 226,328 in float32."""
    return unsupported_reason(batch, in_features, hidden, itemsize) is None


def bind(lib: ctypes.CDLL):
    """The C functions of a build of ``csrc/rssm_step.cu``, with their signatures:
    ``rssm_step_fwd(xh, h, w, gamma, beta, out, batch, K, hidden, eps, ti, th, tg,
    stream)`` and ``rssm_step_bwd(xh, h, w, gamma, beta, g, dxh, dh, dw, dgamma, dbeta,
    batch, K, hidden, eps, ti, th, tg, stream)``."""
    fwd, bwd = lib.rssm_step_fwd, lib.rssm_step_bwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _kernels():
    """Build or load ``csrc/rssm_step.cu`` once: its bound forward and backward."""
    global _KERNELS
    if _KERNELS is None:
        _KERNELS = bind(load_kernel_library("rssm_step"))
    return _KERNELS


def gru_step_reference(
    xh: torch.Tensor, h: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """``h' = GRUGates(LN(xh @ w) * gamma + beta, h)`` in plain ``torch`` ops.

    ``xh``: ``[B, K]``; ``h``: ``[B, H]``; ``w``: ``[K, 3H]``; ``gamma``/``beta``: ``[3H]``.
    The product and everything after it run in float32; the result has ``h``'s type."""
    proj = xh.float() @ w.float()
    n = _ln(proj, gamma.float(), beta.float(), eps)
    return _gates(n, h.float(), h.shape[-1]).to(h.dtype)


def gru_step_backward_reference(xh, h, w, gamma, beta, g, eps: float = 1e-3):
    """``(dxh, dh, dw, dgamma, dbeta)`` for the upstream gradient ``g``: autograd through
    ``gru_step_reference``, the plain version of the backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xh, h, w, gamma, beta)]
        out = gru_step_reference(*leaves, eps)
        return torch.autograd.grad(out, leaves, g)


def _check(xh, h, w, gamma, beta) -> None:
    if xh.dim() != 2 or h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"rssm_step takes xh [B, K], h [B, H] and w [K, 3H]; got {tuple(xh.shape)}, {tuple(h.shape)}, {tuple(w.shape)}")
    batch, k = xh.shape
    hidden = h.shape[1]
    if h.shape[0] != batch or tuple(w.shape) != (k, 3 * hidden):
        raise ValueError(f"h must be [{batch}, H] and w [{k}, 3H]; got {tuple(h.shape)}, {tuple(w.shape)}")
    if tuple(gamma.shape) != (3 * hidden,) or tuple(beta.shape) != (3 * hidden,):
        raise ValueError(f"gamma/beta must be [{3 * hidden}]; got {tuple(gamma.shape)}, {tuple(beta.shape)}")
    if xh.dtype not in _DTYPE_CODES or w.dtype != xh.dtype:
        raise TypeError(f"xh and w must share float32 or bfloat16; got {xh.dtype}, {w.dtype}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"h must be float32 or bfloat16; got {h.dtype}")
    if gamma.dtype not in _DTYPE_CODES or beta.dtype != gamma.dtype:
        raise TypeError(f"gamma and beta must share float32 or bfloat16; got {gamma.dtype}, {beta.dtype}")
    tensors = (xh, h, w, gamma, beta)
    if any(t.device != xh.device for t in tensors):
        raise ValueError("xh, h, w, gamma and beta must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rssm_step kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (xh, w)):
        raise ValueError("rssm_step kernel takes xh and w at 16-byte aligned addresses")
    reason = unsupported_reason(batch, k, hidden, xh.element_size())
    if reason is not None:
        raise ValueError(f"rssm_step kernel does not take this shape: {reason}")


def _codes(xh, h, gamma):
    return _DTYPE_CODES[xh.dtype], _DTYPE_CODES[h.dtype], _DTYPE_CODES[gamma.dtype]


def _launch_fwd(xh, h, w, gamma, beta, eps: float) -> torch.Tensor:
    _check(xh, h, w, gamma, beta)
    batch, k = xh.shape
    hidden = h.shape[1]
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    with _on_device(xh):
        err = _kernels()[0](
            xh.data_ptr(), h.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            batch, k, hidden, float(eps), *_codes(xh, h, gamma), stream,
        )
    if err != 0:
        raise RuntimeError(f"rssm_step_fwd launch failed with CUDA error {err} (B={batch}, K={k}, H={hidden})")
    gru_step.launches += 1
    return out


class GRUStepFunction(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel, then the backward kernel on the
    saved ``(xh, h, w, gamma, beta)``, from which it recomputes the projection."""

    @staticmethod
    def forward(ctx, xh, h, w, gamma, beta, eps):
        ctx.save_for_backward(xh, h, w, gamma, beta)
        ctx.eps = eps
        return _launch_fwd(xh, h, w, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        return (*gru_step_backward(*ctx.saved_tensors, g.contiguous(), ctx.eps), None)


def gru_step(
    xh: torch.Tensor, h: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """The fused step: the CUDA kernels for CUDA tensors (differentiable through
    ``GRUStepFunction`` when autograd records), the plain version on the CPU."""
    if xh.device.type == "cpu":
        return gru_step_reference(xh, h, w, gamma, beta, eps)
    if xh.device.type != "cuda":
        raise ValueError(f"gru_step runs on cuda or cpu tensors, not {xh.device.type}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xh, h, w, gamma, beta)):
        return GRUStepFunction.apply(xh, h, w, gamma, beta, eps)
    return _launch_fwd(xh, h, w, gamma, beta, eps)


def gru_step_backward(xh, h, w, gamma, beta, g, eps: float = 1e-3):
    """``(dxh, dh, dw, dgamma, dbeta)`` of the step for the upstream gradient ``g`` (``h``'s
    shape and type): the backward kernel for CUDA tensors, autograd through the plain
    version on the CPU. Each gradient takes its operand's type."""
    if xh.device.type == "cpu":
        return gru_step_backward_reference(xh, h, w, gamma, beta, g, eps)
    if xh.device.type != "cuda":
        raise ValueError(f"gru_step_backward runs on cuda or cpu tensors, not {xh.device.type}")
    _check(xh, h, w, gamma, beta)
    _check_grad(h, g)
    batch, k = xh.shape
    hidden = h.shape[1]
    dxh, dh, dw = torch.empty_like(xh), torch.empty_like(h), torch.empty_like(w)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    with _on_device(xh):
        err = _kernels()[1](
            xh.data_ptr(), h.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
            dxh.data_ptr(), dh.data_ptr(), dw.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            batch, k, hidden, float(eps), *_codes(xh, h, gamma), stream,
        )
    if err != 0:
        raise RuntimeError(f"rssm_step_bwd launch failed with CUDA error {err} (B={batch}, K={k}, H={hidden})")
    gru_step_backward.launches += 1
    return dxh, dh, dw, dgamma, dbeta


gru_step.launches = 0
gru_step_backward.launches = 0
