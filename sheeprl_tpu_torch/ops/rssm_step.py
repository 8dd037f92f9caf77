"""Fused RSSM step: plain PyTorch version and the hand-written CUDA kernels.

``h' = GRUGates(LayerNorm(xh @ w) * gamma + beta, h)`` with the ``[B, K] @ [K, 3H]``
product inside the kernels, forward and backward (``csrc/rssm_step.cu``): the
counterparts of the JAX package's Pallas kernels ``sheeprl_tpu/ops/rssm_step.py::
_fused_step_fwd`` and ``_fused_step_bwd``. No model calls the step; the RSSM scan
benchmark (``sheeprl_tpu_torch/benchmarks/fused_step_bench.py``) does.

* ``gru_step_reference`` is the plain version: the product of ``xh`` and ``w`` taken in
  float32 (exact products of bf16 operands, float32 sums, as JAX's
  ``preferred_element_type=float32``), then the port's own LayerNorm and gates
  (``ops/gru.py``). Its backward is autograd through it (``gru_step_backward_reference``).
* ``gru_step`` is the wrapper. On CPU tensors it returns the plain version; on CUDA
  tensors it launches the forward kernel or raises, and counts the call in
  ``gru_step.launches``. When autograd records, it goes through ``GRUStepFunction``,
  whose backward is ``gru_step_backward``, counted in ``gru_step_backward.launches``.

The forward is two launches (``launches_per_call`` 2): a product pass, split over
K-slices and blocks of 128 projection columns so that most of the card's SMs stream w,
which writes the float32 projection ``proj`` [B, 3H] to device memory; then a row pass,
one block per row, for the LayerNorm and the gates. ``GRUStepFunction`` keeps ``proj``
as a residual, so that the backward reads it instead of recomputing the product (the
JAX kernel recomputes it). That costs ``B * 3H * 4`` bytes per step held for the
backward: 98,304 at B = 16, H = 512, 6.3 MB over a 64-step scan. The backward is two
launches too: a row pass (statistics, gates and their gradients, dp) and a product pass
(dxh and dw, K rows per block). Each call counts once in its wrapper's ``launches``.

The step has no module and no parameters of its own: its operands are tensors in the
JAX layout (``w`` is ``[K, 3H]``), so the tests hand both packages the same numpy arrays
and ``algos/dreamer_v3/params.py::params_from_jax`` has nothing to carry.

Types: ``xh`` and ``w`` share float32 or bfloat16; ``h`` is float32 or bfloat16 and the
result takes its type; ``gamma`` and ``beta`` share float32 or bfloat16. The gradients
take their operands' types (``dgamma``/``dbeta`` are summed in float32 first), and the
kernel rounds ``dp`` to ``xh``'s type before both products, as the reference does.
Every sum runs in a fixed order without float atomics: two calls give the same bits.
The kernels keep no state between calls, and every workspace is the call's own, so any
stream and any CUDA graph replay may run them.
"""

from __future__ import annotations

import ctypes

import torch

from sheeprl_tpu_torch.ops._build import load_kernel_library
from sheeprl_tpu_torch.ops.gru import _check_grad, _gates, _ln, _on_device

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = None  # the bound C functions, set at their first launch

# The kernels' geometry (csrc/rssm_step.cu), restated. Forward product pass: a block owns
# 128 projection columns, a K-slice of w (a multiple of two tiles) and a group of up to 4
# row tiles of 16; the K-slices of one (column block, row group) are a cluster of at most
# 8 blocks; w and xh stream in tiles of 64 K rows (bf16) or 32 (f32), two in flight. Both
# row passes have one block per row. Backward product pass: blocks own 8 rows of K each
# and stream dp in tiles of 16 rows (bf16) or 8 (f32), three stages. A LayerNorm row's
# units spread over one block's 256 threads, two each at most: H <= 512. B is capped at
# the JAX budget's 256. A block has 232,448 bytes of shared memory on sm_90.
FWD_COLS = 128
ROWS_PER_TILE = 16
WARPS = 8
MAX_HIDDEN = 512
MAX_SLICES = 8
MAX_ROW_TILES = 4
MAX_BATCH = 256
FWD_STAGES = 2
FWD_TILE_K = {2: 64, 4: 32}  # by itemsize
BWD_K = 8
BWD_TILE_ROWS = {2: 16, 4: 8}  # by itemsize
BWD_STAGES = 3
SMEM_LIMIT = 232448
# rssm_step_geometry's fields, in its order
GEOMETRY_FIELDS = (
    "col_blocks", "slice_k", "slices", "row_tiles", "groups", "fwd_smem",
    "dp_rows", "dp_ld", "prod_blocks", "prod_smem",
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fwd_smem(itemsize: int, row_tiles: int) -> int:
    """``fwd_smem`` of the source: the stages of the w tile [BK][128] and of the xh tile
    [16 row_tiles][BK] in the operands' type, the slices' partial products of the block's
    rows in float32 (at most 16 row_tiles + 7 rows of 128), one 8-byte mbarrier per stage
    and 1,024 bytes to align the base."""
    bk, rows = FWD_TILE_K[itemsize], ROWS_PER_TILE * row_tiles
    return (
        FWD_STAGES * bk * FWD_COLS * itemsize + FWD_STAGES * rows * bk * itemsize + (rows + MAX_SLICES - 1) * FWD_COLS * 4
        + FWD_STAGES * 8 + 1024
    )


def _prod_smem(hidden: int, itemsize: int) -> int:
    """``prod_smem`` of the source: w's 8 rows and the stages of the dp tile, each row 3H
    plus 16 bytes in the operands' type; the stages of the xh box [rows][8] from a 128-byte
    boundary; the dxh partials of the warps (two buffers, float32); the mbarriers (the
    stages' and w's) and 1,024 bytes to align the base."""
    row, tr = (3 * hidden + 16 // itemsize) * itemsize, BWD_TILE_ROWS[itemsize]
    x_s = _cdiv(BWD_K * row + BWD_STAGES * tr * row, 128) * 128
    return x_s + BWD_STAGES * tr * BWD_K * itemsize + 2 * WARPS * tr * BWD_K * 4 + (BWD_STAGES + 1) * 8 + 1024


def geometry(batch: int, in_features: int, hidden: int, itemsize: int) -> dict:
    """The launch geometry of a shape (``geometry`` in the source; ``rssm_step_geometry``
    exports it): the forward product pass's grid (``col_blocks`` x ``slices`` x
    ``groups``), its clusters of ``slices`` blocks over ``slice_k`` rows of K each,
    ``row_tiles`` 16-row tiles per block and its shared memory (the forward's row pass has
    B blocks); the backward's workspace rows (``dp_rows``, ``dp_ld`` elements each), its
    product pass's blocks and shared memory (its row pass has ``dp_rows`` blocks).

    At size S (16, 1024, 512): 12 x 8 x 1 = 96 forward product blocks of 49,680 bytes in
    either type, 128 backward product blocks of 182,944 bytes (bf16) or 203,040
    (float32)."""
    bk, tr = FWD_TILE_K[itemsize], BWD_TILE_ROWS[itemsize]
    slice_k = _cdiv(_cdiv(in_features, MAX_SLICES), 2 * bk) * 2 * bk
    slices = _cdiv(in_features, slice_k)
    row_tiles = min(MAX_ROW_TILES, _cdiv(batch, ROWS_PER_TILE))
    groups = _cdiv(batch, ROWS_PER_TILE * row_tiles)
    return {
        "col_blocks": _cdiv(3 * hidden, FWD_COLS),
        "slice_k": slice_k,
        "slices": slices,
        "row_tiles": row_tiles,
        "groups": groups,
        "fwd_smem": _fwd_smem(itemsize, row_tiles),
        "dp_rows": _cdiv(batch, tr) * tr,
        "dp_ld": 3 * hidden + 16 // itemsize,
        "prod_blocks": in_features // BWD_K,
        "prod_smem": _prod_smem(hidden, itemsize),
    }


def unsupported_reason(batch: int, in_features: int, hidden: int, itemsize: int = 4):
    """Why the kernels cannot take this shape, or None when they can."""
    if batch <= 0 or in_features <= 0 or hidden <= 0:
        return f"empty shape (B={batch}, K={in_features}, H={hidden})"
    if batch > MAX_BATCH:
        return f"B={batch} is over {MAX_BATCH}, the JAX budget's batch cap"
    if in_features % 8:
        return f"K={in_features} is not a multiple of 8 (xh and w stream in 16-byte pieces)"
    if hidden % 32 or hidden > MAX_HIDDEN:
        return f"H={hidden} is not a multiple of 32 up to {MAX_HIDDEN} (a LayerNorm row's units over one block's 256 threads)"
    geo = geometry(batch, in_features, hidden, itemsize)
    for name in ("fwd_smem", "prod_smem"):
        if geo[name] > SMEM_LIMIT:
            return f"{name} = {geo[name]} bytes of shared memory per block, over {SMEM_LIMIT} (B={batch}, K={in_features}, H={hidden})"
    return None


def fused_step_supported(batch: int, in_features: int, hidden: int, itemsize: int = 4) -> bool:
    """The port's budget, in place of the JAX package's 12 MB VMEM envelope: H a multiple
    of 32 up to 512 (a LayerNorm row's units over one block's 256 threads), K a multiple of
    8, B up to 256 (the JAX budget's own cap). Neither B nor K bounds the shared memory:
    the forward streams K in slices and boxes and takes at most 64 rows per block, the
    backward streams the rows in tiles. At size S the largest block is the backward's
    product pass, 182,944 bytes in bfloat16 and 203,040 in float32."""
    return unsupported_reason(batch, in_features, hidden, itemsize) is None


def bind(lib: ctypes.CDLL):
    """The C functions of a build of ``csrc/rssm_step.cu``, with their signatures:
    ``rssm_step_fwd(xh, h, w, gamma, beta, out, proj, batch, K, hidden, eps, ti, th, tg,
    stream)``, ``rssm_step_bwd(xh, h, w, gamma, beta, g, proj, dxh, dh, dw, dgamma, dbeta,
    dp_ws, dgb_ws, batch, K, hidden, eps, ti, th, tg, stream)``,
    ``rssm_step_geometry(batch, K, hidden, itemsize, int* out)`` and
    ``rssm_step_max_active_clusters(batch, K, hidden, ti, int* out)``."""
    fwd, bwd = lib.rssm_step_fwd, lib.rssm_step_bwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    geo, clusters = lib.rssm_step_geometry, lib.rssm_step_max_active_clusters
    geo.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    for fn in (fwd, bwd, geo, clusters):
        fn.restype = ctypes.c_int
    return fwd, bwd, geo, clusters


def _kernels():
    """Build or load ``csrc/rssm_step.cu`` once: its bound C functions."""
    global _KERNELS
    if _KERNELS is None:
        _KERNELS = bind(load_kernel_library("rssm_step"))
    return _KERNELS


def kernel_geometry(batch: int, in_features: int, hidden: int, itemsize: int) -> dict:
    """``geometry`` as the built source computes it (``rssm_step_geometry``)."""
    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    err = _kernels()[2](batch, in_features, hidden, itemsize, out)
    if err != 0:
        raise RuntimeError(f"rssm_step_geometry failed with CUDA error {err} (B={batch}, K={in_features}, H={hidden})")
    return dict(zip(GEOMETRY_FIELDS, out))


def max_active_clusters(batch: int, in_features: int, hidden: int, ti: torch.dtype) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the forward's product pass at this shape and
    xh's and w's type on the current device: how many of its clusters the card holds at
    once."""
    out = ctypes.c_int(0)
    err = _kernels()[3](batch, in_features, hidden, _DTYPE_CODES[ti], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"rssm_step_max_active_clusters failed with CUDA error {err}")
    return out.value


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


def gru_step_forward(xh, h, w, gamma, beta, eps: float = 1e-3):
    """``(h', proj)``: the step and its float32 projection ``xh @ w`` [B, 3H], the
    backward's residual. The forward kernel for CUDA tensors (counted in
    ``gru_step.launches``, once for its two launches), the plain version on the CPU."""
    if xh.device.type == "cpu":
        return gru_step_reference(xh, h, w, gamma, beta, eps), xh.float() @ w.float()
    if xh.device.type != "cuda":
        raise ValueError(f"gru_step_forward runs on cuda or cpu tensors, not {xh.device.type}")
    _check(xh, h, w, gamma, beta)
    batch, k = xh.shape
    hidden = h.shape[1]
    out = torch.empty_like(h)
    proj = torch.empty(batch, 3 * hidden, dtype=torch.float32, device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    with _on_device(xh):
        err = _kernels()[0](
            xh.data_ptr(), h.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), proj.data_ptr(),
            batch, k, hidden, float(eps), *_codes(xh, h, gamma), stream,
        )
    if err != 0:
        raise RuntimeError(f"rssm_step_fwd launch failed with CUDA error {err} (B={batch}, K={k}, H={hidden})")
    gru_step.launches += 1
    return out, proj


class GRUStepFunction(torch.autograd.Function):
    """The kernels under autograd: the forward kernel, then the backward kernels on the
    saved ``(xh, h, w, gamma, beta)`` and the forward's float32 projection."""

    @staticmethod
    def forward(ctx, xh, h, w, gamma, beta, eps):
        out, proj = gru_step_forward(xh, h, w, gamma, beta, eps)
        ctx.save_for_backward(xh, h, w, gamma, beta, proj)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        xh, h, w, gamma, beta, proj = ctx.saved_tensors
        return (*gru_step_backward(xh, h, w, gamma, beta, g.contiguous(), proj, ctx.eps), None)


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
    return gru_step_forward(xh, h, w, gamma, beta, eps)[0]


def gru_step_backward(xh, h, w, gamma, beta, g, proj, eps: float = 1e-3):
    """``(dxh, dh, dw, dgamma, dbeta)`` of the step for the upstream gradient ``g`` (``h``'s
    shape and type): the backward kernels for CUDA tensors, autograd through the plain
    version on the CPU. Each gradient takes its operand's type. ``proj`` is the forward's
    float32 projection ``xh @ w`` [B, 3H], as ``gru_step_forward`` returns it; the CPU
    path does not read it."""
    if xh.device.type == "cpu":
        return gru_step_backward_reference(xh, h, w, gamma, beta, g, eps)
    if xh.device.type != "cuda":
        raise ValueError(f"gru_step_backward runs on cuda or cpu tensors, not {xh.device.type}")
    _check(xh, h, w, gamma, beta)
    _check_grad(h, g)
    batch, k = xh.shape
    hidden = h.shape[1]
    if proj.shape != (batch, 3 * hidden) or proj.dtype != torch.float32 or proj.device != xh.device or not proj.is_contiguous():
        raise ValueError(f"proj must be a contiguous float32 [{batch}, {3 * hidden}] tensor on {xh.device}")
    geo = geometry(batch, k, hidden, xh.element_size())
    dxh, dh, dw = torch.empty_like(xh), torch.empty_like(h), torch.empty_like(w)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    dp_ws = torch.empty(geo["dp_rows"], geo["dp_ld"], dtype=xh.dtype, device=xh.device)
    dgb_ws = torch.empty(2, batch, 3 * hidden, dtype=torch.float32, device=xh.device)
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    with _on_device(xh):
        err = _kernels()[1](
            xh.data_ptr(), h.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(), proj.data_ptr(),
            dxh.data_ptr(), dh.data_ptr(), dw.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dp_ws.data_ptr(),
            dgb_ws.data_ptr(), batch, k, hidden, float(eps), *_codes(xh, h, gamma), stream,
        )
    if err != 0:
        raise RuntimeError(f"rssm_step_bwd launch failed with CUDA error {err} (B={batch}, K={k}, H={hidden})")
    gru_step_backward.launches += 1
    return dxh, dh, dw, dgamma, dbeta


gru_step.launches = 0
gru_step_backward.launches = 0
