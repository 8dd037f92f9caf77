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
  tensors it launches the forward kernel or raises, and counts the call in
  ``layernorm_gru.launches``. When autograd records, it goes through
  ``LayerNormGRUFunction``, which saves ``(proj, h, gamma, beta)`` and whose backward is
  ``layernorm_gru_backward``: the backward kernel, counted in
  ``layernorm_gru_backward.launches`` (once per call, whether the call is one launch or
  two).

The kernels' launch plan is ``geometry`` (the source's ``geometry``, exported as
``layernorm_gru_geometry``): a row belongs to a group of ``threads_per_row`` threads, 2 or
4 hidden units a thread per segment, loaded in one piece where every operand is 16-byte
aligned and H allows it. The forward is one launch. The backward is one launch where its
CTAs fit one thread-block cluster (dgamma/dbeta added through distributed shared
memory), else two: clusters of 8 write ``partial_rows`` rows of partial sums, which a
second launch adds.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from sheeprl_tpu_torch.ops._build import load_kernel_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = None  # the bound C functions, set at their first launch
_SET_UP = set()  # devices on which layernorm_gru_setup has run

# The launch plan (csrc/layernorm_gru.cu), restated. A thread owns SMALL_UNITS hidden units
# per segment of the 3H axis where the batch's CTAs fit one cluster of MAX_CLUSTER (the
# backward in one launch), else LARGE_UNITS; a row's group is a whole number of warps.
# Narrow path (groups of at most CTA_THREADS): CTA_THREADS // threads_per_row rows per
# CTA. Wide path: one row per CTA of WIDE_THREADS, the row streamed again in each pass,
# WIDE_VEC units per load. A two-launch backward keeps at most MAX_CTAS CTAs with rows, in
# clusters of MULTI_CLUSTER that write one partial row each for a second launch to add;
# the wide path writes one partial row per CTA (none when the batch is one CTA). A
# backward CTA of the narrow path gathers its share of the cluster's dgamma/dbeta terms in
# dynamic shared memory (one slot per group of the cluster; a single CTA with a single
# group needs none).
SMALL_UNITS = 2
LARGE_UNITS = 4
CTA_THREADS = 256
WIDE_THREADS = 1024
WIDE_VEC = 4
MAX_CTAS = 128
MAX_CLUSTER = 16
MULTI_CLUSTER = 8
MAX_BWD_HIDDEN = 16384
# layernorm_gru_geometry's fields, in its order
GEOMETRY_FIELDS = (
    "units", "vec", "path", "threads_per_row", "rows_per_cta", "fwd_grid", "rows_per_group", "bwd_grid", "cluster",
    "bwd_launches", "partial_rows", "bwd_smem",
)
_PARTIAL_ROWS = GEOMETRY_FIELDS.index("partial_rows")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def share_of(cols: int, size: int) -> int:
    """The columns of the 2 x 3H that each CTA of a cluster of ``size`` adds up: a multiple
    of 8, so that a thread's consecutive columns have one owner."""
    return _cdiv(_cdiv(cols, size), 8) * 8


def _rows_layout(batch: int, hidden: int, units: int) -> tuple:
    tpr = _cdiv(_cdiv(hidden, units), 32) * 32
    path = 0 if tpr <= CTA_THREADS else 1
    rows_per_cta = min(CTA_THREADS // tpr, batch) if path == 0 else 1
    return path, WIDE_THREADS if path == 1 else tpr, rows_per_cta, _cdiv(batch, rows_per_cta)


@functools.lru_cache(maxsize=1024)
def _plan(batch: int, hidden: int, aligned: bool) -> tuple:
    units = SMALL_UNITS
    path, tpr, rows_per_cta, fwd_grid = _rows_layout(batch, hidden, units)
    if path == 1 or fwd_grid > MAX_CLUSTER:
        units = LARGE_UNITS
        path, tpr, rows_per_cta, fwd_grid = _rows_layout(batch, hidden, units)
    vec = WIDE_VEC if path == 1 else units
    vec = vec if aligned and hidden % vec == 0 else 1
    if path == 0 and fwd_grid <= MAX_CLUSTER:
        cluster = 1 << (fwd_grid - 1).bit_length()
        rows_per_group, bwd_grid, launches, partial_rows = 1, cluster, 1, 0
    else:
        rows_per_group = _cdiv(batch, rows_per_cta * MAX_CTAS)
        tiles = _cdiv(batch, rows_per_cta * rows_per_group)
        cluster = MULTI_CLUSTER if path == 0 else 1
        bwd_grid = _cdiv(tiles, cluster) * cluster
        launches = 2 if bwd_grid > 1 else 1
        partial_rows = bwd_grid // cluster if launches == 2 else 0
    slots = path == 0 and (cluster > 1 or rows_per_cta > 1)
    bwd_smem = cluster * rows_per_cta * share_of(6 * hidden, cluster) * 4 if slots else 0
    return (units, vec, path, tpr, rows_per_cta, fwd_grid, rows_per_group, bwd_grid, cluster, launches, partial_rows, bwd_smem)


def geometry(batch: int, hidden: int, aligned: bool = True) -> dict:
    """The kernels' launch plan for ``[batch, 3 * hidden]`` operands of either type
    (``geometry`` in the source; ``layernorm_gru_geometry`` exports it): ``units`` per
    thread and segment, ``vec`` units per load (all of them, 4 on the wide path, when
    ``aligned`` and H allow, else 1), the ``path`` (0 narrow, 1 wide),
    ``threads_per_row``, ``rows_per_cta`` (row groups of a CTA) and the forward's CTAs
    ``fwd_grid`` (one row a group); the backward's ``rows_per_group`` (rows each group
    walks), ``bwd_grid`` CTAs in clusters of ``cluster``, ``bwd_launches`` (1 or 2), the
    scratch rows ``partial_rows`` ([2][3H] float32 each) and ``bwd_smem`` bytes of dynamic
    shared memory per CTA.

    At (16, 512): 2 units a thread, 256 threads per row, one row per CTA, 16 forward CTAs;
    the backward is one launch, a cluster of 16. At (1024, 512): 4 units a thread, 128
    threads per row, two rows per CTA, 512 forward CTAs; the backward is 128 CTAs whose
    groups walk 4 rows each, 16 clusters of 8 and 16 partial rows."""
    if batch <= 0 or hidden <= 0:
        raise ValueError(f"no plan for B={batch}, H={hidden}")
    return dict(zip(GEOMETRY_FIELDS, _plan(batch, hidden, bool(aligned))))


def bind(lib: ctypes.CDLL):
    """The C functions of a build of ``csrc/layernorm_gru.cu``, with their signatures:
    ``layernorm_gru_fwd(proj, h, gamma, beta, out, batch, hidden, eps, dtype, aligned,
    stream)``, ``layernorm_gru_bwd(proj, h, gamma, beta, g, dproj, dh, dgamma, dbeta,
    partials, batch, hidden, eps, dtype, aligned, stream)``,
    ``layernorm_gru_geometry(batch, hidden, aligned, int* out)``,
    ``layernorm_gru_max_active_clusters(batch, hidden, dtype, aligned, int* out)`` and
    ``layernorm_gru_setup()``."""
    fwd, bwd = lib.layernorm_gru_fwd, lib.layernorm_gru_bwd
    geo, clusters, setup = lib.layernorm_gru_geometry, lib.layernorm_gru_max_active_clusters, lib.layernorm_gru_setup
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    geo.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    setup.argtypes = []
    for fn in (fwd, bwd, geo, clusters, setup):
        fn.restype = ctypes.c_int
    return fwd, bwd, geo, clusters, setup


def _kernels():
    """Build or load ``csrc/layernorm_gru.cu`` once and bind it; on each device's first
    call, ``layernorm_gru_setup`` (the backward's shared-memory and cluster attributes)."""
    global _KERNELS
    if _KERNELS is None:
        _KERNELS = bind(load_kernel_library("layernorm_gru"))
    device = torch.cuda.current_device()
    if device not in _SET_UP:
        err = _KERNELS[4]()
        if err != 0:
            raise RuntimeError(f"layernorm_gru_setup failed with CUDA error {err} on device {device}")
        _SET_UP.add(device)
    return _KERNELS


def kernel_geometry(batch: int, hidden: int, aligned: bool = True) -> dict:
    """``geometry`` as the built source computes it (``layernorm_gru_geometry``)."""
    out = (ctypes.c_int * len(GEOMETRY_FIELDS))()
    err = _kernels()[2](batch, hidden, int(aligned), out)
    if err != 0:
        raise RuntimeError(f"layernorm_gru_geometry failed with CUDA error {err} (B={batch}, H={hidden})")
    return dict(zip(GEOMETRY_FIELDS, out))


def max_active_clusters(batch: int, hidden: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the backward's main kernel at this shape on the
    current device: how many of its clusters the card holds at once."""
    out = ctypes.c_int(0)
    err = _kernels()[3](batch, hidden, _DTYPE_CODES[dtype], int(aligned), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"layernorm_gru_max_active_clusters failed with CUDA error {err} (B={batch}, H={hidden})")
    return out.value


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


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts at a 16-byte boundary (a contiguous view with a storage
    offset may not): the kernels' vector path. One flag stands for every operand and
    output of a call, so it asks for the widest access of any plan, 16 bytes (the 4-unit
    paths' float4 loads of gamma/beta and stores of dgamma/dbeta, and f32 proj); a finer
    test per plan would gain only views offset by 4 or 8 bytes, which the port never
    makes (its tensors start where the allocator puts them)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_fwd(proj: torch.Tensor, h: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    _check(proj, h, gamma, beta)
    batch, hidden = h.shape
    out = torch.empty_like(h)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    aligned = _aligned(proj, h, gamma, beta, out)
    with _on_device(proj):
        err = _kernels()[0](
            proj.data_ptr(), h.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            batch, hidden, float(eps), _DTYPE_CODES[proj.dtype], int(aligned), stream,
        )
    if err != 0:
        raise RuntimeError(f"layernorm_gru_fwd launch failed with CUDA error {err} (B={batch}, H={hidden})")
    layernorm_gru.launches += 1
    return out


def _partials(batch: int, hidden: int, aligned: bool, device) -> torch.Tensor | None:
    """The backward's scratch: ``partial_rows`` rows of ``[2][3H]`` float32 (``geometry``),
    or None for a one-launch call."""
    rows = _plan(batch, hidden, aligned)[_PARTIAL_ROWS]
    return torch.empty(rows, 2, 3 * hidden, dtype=torch.float32, device=device) if rows else None


def _launch_bwd(proj, h, gamma, beta, g, eps: float):
    """The backward kernel on checked CUDA operands, its scratch sized from ``geometry``
    (only a two-launch call has any)."""
    batch, hidden = h.shape
    if hidden > MAX_BWD_HIDDEN:
        raise ValueError(f"layernorm_gru backward kernel takes H <= {MAX_BWD_HIDDEN}; got {hidden}")
    dproj, dh = torch.empty_like(proj), torch.empty_like(h)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    aligned = _aligned(proj, h, gamma, beta, g, dproj, dh)
    partials = _partials(batch, hidden, aligned, proj.device)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    with _on_device(proj):
        err = _kernels()[1](
            proj.data_ptr(), h.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(), dproj.data_ptr(),
            dh.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), None if partials is None else partials.data_ptr(),
            batch, hidden, float(eps), _DTYPE_CODES[proj.dtype], int(aligned), stream,
        )
    if err != 0:
        raise RuntimeError(f"layernorm_gru_bwd launch failed with CUDA error {err} (B={batch}, H={hidden})")
    layernorm_gru_backward.launches += 1
    return dproj, dh, dgamma, dbeta


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
    return _launch_bwd(proj, h, gamma, beta, g, eps)


layernorm_gru.launches = 0
layernorm_gru_backward.launches = 0
