"""Time the fused RSSM step's kernels, optionally in turns with another version of them.

    python -m sheeprl_tpu_torch.benchmarks.step_kernel_ab [--baseline SOURCE.cu]

For every (B, K, H) of ``STEP_SHAPES`` and operand types of ``STEP_TYPES`` (the fused
step's kernel rows, which ``chip_smoke.py`` takes from here) it times the forward and
the backward of the port's kernels (``ops/rssm_step.py``) from CUDA graphs of ``CALLS``
calls, w and the inputs hot in L2. The backward is timed from the forward's saved
projection, as autograd calls it.

With ``--baseline``, a second source of ``csrc/rssm_step.cu`` that has the earlier,
single-launch C interface (``rssm_step_fwd(xh, h, w, gamma, beta, out, B, K, H, eps, ti,
th, tg, stream)`` and ``rssm_step_bwd(xh, h, w, gamma, beta, g, dxh, dh, dw, dgamma,
dbeta, B, K, H, eps, ti, th, tg, stream)``; it recomputes the projection) is built by
``ops/_build.py`` as ``rssm_step_baseline``, held against the current kernels (the
largest difference of each output) and timed in the order baseline, current, current,
baseline.

Last, each current kernel's device time per call, by kernel name, under
``torch.profiler`` (the phases of each call are its two launches) at the size-S rows.
Prints one JSON line per row and pass, then one line of profiler times and the card's
``nvidia-smi`` name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from sheeprl_tpu_torch.benchmarks.fused_step_bench import _graph_ms
from sheeprl_tpu_torch.ops import _build
from sheeprl_tpu_torch.ops.rssm_step import _DTYPE_CODES, gru_step_backward, gru_step_forward

# (B, K, H) at the unroll's batch (16), ragged (13), 64 and the JAX package's batch cap
# (256); K = 512 + 512, H = 512 (size S). Operand types (xh and w, h, gamma and beta):
# all float32, all bf16, and the scan bench's mix.
STEP_SHAPES = [(16, 1024, 512), (13, 1024, 512), (64, 1024, 512), (256, 1024, 512)]
STEP_TYPES = {
    "float32": (torch.float32, torch.float32, torch.float32),
    "bfloat16": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    "bf16_xw": (torch.bfloat16, torch.float32, torch.float32),
}
CALLS = 100  # calls per captured graph
EPS = 1e-3


def build_baseline(source: Path):
    """Build ``source`` through ``ops/_build.py`` and bind the earlier interface:
    ``(fwd, bwd)``."""
    lib = _build.load_kernel_library("rssm_step_baseline", source)
    if _build.build_seconds("rssm_step_baseline"):
        print(f"[ab] built {source} in {_build.build_seconds('rssm_step_baseline'):.2f} s", flush=True)
    fwd, bwd = lib.rssm_step_fwd, lib.rssm_step_bwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _baseline_calls(lib, xh, h, w, gamma, beta, g):
    """The baseline's forward and backward as calls that raise on a launch error."""
    fwd, bwd = lib
    batch, k = xh.shape
    hidden = h.shape[1]
    codes = (_DTYPE_CODES[xh.dtype], _DTYPE_CODES[h.dtype], _DTYPE_CODES[gamma.dtype])
    out = torch.empty_like(h)
    grads = [torch.empty_like(t) for t in (xh, h, w, gamma, beta)]

    def call_fwd():
        err = fwd(xh.data_ptr(), h.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                  batch, k, hidden, EPS, *codes, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline rssm_step_fwd: CUDA error {err}")
        return out

    def call_bwd():
        err = bwd(xh.data_ptr(), h.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
                  *(t.data_ptr() for t in grads), batch, k, hidden, EPS, *codes, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline rssm_step_bwd: CUDA error {err}")
        return grads

    return call_fwd, call_bwd


def kernel_ms(fn) -> float:
    """Device ms of one call of ``fn``: ``CALLS`` calls in one CUDA graph, replayed."""
    return _graph_ms(lambda: [fn() for _ in range(CALLS)]) / CALLS


def step_operands(batch: int, k: int, hidden: int, device: torch.device, gen: torch.Generator):
    """Float32 operands of the fused step: xh, h and g ~ N(0, 1), w ~ N(0, 1/K) (so the
    projection is ~N(0, 1)), gamma ~ 1 + N(0, 0.01), beta ~ N(0, 0.01)."""
    xh = torch.randn(batch, k, device=device, generator=gen)
    h = torch.randn(batch, hidden, device=device, generator=gen)
    w = torch.randn(k, 3 * hidden, device=device, generator=gen) * k**-0.5
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device=device, generator=gen)
    beta = 0.1 * torch.randn(3 * hidden, device=device, generator=gen)
    g = torch.randn(batch, hidden, device=device, generator=gen)
    return xh, h, w, gamma, beta, g


def typed(ops, types: str):
    """``step_operands`` in a row's types: ``((xh, h, w, gamma, beta), g)``."""
    ti, th, tg = STEP_TYPES[types]
    xh, h, w, gamma, beta, g = ops
    return (xh.to(ti), h.to(th), w.to(ti), gamma.to(tg), beta.to(tg)), g.to(th)


def operands(batch: int, k: int, hidden: int, types: str, seed: int = 0):
    """``step_operands`` on the card from ``seed``, in the row's types."""
    return typed(step_operands(batch, k, hidden, torch.device("cuda"), torch.Generator(device="cuda").manual_seed(seed)), types)


def _max_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def profile_us(args, g, calls: int = 20) -> dict:
    """Device µs per call of each current kernel, by name, over ``calls`` eager forward
    and backward calls."""
    from torch.profiler import ProfilerActivity, profile

    proj = gru_step_forward(*args, EPS)[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            gru_step_forward(*args, EPS)
            gru_step_backward(*args, g, proj, EPS)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r"rssm_step_\w+_kernel", e.key)
        if found:
            out[found.group(0)] = out.get(found.group(0), 0.0) + e.device_time_total / calls
    return out


def run(baseline: Path | None = None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("step_kernel_ab needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build_baseline(baseline) if baseline is not None else None
    for batch, k, hidden in STEP_SHAPES:
        for types in STEP_TYPES:
            args, g = operands(batch, k, hidden, types)
            out, proj = gru_step_forward(*args, EPS)
            grads = gru_step_backward(*args, g, proj, EPS)
            cur = {"fwd": lambda: gru_step_forward(*args, EPS), "bwd": lambda: gru_step_backward(*args, g, proj, EPS)}
            base = _baseline_calls(lib, *args, g) if lib is not None else None
            for i, name in enumerate(("fwd", "bwd")):
                row = {"B": batch, "K": k, "H": hidden, "types": types, "pass": name}
                if base is None:
                    row["ms"] = kernel_ms(cur[name])
                else:
                    got = base[i]()
                    torch.cuda.synchronize()
                    row["max_diff_vs_baseline"] = _max_diff([out], [got]) if name == "fwd" else _max_diff(grads, got)
                    t0 = kernel_ms(base[i])
                    t1, t2 = kernel_ms(cur[name]), kernel_ms(cur[name])
                    t3 = kernel_ms(base[i])
                    row.update(ms=[t1, t2], baseline_ms=[t0, t3])
                print(json.dumps(row), flush=True)
    phases = {types: profile_us(*operands(16, 1024, 512, types)) for types in STEP_TYPES}
    print(json.dumps({"profiler_us_per_call_at_16x1024x512": phases}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="the fused RSSM step's kernels, timed (in turns with a baseline source)")
    parser.add_argument("--baseline", type=Path, default=None, help="a rssm_step.cu with the single-launch C interface")
    args = parser.parse_args(argv)
    run(args.baseline)


if __name__ == "__main__":
    main()
