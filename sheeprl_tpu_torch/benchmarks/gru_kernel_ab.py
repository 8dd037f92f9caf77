"""Time the LayerNorm-GRU kernels, optionally in turns with another version of them.

    python -m sheeprl_tpu_torch.benchmarks.gru_kernel_ab [--baseline SOURCE.cu]

For every (B, H) of ``KERNEL_SHAPES`` (the kernels' rows, which ``chip_smoke.py`` takes
from here) in float32 and bfloat16 it times the forward and the backward of the port's
kernels (``ops/gru.py``) from CUDA graphs of ``CALLS`` calls, the inputs hot in L2.

With ``--baseline``, a second source of ``csrc/layernorm_gru.cu`` that has the earlier C
interface (``layernorm_gru_fwd(proj, h, gamma, beta, out, B, H, eps, dtype, stream)`` and
``layernorm_gru_bwd(proj, h, gamma, beta, g, dproj, dh, dgamma, dbeta, partials, B, H,
rows_per_tile, eps, dtype, stream)``, its partials ``2 * ceil(B / rows_per_tile) * 3H``
floats with ``rows_per_tile = ceil(B / 128)``) is built by ``ops/_build.py`` as
``layernorm_gru_baseline``, held against the current kernels (the largest difference of
each output) and timed in the order baseline, current, current, baseline.

Last, the current kernels' device time per call and launches per call, by kernel name,
under ``torch.profiler`` at (16, 512) and (1024, 512) in both types. Prints one JSON line
per row and pass, then one line of profiler readings and the card's ``nvidia-smi`` name
and power limit. Needs CUDA.
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
from sheeprl_tpu_torch.ops.gru import _DTYPE_CODES, layernorm_gru, layernorm_gru_backward

# (B, H): DreamerV3-S's eval entry's one row, a ragged batch, the RSSM unroll's 16 rows,
# the imagination's 1024 (T 64 x B 16); DreamerV3-XL's (P2E-DV3 at its published widths)
# unroll and imagination at H = 4096, the wide plan; DreamerV2's unroll (16 rows) and
# imagination (T 50 x B 16 = 800) at its H = 600.
KERNEL_SHAPES = [(1, 512), (13, 512), (16, 512), (1024, 512), (16, 4096), (1024, 4096), (16, 600), (800, 600)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CALLS = 100  # calls per captured graph
EPS = 1e-3
MAX_TILES_BASELINE = 128  # the earlier source's tiles per call


def build_baseline(source: Path):
    """Build ``source`` through ``ops/_build.py`` and bind the earlier interface:
    ``(fwd, bwd)``."""
    lib = _build.load_kernel_library("layernorm_gru_baseline", source)
    if _build.build_seconds("layernorm_gru_baseline"):
        print(f"[ab] built {source} in {_build.build_seconds('layernorm_gru_baseline'):.2f} s", flush=True)
    fwd, bwd = lib.layernorm_gru_fwd, lib.layernorm_gru_bwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _baseline_calls(lib, proj, h, gamma, beta, g):
    """The baseline's forward and backward as calls that raise on a launch error."""
    fwd, bwd = lib
    batch, hidden = h.shape
    code = _DTYPE_CODES[proj.dtype]
    out = torch.empty_like(h)
    grads = [torch.empty_like(t) for t in (proj, h, gamma, beta)]
    rows_per_tile = -(-batch // MAX_TILES_BASELINE)
    partials = torch.empty(2 * -(-batch // rows_per_tile) * 3 * hidden, dtype=torch.float32, device=proj.device)

    def call_fwd():
        err = fwd(proj.data_ptr(), h.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), batch, hidden, EPS,
                  code, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline layernorm_gru_fwd: CUDA error {err}")
        return [out]

    def call_bwd():
        err = bwd(proj.data_ptr(), h.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
                  *(t.data_ptr() for t in grads), partials.data_ptr(), batch, hidden, rows_per_tile, EPS, code,
                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline layernorm_gru_bwd: CUDA error {err}")
        return grads

    return call_fwd, call_bwd


def kernel_ms(fn) -> float:
    """Device ms of one call of ``fn``: ``CALLS`` calls in one CUDA graph, replayed."""
    return _graph_ms(lambda: [fn() for _ in range(CALLS)]) / CALLS


def operands(batch: int, hidden: int, dtype: torch.dtype, seed: int = 0):
    """``(proj, h, gamma, beta, g)`` on the card from ``seed``: proj, h and g ~ N(0, 1) in
    ``dtype``, gamma ~ 1 + N(0, 0.01) and beta ~ N(0, 0.01) in float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    proj = torch.randn(batch, 3 * hidden, device="cuda", generator=gen).to(dtype)
    h = torch.randn(batch, hidden, device="cuda", generator=gen).to(dtype)
    gamma = 1 + 0.1 * torch.randn(3 * hidden, device="cuda", generator=gen)
    beta = 0.1 * torch.randn(3 * hidden, device="cuda", generator=gen)
    g = torch.randn(batch, hidden, device="cuda", generator=gen).to(dtype)
    return proj, h, gamma, beta, g


def _max_diff(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def profile_us(args, calls: int = 20) -> dict:
    """Device µs per call and launches per call of each current kernel, by name, over
    ``calls`` eager forward and backward calls."""
    from torch.profiler import ProfilerActivity, profile

    layernorm_gru(*args[:4], EPS)
    layernorm_gru_backward(*args, EPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            layernorm_gru(*args[:4], EPS)
            layernorm_gru_backward(*args, EPS)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r"layernorm_gru_\w+_kernel", e.key)
        if found:
            us, n = out.get(found.group(0), (0.0, 0.0))
            out[found.group(0)] = (us + e.device_time_total / calls, n + e.count / calls)
    return {name: {"us_per_call": us, "launches_per_call": n} for name, (us, n) in out.items()}


def run(baseline: Path | None = None) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("gru_kernel_ab needs CUDA")
    lib = build_baseline(baseline) if baseline is not None else None
    for batch, hidden in KERNEL_SHAPES:
        for name, dtype in DTYPES.items():
            args = operands(batch, hidden, dtype)
            cur = {"fwd": lambda: [layernorm_gru(*args[:4], EPS)], "bwd": lambda: layernorm_gru_backward(*args, EPS)}
            base = _baseline_calls(lib, *args) if lib is not None else None
            with torch.inference_mode():
                for i, which in enumerate(("fwd", "bwd")):
                    row = {"B": batch, "H": hidden, "dtype": name, "pass": which}
                    if base is None:
                        row["ms"] = kernel_ms(cur[which])
                    else:
                        want, got = cur[which](), base[i]()
                        torch.cuda.synchronize()
                        row["max_diff_vs_baseline"] = _max_diff(want, got)
                        t0 = kernel_ms(base[i])
                        t1, t2 = kernel_ms(cur[which]), kernel_ms(cur[which])
                        t3 = kernel_ms(base[i])
                        row.update(ms=[t1, t2], baseline_ms=[t0, t3])
                    print(json.dumps(row), flush=True)
    phases = {f"{b}x{hd} {name}": profile_us(operands(b, hd, dtype)) for b, hd in ((16, 512), (1024, 512)) for name, dtype in DTYPES.items()}
    print(json.dumps({"profiler": phases}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="the LayerNorm-GRU kernels, timed (in turns with a baseline source)")
    parser.add_argument("--baseline", type=Path, default=None, help="a layernorm_gru.cu with the earlier C interface")
    args = parser.parse_args(argv)
    run(args.baseline)


if __name__ == "__main__":
    main()
