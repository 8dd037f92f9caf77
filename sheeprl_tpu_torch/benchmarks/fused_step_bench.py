"""Microbench: the RSSM recurrent step at DreamerV3 size-S shapes.

The counterpart of ``benchmarks/fused_step_bench.py``. It runs the T-step world-model
unroll (B rows, K = k_in + H = 512 + 512, H = 512 at size S) forward and backward three
ways:

  a. ``plain``      - the plain step, ``ops/rssm_step.py::gru_step_reference``;
  b. ``post_fused`` - a PyTorch product for the projection (``F32Product``), then the
                      LayerNorm-GRU gate kernel (``ops/gru.py::layernorm_gru``, K1-fwd
                      and K1-bwd);
  c. ``full_fused`` - the fused step with the product inside the kernel
                      (``ops/rssm_step.py::gru_step``, K2-fwd and K2-bwd).

The loss is the sum of the squared states over the scan, differentiated in w. Inputs are
the JAX bench's: seeded numpy draws, bf16 on the card (the JAX bench picks bf16 on its
accelerator), float32 on the CPU. ``post_fused``'s projection is float32 on bf16
operands, as XLA's ``preferred_element_type=float32`` product is.

Prints one JSON line: per variant the eager wall time per scan (the JAX bench's timing:
one warm call, then ``reps`` calls and one synchronisation), the device time per scan
(from a CUDA graph of one forward and backward scan, or the profiler's sum of kernel
times where the capture is refused; ``device_ms_source`` says which), and the launches
of each kernel in one scan.

Usage: ``python -m sheeprl_tpu_torch.benchmarks.fused_step_bench [T] [B] [--device cpu]``
(defaults 64, 16, cuda). Without CUDA it raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sheeprl_tpu_torch.ops.counters import launch_counts, zero_launches
from sheeprl_tpu_torch.ops.gru import layernorm_gru
from sheeprl_tpu_torch.ops.rssm_step import gru_step, gru_step_reference

VARIANTS = ("plain", "post_fused", "full_fused")


class F32Product(torch.autograd.Function):
    """``xh @ w`` in float32, as ``jnp.dot(..., preferred_element_type=float32)``: one
    cuBLAS product with a float32 output on bf16 operands (``torch.mm``'s ``out_dtype``,
    which the CPU lacks; the CPU runs the bench in float32). The backward rounds the
    cotangent to the operands' type before both products, as the fused kernel rounds
    ``dp``, and returns the gradients in that type."""

    @staticmethod
    def forward(ctx, xh, w):
        ctx.save_for_backward(xh, w)
        return xh @ w if xh.dtype == torch.float32 else torch.mm(xh, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xh, w = ctx.saved_tensors
        g = g.to(xh.dtype)
        return g @ w.T, xh.T @ g


def _post_fused_step(xh, h, w, gamma, beta):
    return layernorm_gru(F32Product.apply(xh, w), h.float(), gamma, beta)


STEPS = {"plain": gru_step_reference, "post_fused": _post_fused_step, "full_fused": gru_step}


def make_inputs(T: int, B: int, k_in: int, hidden: int, device: torch.device, dtype: torch.dtype, seed: int = 0):
    """``xs`` [T, B, k_in] and ``w`` [k_in + H, 3H] (scaled by 0.02) from one numpy
    generator, in ``dtype``; ``gamma`` ones and ``beta`` zeros in float32."""
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.normal(size=(T, B, k_in)).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.normal(size=(k_in + hidden, 3 * hidden)).astype(np.float32) * 0.02).to(device, dtype)
    gamma = torch.ones(3 * hidden, device=device)
    beta = torch.zeros(3 * hidden, device=device)
    return xs, w, gamma, beta


def scan_grad(step_fn, xs, w, gamma, beta):
    """The unroll: ``h`` starts at zeros (float32), each step takes ``concat(x_t, h)`` in
    the inputs' type and ``h``; returns the states ``hs`` [T, B, H] (float32) and the
    gradient of ``sum(hs ** 2)`` in ``w``."""
    hidden = gamma.shape[0] // 3
    w_ = w.detach().requires_grad_(True)
    h = torch.zeros(xs.shape[1], hidden, device=xs.device)
    hs = []
    for x in xs:
        h = step_fn(torch.cat([x, h.to(xs.dtype)], -1), h, w_, gamma, beta).float()
        hs.append(h)
    hs = torch.stack(hs)
    (dw,) = torch.autograd.grad(hs.square().sum(), w_)
    return hs.detach(), dw


def _wall_ms(fn, reps: int, sync) -> float:
    fn()
    sync()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - start) * 1e3 / reps


def _graph_ms(fn, rounds: int = 5) -> float:
    """Device time of one call of ``fn`` captured in a CUDA graph and replayed ``rounds``
    times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / rounds


def _profiler_ms(fn) -> float:
    """The sum of the kernels' device times of one call of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _device_ms(fn):
    """``(ms, source)``: from a CUDA graph, or from the profiler if the capture is refused."""
    try:
        return _graph_ms(fn), "cuda_graph"
    except RuntimeError as err:
        torch.cuda.synchronize()
        return _profiler_ms(fn), f"profiler (graph capture refused: {str(err)[:120]})"


def run(T: int = 64, B: int = 16, k_in: int = 512, hidden: int = 512, device="cuda", reps: int = 20):
    """Run the three variants, in bf16 on the card and float32 on the CPU; returns the
    JSON line (a dict) and, per variant, the ``(hs, dw)`` of its counted scan."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fused_step_bench runs on CUDA, which is not available here; pass --device cpu for the CPU")
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    xs, w, gamma, beta = make_inputs(T, B, k_in, hidden, device, dtype)
    results, outputs = {}, {}
    for name in VARIANTS:

        def fn(step=STEPS[name]):
            return scan_grad(step, xs, w, gamma, beta)

        zero_launches()
        outputs[name] = fn()
        sync()
        counts = launch_counts()
        ms = _wall_ms(fn, reps, sync)
        row = {"ms_per_scan": ms, "us_per_step": ms * 1e3 / T, "launches_per_scan": counts}
        if on_card:
            row["device_ms_per_scan"], row["device_ms_source"] = _device_ms(fn)
        else:
            row["device_ms_per_scan"], row["device_ms_source"] = None, "not measured (cpu run)"
        results[name] = row
    base = results["plain"]["ms_per_scan"]
    for row in results.values():
        row["speedup_vs_plain"] = base / row["ms_per_scan"]
    line = {
        "bench": "rssm_step_scan_fwd_bwd",
        "backend": device.type,
        "device_name": torch.cuda.get_device_name(device) if on_card else "cpu",
        "shape": {"T": T, "B": B, "K": k_in + hidden, "H": hidden, "dtype": str(dtype).replace("torch.", "")},
        **results,
    }
    return line, outputs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="RSSM step scan, forward and backward, three ways")
    parser.add_argument("T", nargs="?", type=int, default=64)
    parser.add_argument("B", nargs="?", type=int, default=16)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    line, _ = run(args.T, args.B, device=args.device)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
