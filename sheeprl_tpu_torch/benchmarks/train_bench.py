"""The headline rows of DreamerV3 training for the PyTorch port (counterpart of
``bench.py::bench_train_only`` and ``bench.py::bench_e2e``).

* ``train``: the size-S train step alone on a fixed batch 16 x 64 of 64 x 64 x 3 frames
  (``bench.py``'s data: seeded numpy pixels and actions, no terminations), discrete
  actor with 6 actions, bf16-mixed, the target critic updated every step; 5 warm-up
  steps, then ``BENCH_STEPS`` (30) steps between two synchronisations. ``--mode graph``
  replays the step captured as a CUDA graph through the loop's block
  (``utils/blocks.py``), ``--mode eager`` calls ``train_step`` step by step.
* ``e2e``: the training loop through the train entry on the dummy env at size S (4 sync
  envs, replay ratio 1, ``BENCH_E2E_STEPS`` (768) policy steps, 256 of them before
  learning), with ``buffer.device`` on (``--replay device``) or off (``--replay host``):
  policy steps per second over the whole run, and the logged ``Time/sps_train`` and
  ``Time/sps_env_interaction`` (the mean after the first two windows, as ``bench.py``).

``--mode turns`` / ``--replay turns`` run A, B, B, A in one process. Each row is one JSON
line; the last line is the card's name and power limit. Without CUDA it raises unless
given ``--device cpu`` (tiny overrides for a smoke run: ``--train-overrides``).

Usage: ``python -m sheeprl_tpu_torch.benchmarks.train_bench [--rows train,e2e]
[--mode graph|eager|turns] [--replay device|host|turns]``.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

E2E_OVERRIDES = [
    "exp=dreamer_v3_dummy",
    "algo=dreamer_v3_S",
    "env=discrete_dummy",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
    "env.screen_size=64",
    "env.num_envs=4",
    "env.sync_env=True",
    "env.capture_video=False",
    "algo.learning_starts=256",
    "algo.per_rank_batch_size=16",
    "algo.per_rank_sequence_length=64",
    "algo.run_test=False",
    "buffer.size=100000",
    "buffer.memmap=False",
    "buffer.checkpoint=False",
    "checkpoint.every=0",
    "checkpoint.save_last=False",
    "metric.log_every=64",
]


def card() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    return {"nvidia_smi": out.stdout.strip().splitlines()[0]}


def _train_setup(device: torch.device, size: str, batch: int, seq: int, extra: Sequence[str]):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    cfg = compose(overrides=[
        "exp=dreamer_v3", f"algo=dreamer_v3_{size}", "env=discrete_dummy", f"algo.per_rank_batch_size={batch}",
        f"algo.per_rank_sequence_length={seq}", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
        "mesh.precision=bf16-mixed", f"device={device.type}", *extra,
    ])
    obs_space = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8)})
    ctx = RunContext(device, 0, compute_dtype=compute_dtype(cfg.mesh.precision))
    wm, actor, critic, target, _ = build_agent(ctx, (6,), False, cfg, obs_space)
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target}
    step, init = make_train_step(wm, actor, critic, target, cfg, ["rgb"], [])
    T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
    rng = np.random.default_rng(0)
    data = {
        "rgb": rng.integers(0, 255, (T, B, 3, 64, 64), dtype=np.uint8),
        "actions": rng.random((T, B, 6)).astype(np.float32),
        "rewards": rng.random((T, B, 1)).astype(np.float32),
        "terminated": np.zeros((T, B, 1), np.float32),
        "is_first": np.zeros((T, B, 1), np.float32),
    }
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    return modules, step, init(), init_moments(device), data, T, B


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_train_only(
    mode: str, device: torch.device, size: str = "S", batch: int = 16, seq: int = 64, warmup: int = 5,
    steps: Optional[int] = None, extra: Sequence[str] = (),
) -> Dict:
    """Gradient steps per second of the train step alone (``mode``: graph or eager)."""
    from sheeprl_tpu_torch.algos.dreamer_loop import make_captured_step
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher

    steps = int(os.environ.get("BENCH_STEPS", "30")) if steps is None else steps
    if device.type == "cuda":  # each row's memory from an empty cache
        gc.collect()
        torch.cuda.empty_cache()
    modules, step, opt, moments, data, T, B = _train_setup(device, size, batch, seq, extra)
    gen = torch.Generator(device=device).manual_seed(0)
    if mode == "graph":
        start = time.perf_counter()
        make_step = make_captured_step(step, modules, opt, moments, T, B, gen)
        captured, draw = make_step({"table": torch.zeros(1, dtype=torch.int64, device=device), "batch": {k: v.clone() for k, v in data.items()}})
        capture_s = time.perf_counter() - start
        dispatcher = BlockDispatcher(captured, draw, target_update_freq=1)

        def run(n: int) -> None:
            dispatcher.dispatch({k: v.expand(n, *v.shape) for k, v in data.items()}, 0)
            dispatcher.drain(None)  # reads the last metrics: waits for the chain of steps
    elif mode == "eager":
        capture_s = None

        def run(n: int) -> None:
            nonlocal moments
            for _ in range(n):
                moments, metrics = step(opt, moments, data, True, generator=gen)
            torch.stack(list(metrics.values())).cpu()
    else:
        raise ValueError(f"mode must be graph or eager, got {mode!r}")
    run(warmup)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    run(steps)
    _sync(device)
    seconds = time.perf_counter() - start
    return {
        "bench": "train_only", "mode": mode, "size": size, "batch": B, "seq": T, "precision": "bf16-mixed",
        "warmup": warmup, "steps": steps, "grad_steps_per_sec": steps / seconds, "capture_seconds": capture_s,
        # a graphed step's activations live in the graph's private pool: reserved, not
        # allocated, so the reserved bytes are the comparable number
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "reserved_bytes": torch.cuda.memory_reserved(device) if device.type == "cuda" else None,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def _scalars(log_root: str) -> Dict[str, List[float]]:
    """Every scalar the run logged, from its event file (or JSON lines)."""
    out: Dict[str, List[float]] = {}
    runs = sorted(glob.glob(os.path.join(log_root, "**", "version_*"), recursive=True))
    if not runs:
        return out
    lines = os.path.join(runs[-1], "metrics.jsonl")
    if os.path.isfile(lines):
        with open(lines) as f:
            for line in f:
                for k, v in json.loads(line).items():
                    out.setdefault(k, []).append(v)
        return out
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    ea = EventAccumulator(runs[-1])
    ea.Reload()
    return {tag: [s.value for s in ea.Scalars(tag)] for tag in ea.Tags()["scalars"]}


def bench_e2e(replay: str, device: torch.device, replay_ratio: float = 1, total_steps: Optional[int] = None, extra: Sequence[str] = ()) -> Dict:
    """The training loop through the train entry, ``buffer.device`` on (``replay=device``)
    or off (``host``): policy steps per second and the logged rates."""
    from sheeprl_tpu_torch.cli import run

    if replay not in ("device", "host"):
        raise ValueError(f"replay must be device or host, got {replay!r}")
    total_steps = int(os.environ.get("BENCH_E2E_STEPS", "768")) if total_steps is None else total_steps
    tmp = tempfile.mkdtemp(prefix="train_bench_e2e_")
    os.environ.setdefault("SHEEPRL_TPU_QUIET", "1")
    try:
        start = time.perf_counter()
        result = run([
            *E2E_OVERRIDES, f"algo.total_steps={total_steps}", f"algo.replay_ratio={replay_ratio}",
            f"buffer.device={replay == 'device'}", f"device={device.type}", f"log_root={tmp}", *extra,
        ])
        elapsed = time.perf_counter() - start
        row = {
            "bench": "e2e", "replay": replay, "replay_ratio": replay_ratio, "total_steps": total_steps,
            "grad_steps": result.grad_steps, "seconds": elapsed, "e2e_policy_steps_per_sec": result.policy_steps / elapsed,
            "train_seconds": result.train_seconds, "env_seconds": result.env_seconds,
        }
        scalars = _scalars(tmp)
        for tag, key in (("Time/sps_train", "e2e_sps_train"), ("Time/sps_env_interaction", "e2e_sps_env_interaction")):
            vals = scalars.get(tag, [])
            steady = vals[2:] if len(vals) > 4 else vals  # the first windows hold the capture
            row[key] = float(np.mean(steady)) if steady else None
            row[f"{key}_windows"] = vals
        return row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", default="train,e2e")
    parser.add_argument("--mode", default="turns", choices=["graph", "eager", "turns"])
    parser.add_argument("--replay", default="turns", choices=["device", "host", "turns"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", default="S")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--e2e-steps", type=int, default=None)
    parser.add_argument("--train-overrides", nargs="*", default=[])
    parser.add_argument("--e2e-overrides", nargs="*", default=[])
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_bench runs on a CUDA card; pass --device cpu for a smoke run on the CPU")
    rows = args.rows.split(",")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True  # the config's float32_matmul_precision=high
        torch.set_float32_matmul_precision("high")
    if "train" in rows:
        modes = ["graph", "eager", "eager", "graph"] if args.mode == "turns" else [args.mode]
        for mode in modes:
            print(json.dumps(bench_train_only(mode, device, args.size, args.batch, args.seq, args.warmup, args.steps, args.train_overrides)), flush=True)
    if "e2e" in rows:
        replays = ["device", "host", "host", "device"] if args.replay == "turns" else [args.replay]
        for replay in replays:
            print(json.dumps(bench_e2e(replay, device, total_steps=args.e2e_steps, extra=args.e2e_overrides)), flush=True)
    print(json.dumps(card() if device.type == "cuda" else {"device": "cpu"}), flush=True)


if __name__ == "__main__":
    main()
