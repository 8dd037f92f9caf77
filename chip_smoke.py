#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sheeprl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and prints no
result line:

1. build: compile every CUDA kernel of the slice from ``sheeprl_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``; print the build seconds and the card's name and power limit;
2. kernels: with TF32 off for matmuls and cuDNN, hold each kernel against its plain
   PyTorch version at the slice's shapes (f32 atol 1e-5; bf16 atol 1e-2 on the bf16
   output) and time both;
3. agreement: the size-S DreamerV3 player on the card against the same agent on the
   CPU (plain path) for a few steps with injected draws, TF32 off, atol = rtol = 1e-3;
4. eval (the slice's main path): write a seeded size-S DreamerV3 checkpoint and run
   ``sheeprl_tpu_torch.cli.evaluate`` on it, with the precision the config asks for
   (``float32_matmul_precision=high``: TF32 matmuls; cuDNN's default TF32 convs); the
   kernel's launch count must equal the player steps;
5. batched player: 16 envs for 64 steps, sampling from a CUDA generator.

It then prints one JSON line describing every kernel, and last the line
``{"ok": true, "device": {...}}``. Exits 2 without CUDA.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# H100 SXM, dense, from NVIDIA's data sheet (full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores

# Eval-phase configuration: DreamerV3 size S on the dummy env with rgb + state keys.
S_OVERRIDES = [
    "exp=dreamer_v3_dummy",
    "algo=dreamer_v3_S",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
]
EPISODE_STEPS = 128  # DiscreteDummyEnv(n_steps=128): 129 player steps per episode

KERNEL_SHAPES = [(1, 512), (13, 512), (16, 512), (1024, 512), (16, 4096)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# per hidden unit: LayerNorm statistics and normalisation over its 3 values (24),
# two sigmoids, a tanh and the blend (15); transcendental functions count as one
GRU_OPS_PER_UNIT = 39


def log(msg: str) -> None:
    print(msg, flush=True)


def set_tf32(enabled: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    torch.set_float32_matmul_precision("high" if enabled else "highest")


def graph_ms(fn, reps: int = 100, rounds: int = 5) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events, so host overhead is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def eager_ms(fn, reps: int = 200) -> float:
    """Wall time of one eager call, host overhead included (CUDA events)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gru_bound(batch: int, hidden: int, dtype: torch.dtype):
    """Least time for the gate step on an H100: every input read once and the output
    written once, against the float32 operations it needs."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (batch * 3 * hidden + 2 * batch * hidden) * elem + 2 * 3 * hidden * 4
    ops = GRU_OPS_PER_UNIT * batch * hidden
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> float:
    from sheeprl_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.load_kernel_library("layernorm_gru")
    seconds = time.perf_counter() - start
    log(f"[build] layernorm_gru: nvcc {_build.build_seconds('layernorm_gru'):.2f} s, load total {seconds:.2f} s")
    return seconds


def phase_kernels(device: torch.device) -> dict:
    """K1-fwd against its plain version, f32 and bf16, at the slice's shapes."""
    from sheeprl_tpu_torch.ops.gru import layernorm_gru, layernorm_gru_reference

    set_tf32(False)
    log("[kernels] TF32 off for matmuls and cuDNN (parity at full float32)")
    gen = torch.Generator(device=device).manual_seed(0)
    rows, worst = [], 0.0
    for batch, hidden in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            proj = torch.randn(batch, 3 * hidden, device=device, generator=gen).to(dtype)
            h = torch.randn(batch, hidden, device=device, generator=gen).to(dtype)
            gamma = 1 + 0.1 * torch.randn(3 * hidden, device=device, generator=gen)
            beta = 0.1 * torch.randn(3 * hidden, device=device, generator=gen)
            with torch.inference_mode():
                out = layernorm_gru(proj, h, gamma, beta)
                torch.cuda.synchronize()
                ref = layernorm_gru_reference(proj, h, gamma, beta)
                err = (out.float() - ref.float()).abs().max().item()
                if not (out.dtype == dtype and out.shape == h.shape and math.isfinite(err) and err <= TOL[dtype]):
                    raise AssertionError(f"layernorm_gru {batch}x{hidden} {dtype}: max_abs_err {err} > {TOL[dtype]}")
                ms = graph_ms(lambda: layernorm_gru(proj, h, gamma, beta))
                plain_ms = graph_ms(lambda: layernorm_gru_reference(proj, h, gamma, beta))
                call_ms = eager_ms(lambda: layernorm_gru(proj, h, gamma, beta))
            bound_ms, bound_by = gru_bound(batch, hidden, dtype)
            row = {
                "B": batch,
                "H": hidden,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "tol": TOL[dtype],
                "kernel_ms": ms,
                "plain_ms": plain_ms,
                "eager_call_ms": call_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
            log("[kernels] layernorm_gru " + json.dumps(row))
            rows.append(row)
            if dtype == torch.float32:
                worst = max(worst, err)
    main = next(r for r in rows if (r["B"], r["H"], r["dtype"]) == (1, 512, "float32"))
    return {"rows": rows, "max_abs_err_f32": worst, "main": main}


def _s_config(extra=()):
    from sheeprl_tpu_torch.config.core import compose

    return compose(overrides=[*S_OVERRIDES, *extra])


def _build_s_agent(cfg, device: torch.device, seed: int):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, parse_actions_dim
    from sheeprl_tpu_torch.parallel.context import RunContext
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, None)()
    is_continuous, actions_dim = parse_actions_dim(env.action_space)
    modules = build_agent(RunContext(device, seed), actions_dim, is_continuous, cfg, env.observation_space)
    return env, actions_dim, modules


def phase_agreement(device: torch.device, steps: int = 4, batch: int = 2) -> float:
    """The size-S player on ``device`` against the same agent on the CPU (plain GRU
    path), fed the same observations and the same one-hot draws."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, make_player_step

    set_tf32(False)
    cfg = _s_config(["device=cpu"])
    env, actions_dim, (wm, actor, _, _, _) = _build_s_agent(cfg, torch.device("cpu"), seed=11)
    wm_d, actor_d = copy.deepcopy(wm).to(device), copy.deepcopy(actor).to(device)
    wm_cfg = cfg.algo.world_model
    stoch, discrete = wm_cfg.stochastic_size, wm_cfg.discrete_size
    rec = wm_cfg.recurrent_model.recurrent_state_size
    step_c = make_player_step(wm, actor, actions_dim, discrete)
    step_d = make_player_step(wm_d, actor_d, actions_dim, discrete)
    zeros = lambda n: torch.zeros(batch, n)  # noqa: E731
    state_c = PlayerState(zeros(rec), zeros(stoch * discrete), zeros(sum(actions_dim)))
    state_d = PlayerState(*(t.to(device) for t in state_c))
    gen = torch.Generator().manual_seed(5)
    worst = 0.0
    with torch.inference_mode():
        for t in range(steps):
            obs = {
                "rgb": torch.randint(0, 256, (batch, 3, 64, 64), generator=gen, dtype=torch.uint8),
                "state": torch.randn(batch, 10, generator=gen),
            }
            is_first = torch.full((batch, 1), 1.0 if t == 0 else 0.0)
            draw = torch.nn.functional.one_hot(torch.randint(0, discrete, (batch, stoch), generator=gen), discrete).float()
            _, _, state_c = step_c(state_c, obs, is_first, greedy=True, draws=(draw, None))
            _, _, state_d = step_d(
                state_d, {k: v.to(device) for k, v in obs.items()}, is_first.to(device), greedy=True, draws=(draw.to(device), None)
            )
            latent_c = torch.cat([state_c.stochastic_state, state_c.recurrent_state], -1)
            latent_d = torch.cat([state_d.stochastic_state, state_d.recurrent_state], -1)
            pairs = (
                ("recurrent_state", state_d.recurrent_state.cpu(), state_c.recurrent_state),
                ("actor_logits", actor_d(latent_d, greedy=True)[1][0].logits.cpu(), actor(latent_c, greedy=True)[1][0].logits),
            )
            for name, a, b in pairs:
                if not torch.isfinite(a).all():
                    raise AssertionError(f"agreement step {t}: non-finite {name}")
                torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3, msg=lambda m: f"agreement step {t} {name}: {m}")
                worst = max(worst, (a - b).abs().max().item())
    log(f"[agreement] size-S player, {steps} steps x {batch} envs, {device} vs cpu: max_abs_diff {worst:.3e} (atol=rtol=1e-3)")
    env.close()
    return worst


def phase_eval(device: torch.device, workdir: Path) -> dict:
    """The slice's main path: the eval entry on a size-S checkpoint."""
    import sheeprl_tpu_torch.algos.dreamer_v3.evaluate as dv3_eval
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate
    from sheeprl_tpu_torch.config.core import save_config
    from sheeprl_tpu_torch.ops.gru import layernorm_gru

    set_tf32(True)  # the config's float32_matmul_precision=high sets the same for matmuls
    cfg = _s_config([f"device={device.type}"])
    _, _, (wm, actor, critic, target_critic, _) = _build_s_agent(cfg, device, seed=cfg.seed)
    params = {"world_model": wm.state_dict(), "actor": actor.state_dict(), "critic": critic.state_dict(), "target_critic": target_critic.state_dict()}
    n_params = sum(v.numel() for sd in params.values() for v in sd.values())
    save_config(cfg, workdir / "run" / "config.yaml")
    ckpt = CheckpointManager(workdir / "run" / "checkpoints").save(1, {"params": params})
    del wm, actor, critic, target_critic, params

    built = []
    real_build = dv3_eval.build_agent

    def spy(*args, **kwargs):
        out = real_build(*args, **kwargs)
        built.extend(out[:4])
        return out

    dv3_eval.build_agent = spy
    try:
        layernorm_gru.launches = 0
        result = evaluate(
            [
                f"checkpoint_path={ckpt}",
                "env.capture_video=False",
                f"env.wrapper.n_steps={EPISODE_STEPS}",
                f"log_root={workdir / 'logs'}",
            ]
        )
        launches = layernorm_gru.launches
    finally:
        dv3_eval.build_agent = real_build
    tensors = [t for m in built for t in (*m.parameters(), *m.buffers())]
    if not tensors or any(t.device.type != device.type for t in tensors):
        raise AssertionError("the evaluated agent is not on the card")
    if result.steps != EPISODE_STEPS + 1 or launches != result.steps:
        raise AssertionError(f"eval: {result.steps} player steps, {launches} kernel launches")
    if not (math.isfinite(result.reward) and result.reward == 0.0):
        raise AssertionError(f"eval: reward {result.reward} (the dummy env pays 0)")
    sps = result.steps / result.seconds
    log(f"[eval] DreamerV3-S ({n_params} parameters) on {device}: reward {result.reward}, {result.steps} player steps, "
        f"{sps:.1f} player steps/s, layernorm_gru launches {launches}")
    return {"launches": launches, "steps": result.steps, "steps_per_s": sps, "devices": {t.device for t in tensors}}


def phase_batched(device: torch.device, n_envs: int = 16, steps: int = 64) -> dict:
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, make_player_step
    from sheeprl_tpu_torch.ops.gru import layernorm_gru

    set_tf32(True)
    cfg = _s_config([f"device={device.type}"])
    env, actions_dim, (wm, actor, _, _, _) = _build_s_agent(cfg, device, seed=3)
    env.close()
    wm_cfg = cfg.algo.world_model
    rec, stoch = wm_cfg.recurrent_model.recurrent_state_size, wm_cfg.stochastic_size * wm_cfg.discrete_size
    step = make_player_step(wm, actor, actions_dim, wm_cfg.discrete_size)
    gen = torch.Generator(device=device).manual_seed(9)
    obs = {
        "rgb": torch.randint(0, 256, (steps, n_envs, 3, 64, 64), generator=gen, device=device, dtype=torch.uint8),
        "state": torch.randn(steps, n_envs, 10, generator=gen, device=device),
    }
    state = PlayerState(
        torch.zeros(n_envs, rec, device=device), torch.zeros(n_envs, stoch, device=device), torch.zeros(n_envs, sum(actions_dim), device=device)
    )
    is_first = torch.ones(n_envs, 1, device=device)
    with torch.inference_mode():
        step(state, {k: v[0] for k, v in obs.items()}, is_first, gen)  # warm-up (cuDNN/cuBLAS choice)
        torch.cuda.synchronize()
        layernorm_gru.launches = 0
        start = time.perf_counter()
        for t in range(steps):
            actions, _, state = step(state, {k: v[t] for k, v in obs.items()}, is_first, gen)
            is_first = torch.zeros(n_envs, 1, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = layernorm_gru.launches
    if launches != steps:
        raise AssertionError(f"batched player: {launches} kernel launches for {steps} steps")
    if not (torch.isfinite(state.recurrent_state).all() and actions[0].shape == (n_envs, actions_dim[0])):
        raise AssertionError("batched player: non-finite state or wrong action shape")
    log(f"[batched] {n_envs} envs x {steps} steps: {steps / seconds:.1f} player steps/s ({n_envs * steps / seconds:.1f} env steps/s), "
        f"layernorm_gru launches {launches}")
    for rows in (1, n_envs):
        sub_state = PlayerState(*(t[:rows] for t in state))
        sub_obs = {k: v[:, :rows] for k, v in obs.items()}
        profile_player(step, sub_state, sub_obs, gen, min(16, steps))
    return {"launches": launches, "steps_per_s": steps / seconds}


def profile_player(step, state, obs, gen, steps: int) -> None:
    """Where a player step's time goes on the card: ``torch.profiler`` over ``steps``
    steps (no env, observations already on the card). Prints the kernels per step, the
    device time per step, the wall time per step (profiler overhead included) and the
    device's busy share, and the kernels that take most device time."""
    from torch.profiler import ProfilerActivity, profile

    rows = state.recurrent_state.shape[0]
    is_first = torch.zeros(rows, 1, device=state.recurrent_state.device)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for t in range(steps):
            _, _, state = step(state, {k: v[t] for k, v in obs.items()}, is_first, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    if not kernels or device_ms <= 0:
        log(f"[profile] {rows} env(s): device time not measured (the profiler recorded no CUDA kernels)")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("[profile] " + json.dumps({
        "envs": rows,
        "steps": steps,
        "kernels_per_step": len(kernels) / steps,
        "device_ms_per_step": device_ms,
        "wall_ms_per_step": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels_ms_per_step": [[name[:80], ms] for name, ms in top],
    }))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import sheeprl_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    kernels = phase_kernels(device)
    phase_agreement(device)
    with tempfile.TemporaryDirectory() as tmp:
        ev = phase_eval(device, Path(tmp))
    phase_batched(device)
    main_row = kernels["main"]
    line = {
        "kernels": [
            {
                "name": "layernorm_gru_fwd",
                "route": "cuda",
                "source": "sheeprl_tpu_torch/csrc/layernorm_gru.cu",
                "replaces": "sheeprl_tpu/ops/gru.py:119",
                "launches": ev["launches"],
                "max_abs_err": kernels["max_abs_err_f32"],
                "ms": main_row["kernel_ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": None,
            }
        ]
    }
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps(line))
    # count: the cards the run used (the evaluated agent's), not every card visible
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(ev["devices"])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
