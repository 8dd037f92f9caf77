#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sheeprl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and prints no
result line:

1. build: compile every CUDA kernel of the port from ``sheeprl_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``; print the build seconds and the card's name and power limit;
   check that the profiler's device events read raw (``device_events``, what every
   profiled phase reads) equal ``prof.events()``'s;
2. kernels: with TF32 off for matmuls and cuDNN, hold each kernel against its plain
   PyTorch version at the port's shapes and time both: the LayerNorm-GRU forward (f32
   atol 1e-5; bf16 atol 1e-2 on the bf16 output) and backward (against autograd through
   the plain forward on f32 inputs: f32 atol 2e-4, bf16 atol 6e-2 or, where the plain
   version on the same bf16 inputs lies further off, its distance plus 2e-4; and against
   the same bf16 values in float32 within 6e-2), two calls of each
   giving the same bits, beside each row the least a one-kernel call takes from a CUDA
   graph (``launch_floor_ms``: a one-element ``zero_()``); their launches per call read
   by ``torch.profiler`` between spin kernels and, where it reads fewer than the plan,
   counted in a CUDA graph of the same calls; their launch plan held equal
   to the wrapper's at every row (``[kernels] layernorm_gru geometry``); and the fused RSSM
   step forward and backward at (B, K, H) = (16|13|64|256, 1024, 512) (``STEP_TOL``),
   two calls of each giving the same bits, the backward from the forward's saved
   projection; the source's launch geometry held equal to the wrapper's and the card's
   ``cudaOccupancyMaxActiveClusters`` for the forward's clusters printed; beside each
   fused-step row the bare cuBLAS product(s) of its shapes (``product_ms``, a yardstick);
3. agreement: the size-S DreamerV3 player on the card against the same agent on the
   CPU (plain path) for a few steps with injected draws, at ``mesh.precision=32-true``
   set explicitly and TF32 off, atol = rtol = 1e-3;
4. eval: write a seeded size-S DreamerV3 checkpoint and run
   ``sheeprl_tpu_torch.cli.evaluate`` on it at the config's defaults
   (``mesh.precision=bf16-mixed``, ``float32_matmul_precision=high``); the forward
   kernel's launch count must equal the player steps;
5. batched player: 16 envs for 64 steps, sampling from a CUDA generator;
6. train-agreement: one whole training step of a small agent on the card against the
   CPU, same weights, batch and draws, at ``mesh.precision=32-true`` with TF32 off: the
   parameter changes to 0.1 of the learning rate, the Adam moments, losses and gradient
   norms (``TRAIN_AGREEMENT_TOL``);
7. train: the size-S training step, eager, at batch 16 x sequence 64, horizon 15, at
   bf16-mixed and at 32-true: gradient steps/s, kernel launches per step against the
   expected counts, peak memory and a ``torch.profiler`` breakdown of one step;
8. train-graph: the same step captured as a CUDA graph and replayed through the loop's
   block, discrete and continuous actor at bf16-mixed: 4 replays against 4 eager steps
   from the same state, batches and draws, within the spread of two eager runs
   (``GRAPH_SPREAD``) and never looser than ``TRAIN_AGREEMENT_TOL``; K1 launches per
   replay by the profiler equal to the eager step's (79/64 discrete, 79/79 continuous);
   the quantile levels on the card make no host sync; then graph against eager in
   turns: gradient steps/s, device ms per step, busy share, peak memory; then the
   ``Health/*`` of a replay against the eager step's from one state (bit for bit), and
   the device ms and kernels of the step with and without ``obs.health`` in turns;
9. train-cli: the training loop through the train entry at size S with the async vector
   env, which replays the captured step: it trains, checkpoints, resumes from a
   checkpoint, and the eval entry evaluates the last checkpoint; once with host replay
   and once with ``buffer.device=True`` (batches gathered from the ring on the card);
   the backward kernel's launches count the replays (64 per gradient step, plus the
   capture's warm-up steps);
10. dv2-train-agreement: one DreamerV2 training step of a small agent on the card against
   the CPU (``SMALL_DV2``), under ``[train-agreement]``'s limits;
11. dv2-train-graph: DreamerV2 at the published widths (``DV2_OVERRIDES``: dense 400 x 4,
   ELU, CNN multiplier 48, H 600, stochastic 32 x 32, B 16 x T 50, horizon 15, rgb 64 x
   64, discrete actor, bf16-mixed), captured and replayed as ``[train-graph]`` does:
   parity with the eager step, K1 per replay (65 forward, 65 backward, 15 sum launches:
   the imagination's backward runs) by the profiler, the capture and the plan, then
   eager, graph, graph, eager;
12. dv2-train-cli: DreamerV2's train entry at those widths (``DV2_CLI``) with
   ``buffer.device=True`` and with ``buffer.type=episode``: train, resume, eval; K1-bwd
   = 65 x (gradient steps + 2); then a ``[dv2-counts]`` line;
13. dv1-, p2e-dv1- and p2e-dv2-train-agreement: one step of a small DreamerV1, P2E-DV1 and
   P2E-DV2 exploration agent on the card against the CPU, under ``[train-agreement]``'s
   limits;
14. dv1-train-graph and p2e-dv1-train-graph: DreamerV1 at its published widths
   (``DV1_OVERRIDES``: dense 400 x 4, ELU, CNN 32, plain GRU H 200, stochastic 30, B 50 x
   T 50, horizon 15, rgb 64 x 64, discrete, bf16-mixed), then the P2E-DV1 exploration
   step at those widths with 10 ensembles of 400 x 4 that predict the 1024-wide
   embedding (``P2E_DV1_OVERRIDES``), each as ``[train-graph]``: parity, no K1 launch;
   eager, graph, graph, eager;
15. p2e-dv2-train-graph: the P2E-DV2 exploration step at DreamerV2's widths with 10
   ensembles of 400 x 4 (``P2E_DV2_OVERRIDES``), discrete (parity, K1 per replay 80
   forward and 50 backward by the profiler, the capture and the plan, then the turns)
   and continuous (parity, 80 forward, 80 backward, 30 sum launches);
16. dv1-train-cli: DreamerV1's train entry (``DV1_CLI``): train, resume, eval; no K1;
17. p2e-dv1-cli and p2e-dv2-cli: at the graph phases' widths (``P2E_DV1_OVERRIDES``,
   ``P2E_DV2_OVERRIDES``), explore (train, resume), finetune from the exploration
   checkpoint without and with ``buffer.load_from_exploration``, evaluate the exploration
   and each finetuning run; K1-bwd = the step's plan x (gradient steps + 2) per run (50
   exploring, 65 finetuning; none for P2E-DV1);
18. dv3-decoupled-train-agreement and dv3-decoupled-train-graph: DreamerV3 with the
   decoupled RSSM (``algo.world_model.decoupled_rssm=True``), a small agent card against
   CPU, then size S (``DV3_DECOUPLED_OVERRIDES``) as ``[train-graph]``: parity, K1 per
   replay 79 forward and 64 backward by the profiler, the capture and the plan, the turns;
19. minedojo-actor: DreamerV3's and DreamerV2's masked MineDojo actors on the card
   against the CPU (synthetic masks, injected draws);
20. p2e-dv3-train-agreement and p2e-dv3-train-graph: a small P2E-DV3 exploration step
   card against CPU, then the step at the published XL widths (``P2E_DV3_OVERRIDES``:
   dense 1024 x 5, CNN 96, H 4096, 8 ensembles, B 16 x T 64, horizon 15, bf16-mixed):
   discrete (parity, K1 per replay 94 forward, 64 backward and 64 sum launches: K1's wide
   plan, every backward call two launches; the turns) and continuous (parity, 94/94/94);
21. p2e-dv3-cli: the P2E-DV3 entries at size-S widths (``P2E_DV3_CLI_OVERRIDES``): explore,
   resume, finetune without and with the exploration buffer, evaluate each; K1-bwd = 64 x
   (gradient steps + 2) per run; then the ``[p2e-counts]`` line;
22. ppo-train-agreement: one whole update of a small PPO, A2C and recurrent PPO (LSTM and
   attention) agent on the card (the update captured as a CUDA graph) against the CPU,
   image and vector keys, 2 epochs x 2 minibatches, float32 with TF32 off, under
   ``[train-agreement]``'s limits; one policy step with injected draws alike;
23. ppo-train-graph: PPO's update at ``exp=ppo_atari``'s published widths (``PPO_ATARI``:
   Nature CNN on 84 x 84 frames stacked 4 deep, 3 epochs x 4 minibatches of 256,
   bf16-mixed), discrete and continuous: the captured minibatch step replayed 12 times
   against the eager update from the same state, rollout and permutations (within
   ``GRAPH_SPREAD``); then, discrete, eager, graph, graph, eager: gradient steps/s,
   device ms and kernels per minibatch step, peak memory; and the profiled batch-1
   player step (``[ppo-player]``);
24. ppo-cli: PPO's train entry at those widths (``PPO_CLI``: two updates of 1,024 policy
   steps), with ``rollout.pipeline_depth=0`` and ``1``: train, resume, eval; policy steps/s
   split into acting and updating; then a2c-cli and ppo-recurrent-cli (LSTM, attention)
   at their exps' widths on the dummy env's vector: train, resume, eval; a
   ``[ppo-counts]`` line: no PPO-family path launches K1 or K2;
25. the SAC family (SAC, DroQ, SAC-AE): ``[sac-train-agreement]``, ``[droq-…]``,
   ``[sac-ae-…]``: one block of a small agent's gradient steps (DroQ: and its actor
   step), the card's replayed from captured graphs over a device transition ring,
   against the CPU's, same weights, ring, indices and draws, float32, TF32 off, under
   ``[train-agreement]``'s limits; ``[sac-train-graph]``, ``[droq-…]``, ``[sac-ae-…]``:
   each update at its exp's published widths (``SAC_GRAPH``: MLPs 256 x 2 at batch 256;
   DroQ's Dropout + LayerNorm critics, a block of 20 critic steps and the actor step;
   SAC-AE's 32-channel trunk on 3 x 64 x 64 frames, 1024 x 2, batch 128, both cadence
   graphs), bf16-mixed, over a ring of the published buffer size on the card: graphed
   against two eager runs (``GRAPH_SPREAD``), then eager, graph, graph, eager: gradient
   steps/s, device ms and kernels per step, peak memory; ``[sac-cli]``, ``[droq-cli]``,
   ``[sac-ae-cli]``: the train entries at those widths (``SAC_CLI``, ``SAC_CLI_STEPS``;
   SAC at pipeline depths 0 and 1), with host replay and with ``buffer.device=True``:
   train, resume, eval; policy steps/s split into acting and updating; a
   ``[sac-counts]`` line: no SAC-family path launches K1 or K2;
26. the thread-decoupled entries: ``[ppo-decoupled-agreement]``: ``ppo_decoupled`` against
   ``ppo`` at pipeline depth 0 through the train entry on the same draws
   (``SMALL_PPO_DECOUPLED``: three updates, float32, TF32 off) under
   ``[train-agreement]``'s limits; ``[sac-decoupled-publish]``: a short ``sac_decoupled``
   run over the device ring at exp=sac's widths whose every adopted publication equals,
   bit for bit, the learner's actor when it was published, the player on a stream of its
   own; then a graph captured while another thread launches eager work;
   ``[sac-decoupled-cli]`` (host replay, device ring) and ``[ppo-decoupled-cli]``
   (``DECOUPLED_CLI``): train, resume, eval at the exps' widths; policy steps/s, acting
   and updating, and their overlap (acting plus updating seconds over wall seconds); a
   ``[decoupled-counts]`` line: no decoupled path launches K1 or K2;
27. serve: a freshly initialised checkpoint of PPO (``PPO_ATARI``'s Nature CNN on 4 x 84 x
   84 frames), recurrent PPO (exp=ppo_recurrent's LSTM 64) and SAC (exp=sac's 256 x 2),
   each registered in a local registry, then served from one ``PolicyServer`` on the card
   at ``serve.max_batch_size=32`` (ladder 1..32, one CUDA graph per bucket) at the f32, bf16
   and int8 tiers in turn, each family driven by ``SERVE_CLIENTS`` client threads x
   ``SERVE_REQUESTS`` requests: requests/s, client p50 and p99 ms, mean batch fill,
   startup and capture seconds, the parity stamp; every bucket's graph replay against the
   eager act function bit for bit (the recurrent rows scattered too); the card's greedy
   actions against a CPU load of the same checkpoint at the tier, TF32 off (f32 and int8:
   discrete equal, continuous within ``SERVE_CPU_ATOL``; bf16 reported); kernels and device
   ms per replay at buckets 1 and 32; no graph captured after warm-up; no K1/K2 launch.
   Then ``[serve-cli]``: ``python -m sheeprl_tpu_torch.serve`` as a subprocess answers a
   request and exits 75 on SIGTERM; a ``[serve-counts]`` line;
28. the Anakin engine and its populations: ``[anakin-ppo-graph]`` and ``[anakin-sac-graph]``:
   ``exp=ppo_anakin`` and ``exp=sac_anakin`` at their published widths (batched CartPole
   and Pendulum on the card), a captured iteration or dispatch against the eager one from
   the same carry and draws, bit for bit; then eager, graph, graph, eager: env and
   gradient steps/s, device ms and kernels per dispatch, busy share, host ms per dispatch,
   peak and reserved memory; ``[anakin-pop]``: the two ``_pop`` presets (16 members), the
   capture seconds and the memory they add, the rates per member and in all, member 0
   against a standalone run bit for bit; ``[anakin-agreement]``: a small iteration and
   dispatch of each on the card against the CPU, TF32 off, under ``[train-agreement]``'s
   limits; ``[anakin-cli]``: each of the four exps trains, resumes and evaluates through
   the entries at cut total steps (``ANAKIN_CLI``); an ``[anakin-counts]`` line: no
   Anakin path launches K1 or K2;
29. rssm-scan: the port's ``fused_step_bench`` at T 64 x B 16 x K 1024 x H 512 in bf16
   (the fused step's only path): the three variants' eager and device ms per scan, 64
   launches of each fused-step kernel per ``full_fused`` scan (and of each LayerNorm-GRU
   kernel per ``post_fused`` scan), and each fused variant's states and gradient against
   ``plain``'s (``RSSM_SCAN_TOL``);
30. entries: the phases above that drive the train and eval entries through the CLI
   (train-cli, dv2-train-cli, dv1-train-cli, p2e-dv1/2/3-cli, ppo-cli, a2c-cli,
   ppo-recurrent-cli, the SAC family's and the decoupled entries' cli phases,
   anakin-cli, and the Sebulba phases below; ``entry_phases``) run last, in four worker
   processes side by side (``ENTRY_GROUPS``, the Sebulba kill, ``[obs]`` and the supervisor's drill in one; ``run_entry_workers``: ``chip_smoke.py
   --entries NAME,... --out PATH``), each group's phases in order; their lines print when
   all have ended, then the ``[dv2-counts]``, ``[p2e-counts]``, ``[ppo-counts]``,
   ``[sac-counts]``, ``[decoupled-counts]``, ``[anakin-counts]`` and ``[sebulba-counts]``
   lines. The Sebulba phases run ``python -m sheeprl_tpu_torch.sebulba`` (a launcher, a
   learner process and actor processes, each with a CUDA context of its own on the card):
   ``[sebulba-sac-cli]``: ``exp=sac_decoupled``'s widths (MLPs 256 x 2, batch 256) with two
   actors of 4 sync envs at ``[sac-decoupled-cli]``'s steps; the learner's summary accounts
   for every block (blocks, env steps, gradient steps replayed from each actor's
   ``Ratio``, publications, bytes), its rates, ms per publication, staleness and each
   process's peak memory; then a placement resumed from the learner's checkpoint, and
   the eval entry on the resumed run's; ``[sebulba-ppo-cli]``: ``[ppo-decoupled-cli]``'s
   run with one actor beside the thread mode's, their ``SHEEPRL_TPU_BATCH_DIGEST`` lines
   equal line for line; ``[sebulba-kill]``: two actors (``SEBULBA_KILL``), actor 0
   SIGKILLed by ``chaos.kill_actor_at_step``: its generation 1 reconnects and finishes,
   the learner's gradient-step trace rises strictly inside the kill window, exit 0; the
   ``[sebulba-counts]`` line: every Sebulba process launches no K1 or K2, and the Sebulba
   rates beside the thread mode's. ``[obs]`` (in the Sebulba phases' worker, which mostly
   waits): the DreamerV3-S train entry with the observability plane on (``OBS_RUN``, a
   profiler window over two training updates): ``trace.json``'s spans, the profile's
   kernels (K1's among them), ``perf_report.json``'s MFU and goodput, the ``Memory/*``
   gauges against ``torch.cuda.memory_stats``, no capture after warm-up, finite
   ``Health/*``; the same run with ``obs.enabled=False`` (its policy steps/s beside); a small
   run whose training raises leaves a blackbox; the ``[obs-counts]`` line. The fault
   drills (``FAULT_*``): ``[fault-dv3]`` (in the p2e-dv2 worker) SIGTERMs the DreamerV3-S
   train entry at a boundary through the chaos schedule and resumes it in process
   (``fault.autoresume``): each attempt's K1 launches, the final counters, checkpoints and
   marker against ``fault_schedule``, ``Fault/*`` in the logged metrics, the seconds from
   the kill to the resumed attempt's first gradient step; ``[fault-anakin]`` (in the Anakin
   worker): ``exp=ppo_anakin`` killed and resumed against the same run uninterrupted, the
   final checkpoints bit for bit; ``[fault-supervise]`` (in the Sebulba worker):
   ``python -m sheeprl_tpu_torch.supervise`` on a DreamerV3-S run whose newest checkpoint
   is corrupted and whose child is SIGKILLed: rc -9 then 0, the relaunch from the
   checkpoint before the corrupted one, each child's K1 launches (``LAUNCH_HOOK``); the
   ``[fault-counts]`` line. The env pool's phases, one in each of the three lightest
   workers: ``[pool]`` (Sebulba worker), the port's ``EnvPool`` at 1, 4 and 8 workers and
   the one-process-per-env vector env, each against the in-process ``SyncVectorEnv`` bit
   for bit over 256 steps of 8 DreamerV3-S dummy envs that cross episode ends
   (``POOL_ENVS``), their env steps/s and start seconds, and no worker with CUDA
   initialised; ``[pool-dv3-cli]`` (train-cli worker), ``[train-cli]``'s run on the pool (2
   workers) with ``rollout.pipeline_depth=1``: train, resume, eval, K1-bwd = 64 x
   (gradient steps + 2), K1-fwd the plan's plus at least one a policy-driven player step,
   ``Rollout/*`` as logged; ``[pool-fault]`` (Anakin worker), the chaos worker fault
   (crash, then hang past a 5 s step timeout) on a pooled dense PPO run
   (``POOL_FAULT``): one restart each and the schedule's counts, then
   ``rollout.max_restarts=0`` through ``python -m sheeprl_tpu_torch``: a non-zero exit,
   ``RolloutAbortError`` and a blackbox holding ``rollout_abort``; the ``[pool-counts]``
   line.

The K1 rows of phase 2 include DreamerV2's (16, 600) and (800, 600) and DreamerV3-XL's
(16, 4096) and (1024, 4096). Every path (eval,
batched, train, train-cli, the DreamerV2, DreamerV1, P2E, PPO- and SAC-family phases, the decoupled entries', every serve tier, the Anakin phases, rssm-scan,
the pooled runs) zeroes the kernels' launch counters just before it and reads them just after (a Sebulba
process's counters start at zero with the process: the learner's summary carries its
own and each actor's); a replayed graph
adds its capture's counts on every replay (``utils/graphs.py``). The script then prints
one JSON line describing every kernel (each row with its launches on every path it could
run on, the serve paths' zeros among them), and last the line ``{"ok": true, "device": {...}}``. Exits 2 without CUDA.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM, dense, from NVIDIA's data sheet (full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12  # bf16 products in the tensor cores, dense

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

# The LayerNorm-GRU kernels' rows are KERNEL_SHAPES of the port's
# benchmarks/gru_kernel_ab.py: (B, H) at the eval entry's one row, a ragged batch, the
# RSSM unroll's 16 rows, the imagination's 1024 and a wide H.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
# per hidden unit: LayerNorm statistics and normalisation over its 3 values (24),
# two sigmoids, a tanh and the blend (15); transcendental functions count as one
GRU_OPS_PER_UNIT = 39
# the backward per hidden unit: the forward's recompute (39), the gate gradients (15),
# the dgamma/dbeta sums (6), the two dp means (9) and dp itself (12)
GRU_BWD_OPS_PER_UNIT = 81

# The fused RSSM step's rows are STEP_SHAPES x STEP_TYPES of the port's
# benchmarks/step_kernel_ab.py. Forward: against the plain version on the same inputs, by the output's type (h's):
# f32 atol 1e-5, bf16 atol 1e-2. Backward: against autograd through the plain forward on
# float32 inputs, by the least precise operand's type (bf16 operands put their rounding
# into every gradient): f32 atol 2e-4; bf16 atol 6e-2 (test_precision_ops.py's, at its 8
# rows) for dxh and dh, and for dw, dgamma and dbeta, which sum B rows of bf16-rounded
# terms, 6e-2 * sqrt(max(B, 8) / 8): the rounding errors of a sum grow as the root of
# its terms. The JAX package's own kernel (interpret mode, all-bf16 operands, seeds 0-3 of
# `python -m tests.torch_rssm_step_bf16_readings`) reaches 0.079 on dw at B = 16, where
# dw's entries reach ~9, 0.096 at B = 64 and 0.133 at B = 256 (entries ~20).
STEP_TOL = {torch.float32: (1e-5, 2e-4), torch.bfloat16: (1e-2, 6e-2)}


def step_bwd_atol(dtype: torch.dtype, batch: int, row_sum: bool) -> float:
    """The backward's limit for a gradient of the fused step (``STEP_TOL``)."""
    atol = STEP_TOL[dtype][1]
    return atol * math.sqrt(max(batch, 8) / 8) if dtype == torch.bfloat16 and row_sum else atol
# The scan: each fused variant's dw against plain's by relative norm, and the states by
# max abs difference. First readings of full_fused (H100, bf16): 7.07e-3 and 4.89e-4.
RSSM_SCAN_TOL = {"dw_rel": 3e-2, "hs_atol": 1e-2}

# Training phases: DreamerV3-S on 64x64 rgb frames, batch 16 x sequence 64, horizon 15
TRAIN_OVERRIDES = [
    "exp=dreamer_v3_dummy",
    "algo=dreamer_v3_S",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
    "algo.per_rank_batch_size=16",
    "algo.per_rank_sequence_length=64",
    "algo.horizon=15",
]
# [obs]: the train entry at size S with the observability plane on (2 async envs: the
# first 64 updates are the prefill's, the next 32 train); the profiler window holds two
# training updates
OBS_RUN = [*TRAIN_OVERRIDES, "env.sync_env=False", "algo.learning_starts=128", "algo.total_steps=192", "checkpoint.every=0",
           "checkpoint.save_last=False", "metric.log_every=32", "algo.run_test=False"]
OBS_CAPTURE = (66, 67)
# a small agent for the card-against-CPU training step
SMALL_TRAIN = [
    "exp=dreamer_v3_dummy",
    "algo=dreamer_v3_XS",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
    "algo.dense_units=64",
    "algo.world_model.encoder.cnn_channels_multiplier=8",
    "algo.world_model.recurrent_model.recurrent_state_size=128",
    "algo.world_model.transition_model.hidden_size=64",
    "algo.world_model.representation_model.hidden_size=64",
    "algo.per_rank_batch_size=4",
    "algo.per_rank_sequence_length=16",
    "algo.horizon=5",
    "mesh.precision=32-true",
]
# [obs]'s crashing run: a small agent whose training raises at its third block
OBS_CRASH = [*SMALL_TRAIN, "env.sync_env=True", "algo.learning_starts=32", "algo.total_steps=64", "checkpoint.every=0",
             "checkpoint.save_last=False", "metric.log_every=16", "algo.run_test=False"]
# The first Adam step moves each parameter by about its lr (1e-4 world model, 8e-5 actor
# and critic) with the gradient's sign. Held, card against CPU: each module's parameter
# change (new minus old) to 0.1 of its lr, where at most 0.1 % of the entries (gradients
# whose sign the summation order decides) may miss it; each leaf's Adam mu and nu by
# relative norm to 1e-2 (on an H100 the furthest leaf read 1.34e-3: float32 sums in
# another order, and a leaf whose gradient is a difference of large terms keeps only
# their absolute precision; a wrong or rescaled gradient is off by ~0.1-1); the losses
# and the Grads/* norms at rtol 1e-4 with atol 1e-6 (the policy loss is ~1e-4: a mean
# of products of small advantages).
TRAIN_AGREEMENT_TOL = {"step_of_lr": 0.1, "off_share": 1e-3, "moments_rtol": 1e-2, "metrics_rtol": 1e-4, "metrics_atol": 1e-6}
# The graphed train step against the eager step ([train-graph]): from the same state,
# batches and draws, 4 replays against 4 eager steps, the eager steps run twice. The
# replay runs the eager step's kernels on the same inputs, so it may differ from the
# first eager run only as the second eager run does (kernels whose sums are ordered by
# atomics): by GRAPH_SPREAD x that run's largest difference, plus a floor for two
# identical eager runs (parameters: in units of the learning rate; Adam moments and
# losses: relative); never by more than TRAIN_AGREEMENT_TOL.
GRAPH_SPREAD = 2.0
GRAPH_FLOOR = {"params": 1e-3, "moments": 1e-6, "losses": 1e-6}

# DreamerV2 at the reference's published widths (exp=dreamer_v2: dense 400 x 4, ELU, CNN
# multiplier 48, GRU H = 600, stochastic 32 x 32, B 16 x T 50, horizon 15, bf16-mixed) on
# 64x64 rgb frames
DV2_OVERRIDES = [
    "exp=dreamer_v2",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
]
# its train entry, with the sync vector env (four async workers each start by importing
# the port: ~10 s a run): episodes of 66 stored rows (n_steps 64), a whole one per env before
# the first gradient step (learning_starts 264 over 4 envs), 8 pretraining steps in place
# of 100, 128 iterations, checkpoints every 128 policy steps
DV2_CLI = [
    "env.sync_env=True",
    "env.wrapper.n_steps=64",
    "algo.learning_starts=264",
    "algo.per_rank_pretrain_steps=8",
    "algo.total_steps=512",
    "checkpoint.every=128",
    "metric.log_every=128",
]
# DreamerV1 at its published widths (exp=dreamer_v1: dense 400 x 4, ELU, CNN multiplier
# 32, plain GRU H = 200, stochastic 30, B 50 x T 50, horizon 15, bf16-mixed) on 64x64 rgb
DV1_OVERRIDES = [
    "exp=dreamer_v1",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
]
# its train entry on 4 sync envs: 52 rows per env before the first gradient step (a
# sequence is 50), 4 pretraining steps, 96 iterations, checkpoints every 128 policy steps
DV1_CLI = [
    "env.sync_env=True",
    "algo.learning_starts=208",
    "algo.per_rank_pretrain_steps=4",
    "algo.total_steps=384",
    "checkpoint.every=128",
    "metric.log_every=128",
]
# P2E-DV2's exploration step at DreamerV2's widths, 10 ensembles of 400 x 4
P2E_DV2_OVERRIDES = [
    "exp=p2e_dv2_exploration",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
]
# DreamerV2's schedule, with a 8,192-row replay (the exploration run checkpoints its
# buffer, which the finetuning run loads: the exp's 10^6 rows would be copied each time)
P2E_DV2_CLI = [*DV2_CLI, "buffer.size=8192"]
# P2E-DV1's exploration step at DreamerV1's widths, 10 ensembles of 400 x 4 that predict
# the 1024-wide observation embedding
P2E_DV1_OVERRIDES = [
    "exp=p2e_dv1_exploration",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
]
# DreamerV1's schedule, with an 8,192-row replay (checkpointed by the exploration run and
# loaded by the finetuning run, as P2E_DV2_CLI's)
P2E_DV1_CLI = [*DV1_CLI, "buffer.size=8192"]
# a small DreamerV2 for the card-against-CPU training step
SMALL_DV2 = [
    "exp=dreamer_v2_dummy",
    "env=discrete_dummy",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
    "algo.dense_units=64",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=8",
    "algo.world_model.recurrent_model.recurrent_state_size=128",
    "algo.world_model.transition_model.hidden_size=64",
    "algo.world_model.representation_model.hidden_size=64",
    "algo.world_model.stochastic_size=8",
    "algo.world_model.discrete_size=8",
    "algo.per_rank_batch_size=4",
    "algo.per_rank_sequence_length=16",
    "algo.horizon=5",
    "mesh.precision=32-true",
]
# small DreamerV1, P2E-DV1 and P2E-DV2 (three ensembles) for the card-against-CPU step
SMALL_DV1 = [
    "exp=dreamer_v1_dummy",
    "env=discrete_dummy",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
    "algo.dense_units=64",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=8",
    "algo.world_model.recurrent_model.recurrent_state_size=128",
    "algo.world_model.transition_model.hidden_size=64",
    "algo.world_model.representation_model.hidden_size=64",
    "algo.world_model.stochastic_size=16",
    "algo.per_rank_batch_size=4",
    "algo.per_rank_sequence_length=16",
    "algo.horizon=5",
    "mesh.precision=32-true",
]
SMALL_P2E_DV1 = ["exp=p2e_dv1_dummy", *SMALL_DV1[1:], "algo.ensembles.n=3"]
SMALL_P2E_DV2 = ["exp=p2e_dv2_dummy", *SMALL_DV2[1:], "algo.ensembles.n=3"]
# DreamerV3 with the decoupled RSSM: a small agent for the card-against-CPU step, and size S
DECOUPLED = ["algo.world_model.decoupled_rssm=True"]
SMALL_DV3_DECOUPLED = [*SMALL_TRAIN, *DECOUPLED]
DV3_DECOUPLED_OVERRIDES = [*TRAIN_OVERRIDES, *DECOUPLED]
# a small P2E-DV3 (three ensembles, the two exploration critics of algo/p2e_dv3.yaml)
SMALL_P2E_DV3 = ["exp=p2e_dv3_dummy", *(o for o in SMALL_TRAIN[1:] if not o.startswith("algo=")), "algo.ensembles.n=3"]
# P2E-DV3's exploration step at the published XL widths of algo/dreamer_v3.yaml (dense
# 1024 x 5, CNN multiplier 96, GRU H = 4096, stochastic 32 x 32), B 16 x T 64, horizon 15,
# 8 ensembles of 1024 x 5, two exploration critics, bf16-mixed, 64x64 rgb: K1's wide plan
P2E_DV3_OVERRIDES = [
    "exp=p2e_dv3_exploration",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]",
]
# its train entry at size S, the widths of exp/p2e_dv3_expl_dmc_cartpole_swingup_sparse.yaml
# (dense 512 x 2, GRU H = 512, CNN 32): an XL checkpoint holds every module of the XL step
# with its Adam state, and the phase writes a dozen. DreamerV2's CLI schedule with an
# 8,192-row replay, one gradient step per 8 policy steps (DreamerV3's ratio of 1 would be
# ~250 steps a run)
P2E_DV3_CLI_OVERRIDES = [
    *P2E_DV3_OVERRIDES,
    "algo.dense_units=512",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=32",
    "algo.world_model.recurrent_model.recurrent_state_size=512",
    "algo.world_model.transition_model.hidden_size=512",
    "algo.world_model.representation_model.hidden_size=512",
]
P2E_DV3_CLI = [*DV2_CLI, "buffer.size=8192", "algo.replay_ratio=0.125"]
# The PPO family (no K1/K2 on any of its paths). PPO at exp=ppo_atari's published widths:
# Nature CNN 32/64/64 (kernels 8/4/3, strides 4/2/1, VALID), 512 features, dense 512 x 1
# ReLU, 84 x 84 frames stacked 4 deep (rgb: 12 channels), minibatches of 256 from a
# 1,024-step rollout of one env, 3 epochs, annealed lr and clip, normalized advantages,
# clipped value loss, grad norm 0.5. The dummy env draws its 84 x 84 frames itself (the
# card's host has no OpenCV to resize them); nothing else is cut.
PPO_ATARI = ["exp=ppo_atari", "env=discrete_dummy", "env.screen_size=84", "env.frame_stack=4", "env.wrapper.image_size=[3,84,84]"]
# its train entry: two updates of 1,024 policy steps on the sync vector env, a
# checkpoint after each
PPO_CLI = ["env.sync_env=True", "algo.total_steps=2048", "checkpoint.every=1024", "metric.log_every=1024"]
# A2C (exp=a2c: dense 64 x 2 tanh, 128-step rollouts of 4 envs, rmsprop_tf, loss sum) and
# recurrent PPO (exp=ppo_recurrent: LSTM 64, or causal attention with a 64-step window and
# 4 heads; 4 epochs x 4 env minibatches) on the dummy env's vector key in place of their
# gym envs' vectors; two updates each
A2C_CLI = ["exp=a2c", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "env.sync_env=True", "algo.total_steps=1024",
           "checkpoint.every=512", "metric.log_every=512"]
PPO_REC_CLI = ["exp=ppo_recurrent", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "env.sync_env=True", "algo.total_steps=1024",
               "checkpoint.every=512", "metric.log_every=512"]
# small agents for the card-against-CPU update: image and vector keys, 2 epochs x 2
# minibatches (recurrent: 2 env minibatches of 2), float32
_SMALL_PPO_KEYS = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "env.screen_size=64", "mesh.precision=32-true",
                   "algo.dense_units=64", "algo.normalize_advantages=True", "algo.max_grad_norm=0.5"]
SMALL_PPO = ["exp=ppo_dummy", "env=discrete_dummy", *_SMALL_PPO_KEYS, "algo.rollout_steps=16", "env.num_envs=2",
             "algo.per_rank_batch_size=16", "algo.update_epochs=2", "algo.anneal_lr=True", "algo.clip_vloss=True", "algo.ent_coef=0.01"]
SMALL_A2C = ["exp=a2c", "env=continuous_dummy", *_SMALL_PPO_KEYS, "algo.rollout_steps=16", "env.num_envs=2", "algo.ent_coef=0.01"]
SMALL_PPO_REC = ["exp=ppo_recurrent", "env=discrete_dummy", *_SMALL_PPO_KEYS, "algo.rollout_steps=16", "env.num_envs=4",
                 "algo.per_rank_num_batches=2", "algo.update_epochs=2", "algo.rnn.lstm.hidden_size=32", "algo.clip_vloss=True",
                 "algo.attention.window=8"]
# MineDojo's functional action space: 19 action types (the reference's ACTION_MAP) and the
# craft and item argument heads
MINEDOJO_HEADS = (19, 244, 634)
# The SAC family (SAC, DroQ, SAC-AE) at their exps' published widths: MLPs of 256 x 2 on
# HalfCheetah-v4's 17-wide vector and 6 actions (the dummy env at those shapes), batch 256;
# SAC-AE's 32-channel trunk on 3 x 64 x 64 frames, 50 features, 1024 x 2, batch 128; the
# graph phases' rings at the published buffer.size (1,000,000 and 100,000 transitions)
# (overrides, block steps, timed blocks, steps profiled, ring rows); DroQ's block is one
# iteration at replay ratio 20 and is profiled whole with its actor step
SAC_GRAPH = {"sac": (["exp=sac"], 64, 2, 8, 1_000_000), "droq": (["exp=droq"], 20, 6, 20, 1_000_000),
             "sac_ae": (["exp=sac_ae"], 32, 2, 4, 100_000)}
_SMALL_VEC = ["algo.hidden_size=32", "algo.per_rank_batch_size=16", "env.wrapper.vector_shape=[7]", "env.wrapper.action_dim=3"]
SMALL_SAC = {"sac": ["exp=sac", *_SMALL_VEC], "droq": ["exp=droq", *_SMALL_VEC],
             "sac_ae": ["exp=sac_ae", "env.screen_size=32", "env.wrapper.image_size=[3,32,32]", "algo.encoder.features_dim=16",
                        "algo.encoder.channels=8", "algo.actor.dense_units=32", "algo.critic.dense_units=32", "algo.per_rank_batch_size=8"]}
# the entries at those widths, 4 sync envs, the step counts and SAC-AE's buffer cut:
# (overrides, the checkpoint a resume starts from)
SAC_CLI = {
    "sac_host_depth0": (["exp=sac", "rollout.pipeline_depth=0"], "ckpt_1024"),
    "sac_device_depth0": (["exp=sac", "buffer.device=True", "rollout.pipeline_depth=0"], "ckpt_1024"),
    "sac_device_depth1": (["exp=sac", "buffer.device=True", "rollout.pipeline_depth=1"], "ckpt_1024"),
    "droq_host": (["exp=droq"], "ckpt_64"),
    "droq_device": (["exp=droq", "buffer.device=True"], "ckpt_64"),
    "sac_ae_host": (["exp=sac_ae"], "ckpt_128"),
    "sac_ae_device": (["exp=sac_ae", "buffer.device=True"], "ckpt_128"),
}
# a resumed run trains again after learning_starts more iterations (as the reference's):
# each resumes from a checkpoint early enough to train
SAC_CLI_STEPS = {
    "sac": ["algo.total_steps=2048", "algo.learning_starts=512", "checkpoint.every=1024", "metric.log_every=512"],
    "droq": ["algo.total_steps=256", "algo.learning_starts=64", "checkpoint.every=64", "metric.log_every=64"],
    "sac_ae": ["algo.total_steps=512", "algo.learning_starts=128", "checkpoint.every=128", "metric.log_every=128", "buffer.size=8192"],
}
# The thread-decoupled entries at their exps' published widths: sac_decoupled is exp=sac's
# (HalfCheetah-v4's shapes on the dummy env), with host replay and with the device ring,
# at the [sac-cli] step counts; ppo_decoupled is algo=ppo's dense 64 x 2 on CartPole-v1's
# shapes, 128-step rollouts of 4 envs, four updates: (overrides, the checkpoint a resume
# starts from, whether the resumed run takes half the gradient steps)
_PPO_DECOUPLED_CLI = ["env.sync_env=True", "algo.total_steps=2048", "checkpoint.every=1024", "metric.log_every=512"]
DECOUPLED_CLI = {
    "sac_decoupled_host": (["exp=sac_decoupled", "env.sync_env=True", *SAC_CLI_STEPS["sac"]], "ckpt_1024", False),
    "sac_decoupled_device": (["exp=sac_decoupled", "buffer.device=True", "env.sync_env=True", *SAC_CLI_STEPS["sac"]], "ckpt_1024", False),
    "ppo_decoupled": (["exp=ppo_decoupled", *_PPO_DECOUPLED_CLI], "ckpt_1024", True),
    # the coupled entry at the same widths and steps, to compare with
    "ppo_coupled": (["exp=ppo_decoupled", "algo.name=ppo", "rollout.pipeline_depth=0", *_PPO_DECOUPLED_CLI], "ckpt_1024", True),
}
# [ppo-decoupled-agreement]: three updates of a small ppo_decoupled and of ppo at depth 0,
# float32, every annealing on, on the same draws
SMALL_PPO_DECOUPLED = ["exp=ppo_decoupled", "algo.rollout_steps=16", "env.num_envs=2", "algo.per_rank_batch_size=16", "algo.update_epochs=2",
                       "algo.total_steps=96", "algo.anneal_lr=True", "algo.anneal_clip_coef=True", "algo.anneal_ent_coef=True",
                       "algo.ent_coef=0.01", "algo.normalize_advantages=True", "algo.clip_vloss=True", "algo.max_grad_norm=0.5",
                       "env.max_episode_steps=5", "env.sync_env=True", "algo.run_test=False", "checkpoint.every=32", "metric.log_every=32",
                       "mesh.precision=32-true", "float32_matmul_precision=highest"]
# [sac-decoupled-publish]: a short sac_decoupled run over the device ring at exp=sac's widths
SAC_DECOUPLED_PUBLISH = ["exp=sac_decoupled", "buffer.device=True", "env.sync_env=True", "algo.total_steps=1024",
                         "algo.learning_starts=256", "checkpoint.every=0", "checkpoint.save_last=True", "metric.log_every=256",
                         "algo.run_test=False"]

# The serving path: a freshly initialised checkpoint of each servable family at its exp's
# published widths, registered, then served from one PolicyServer at each precision tier
# (serving cost does not depend on the weights' values): PPO at exp=ppo_atari's
# Nature-CNN widths (4 x 84 x 84 frames, 512 features, dense 512), recurrent PPO at
# exp=ppo_recurrent's (LSTM 64 on the dummy env's vector) and SAC at exp=sac's (256 x 2
# on HalfCheetah-v4's 17-wide vector, 6 actions)
SERVE_FAMILIES = {
    "ppo": PPO_ATARI,
    "ppo_recurrent": ["exp=ppo_recurrent", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]"],
    "sac": ["exp=sac"],
}
SERVE_TIERS = ("f32", "bf16", "int8")
SERVE_MAX_BATCH = 32  # the ladder 1, 2, 4, 8, 16, 32
SERVE_CLIENTS, SERVE_REQUESTS = 8, 64  # client threads x requests each, per family and tier
SERVE_WARMUP_REQUESTS = 16  # each client's untimed requests before them
SERVE_CPU_ATOL = 1e-3  # continuous actions, card against CPU, TF32 off


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


def bound_ms(nbytes: float, ops: float, tensor_ops: float = 0.0):
    """Least time on an H100 for work that moves ``nbytes``, does ``ops`` float32
    operations and ``tensor_ops`` bf16 tensor-core operations: the larger of the byte
    time and the operation time, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_FLOPS + tensor_ops / BF16_TENSOR_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launches() -> tuple:
    """The launch counts of the LayerNorm-GRU forward and backward kernels; raises if a
    fused-step kernel launched, which no DreamerV3 path calls."""
    from sheeprl_tpu_torch.ops.gru import layernorm_gru, layernorm_gru_backward
    from sheeprl_tpu_torch.ops.rssm_step import gru_step, gru_step_backward

    if gru_step.launches or gru_step_backward.launches:
        raise AssertionError(f"a DreamerV3 path launched the fused step: {gru_step.launches} forward, {gru_step_backward.launches} backward")
    return layernorm_gru.launches, layernorm_gru_backward.launches


def zero_launches() -> None:
    from sheeprl_tpu_torch.ops.counters import zero_launches as zero_all

    zero_all()


def phase_build() -> float:
    """Build every kernel library at once, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    from sheeprl_tpu_torch.ops import _build

    names = ("layernorm_gru", "rssm_step")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load_kernel_library, names))
    seconds = time.perf_counter() - start
    log("[build] " + ", ".join(f"{n}: nvcc {_build.build_seconds(n):.2f} s" for n in names) + f"; all loaded in {seconds:.2f} s")
    return seconds


def launch_floor_ms(device: torch.device) -> float:
    """The least time one kernel takes from a CUDA graph: a one-element ``zero_()``,
    captured and replayed as ``graph_ms`` captures a kernel."""
    z = torch.zeros(1, device=device)
    return graph_ms(lambda: z.zero_())


SENTINELS = 8  # spin kernels on each side of a profiled window


def device_events(prof) -> list:
    """``(name, µs)`` of every device event (kernels, copies, sets) a finished
    ``torch.profiler.profile`` recorded, read from its raw Kineto events: the same events
    and times as ``prof.events()``'s with ``device_type`` CUDA (``check_device_events``),
    without building its ``FunctionEvent`` tree, the slow part of reading a profiled
    train step of tens of thousands of kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1000) for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def check_device_events(device: torch.device) -> int:
    """``device_events`` against ``prof.events()`` on a few profiled launches (CPU and
    CUDA activities, as ``profile_calls``): the same names and times, or it raises."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            x = torch.tanh(x @ x).contiguous()
        torch.cuda.synchronize()
    raw = sorted(device_events(prof))
    parsed = sorted((e.name, e.device_time_total) for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if not raw or [n for n, _ in raw] != [n for n, _ in parsed] or any(abs(a - b) > 1e-3 for (_, a), (_, b) in zip(raw, parsed)):
        raise AssertionError(f"device_events {raw[:4]} ... disagree with prof.events() {parsed[:4]} ...")
    log(f"[profile] device_events equal prof.events() on {len(raw)} device events")
    return len(raw)


def profiled_kernel_names(fn, calls: int) -> tuple[list, int] | None:
    """The names of the CUDA kernels that ``calls`` calls of ``fn`` launch, read by
    ``torch.profiler``, and how many of the window's ``2 * SENTINELS`` spin kernels it
    recorded; None where it recorded no kernel at all. The calls are bracketed by spin
    kernels (``torch.cuda._sleep``): the profiler has been seen to drop records at a
    window's edge (an H100: 3 of 4 one-launch calls, three readings in a row), and a
    dropped record then falls on a spin kernel, which the count leaves out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        for _ in range(SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.01)
    names = [name for name, _ in device_events(prof)]
    if not names:
        return None
    spins = [n for n in names if "spin_kernel" in n]
    return [n for n in names if "spin_kernel" not in n], len(spins)


def read_launches(fn, calls: int, count, want: dict | None, what: str, readings: int = 5) -> dict | None:
    """``count(names)`` (launches per kernel over the window) divided by ``calls``, from
    ``profiled_kernel_names``; None where no reading recorded a kernel. A reading with no
    kernel (an H100 has given one among many), and with ``want`` (the plan's counts) a
    reading under the plan in some kernel and over it in none, is profiled again, up to
    ``readings`` in all; a count over the plan is never a dropped record and is returned
    at once. A reading that missed spin kernels is not read again for that: on an H100
    the readings of a replayed train step missed 1–8 of the 16 while every K1 launch was
    there."""
    got = None
    for _ in range(readings):
        read = profiled_kernel_names(fn, calls)
        if read is None:
            log(f"[profile] {what}: the profiler recorded no CUDA kernel; profiling again")
            continue
        names, spins = read
        got = {k: v / calls for k, v in count(names).items()}
        if want is None or got == want or any(got[k] > want[k] for k in want):
            return got
        log(f"[profile] {what}: launches per call {got}, plan {want}, {spins} of {2 * SENTINELS} spin kernels recorded; profiling again")
    return got


def graph_launches(fn, calls: int, match: str) -> int:
    """Kernel nodes whose function name holds ``match`` in a CUDA graph of ``calls``
    calls of ``fn``, read from the graph's DOT dump (the driver's ``cuGraphDebugDotPrint``,
    verbose): a count of the launches that needs no profiler."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        err = ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), ctypes.c_uint(1))
        if err != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint returned CUDA error {err}")
        text = Path(path).read_text()
    del graph
    # one chunk per node statement: from a node's quoted name and its ``[`` to the next
    return sum(match in chunk for chunk in re.split(r'(?="[^"\n]*"\s*\[)', text)[1:])


def gru_launches_per_call(fn, want: int, what: str, calls: int = 4) -> int:
    """Kernel launches per call of ``fn`` whose name holds ``layernorm_gru``, counted by
    ``torch.profiler`` over ``calls`` eager calls (``read_launches``); it must be ``want``
    (the plan's). Where every reading lies under the plan or recorded no kernel, the
    launches of the same calls captured in a CUDA graph decide (``graph_launches``), and
    the profiler's reading is logged beside them. One call runs before the profiler
    starts: a kernel's first launch loads its module."""
    fn()
    torch.cuda.synchronize()
    got = read_launches(fn, calls, lambda names: {"k1": sum("layernorm_gru" in n for n in names)}, {"k1": want}, what)
    per_call = None if got is None else got["k1"]
    if per_call is None or per_call < want:
        in_graph = graph_launches(fn, calls, "layernorm_gru") / calls
        log(f"[kernels] {what}: the profiler read {per_call} layernorm_gru launches per call, a CUDA graph of the same calls holds {in_graph}")
        per_call = in_graph
    if per_call != want:
        raise AssertionError(f"{what}: {per_call} layernorm_gru launches per call, the plan says {want}")
    return want


def phase_kernels(device: torch.device) -> dict:
    """K1-fwd against its plain version, f32 and bf16, at the slice's shapes; two calls
    must give the same bits."""
    from sheeprl_tpu_torch.benchmarks.gru_kernel_ab import KERNEL_SHAPES
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
                again = layernorm_gru(proj, h, gamma, beta)
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"layernorm_gru {batch}x{hidden} {dtype}: two calls differ")
                ref = layernorm_gru_reference(proj, h, gamma, beta)
                err = (out.float() - ref.float()).abs().max().item()
                if not (out.dtype == dtype and out.shape == h.shape and math.isfinite(err) and err <= TOL[dtype]):
                    raise AssertionError(f"layernorm_gru {batch}x{hidden} {dtype}: max_abs_err {err} > {TOL[dtype]}")
                ms = graph_ms(lambda: layernorm_gru(proj, h, gamma, beta))
                plain_ms = graph_ms(lambda: layernorm_gru_reference(proj, h, gamma, beta))
                call_ms = eager_ms(lambda: layernorm_gru(proj, h, gamma, beta))
                per_call = gru_launches_per_call(lambda: layernorm_gru(proj, h, gamma, beta), 1, f"layernorm_gru {batch}x{hidden} {dtype}")
            # proj and h read, h' written, gamma and beta read (float32)
            elem = proj.element_size()
            bound, bound_by = bound_ms((batch * 3 * hidden + 2 * batch * hidden) * elem + 2 * 3 * hidden * 4, GRU_OPS_PER_UNIT * batch * hidden)
            row = {
                "B": batch,
                "H": hidden,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "tol": TOL[dtype],
                "bit_identical": True,
                "launches_per_call": per_call,
                "kernel_ms": ms,
                "launch_floor_ms": launch_floor_ms(device),
                "plain_ms": plain_ms,
                "eager_call_ms": call_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,
            }
            log("[kernels] layernorm_gru " + json.dumps(row))
            rows.append(row)
            if dtype == torch.float32:
                worst = max(worst, err)
    main = next(r for r in rows if (r["B"], r["H"], r["dtype"]) == (16, 512, "bfloat16"))
    return {"rows": rows, "max_abs_err_f32": worst, "main": main}


def phase_kernels_bwd(device: torch.device) -> dict:
    """K1-bwd: the backward kernel against autograd through the plain forward, at the
    slice's shapes, f32 and bf16 inputs: on the float32 inputs (``BWD_TOL``, or no further
    off than the plain version on the same bf16 inputs plus the float32 limit) and on the
    same bf16 values in float32 (``BWD_TOL``); two calls must give the same bits."""
    from sheeprl_tpu_torch.benchmarks.gru_kernel_ab import KERNEL_SHAPES
    from sheeprl_tpu_torch.ops.gru import geometry, layernorm_gru_backward, layernorm_gru_backward_reference

    set_tf32(False)
    gen = torch.Generator(device=device).manual_seed(1)
    rows, worst = [], 0.0
    for batch, hidden in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            proj = torch.randn(batch, 3 * hidden, device=device, generator=gen)
            h = torch.randn(batch, hidden, device=device, generator=gen)
            gamma = 1 + 0.1 * torch.randn(3 * hidden, device=device, generator=gen)
            beta = 0.1 * torch.randn(3 * hidden, device=device, generator=gen)
            g = torch.randn(batch, hidden, device=device, generator=gen)
            ref = layernorm_gru_backward_reference(proj, h, gamma, beta, g)
            args = (proj.to(dtype), h.to(dtype), gamma, beta, g.to(dtype))
            out = layernorm_gru_backward(*args)
            again = layernorm_gru_backward(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("dproj", "dh", "dgamma", "dbeta"), out, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"layernorm_gru_bwd {batch}x{hidden} {dtype}: two calls differ in {name}")
            # against the float32 inputs, each gradient within BWD_TOL or no further off
            # than the plain version on the same inputs (plus the float32 limit): the bf16
            # inputs' rounding, summed over B rows into dgamma/dbeta, sets that distance
            plain = layernorm_gru_backward_reference(*args)
            rounded = layernorm_gru_backward_reference(*(a.float() for a in args))
            errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(out, ref)]
            plain_errs = [(p.float() - r.float()).abs().max().item() for p, r in zip(plain, ref)]
            limits = [max(BWD_TOL[dtype], e + BWD_TOL[torch.float32]) for e in plain_errs]
            same_values = max((o.float() - r).abs().max().item() for o, r in zip(out, rounded))
            err = max(errs)
            want = [dtype, dtype, torch.float32, torch.float32]
            if [o.dtype for o in out] != want or not all(map(math.isfinite, errs)) or any(e > lim for e, lim in zip(errs, limits)):
                raise AssertionError(f"layernorm_gru_bwd {batch}x{hidden} {dtype}: errors {errs} over {limits}")
            if not same_values <= BWD_TOL[dtype]:
                raise AssertionError(f"layernorm_gru_bwd {batch}x{hidden} {dtype}: {same_values} off the same values in float32")
            ms = graph_ms(lambda: layernorm_gru_backward(*args))
            plain_ms = graph_ms(lambda: layernorm_gru_backward_reference(*args))
            call_ms = eager_ms(lambda: layernorm_gru_backward(*args))
            planned = geometry(batch, hidden)["bwd_launches"]
            per_call = gru_launches_per_call(lambda: layernorm_gru_backward(*args), planned, f"layernorm_gru_bwd {batch}x{hidden} {dtype}")
            # proj, h and g read, dproj and dh written, gamma/beta read and dgamma/dbeta
            # written (float32); the two-launch plan's partial rows are not counted: the
            # work does not need them
            elem = args[0].element_size()
            bound, bound_by = bound_ms(batch * 9 * hidden * elem + 4 * 3 * hidden * 4, GRU_BWD_OPS_PER_UNIT * batch * hidden)
            row = {
                "B": batch,
                "H": hidden,
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err,
                "tol": max(limits),
                "plain_max_abs_err": max(plain_errs),
                "max_abs_err_same_values": same_values,
                "bit_identical": True,
                "launches_per_call": per_call,
                "kernel_ms": ms,
                "launch_floor_ms": launch_floor_ms(device),
                "plain_ms": plain_ms,
                "eager_call_ms": call_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,
            }
            log("[kernels] layernorm_gru_bwd " + json.dumps(row))
            rows.append(row)
            if dtype == torch.float32:
                worst = max(worst, err)
    main = next(r for r in rows if (r["B"], r["H"], r["dtype"]) == (16, 512, "bfloat16"))
    return {"rows": rows, "max_abs_err_f32": worst, "main": main}


def _step_row(batch, k, hidden, types, err, tol, fn, plain, product, nbytes, ops, tensor_ops) -> dict:
    """A fused-step kernel's row: its time, its plain version's, and the bare product(s)
    of the same shapes in cuBLAS (``product_ms``, a yardstick the port never calls). The
    bound counts the bytes of the function itself; ``residual_bytes`` is the float32
    projection that the port's forward writes and its backward reads beside them."""
    bound, bound_by = bound_ms(nbytes, ops, tensor_ops)
    return {
        "B": batch,
        "K": k,
        "H": hidden,
        "types": types,
        "max_abs_err": err,
        "tol": tol,
        "bit_identical": True,
        "launches_per_call": 2,
        "kernel_ms": graph_ms(fn),
        "plain_ms": graph_ms(plain),
        "product_ms": graph_ms(product),
        "eager_call_ms": eager_ms(fn),
        "bound_ms": bound,
        "bound_by": bound_by,
        "residual_bytes": batch * 3 * hidden * 4,
        "w_in_l2": "hot: the graph replays one w, 3.1 MB in bf16 and 6.3 MB in f32, under the 50 MB L2",
        "library_ms": None,
    }


def _same_bits(a, b, what: str) -> None:
    """Two calls of a fused-step kernel must give the same bits (fixed-order sums)."""
    for name, x, y in zip(("dxh", "dh", "dw", "dgamma", "dbeta") if len(a) > 1 else ("h'",), a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: two calls differ in {name} (max {(x.float() - y.float()).abs().max().item()})")


def _f32_product(a, b):
    """a @ b with a float32 output, as XLA's preferred_element_type (TF32 off)."""
    return a @ b if a.dtype == torch.float32 else torch.mm(a, b, out_dtype=torch.float32)


def _main_step_row(rows: list) -> dict:
    return next(r for r in rows if (r["B"], r["types"]) == (16, "bf16_xw"))


def check_gru_geometry() -> list:
    """The built source's launch plan (``layernorm_gru_geometry``) against the wrapper's
    restatement at every ``KERNEL_SHAPES`` row, and ``cudaOccupancyMaxActiveClusters`` of
    the backward's clusters in each type beside the clusters its grid holds."""
    from sheeprl_tpu_torch.benchmarks.gru_kernel_ab import KERNEL_SHAPES
    from sheeprl_tpu_torch.ops.gru import geometry, kernel_geometry, max_active_clusters

    out = []
    for batch, hidden in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            c_geo, py_geo = kernel_geometry(batch, hidden), geometry(batch, hidden)
            if c_geo != py_geo:
                raise AssertionError(f"layernorm_gru geometry {batch}x{hidden} {dtype}: source {c_geo} != wrapper {py_geo}")
            row = {
                "B": batch, "H": hidden, "dtype": str(dtype).replace("torch.", ""), **c_geo,
                "clusters": c_geo["bwd_grid"] // c_geo["cluster"], "max_active_clusters": max_active_clusters(batch, hidden, dtype),
            }
            if row["max_active_clusters"] < 1:
                raise AssertionError(f"layernorm_gru geometry {batch}x{hidden} {dtype}: no cluster of {c_geo['cluster']} fits the card")
            log("[kernels] layernorm_gru geometry " + json.dumps(row))
            out.append(row)
    return out


def check_step_geometry() -> list:
    """The built source's launch geometry (``rssm_step_geometry``) against the wrapper's
    restatement at every ``STEP_SHAPES`` row, and ``cudaOccupancyMaxActiveClusters`` of
    the forward's clusters beside the clusters its grid holds."""
    from sheeprl_tpu_torch.benchmarks.step_kernel_ab import STEP_SHAPES, STEP_TYPES
    from sheeprl_tpu_torch.ops.rssm_step import geometry, kernel_geometry, max_active_clusters

    out = []
    for batch, k, hidden in STEP_SHAPES:
        for types, (ti, th, tg) in STEP_TYPES.items():
            itemsize = torch.empty((), dtype=ti).element_size()
            c_geo, py_geo = kernel_geometry(batch, k, hidden, itemsize), geometry(batch, k, hidden, itemsize)
            if c_geo != py_geo:
                raise AssertionError(f"rssm_step geometry {batch}x{k}x{hidden} {types}: source {c_geo} != wrapper {py_geo}")
            row = {
                "B": batch, "types": types, "grid": [c_geo["col_blocks"], c_geo["slices"], c_geo["groups"]],
                "cluster": c_geo["slices"], "clusters": c_geo["col_blocks"] * c_geo["groups"],
                "max_active_clusters": max_active_clusters(batch, k, hidden, ti),
                "fwd_smem": c_geo["fwd_smem"], "prod_blocks": c_geo["prod_blocks"], "prod_smem": c_geo["prod_smem"],
            }
            log("[kernels] rssm_step geometry " + json.dumps(row))
            out.append(row)
    return out


def phase_kernels_step(device: torch.device) -> dict:
    """K2-fwd against its plain version on the same inputs, at ``STEP_SHAPES`` in each of
    ``STEP_TYPES``; the tolerance is that of the output's type (h's). Two calls must give
    the same bits."""
    from sheeprl_tpu_torch.benchmarks.step_kernel_ab import STEP_SHAPES, STEP_TYPES, step_operands, typed
    from sheeprl_tpu_torch.ops.rssm_step import gru_step, gru_step_reference

    set_tf32(False)
    gen = torch.Generator(device=device).manual_seed(2)
    rows, worst = [], 0.0
    for batch, k, hidden in STEP_SHAPES:
        ops = step_operands(batch, k, hidden, device, gen)
        for types, (ti, th, tg) in STEP_TYPES.items():
            args, _ = typed(ops, types)
            h = args[1]
            with torch.inference_mode():
                out = gru_step(*args)
                again = gru_step(*args)
                torch.cuda.synchronize()
                _same_bits([out], [again], f"rssm_step {batch}x{k}x{hidden} {types}")
                err = (out.float() - gru_step_reference(*args).float()).abs().max().item()
                tol = STEP_TOL[th][0]
                if not (out.dtype == th and out.shape == h.shape and math.isfinite(err) and err <= tol):
                    raise AssertionError(f"rssm_step {batch}x{k}x{hidden} {types}: max_abs_err {err} > {tol}")
                # xh, w, h, gamma and beta read, h' written; the product (2 B K 3H, on the
                # tensor cores in bf16) beside the LayerNorm-GRU's 39 operations per unit
                nbytes = sum(t.numel() * t.element_size() for t in args) + out.numel() * out.element_size()
                mm = 2 * batch * k * 3 * hidden
                row = _step_row(
                    batch, k, hidden, types, err, tol, lambda: gru_step(*args), lambda: gru_step_reference(*args),
                    lambda: _f32_product(args[0], args[2]), nbytes,
                    GRU_OPS_PER_UNIT * batch * hidden + (mm if ti == torch.float32 else 0), mm if ti == torch.bfloat16 else 0,
                )
            log("[kernels] rssm_step " + json.dumps(row))
            rows.append(row)
            if th == torch.float32:
                worst = max(worst, err)
    return {"rows": rows, "max_abs_err_f32": worst, "main": _main_step_row(rows)}


def phase_kernels_step_bwd(device: torch.device) -> dict:
    """K2-bwd against autograd through the plain forward on the same values in float32,
    at ``STEP_SHAPES`` in each of ``STEP_TYPES``; each gradient is held to its own type's
    tolerance. The backward runs from the forward's saved projection, as autograd (and
    the scan) calls it; two calls must give the same bits."""
    from sheeprl_tpu_torch.benchmarks.step_kernel_ab import STEP_SHAPES, STEP_TYPES, step_operands, typed
    from sheeprl_tpu_torch.ops.rssm_step import gru_step_backward, gru_step_backward_reference, gru_step_forward

    set_tf32(False)
    gen = torch.Generator(device=device).manual_seed(3)
    rows, worst = [], 0.0
    for batch, k, hidden in STEP_SHAPES:
        ops = step_operands(batch, k, hidden, device, gen)
        ref = gru_step_backward_reference(*ops)
        for types, (ti, th, tg) in STEP_TYPES.items():
            five, g = typed(ops, types)
            args = (*five, g)
            proj = gru_step_forward(*five)[1]
            out = gru_step_backward(*args, proj)
            again = gru_step_backward(*args, proj)
            torch.cuda.synchronize()
            _same_bits(out, again, f"rssm_step_bwd {batch}x{k}x{hidden} {types}")
            want = [ti, th, ti, tg, tg]
            if [o.dtype for o in out] != want:
                raise AssertionError(f"rssm_step_bwd {batch}x{k}x{hidden} {types}: gradient types {[o.dtype for o in out]}, expected {want}")
            lo = torch.float32 if types == "float32" else torch.bfloat16
            err, over, tol = 0.0, [], {}
            for name, o, r in zip(("dxh", "dh", "dw", "dgamma", "dbeta"), out, ref):
                e = (o.float() - r).abs().max().item()
                tol[name] = step_bwd_atol(lo, batch, name not in ("dxh", "dh"))
                if not e <= tol[name]:
                    over.append(f"{name} max_abs_err {e} > {tol[name]}")
                err = max(err, e)
            if over:
                raise AssertionError(f"rssm_step_bwd {batch}x{k}x{hidden} {types}: {over}")
            # xh, h, w, gamma, beta and g read; dxh, dh, dw, dgamma and dbeta written; the
            # two products of dp (2 x 2 B K 3H) beside the LayerNorm-GRU backward's 81
            # operations per unit
            nbytes = 2 * sum(t.numel() * t.element_size() for t in five) + g.numel() * g.element_size()
            mm = 2 * 2 * batch * k * 3 * hidden
            dp = torch.randn(batch, 3 * hidden, device=device, generator=torch.Generator(device=device).manual_seed(4)).to(ti)
            row = _step_row(
                batch, k, hidden, types, err, tol, lambda: gru_step_backward(*args, proj),
                lambda: gru_step_backward_reference(*args), lambda: (dp @ args[2].T, args[0].T @ dp), nbytes,
                GRU_BWD_OPS_PER_UNIT * batch * hidden + (mm if ti == torch.float32 else 0), mm if ti == torch.bfloat16 else 0,
            )
            log("[kernels] rssm_step_bwd " + json.dumps(row))
            rows.append(row)
            if types == "float32":
                worst = max(worst, err)
    return {"rows": rows, "max_abs_err_f32": worst, "main": _main_step_row(rows)}


def phase_rssm_scan(device: torch.device) -> dict:
    """The fused step's path: the port's ``fused_step_bench`` at size S in bf16. Checks
    each variant's launches per scan and holds ``post_fused``'s and ``full_fused``'s
    states and gradient to ``plain``'s (``RSSM_SCAN_TOL``)."""
    from sheeprl_tpu_torch.benchmarks.fused_step_bench import run
    from sheeprl_tpu_torch.ops.counters import launch_counts

    set_tf32(False)  # as PyTorch's default: the plain scan's float32 products stay float32
    T, B = 64, 16
    zero_launches()
    line, outputs = run(T, B, 512, 512, device)
    total = launch_counts()
    zero = {"rssm_step": 0, "rssm_step_bwd": 0, "layernorm_gru": 0, "layernorm_gru_bwd": 0}
    want = {
        "plain": zero,
        "post_fused": {**zero, "layernorm_gru": T, "layernorm_gru_bwd": T},
        "full_fused": {**zero, "rssm_step": T, "rssm_step_bwd": T},
    }
    bad = [f"{n}: {line[n]['launches_per_scan']} per scan, expected {want[n]}" for n in want if line[n]["launches_per_scan"] != want[n]]
    hs_p, dw_p = (t.float() for t in outputs["plain"])
    if hs_p.shape != (T, B, 512) or not (torch.isfinite(hs_p).all() and torch.isfinite(dw_p).all()):
        bad.append(f"plain: states {tuple(hs_p.shape)}, finite {bool(torch.isfinite(hs_p).all())}, dw finite {bool(torch.isfinite(dw_p).all())}")
    agree = {}
    for name in ("post_fused", "full_fused"):
        hs_v, dw_v = (t.float() for t in outputs[name])
        agree[name] = {"dw_rel": ((dw_v - dw_p).norm() / dw_p.norm()).item(), "hs_diff": (hs_v - hs_p).abs().max().item()}
        if not agree[name]["dw_rel"] <= RSSM_SCAN_TOL["dw_rel"] or not agree[name]["hs_diff"] <= RSSM_SCAN_TOL["hs_atol"]:
            bad.append(f"{name} against plain: dw relative norm {agree[name]['dw_rel']}, states max abs diff {agree[name]['hs_diff']} ({RSSM_SCAN_TOL})")
    log("[rssm-scan] " + json.dumps(line))
    log(f"[rssm-scan] {json.dumps(line['shape'])}: "
        + "; ".join(f"{n} {line[n]['ms_per_scan']:.3f} ms eager, {line[n]['device_ms_per_scan']:.3f} ms device ({line[n]['device_ms_source']})" for n in want)
        + "".join(f"; {n} vs plain: dw relative norm {a['dw_rel']:.3e}, states max abs diff {a['hs_diff']:.3e}" for n, a in agree.items())
        + f"; launches in the phase {json.dumps(total)}")
    if bad:
        raise AssertionError(f"rssm-scan: {bad}")
    return {"line": line, "launches": total, "agree": agree}


def _s_config(extra=()):
    from sheeprl_tpu_torch.config.core import compose

    return compose(overrides=[*S_OVERRIDES, *extra])


def _algo_package(name: str) -> str:
    """The package of an algorithm's modules: ``p2e_dv2`` for ``p2e_dv2_exploration``."""
    return name.rsplit("_", 1)[0] if name.startswith("p2e_") else name


def _train_parts(cfg, device: torch.device, seed: int):
    """``(actions_dim, modules, make)`` of ``cfg``'s algorithm (any Dreamer or P2E
    entry): its modules by their checkpoint names, built on ``device`` from ``seed`` in
    its ``mesh.precision``, and ``make(modules) -> (step, init)``, its train step over a
    set of such modules (image key ``rgb``), of one call shape for every algorithm."""
    import importlib

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import parse_actions_dim
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, None)()
    is_continuous, actions_dim = parse_actions_dim(env.action_space)
    obs_space = env.observation_space
    env.close()
    ctx = RunContext(device, seed, compute_dtype=compute_dtype(cfg.mesh.precision))
    name, pkg = cfg.algo.name, _algo_package(cfg.algo.name)
    built = importlib.import_module(f"sheeprl_tpu_torch.algos.{pkg}.agent").build_agent(ctx, actions_dim, is_continuous, cfg, obs_space)
    train = importlib.import_module(f"sheeprl_tpu_torch.algos.{pkg}.{name}")
    if pkg.startswith("p2e_"):
        return actions_dim, built[0], lambda mods: train.make_train_step(mods, cfg, ["rgb"], [])
    modules = dict(zip(("world_model", "actor", "critic", "target_critic"), built[:-1]))
    return actions_dim, modules, lambda mods: train.make_train_step(*mods.values(), cfg, ["rgb"], [])


def _lr(cfg, module: str) -> float:
    """The learning rate of the optimizer that trains ``module`` (a target critic: its
    critic's)."""
    a = cfg.algo
    if module in ("world_model", "ensembles"):
        return a[module].optimizer.lr
    return (a.actor if module.startswith("actor") else a.critic).optimizer.lr


def _is_continuous(modules: dict) -> bool:
    return (modules.get("actor") or modules["actor_task"]).is_continuous


def phase_agreement(device: torch.device, steps: int = 4, batch: int = 2) -> float:
    """The size-S player on ``device`` against the same agent on the CPU (plain GRU
    path), fed the same observations and the same one-hot draws, in float32."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, make_player_step

    set_tf32(False)
    cfg = _s_config(["device=cpu", "mesh.precision=32-true"])
    actions_dim, modules, _ = _train_parts(cfg, torch.device("cpu"), seed=11)
    wm, actor = modules["world_model"], modules["actor"]
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
    log(f"[agreement] size-S player at mesh.precision=32-true, {steps} steps x {batch} envs, {device} vs cpu: "
        f"max_abs_diff {worst:.3e} (atol=rtol=1e-3)")
    return worst


def phase_eval(device: torch.device, workdir: Path) -> dict:
    """The slice's main path: the eval entry on a size-S checkpoint."""
    import sheeprl_tpu_torch.algos.dreamer_v3.evaluate as dv3_eval
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate
    from sheeprl_tpu_torch.config.core import save_config

    set_tf32(True)  # the config's float32_matmul_precision=high sets the same for matmuls
    cfg = _s_config([f"device={device.type}"])
    _, modules, _ = _train_parts(cfg, device, seed=cfg.seed)
    params = {name: m.state_dict() for name, m in modules.items()}
    n_params = sum(v.numel() for sd in params.values() for v in sd.values())
    save_config(cfg, workdir / "run" / "config.yaml")
    ckpt = CheckpointManager(workdir / "run" / "checkpoints").save(1, {"params": params})
    del modules, params

    built = []
    real_build = dv3_eval.build_agent

    def spy(*args, **kwargs):
        out = real_build(*args, **kwargs)
        built.extend(out[:4])
        return out

    dv3_eval.build_agent = spy
    try:
        zero_launches()
        result = evaluate(
            [
                f"checkpoint_path={ckpt}",
                "env.capture_video=False",
                f"env.wrapper.n_steps={EPISODE_STEPS}",
                f"log_root={workdir / 'logs'}",
            ]
        )
        fwd_launches, bwd_launches = launches()
    finally:
        dv3_eval.build_agent = real_build
    tensors = [t for m in built for t in (*m.parameters(), *m.buffers())]
    if not tensors or any(t.device.type != device.type for t in tensors):
        raise AssertionError("the evaluated agent is not on the card")
    if result.steps != EPISODE_STEPS + 1 or fwd_launches != result.steps or bwd_launches != 0:
        raise AssertionError(f"eval: {result.steps} player steps, {fwd_launches} forward and {bwd_launches} backward launches")
    if not (math.isfinite(result.reward) and result.reward == 0.0):
        raise AssertionError(f"eval: reward {result.reward} (the dummy env pays 0)")
    sps = result.steps / result.seconds
    log(f"[eval] DreamerV3-S ({n_params} parameters) on {device} at mesh.precision={cfg.mesh.precision}: reward "
        f"{result.reward}, {result.steps} player steps, {sps:.1f} player steps/s, layernorm_gru launches {fwd_launches}")
    return {"launches": fwd_launches, "steps": result.steps, "steps_per_s": sps, "devices": {t.device for t in tensors}}


def phase_batched(device: torch.device, n_envs: int = 16, steps: int = 64) -> dict:
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState, make_player_step

    set_tf32(True)
    cfg = _s_config([f"device={device.type}"])
    actions_dim, modules, _ = _train_parts(cfg, device, seed=3)
    wm, actor = modules["world_model"], modules["actor"]
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
        zero_launches()
        start = time.perf_counter()
        for t in range(steps):
            actions, _, state = step(state, {k: v[t] for k, v in obs.items()}, is_first, gen)
            is_first = torch.zeros(n_envs, 1, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        fwd_launches = launches()[0]
    if fwd_launches != steps:
        raise AssertionError(f"batched player: {fwd_launches} kernel launches for {steps} steps")
    if not (torch.isfinite(state.recurrent_state).all() and actions[0].shape == (n_envs, actions_dim[0])):
        raise AssertionError("batched player: non-finite state or wrong action shape")
    log(f"[batched] {n_envs} envs x {steps} steps: {steps / seconds:.1f} player steps/s ({n_envs * steps / seconds:.1f} env steps/s), "
        f"layernorm_gru launches {fwd_launches}")
    for rows in (1, n_envs):  # one player step per call, observations on the card
        box = [PlayerState(*(t[:rows] for t in state))]
        frames = iter(range(steps))
        is_first = torch.zeros(rows, 1, device=device)

        def one_step():
            t = next(frames)
            box[0] = step(box[0], {k: v[t, :rows] for k, v in obs.items()}, is_first, gen)[2]

        with torch.inference_mode():
            profile_calls(one_step, min(16, steps), "player step", {"envs": rows})
    return {"launches": fwd_launches, "steps_per_s": steps / seconds}


def profile_calls(fn, calls: int, label: str, extra: dict) -> dict:
    """Where ``calls`` calls of ``fn`` spend their time on the card, under
    ``torch.profiler``: kernels, device time and wall time per call (profiler overhead
    included), the device's busy share, the LayerNorm-GRU kernels' share and the
    kernels that take most device time. Printed as ``[profile] <label> {...}``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / calls
    kernels = device_events(prof)
    device_ms = sum(us for _, us in kernels) / 1e3 / calls
    if not kernels or device_ms <= 0:
        log(f"[profile] {label}: device time not measured (the profiler recorded no CUDA kernels)")
        return {}
    by_name = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / calls
    out = {
        **extra,
        "calls": calls,
        "kernels_per_call": len(kernels) / calls,
        "device_ms_per_call": device_ms,
        "wall_ms_per_call": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "layernorm_gru_ms_per_call": {k[:60]: v for k, v in by_name.items() if "layernorm_gru" in k},
        "top_kernels_ms_per_call": [[name[:80], ms] for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]],
    }
    log(f"[profile] {label} " + json.dumps(out))
    return out


def _train_batch(cfg, actions_dim, device: torch.device, gen: torch.Generator) -> dict:
    """A seeded ``[T, B]`` replay batch on ``device``: rgb frames, one-hot actions,
    rewards, a few terminations and episode starts."""
    T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
    n = int(sum(actions_dim))
    u = lambda *shape: torch.rand(*shape, generator=gen, device=device)  # noqa: E731
    return {
        "rgb": torch.randint(0, 256, (T, B, 3, 64, 64), generator=gen, device=device, dtype=torch.uint8),
        "actions": torch.nn.functional.one_hot(torch.randint(0, n, (T, B), generator=gen, device=device), n).float(),
        "rewards": torch.randn(T, B, 1, generator=gen, device=device),
        "terminated": (u(T, B, 1) < 0.01).float(),
        "truncated": torch.zeros(T, B, 1, device=device),
        "is_first": (u(T, B, 1) < 0.02).float(),
    }


def phase_train_agreement(device: torch.device, overrides=SMALL_TRAIN, label: str = "[train-agreement]") -> dict:
    """One training step of a small agent on the card against the same step on the CPU:
    same weights, batch and draws, float32, TF32 off."""
    from sheeprl_tpu_torch.config.core import compose

    set_tf32(False)
    cfg = compose(overrides=[*overrides, "device=cpu"])
    actions_dim, cpu_modules, make = _train_parts(cfg, torch.device("cpu"), seed=21)
    dev_modules = {k: copy.deepcopy(m).to(device) for k, m in cpu_modules.items()}
    gen = torch.Generator().manual_seed(4)
    batch = _train_batch(cfg, actions_dim, torch.device("cpu"), gen)
    T, B = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size
    draws = None
    results = []
    for modules, dev in ((cpu_modules, torch.device("cpu")), (dev_modules, device)):
        step, init = make(modules)
        if draws is None:
            draws = step.sample_draws(T, B, gen, torch.device("cpu"))
        opt = init()
        moved = type(draws)(*(tuple(t.to(dev) for t in d) if isinstance(d, tuple) else d.to(dev) for d in draws))
        _, metrics = step(opt, step.init_extra(), {k: v.to(dev) for k, v in batch.items()}, True, draws=moved)
        results.append((modules, opt, metrics))
    torch.cuda.synchronize()
    (cm, copt, cmet), (dm, dopt, dmet) = results
    tol = TRAIN_AGREEMENT_TOL
    # both start from the same weights, so the difference of the two parameter changes is
    # that of the new parameters; per module: its largest entry over lr, and the share of
    # entries off by more than the limit
    steps = {}
    for name in cm:
        lr, sa, sb = _lr(cfg, name), cm[name].state_dict(), dm[name].state_dict()
        diff = torch.cat([(sb[k].float().cpu() - sa[k].float()).abs().flatten() for k in sa])
        steps[name] = ((diff.max() / lr).item(), (diff > tol["step_of_lr"] * lr).float().mean().item())
    cflat, dflat = _flat_opt(cm, copt), _flat_opt(dm, dopt)
    leaves = {name: [k for k, _ in module.named_parameters()] for name, (module, _) in cflat.items()}
    moments = {}  # per moment: the leaf whose card value lies furthest from the CPU's, by relative norm
    for key in ("mu", "nu"):
        moments[key] = max(
            (((q.cpu() - p).norm() / p.norm().clamp_min(1e-30)).item(), f"{name}.{leaf}", p.norm().item())
            for name in leaves for leaf, p, q in zip(leaves[name], cflat[name][1][key], dflat[name][1][key])
        )
    rel_moment = max(rel for rel, _, _ in moments.values())
    metrics = {k: (cmet[k].item(), dmet[k].item()) for k in cmet if k.startswith(("Loss/", "Grads/"))}
    bad = [k for k, (c, d) in metrics.items() if abs(c - d) > tol["metrics_atol"] + tol["metrics_rtol"] * abs(c)]
    bad += [f"{k} change" for k, (_, share) in steps.items() if share > tol["off_share"]]
    if rel_moment > tol["moments_rtol"]:
        bad.append(f"Adam moments {rel_moment}")
    if not all(torch.isfinite(v).all() for v in dmet.values()):
        bad.append("non-finite metrics")
    log(f"{label} small {cfg.algo.name} agent, one step at mesh.precision=32-true, TF32 off, {device} vs cpu: parameter change "
        "(max |card - cpu| / lr, share > " + f"{tol['step_of_lr']} lr) " + json.dumps(steps) + f" (share <= {tol['off_share']}); "
        "Adam moments, the leaf furthest off (relative norm diff, leaf, its norm) " + json.dumps(moments)
        + f" (<= {tol['moments_rtol']}); metrics (cpu, card) " + json.dumps(metrics)
        + f" (rtol {tol['metrics_rtol']}, atol {tol['metrics_atol']})")
    if bad:
        raise AssertionError(f"{label}: the card's training step disagrees with the CPU's: {bad}")
    return {"steps": steps, "moments": moments, "metrics": metrics}


def phase_minedojo_actor(device: torch.device, rows: int = 1024) -> dict:
    """Both MineDojo actors on the card against the CPU, at float32 with TF32 off:
    DreamerV3-S's (latent 1536, dense 512 x 2) and DreamerV2's widths (latent 1624, dense
    400 x 4, ELU) over ``rows`` latents, ``MINEDOJO_HEADS``, synthetic masks (each entry
    allowed with probability 1/2, one allowed at least) and injected Gumbel draws: the
    same sampled one-hots, each head's logits within atol = rtol = 1e-3, every sample
    within its masks."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import MinedojoActorV2, xavier_normal_init
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import MinedojoActor, flax_default_init

    set_tf32(False)
    gen = torch.Generator().manual_seed(12)
    out = {}
    for name, actor, init in (
        ("MinedojoActor", MinedojoActor(1536, MINEDOJO_HEADS, False, dense_units=512, mlp_layers=2), flax_default_init),
        ("MinedojoActorV2", MinedojoActorV2(1624, MINEDOJO_HEADS, False, dense_units=400, mlp_layers=4), xavier_normal_init),
    ):
        init(actor, gen)
        latent = torch.randn(rows, actor.mlp.dense[0].in_features, generator=gen)
        masks = {}
        for key, n in zip(("mask_action_type", "mask_craft_smelt", "mask_equip_place", "mask_destroy"), (*MINEDOJO_HEADS, MINEDOJO_HEADS[2])):
            m = torch.rand(rows, n, generator=gen) < 0.5
            m[torch.arange(rows), torch.randint(0, n, (rows,), generator=gen)] = True
            masks[key] = m
        # a quarter of the rows each: craft, equip, place, destroy allowed alone, so that
        # every argument mask is read
        masks["mask_action_type"][: rows // 4] = torch.nn.functional.one_hot(
            torch.tensor([15, 16, 17, 18]).repeat_interleave(rows // 16), MINEDOJO_HEADS[0]
        ).bool()
        gumbels = tuple(-torch.log(-torch.log(torch.rand(rows, d, generator=gen).clamp_min(1e-20))) for d in MINEDOJO_HEADS)
        card = copy.deepcopy(actor).to(device)
        with torch.inference_mode():
            acts_c, dists_c = actor(latent, mask=masks, gumbels=gumbels)
            acts_d, dists_d = card(latent.to(device), mask={k: v.to(device) for k, v in masks.items()}, gumbels=tuple(g.to(device) for g in gumbels))
            torch.cuda.synchronize()
        worst = 0.0
        for i, (a, b, dc, dd) in enumerate(zip(acts_c, acts_d, dists_c, dists_d)):
            if not torch.equal(a.argmax(-1), b.argmax(-1).cpu()):
                raise AssertionError(f"[minedojo-actor] {name} head {i}: the card sampled other actions")
            torch.testing.assert_close(dd.logits.cpu(), dc.logits, atol=1e-3, rtol=1e-3, msg=lambda m: f"[minedojo-actor] {name} head {i}: {m}")
            finite = torch.isfinite(dc.logits) & (dc.logits > torch.finfo(torch.float32).min / 2)
            worst = max(worst, (dd.logits.cpu() - dc.logits)[finite].abs().max().item())
        kind = acts_d[0].argmax(-1).cpu()
        allowed = masks["mask_action_type"].gather(1, kind[:, None]).all()
        craft = masks["mask_craft_smelt"].gather(1, acts_d[1].argmax(-1).cpu()[:, None])[kind == 15].all()
        equip = masks["mask_equip_place"].gather(1, acts_d[2].argmax(-1).cpu()[:, None])[(kind == 16) | (kind == 17)].all()
        destroy = masks["mask_destroy"].gather(1, acts_d[2].argmax(-1).cpu()[:, None])[kind == 18].all()
        if not (allowed and craft and equip and destroy):
            raise AssertionError(f"[minedojo-actor] {name}: a sample outside its masks ({allowed}, {craft}, {equip}, {destroy})")
        out[name] = {"rows": rows, "heads": list(MINEDOJO_HEADS), "max_abs_diff_logits": worst}
    log("[minedojo-actor] card vs cpu, float32, TF32 off, injected Gumbel draws, synthetic masks: " + json.dumps(out))
    return out


def phase_train(device: torch.device, precision: str, env: str = "discrete_dummy", steps: int = 8, warmup: int = 2) -> dict:
    """The size-S training step on the card at the config's matmul precision (TF32):
    steps/s, the kernels' launches per step (checked), peak memory, and one profiled
    step."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config.core import compose

    set_tf32(True)
    cfg = compose(overrides=[*TRAIN_OVERRIDES, f"env={env}", f"mesh.precision={precision}", "device=cuda"])
    actions_dim, modules, make = _train_parts(cfg, device, seed=31)
    is_continuous = _is_continuous(modules)
    step, init = make(modules)
    gen = torch.Generator(device=device).manual_seed(6)
    batch = _train_batch(cfg, actions_dim, device, gen)
    if is_continuous:
        batch["actions"] = torch.rand(*batch["actions"].shape[:2], int(sum(actions_dim)), generator=gen, device=device) * 2 - 1
    opt, moments = init(), init_moments(device)
    T, H = cfg.algo.per_rank_sequence_length, cfg.algo.horizon
    for _ in range(warmup):
        moments, metrics = step(opt, moments, batch, True, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    zero_launches()
    start = time.perf_counter()
    for _ in range(steps):
        moments, metrics = step(opt, moments, batch, True, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    fwd, bwd = launches()
    want = (steps * (T + H), steps * (T + H if is_continuous else T))
    if (fwd, bwd) != want:
        raise AssertionError(f"train {precision} {env}: launches (fwd, bwd) = {(fwd, bwd)}, expected {want}")
    if not all(math.isfinite(v.item()) for v in metrics.values()):
        raise AssertionError(f"train {precision} {env}: non-finite metrics {metrics}")
    peak = torch.cuda.max_memory_allocated(device)
    row = {
        "precision": precision,
        "actor": "continuous" if is_continuous else "discrete",
        "grad_steps_per_s": steps / seconds,
        "fwd_launches_per_step": fwd / steps,
        "bwd_launches_per_step": bwd / steps,
        "peak_memory_bytes": peak,
        "losses": {k: v.item() for k, v in metrics.items() if k.startswith("Loss/")},
    }
    log("[train] DreamerV3-S B16xT64 H15 " + json.dumps(row))
    if not is_continuous:
        row["profile"] = profile_calls(lambda: step(opt, moments, batch, True, generator=gen), 1, "train step", {"precision": precision})
    return row


def k1_launches(names: list) -> dict:
    """K1 launches among the profiled kernel ``names``: forward kernels, backward kernels
    (one per backward call) and the two-launch plan's sum kernels."""
    return {
        "fwd": sum("layernorm_gru_fwd" in n for n in names),
        "bwd": sum("layernorm_gru_bwd" in n and "bwd_sum" not in n for n in names),
        "bwd_sum": sum("layernorm_gru_bwd_sum" in n for n in names),
    }


def _profiled_k1(fn, calls: int, want: dict | None = None) -> dict | None:
    """K1 launches per call of ``fn`` by ``torch.profiler`` (``read_launches``); None
    where it saw no kernel. The profiler has also been seen to drop launches from inside
    a step of ~12,000 kernels (an H100: 78 of 80 forward), so a reading under the plan is
    profiled again."""
    return read_launches(fn, calls, k1_launches, want, "K1")


def _param_diffs(ma: dict, mb: dict) -> dict:
    """Per module: every |a - b| of its parameters, flat."""
    return {
        name: torch.cat([(x.float() - y.float()).abs().flatten() for x, y in zip(ma[name].state_dict().values(), mb[name].state_dict().values())])
        for name in ma
    }


def _opt_items(opt_states: dict):
    """``(name, state)`` for every optimizer of a step; P2E-DV3's exploration critics
    (``critics_exploration``, one state per critic) as ``critics_exploration.<critic>``."""
    for name, state in opt_states.items():
        if "count" in state:
            yield name, state
        else:
            yield from ((f"{name}.{k}", s) for k, s in state.items())


def _flat_opt(modules: dict, opt_states: dict) -> dict:
    """``{name: (module, optimizer state)}`` over ``_opt_items``."""
    out = {}
    for name, state in _opt_items(opt_states):
        top, _, critic = name.partition(".")
        out[name] = (modules[top][critic]["module"] if critic else modules[top], state)
    return out


def _moment_diff(oa: dict, ob: dict) -> float:
    """The largest relative-norm difference of any Adam moment leaf."""
    sa, sb = dict(_opt_items(oa)), dict(_opt_items(ob))
    return max(
        ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        for name in sa for key in ("mu", "nu") for a, b in zip(sa[name][key], sb[name][key])
    )


def k1_per_step(cfg, is_continuous: bool) -> dict:
    """K1 launches a training step makes, by the kernels' plan (``ops/gru.py::geometry``):
    the forward at every unroll step and every step of each imagination (P2E-DV2's and
    P2E-DV3's exploration steps imagine twice, for the exploration and the task actor); the
    backward at every unroll step, and at every step of an imagination that the
    gradient crosses: DreamerV3's (and P2E-DV3 finetuning's) with a continuous actor,
    DreamerV2's (and P2E-DV2 finetuning's) always, its dynamics term, each of the P2E-DV2
    and P2E-DV3 exploration steps' with a continuous actor only (a discrete one's
    objective is REINFORCE on the stopped trajectory); a second (sum) launch for each
    backward whose plan is two launches (every one at H = 4096). The decoupled RSSM
    unrolls the same T prior steps.
    DreamerV1 and P2E-DV1 step a plain GRU: no K1."""
    from sheeprl_tpu_torch.ops.gru import geometry

    name = cfg.algo.name
    if name.startswith(("dreamer_v1", "p2e_dv1")):
        return {"fwd": 0, "bwd": 0, "bwd_sum": 0}
    T, B, H = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, cfg.algo.horizon
    rec = cfg.algo.world_model.recurrent_model.recurrent_state_size
    imaginations = 2 if name in ("p2e_dv2_exploration", "p2e_dv3_exploration") else 1
    if name in ("dreamer_v2", "p2e_dv2_finetuning"):
        imag_bwd = H
    else:
        imag_bwd = imaginations * H if is_continuous else 0
    two = lambda rows: geometry(rows, rec)["bwd_launches"] - 1  # noqa: E731
    return {"fwd": T + imaginations * H, "bwd": T + imag_bwd, "bwd_sum": T * two(B) + imag_bwd * two(T * B)}


def phase_train_graph(
    device: torch.device, env: str = "discrete_dummy", timed_steps: int = 8, overrides=TRAIN_OVERRIDES, tag: str = "[train-graph]",
    health_turn: bool = False,
) -> dict:
    """The train step of ``overrides`` (DreamerV3-S by default) captured as a CUDA graph
    (``utils/graphs.py``) and replayed through the loop's block (``utils/blocks.py``),
    against the eager step, at bf16-mixed. From the same weights, batches and draws (a
    generator seeded alike), 4 graphed steps against 4 eager steps, twice eager:
    parameters, Adam moments and losses within the spread of the two eager runs
    (``GRAPH_SPREAD``), and never looser than ``TRAIN_AGREEMENT_TOL``. K1 launches per
    replay by the profiler, equal to the eager step's, to the capture's count and to the
    plan's (``k1_per_step``). Then, discrete actor only, in turns (eager, graph, graph,
    eager): gradient steps/s, device ms and kernels per step, busy share, peak memory.
    ``health_turn``: the step (``obs.health`` on, the default) against the same step
    built with ``obs.health=False``: a replay's ``Health/*`` against the eager step's
    from the same state (bit for bit), and the device ms and kernels per step of both,
    profiled in turns (on, off, on, off)."""
    from sheeprl_tpu_torch.algos.dreamer_loop import make_captured_step
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher, target_flags

    set_tf32(True)
    cfg = compose(overrides=[*overrides, f"env={env}", "mesh.precision=bf16-mixed", "device=cuda"])
    actions_dim, modules, make = _train_parts(cfg, device, seed=31)
    is_continuous = _is_continuous(modules)
    label = f"{tag} {'continuous' if is_continuous else 'discrete'}"
    T, B, H = cfg.algo.per_rank_sequence_length, cfg.algo.per_rank_batch_size, cfg.algo.horizon
    runs = [modules] + [{k: copy.deepcopy(v) for k, v in modules.items()} for _ in range(2)]
    gen = torch.Generator(device=device).manual_seed(6)
    batches = []
    for _ in range(4):
        batch = _train_batch(cfg, actions_dim, device, gen)
        if is_continuous:
            batch["actions"] = torch.rand(T, B, int(sum(actions_dim)), generator=gen, device=device) * 2 - 1
        batches.append(batch)
    offset = 1 if cfg.algo.name == "dreamer_v3" else 0  # the target cadence's count_offset
    flags = target_flags(0, 4, 2, offset)

    if cfg.algo.name == "dreamer_v3":  # the quantile levels on the card: update_moments makes no host sync
        from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments, update_moments

        levels = torch.tensor([0.05, 0.95], device=device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            update_moments(init_moments(device), torch.randn(H, T * B, 1, device=device, generator=gen), levels=levels)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    step, init = make(modules)
    opt, extra = init(), step.init_extra()
    start = time.perf_counter()
    make_step = make_captured_step(step, modules, opt, extra, T, B, torch.Generator(device=device).manual_seed(8))
    captured, draw = make_step({"table": torch.zeros(1, dtype=torch.int64, device=device), "batch": {k: torch.zeros_like(v) for k, v in batches[0].items()}})
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - start
    dispatcher = BlockDispatcher(captured, draw, target_update_freq=2, count_offset=offset)
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    first = {k: v[:1] for k, v in stacked.items()}
    dispatcher.dispatch(stacked, 0)
    graphed = {}
    dispatcher.drain(type("Last", (), {"update": lambda self, k, v: graphed.__setitem__(k, v)})())

    eager = []
    for mods in runs[1:]:
        step_e, init_e = make(mods)
        opt_e, ext_e = init_e(), step_e.init_extra()
        g = torch.Generator(device=device).manual_seed(8)
        for i, flag in enumerate(flags):
            ext_e, met_e = step_e(opt_e, ext_e, batches[i], bool(flag), draws=step_e.sample_draws(T, B, g, device))
        eager.append((mods, opt_e, ext_e, {k: v.item() for k, v in met_e.items()}, step_e))
    torch.cuda.synchronize()
    lrs = {name: _lr(cfg, name) for name in modules}
    (m1, o1, ext1, met1, step1), (m2, o2, _, met2, _) = eager
    tol = TRAIN_AGREEMENT_TOL
    bad, params = [], {}
    d_spread, d_off = _param_diffs(m2, m1), _param_diffs(modules, m1)
    for name, lr in lrs.items():
        # an entry may lie off the first eager run by GRAPH_SPREAD x the second run's
        # largest difference (a floor for two identical eager runs), never by more than
        # [train-agreement]'s 0.1 lr; at most its share of entries may exceed that
        limit = min(GRAPH_SPREAD * d_spread[name].max().item() + GRAPH_FLOOR["params"] * lr, tol["step_of_lr"] * lr)
        share = (d_off[name] > limit).float().mean().item()
        params[name] = {"off_max_of_lr": d_off[name].max().item() / lr, "spread_max_of_lr": d_spread[name].max().item() / lr,
                        "limit_of_lr": limit / lr, "share_over_limit": share}
        if share > tol["off_share"]:
            bad.append(f"{name} parameters: {params[name]}")
    spread = {"moments": _moment_diff(o2, o1)}
    off = {"moments": _moment_diff(opt, o1)}
    losses = [k for k in met1 if k.startswith("Loss/")]
    spread["losses"] = max(abs(met2[k] - met1[k]) / max(abs(met1[k]), 1e-6) for k in losses)
    off["losses"] = max(abs(graphed[k] - met1[k]) / max(abs(met1[k]), 1e-6) for k in losses)
    if off["moments"] > min(GRAPH_SPREAD * spread["moments"] + GRAPH_FLOOR["moments"], tol["moments_rtol"]):
        bad.append(f"Adam moments {off['moments']} (eager spread {spread['moments']})")
    if off["losses"] > min(GRAPH_SPREAD * spread["losses"] + GRAPH_FLOOR["losses"], tol["metrics_rtol"]):
        bad.append(f"losses {off['losses']} (eager spread {spread['losses']})")
    if not all(math.isfinite(v) for v in graphed.values()):
        bad.append("non-finite metrics")

    # K1 launches per step: the plan's, the capture's count, the profiler's over real
    # replays and over eager steps
    want = k1_per_step(cfg, is_continuous)
    per_replay = captured.launches_per_replay
    if (per_replay.get("layernorm_gru", 0), per_replay.get("layernorm_gru_bwd", 0)) != (want["fwd"], want["bwd"]):
        bad.append(f"the capture counted {per_replay}, expected {want}")
    replay_k1 = _profiled_k1(lambda: dispatcher.dispatch(first, 4), 2, want)
    eager_k1 = _profiled_k1(lambda: step1(o1, ext1, batches[0], True, generator=gen), 1, want)
    if replay_k1 is None:
        log(f"{label}: K1 launches per replay not measured (the profiler recorded no CUDA kernels)")
    elif replay_k1 != want or eager_k1 != want:
        bad.append(f"K1 launches per step by the profiler: replay {replay_k1}, eager {eager_k1}, expected {want}")
    row = {
        "actor": "continuous" if is_continuous else "discrete", "precision": "bf16-mixed", "capture_seconds": capture_s,
        "params": params, "off": off, "eager_spread": spread, "graph_spread_factor": GRAPH_SPREAD, "floor": GRAPH_FLOOR,
        "k1_per_replay_profiler": replay_k1, "k1_per_eager_step_profiler": eager_k1, "k1_per_replay_capture": per_replay,
        "k1_per_step_plan": want,
    }
    log(label + " parity " + json.dumps(row))
    if bad:
        raise AssertionError(f"{label}: the graphed step disagrees with the eager step: {bad}")
    dispatcher.drain(None)
    if is_continuous:
        return row

    # in turns: eager, graph, graph, eager
    count = 5
    timings = []
    for mode in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start = time.perf_counter()
        if mode == "graph":
            dispatcher.dispatch({k: v.expand(timed_steps, *v.shape[1:]) for k, v in first.items()}, count)
            dispatcher.drain(None)  # the last metrics: waits for the whole chain
            count += timed_steps
        else:
            for _ in range(timed_steps):
                ext1, met_t = step1(o1, ext1, batches[0], True, generator=gen)
            torch.stack(list(met_t.values())).cpu()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(device)
        if mode == "graph":
            prof = profile_calls(lambda: dispatcher.dispatch(first, count), 1, f"{label} graph step", {"mode": "graph"})
            dispatcher.drain(None)
            count += 1
        else:
            prof = profile_calls(lambda: step1(o1, ext1, batches[0], True, generator=gen), 1, f"{label} eager step", {"mode": "eager"})
        device_ms = prof.get("device_ms_per_call")
        timings.append({
            "mode": mode, "grad_steps_per_s": timed_steps / seconds, "device_ms_per_step": device_ms,
            "kernels_per_step": prof.get("kernels_per_call"), "busy_share_profiled": prof.get("device_busy_share"),
            # the profiled step's device time over the timed (unprofiled) window's time per step
            "busy_share_timed": device_ms * timed_steps / seconds / 1e3 if device_ms else None,
            # a graphed step's activations live in the graph's private pool: reserved,
            # not allocated; the reserved bytes hold every phase's cache so far
            "peak_allocated_bytes": peak, "reserved_bytes": torch.cuda.memory_reserved(device),
        })
    row["turns"] = timings
    log(label + " turns " + json.dumps(timings))
    if health_turn:
        row["health"] = _health_turn(cfg, overrides, env, device, modules, opt, extra, captured, dispatcher, first, count + 1, label)
    return row


def _health_turn(cfg, overrides, env: str, device: torch.device, modules, opt, extra, captured, dispatcher, first, count: int, label: str) -> dict:
    """``phase_train_graph``'s health turn (its docstring). ``captured`` is the step with
    the diagnostics, last replayed by ``dispatcher`` on its inputs."""
    from sheeprl_tpu_torch.algos.dreamer_loop import make_captured_step
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    # a replay against the eager step from one state, on the inputs the block wrote last
    state = [p for m in modules.values() for p in m.parameters()] + tree_tensors(opt) + tree_tensors(extra)
    saved = [t.detach().clone() for t in state]
    replayed = {k: v.clone() for k, v in captured().items()}
    with torch.no_grad():
        torch._foreach_copy_(state, saved)
    eager = {k: v.detach().clone() for k, v in captured.fn(captured.inputs).items()}
    with torch.no_grad():
        torch._foreach_copy_(state, saved)
    torch.cuda.synchronize()
    health = sorted(k for k in replayed if k.startswith("Health/"))
    differ = [k for k in health if not torch.equal(replayed[k], eager[k])]
    losses_differ = [k for k in replayed if k.startswith("Loss/") and not torch.equal(replayed[k], eager[k])]
    out = {"health_metrics": len(health), "health_bits_differ": differ, "losses_bits_differ": losses_differ,
           "max_rel_diff": max((abs(replayed[k] - eager[k]).item() / max(abs(eager[k].item()), 1e-12) for k in health), default=0.0)}

    # the same step without the diagnostics, captured over the same batches
    cfg_off = compose(overrides=[*overrides, f"env={env}", "mesh.precision=bf16-mixed", "device=cuda", "obs.health=False"])
    _, modules_off, make_off = _train_parts(cfg_off, device, seed=31)
    step_off, init_off = make_off(modules_off)
    opt_off, extra_off = init_off(), step_off.init_extra()
    T, B = cfg_off.algo.per_rank_sequence_length, cfg_off.algo.per_rank_batch_size
    make = make_captured_step(step_off, modules_off, opt_off, extra_off, T, B, torch.Generator(device=device).manual_seed(8))
    example = {"table": torch.zeros(1, dtype=torch.int64, device=device), "batch": {k: torch.zeros_like(v[0]) for k, v in first.items()}}
    captured_off, draw_off = make(example)
    off_dispatcher = BlockDispatcher(captured_off, draw_off, target_update_freq=2, count_offset=1)
    off_dispatcher.dispatch(first, 0)
    off_dispatcher.drain(None)
    if any(k.startswith("Health/") for k in captured_off.outputs):
        raise AssertionError(f"{label}: obs.health=False still returns Health/*")
    turns = []
    for mode in ("on", "off", "on", "off"):
        d = dispatcher if mode == "on" else off_dispatcher
        prof = profile_calls(lambda: d.dispatch(first, count), 1, f"{label} health {mode}", {"health": mode})  # noqa: B023
        d.drain(None)
        count += 1
        turns.append({"health": mode, "device_ms_per_step": prof.get("device_ms_per_call"), "kernels_per_step": prof.get("kernels_per_call")})
    out["turns"] = turns
    log(label + " health " + json.dumps(out))
    if differ and not losses_differ:
        raise AssertionError(f"{label}: a replay's Health/* differ from the eager step's where its losses agree bit for bit: {differ}")
    return out


def phase_train_cli(device: torch.device, workdir: Path, device_replay: bool = False) -> dict:
    """The training loop through the train entry, at size S with the async vector env:
    train, checkpoint, resume from the checkpoint at policy step 64, evaluate the last
    checkpoint through the eval entry. The loop replays its captured train step: each
    replay launches the step's 64 backward kernels, and the capture's two warm-up steps
    launch theirs eagerly, so the backward's count is 64 x (gradient steps + 2).
    ``device_replay``: ``buffer.device=True``, the batches gathered from the ring on the
    card."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    set_tf32(True)
    tag = "[train-cli buffer.device]" if device_replay else "[train-cli]"
    overrides = [
        *TRAIN_OVERRIDES,
        f"device={device.type}",
        f"log_root={workdir / 'logs'}",
        "env.sync_env=False",
        "algo.learning_starts=128",
        "algo.total_steps=256",
        "checkpoint.every=64",
        "metric.log_every=64",
        f"buffer.device={device_replay}",
    ]
    T = 64
    out = {}
    zero_launches()
    first = run(overrides)
    fwd, bwd = launches()
    if first.grad_steps < 32 or fwd == 0 or bwd != T * (first.grad_steps + WARMUP_STEPS) or first.checkpoint is None:
        raise AssertionError(f"{tag}: {first.grad_steps} gradient steps, launches (fwd, bwd) = {(fwd, bwd)}, checkpoint {first.checkpoint}")
    out["train"] = {"grad_steps": first.grad_steps, "fwd": fwd, "bwd": bwd, "policy_steps_per_s": first.policy_steps / first.seconds,
                    "seconds": first.seconds, "train_seconds": first.train_seconds, "env_seconds": first.env_seconds}
    log(f"{tag} train: {first.policy_steps} policy steps, {first.grad_steps} gradient steps in {first.seconds:.2f} s "
        f"({first.policy_steps / first.seconds:.1f} policy steps/s; {first.train_seconds:.2f} s dispatching gradient steps, "
        f"{first.env_seconds:.2f} s acting and stepping envs), layernorm_gru launches fwd {fwd} bwd {bwd}")
    ckpts = CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints()
    mid = next(p for p in ckpts if p.name == "ckpt_64")
    zero_launches()
    resumed = run([*overrides, f"checkpoint.resume_from={mid}"])
    fwd, bwd = launches()
    if resumed.grad_steps <= 0 or bwd != T * (resumed.grad_steps + WARMUP_STEPS) or resumed.checkpoint is None:
        raise AssertionError(f"{tag} resume: {resumed.grad_steps} gradient steps, launches {(fwd, bwd)}")
    out["resume"] = {"grad_steps": resumed.grad_steps, "fwd": fwd, "bwd": bwd}
    log(f"{tag} resume from {mid.name}: {resumed.policy_steps - 64} policy steps, {resumed.grad_steps} gradient steps "
        f"in {resumed.seconds:.2f} s, layernorm_gru launches fwd {fwd} bwd {bwd}")
    zero_launches()
    start = time.perf_counter()
    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "env.capture_video=False", f"log_root={workdir / 'logs'}"])
    fwd, bwd = launches()
    if fwd != result.steps or bwd != 0 or not math.isfinite(result.reward):
        raise AssertionError(f"{tag} eval: {result.steps} steps, launches {(fwd, bwd)}, reward {result.reward}")
    out["eval"] = {"steps": result.steps, "fwd": fwd}
    log(f"{tag} eval of {Path(resumed.checkpoint).name}: reward {result.reward}, {result.steps} player steps in "
        f"{time.perf_counter() - start:.2f} s, layernorm_gru launches fwd {fwd}")
    return out


def phase_dv2_train_cli(device: torch.device, workdir: Path, buffer: str, overrides=DV2_OVERRIDES) -> dict:
    """DreamerV2's train entry at ``overrides``' widths (``DV2_CLI``'s schedule): train, checkpoint, resume from the checkpoint at policy step 128,
    evaluate the last checkpoint through the eval entry. ``buffer``: ``device``
    (``buffer.device=True``, the batches gathered from the ring on the card) or
    ``episode`` (``buffer.type=episode``, sampled on the host). The loop replays its
    captured train step: each replay launches the plan's K1 backward count
    (``k1_per_step``: the unroll's T and the imagination's horizon), and the capture's
    warm-up steps theirs eagerly, so the backward's count is that x (gradient steps + 2);
    the forward's adds the player's steps."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    set_tf32(True)
    tag = f"[dv2-train-cli {buffer}]"
    overrides = [
        *overrides, *DV2_CLI, f"device={device.type}", f"log_root={workdir / 'logs'}",
        *(["buffer.device=True"] if buffer == "device" else ["buffer.type=episode"]),
    ]
    cfg = compose(overrides=overrides)
    per_step, horizon = k1_per_step(cfg, is_continuous=False), cfg.algo.horizon
    out = {"k1_per_step": per_step}
    zero_launches()
    first = run(overrides)
    fwd, bwd = launches()
    want = per_step["bwd"] * (first.grad_steps + WARMUP_STEPS)
    if first.grad_steps < 16 or bwd != want or fwd < per_step["fwd"] * (first.grad_steps + WARMUP_STEPS) or first.checkpoint is None:
        raise AssertionError(f"{tag}: {first.grad_steps} gradient steps, launches (fwd, bwd) = {(fwd, bwd)} (bwd expected {want}), checkpoint {first.checkpoint}")
    out["train"] = {"grad_steps": first.grad_steps, "fwd": fwd, "bwd": bwd, "policy_steps_per_s": first.policy_steps / first.seconds,
                    "seconds": first.seconds, "train_seconds": first.train_seconds, "env_seconds": first.env_seconds}
    log(f"{tag} train: {first.policy_steps} policy steps, {first.grad_steps} gradient steps in {first.seconds:.2f} s "
        f"({first.policy_steps / first.seconds:.1f} policy steps/s; {first.train_seconds:.2f} s dispatching gradient steps, "
        f"{first.env_seconds:.2f} s acting and stepping envs), layernorm_gru launches fwd {fwd} bwd {bwd} = {per_step['bwd']} x "
        f"({first.grad_steps} + {WARMUP_STEPS}) (the unroll's {per_step['bwd'] - horizon} and the imagination's "
        f"{horizon} per step)")
    mid = next(p for p in CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints() if p.name == "ckpt_128")
    zero_launches()
    resumed = run([*overrides, f"checkpoint.resume_from={mid}"])
    fwd, bwd = launches()
    if resumed.grad_steps <= 0 or bwd != per_step["bwd"] * (resumed.grad_steps + WARMUP_STEPS) or resumed.checkpoint is None:
        raise AssertionError(f"{tag} resume: {resumed.grad_steps} gradient steps, launches {(fwd, bwd)}")
    out["resume"] = {"grad_steps": resumed.grad_steps, "fwd": fwd, "bwd": bwd}
    log(f"{tag} resume from {mid.name}: {resumed.policy_steps - 128} policy steps, {resumed.grad_steps} gradient steps "
        f"in {resumed.seconds:.2f} s, layernorm_gru launches fwd {fwd} bwd {bwd}")
    zero_launches()
    start = time.perf_counter()
    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "env.capture_video=False", f"log_root={workdir / 'logs'}"])
    fwd, bwd = launches()
    if fwd != result.steps or bwd != 0 or not math.isfinite(result.reward):
        raise AssertionError(f"{tag} eval: {result.steps} steps, launches {(fwd, bwd)}, reward {result.reward}")
    out["eval"] = {"steps": result.steps, "fwd": fwd}
    log(f"{tag} eval of {Path(resumed.checkpoint).name}: reward {result.reward}, {result.steps} player steps in "
        f"{time.perf_counter() - start:.2f} s, layernorm_gru launches fwd {fwd}")
    return out


def _run_counted(overrides: list, tag: str, per_step: dict, min_grad_steps: int):
    """One run of the train entry with the launch counters zeroed just before it: K1-bwd
    must equal the per-replay count x (gradient steps + the capture's warm-up steps), and
    K1-fwd at least the replays' (the player adds one a step). Returns ``(result,
    counts)``."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    zero_launches()
    result = run(overrides)
    fwd, bwd = launches()
    want = per_step["bwd"] * (result.grad_steps + WARMUP_STEPS)
    if result.grad_steps < min_grad_steps or bwd != want or fwd < per_step["fwd"] * (result.grad_steps + WARMUP_STEPS) or result.checkpoint is None:
        raise AssertionError(f"{tag}: {result.grad_steps} gradient steps, launches (fwd, bwd) = {(fwd, bwd)} (bwd expected {want}), checkpoint {result.checkpoint}")
    counts = {"grad_steps": result.grad_steps, "fwd": fwd, "bwd": bwd, "policy_steps_per_s": result.policy_steps / result.seconds,
              "seconds": result.seconds, "train_seconds": result.train_seconds, "env_seconds": result.env_seconds}
    log(f"{tag}: {result.policy_steps} policy steps, {result.grad_steps} gradient steps in {result.seconds:.2f} s "
        f"({counts['policy_steps_per_s']:.1f} policy steps/s; {result.train_seconds:.2f} s dispatching gradient steps, "
        f"{result.env_seconds:.2f} s acting and stepping envs), layernorm_gru launches fwd {fwd} bwd {bwd} = {per_step['bwd']} x "
        f"({result.grad_steps} + {WARMUP_STEPS})")
    return result, counts


def _evaluate_counted(ckpt: str, workdir: Path, tag: str, k1: bool) -> dict:
    """The eval entry on ``ckpt``: one K1-fwd a player step where the world model steps
    K1 (``k1``), none else; no K1-bwd."""
    from sheeprl_tpu_torch.cli import evaluate

    zero_launches()
    start = time.perf_counter()
    result = evaluate([f"checkpoint_path={ckpt}", "env.capture_video=False", f"log_root={workdir / 'logs'}"])
    fwd, bwd = launches()
    if fwd != (result.steps if k1 else 0) or bwd != 0 or not math.isfinite(result.reward):
        raise AssertionError(f"{tag} eval: {result.steps} steps, launches {(fwd, bwd)}, reward {result.reward}")
    log(f"{tag} eval of {Path(ckpt).name}: reward {result.reward}, {result.steps} player steps in "
        f"{time.perf_counter() - start:.2f} s, layernorm_gru launches fwd {fwd}")
    return {"steps": result.steps, "fwd": fwd}


def phase_dv1_train_cli(device: torch.device, workdir: Path) -> dict:
    """DreamerV1's train entry at its published widths (``DV1_CLI``'s schedule): train,
    checkpoint, resume from the checkpoint at policy step 128, evaluate the last
    checkpoint. Its plain GRU launches no K1."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    set_tf32(True)
    tag = "[dv1-train-cli]"
    overrides = [*DV1_OVERRIDES, *DV1_CLI, f"device={device.type}", f"log_root={workdir / 'logs'}"]
    none = {"fwd": 0, "bwd": 0, "bwd_sum": 0}
    first, out_train = _run_counted(overrides, f"{tag} train", none, 8)
    mid = next(p for p in CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints() if p.name == "ckpt_128")
    resumed, out_resume = _run_counted([*overrides, f"checkpoint.resume_from={mid}"], f"{tag} resume from {mid.name}", none, 1)
    return {"train": out_train, "resume": out_resume, "eval": _evaluate_counted(resumed.checkpoint, workdir, tag, k1=False)}


def phase_p2e_cli(device: torch.device, workdir: Path, version: int, overrides: list, schedule: list) -> dict:
    """P2E on DreamerV``version`` through the train and eval entries at ``overrides``'
    widths and ``schedule``: explore (train, checkpoint with the replay buffer, resume
    from the checkpoint at policy step 128), then finetune from the exploration
    checkpoint once without and once with ``buffer.load_from_exploration``; evaluate
    the exploration run's and each finetuning run's last checkpoint. Each run's K1-bwd
    equals its step's plan (``k1_per_step``: the exploration step's, then DreamerV2's)
    x (gradient steps + 2); DreamerV1's plain GRU launches none."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import compose

    set_tf32(True)
    tag = f"[p2e-dv{version}-cli]"
    base = [*overrides, *schedule, f"device={device.type}", f"log_root={workdir / 'logs'}", "buffer.checkpoint=True"]
    out = {}
    per_step = k1_per_step(compose(overrides=base), is_continuous=False)
    explored, out["explore"] = _run_counted(base, f"{tag} explore", per_step, 8)
    mid = next(p for p in CheckpointManager(Path(explored.log_dir) / "checkpoints").list_checkpoints() if p.name == "ckpt_128")
    _, out["explore_resume"] = _run_counted([*base, f"checkpoint.resume_from={mid}"], f"{tag} explore resume from {mid.name}", per_step, 1)
    out["explore_eval"] = _evaluate_counted(explored.checkpoint, workdir, f"{tag} explore", k1=version >= 2)
    for load in (False, True):
        tuned_args = [*base, f"algo.name=p2e_dv{version}_finetuning", f"checkpoint.exploration_ckpt_path={explored.checkpoint}", f"buffer.load_from_exploration={load}"]
        fine_step = k1_per_step(compose(overrides=tuned_args), is_continuous=False)
        tuned, out[f"finetune_load_{load}"] = _run_counted(tuned_args, f"{tag} finetune load_from_exploration={load}", fine_step, 8)
        state = CheckpointManager.load(tuned.checkpoint)
        if state.get("actor_type") != "task" or set(state["params"]) != set(CheckpointManager.load(explored.checkpoint)["params"]):
            raise AssertionError(f"{tag} finetune: actor_type {state.get('actor_type')}, modules {sorted(state['params'])}")
        out[f"finetune_load_{load}"]["k1_per_step"] = fine_step
        out[f"finetune_load_{load}_eval"] = _evaluate_counted(tuned.checkpoint, workdir, f"{tag} finetune", k1=version >= 2)
    out["k1_per_step"] = per_step
    return out


def _ppo_family(cfg, ctx, capture: bool = True):
    """``(agent, fns)`` of ``cfg``'s PPO-family algorithm on ``ctx.device``, with the
    observation and action spaces of its env."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, None)()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    keys = [*cfg.algo.cnn_keys.encoder, *cfg.algo.mlp_keys.encoder]
    if cfg.algo.name == "ppo_recurrent":
        from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
        from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainFns

        agent = build_agent(ctx, act_space, obs_space, cfg)
        return agent, lambda a, c=ctx, cap=capture: RecurrentPPOTrainFns(c, a, cfg, keys, cap), obs_space
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent

    agent = build_agent(ctx, act_space, obs_space, cfg)
    if cfg.algo.name == "a2c":
        from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainFns

        return agent, lambda a, c=ctx, cap=capture: A2CTrainFns(c, a, cfg, keys, cap), obs_space
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainFns

    return agent, lambda a, c=ctx, cap=capture: PPOTrainFns(c, a, cfg, keys, 10, cap), obs_space


def _ppo_rollout(cfg, fns, obs_space, gen: torch.Generator, device: torch.device) -> dict:
    """A rollout of ``cfg``'s size (flat ``[T * N, ...]``; recurrent: ``[T, N, ...]`` with
    the initial state): random frames and vectors, the actions the policy samples, its
    log-probs and values as it stored them (a little noise: a policy a few steps older),
    random returns and advantages. Built on ``device`` from ``gen``."""
    T, N = cfg.algo.rollout_steps, cfg.env.num_envs
    rec = cfg.algo.name == "ppo_recurrent"
    lead = (T, N) if rec else (T * N,)
    data = {}
    for k in cfg.algo.cnn_keys.encoder:
        data[k] = torch.randint(0, 256, (*lead, *obs_space[k].shape), generator=gen, device=device, dtype=torch.uint8)
    for k in cfg.algo.mlp_keys.encoder:
        data[k] = torch.randn((*lead, *obs_space[k].shape), generator=gen, device=device)
    agent = fns.agent
    with torch.no_grad():
        obs = {k: data[k] for k in [*cfg.algo.cnn_keys.encoder, *cfg.algo.mlp_keys.encoder]}
        if rec:
            from sheeprl_tpu_torch.algos.ppo_recurrent.agent import make_zero_state

            act_sum = int(sum(agent.action_dims))
            data["prev_actions"] = torch.zeros((T, N, act_sum), device=device)
            data["is_first"] = (torch.rand((T, N, 1), generator=gen, device=device) < 0.1).float()
            data["is_first"][0] = 1.0
            state = make_zero_state(cfg, device)(N)
            actor_out, values = agent(obs, data["prev_actions"], data["is_first"], state)
            data["c0"], data["h0"] = state
        else:
            actor_out, values = agent(fns.cast_obs(obs) if hasattr(fns, "cast_obs") else obs)
        from sheeprl_tpu_torch.algos.ppo.utils import log_prob_and_entropy, make_draws, sample_actions

        actions = sample_actions(actor_out, agent.is_continuous, draws=make_draws(actor_out, agent.is_continuous, gen))[1].float()
        logprob, _ = log_prob_and_entropy(actor_out, actions, agent.is_continuous)
    data["actions"] = actions
    data["logprobs"] = logprob + 0.02 * torch.randn(logprob.shape, generator=gen, device=device)
    data["values"] = values[..., 0] + 0.05 * torch.randn(logprob.shape, generator=gen, device=device)
    data["returns"] = torch.randn(logprob.shape, generator=gen, device=device)
    data["advantages"] = torch.randn(logprob.shape, generator=gen, device=device)
    return data


def _ppo_update(fns, cfg, data: dict, perms) -> dict:
    """One update of ``fns`` (PPO, A2C or recurrent PPO) over ``data``."""
    if cfg.algo.name == "a2c":
        return fns.train_fn({k: v for k, v in data.items() if k != "logprobs"})
    if cfg.algo.name == "ppo_recurrent":
        seq = {k: v for k, v in data.items() if k not in ("c0", "h0")}
        return fns.train_fn(seq, data["c0"], data["h0"], perms, 0.2, 0.01)
    return fns.train_fn(data, perms, 0.1, 0.01)


def phase_ppo_train_agreement(device: torch.device, overrides: list, label: str) -> dict:
    """One whole update of a small PPO-family agent on the card (the update captured as
    a CUDA graph) against the same update on the CPU: same weights, rollout,
    permutations and the act's draws; float32, TF32 off; ``[train-agreement]``'s limits
    (``TRAIN_AGREEMENT_TOL``) on the parameter change, the Adam or RMSProp moments and
    the losses. The act of one policy step (injected draws) must sample the same
    actions."""
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.parallel.context import RunContext

    set_tf32(False)
    cfg = compose(overrides=[*overrides, "device=cpu"])
    cpu = torch.device("cpu")
    agent_c, make_fns, obs_space = _ppo_family(cfg, RunContext(cpu, 21))
    agent_d = copy.deepcopy(agent_c).to(device)
    fns_c, fns_d = make_fns(agent_c), make_fns(agent_d, RunContext(device, 21))
    gen = torch.Generator().manual_seed(4)
    data = _ppo_rollout(cfg, fns_c, obs_space, gen, cpu)
    perms = None if cfg.algo.name == "a2c" else fns_c.permutations(gen)
    before = {k: v.clone() for k, v in agent_c.state_dict().items()}
    zero_launches()
    met_c = _ppo_update(fns_c, cfg, data, perms)
    met_d = _ppo_update(fns_d, cfg, {k: v.to(device) for k, v in data.items()}, None if perms is None else perms.to(device))
    torch.cuda.synchronize()
    counts = launch_counts()
    tol, lr = TRAIN_AGREEMENT_TOL, cfg.algo.optimizer.lr
    sd = agent_d.state_dict()
    diff = torch.cat([(sd[k].float().cpu() - v.float()).abs().flatten() for k, v in agent_c.state_dict().items()])
    moved = torch.cat([(v.float() - before[k].float()).abs().flatten() for k, v in agent_c.state_dict().items()])
    steps = {"max_of_lr": (diff.max() / lr).item(), "share_over": (diff > tol["step_of_lr"] * lr).float().mean().item(),
             "moved_max_of_lr": (moved.max() / lr).item()}
    names = [k for k, _ in agent_c.named_parameters()]
    moments = {}  # relative norm; a leaf whose gradient vanishes analytically (the attention's key bias) holds only
    for key in ("mu", "nu", "trace"):  # rounding noise: relative to at least 1e-6 of the moment's largest leaf norm
        if key in fns_c.opt_state:
            floor = 1e-6 * max(p.norm().item() for p in fns_c.opt_state[key])
            moments[key] = max(
                (((q.cpu() - p).norm() / max(p.norm().item(), floor)).item(), leaf, p.norm().item())
                for leaf, p, q in zip(names, fns_c.opt_state[key], fns_d.opt_state[key])
            )
    metrics = {k: (met_c[k], met_d[k]) for k in met_c}
    bad = [k for k, (c, d) in metrics.items() if abs(c - d) > tol["metrics_atol"] + tol["metrics_rtol"] * abs(c)]
    if steps["share_over"] > tol["off_share"]:
        bad.append(f"parameter change {steps}")
    if max(m[0] for m in moments.values()) > tol["moments_rtol"]:
        bad.append(f"moments {moments}")
    if any(counts.values()):
        bad.append(f"kernel launches {counts}")
    # one policy step on the card and on the CPU from the same observations and draws
    obs = {k: data[k][:2] if cfg.algo.name != "ppo_recurrent" else data[k][0, :2] for k in [*cfg.algo.cnn_keys.encoder, *cfg.algo.mlp_keys.encoder]}
    from sheeprl_tpu_torch.algos.ppo.utils import make_draws

    with torch.no_grad():
        if cfg.algo.name == "ppo_recurrent":
            args = (data["prev_actions"][0, :2], data["is_first"][0, :2], (data["c0"][:2], data["h0"][:2]))
            draws = make_draws(agent_c.step(obs, *args)[0], agent_c.is_continuous, gen)
            out_c = fns_c.act(obs, *args, draws=draws)[:3]
            out_d = fns_d.act({k: v.to(device) for k, v in obs.items()}, *(a.to(device) if torch.is_tensor(a) else tuple(x.to(device) for x in a) for a in args), draws=[d.to(device) for d in draws])[:3]
        else:
            draws = make_draws(agent_c(obs)[0], agent_c.is_continuous, gen)
            out_c = fns_c.act(obs, draws=draws)
            out_d = fns_d.act({k: v.to(device) for k, v in obs.items()}, draws=[d.to(device) for d in draws])
            out_c, out_d = (out_c[0], out_c[2], out_c[3]), (out_d[0], out_d[2], out_d[3])
    act_off = max((a.float() - b.float().cpu()).abs().max().item() for a, b in zip(out_c, out_d))
    if act_off > 1e-3:
        bad.append(f"act {act_off}")
    log(f"{label} small {cfg.algo.name}{' ' + cfg.algo.sequence_model if cfg.algo.name == 'ppo_recurrent' else ''}, one update at "
        f"32-true, TF32 off, {device} (captured) vs cpu: parameter change " + json.dumps(steps)
        + f" (share > {tol['step_of_lr']} lr <= {tol['off_share']}); moments, the leaf furthest off " + json.dumps(moments)
        + f" (<= {tol['moments_rtol']}); losses (cpu, card) " + json.dumps(metrics) + f"; act (actions, log-prob, value) max diff {act_off}"
        + f"; K1/K2 launches {counts}")
    if bad:
        raise AssertionError(f"{label}: the card's update disagrees with the CPU's: {bad}")
    return {"steps": steps, "moments": moments, "metrics": metrics}


def phase_ppo_train_graph(device: torch.device, env: str = "discrete_dummy", timed_updates: int = 2) -> dict:
    """PPO's update at ``exp=ppo_atari``'s published widths (``PPO_ATARI``), bf16-mixed:
    the minibatch step captured as a CUDA graph and replayed 12 times (3 epochs x 4
    minibatches of 256) against the eager update from the same weights, rollout and
    permutations, run twice (parameters, Adam moments and losses within
    ``GRAPH_SPREAD`` x the eager runs' spread, never looser than
    ``TRAIN_AGREEMENT_TOL``); no K1/K2 launch. Then, discrete actor only, in turns
    (eager, graph, graph, eager): gradient steps/s, device ms and kernels per
    minibatch step, peak memory."""
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype

    set_tf32(True)
    cfg = compose(overrides=[*PPO_ATARI, f"env={env}", "mesh.precision=bf16-mixed", "device=cuda"])
    ctx = RunContext(device, 31, compute_dtype("bf16-mixed"))
    agent, make_fns, obs_space = _ppo_family(cfg, ctx)
    label = f"[ppo-train-graph] {'continuous' if agent.is_continuous else 'discrete'}"
    eager_agents = [copy.deepcopy(agent) for _ in range(2)]
    fns = make_fns(agent)
    eager = [make_fns(a, ctx, False) for a in eager_agents]
    gen = torch.Generator(device=device).manual_seed(6)
    data = _ppo_rollout(cfg, fns, obs_space, gen, device)
    perms = fns.permutations(gen)
    steps = fns.grad_steps_per_update
    zero_launches()
    start = time.perf_counter()
    met_g = fns.train_fn(data, perms, 0.1, 0.01)
    capture_s = time.perf_counter() - start
    met_e = [f.train_fn(data, perms, 0.1, 0.01) for f in eager]
    torch.cuda.synchronize()
    counts = launch_counts()
    lr = cfg.algo.optimizer.lr
    tol, bad = TRAIN_AGREEMENT_TOL, []
    ma, m1, m2 = {"agent": agent}, {"agent": eager_agents[0]}, {"agent": eager_agents[1]}
    d_spread, d_off = _param_diffs(m2, m1)["agent"], _param_diffs(ma, m1)["agent"]
    limit = min(GRAPH_SPREAD * d_spread.max().item() + GRAPH_FLOOR["params"] * lr, tol["step_of_lr"] * lr)
    share = (d_off > limit).float().mean().item()
    params = {"off_max_of_lr": d_off.max().item() / lr, "spread_max_of_lr": d_spread.max().item() / lr, "limit_of_lr": limit / lr, "share_over_limit": share}
    if share > tol["off_share"]:
        bad.append(f"parameters {params}")
    spread = {"moments": _moment_diff({"agent": eager[1].opt_state}, {"agent": eager[0].opt_state})}
    off = {"moments": _moment_diff({"agent": fns.opt_state}, {"agent": eager[0].opt_state})}
    spread["losses"] = max(abs(met_e[1][k] - met_e[0][k]) / max(abs(met_e[0][k]), 1e-6) for k in met_g)
    off["losses"] = max(abs(met_g[k] - met_e[0][k]) / max(abs(met_e[0][k]), 1e-6) for k in met_g)
    if off["moments"] > min(GRAPH_SPREAD * spread["moments"] + GRAPH_FLOOR["moments"], tol["moments_rtol"]):
        bad.append(f"Adam moments {off['moments']} (eager spread {spread['moments']})")
    if off["losses"] > min(GRAPH_SPREAD * spread["losses"] + GRAPH_FLOOR["losses"], tol["metrics_rtol"]):
        bad.append(f"losses {off['losses']} (eager spread {spread['losses']})")
    if any(counts.values()) or not all(math.isfinite(v) for v in met_g.values()):
        bad.append(f"K1/K2 launches {counts}, losses {met_g}")
    row = {"actor": "continuous" if agent.is_continuous else "discrete", "precision": "bf16-mixed", "steps_per_update": steps,
           "capture_seconds": capture_s, "params": params, "off": off, "eager_spread": spread, "losses": met_g, "k1_k2_launches": counts}
    log(label + " parity " + json.dumps(row))
    if bad:
        raise AssertionError(f"{label}: the graphed update disagrees with the eager one: {bad}")
    if agent.is_continuous:
        return row
    timings = []
    for mode in ("eager", "graph", "graph", "eager"):
        f = eager[0] if mode == "eager" else fns
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start = time.perf_counter()
        for _ in range(timed_updates):
            f.train_fn(data, perms, 0.1, 0.01)  # reads the losses back: waits for the update
        seconds = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(device)
        prof = profile_calls(lambda: f.train_fn(data, perms, 0.1, 0.01), 1, f"{label} {mode} update", {"mode": mode})
        device_ms = prof.get("device_ms_per_call")
        timings.append({
            "mode": mode, "grad_steps_per_s": timed_updates * steps / seconds,
            "device_ms_per_step": device_ms / steps if device_ms else None,
            "kernels_per_step": prof["kernels_per_call"] / steps if prof else None,
            "busy_share_timed": device_ms * timed_updates / seconds / 1e3 if device_ms else None,
            "peak_allocated_bytes": peak, "reserved_bytes": torch.cuda.memory_reserved(device),
        })
    row["turns"] = timings
    log(label + " turns (per minibatch step; an update is 12 steps, its loss read back) " + json.dumps(timings))
    # the player step at these widths: one env's frame stack, the policy eager, its
    # outputs read back (what [ppo-cli] runs 1,024 times an update at depth 0)
    frame = {k: v[:1] for k, v in data.items() if k in cfg.algo.cnn_keys.encoder}
    pgen = torch.Generator(device=device).manual_seed(7)
    player = lambda: [t.cpu() for t in fns.act(frame, pgen)]  # noqa: E731
    for _ in range(8):
        player()
    row["player_step"] = profile_calls(player, 64, "[ppo-player] batch-1 player step, eager", {"mode": "eager"})
    return row


def _entry_run(overrides: list, tag: str, start_step: int = 0) -> tuple:
    """One run of the train entry with the launch counters zeroed around it: no K1/K2
    launch. ``start_step``: the policy step a resumed run starts from. Returns
    ``(result, row)``."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops.counters import launch_counts

    zero_launches()
    result = run(overrides)
    counts = launch_counts()
    if any(counts.values()) or result.checkpoint is None or result.grad_steps <= 0:
        raise AssertionError(f"{tag}: {result.grad_steps} gradient steps, checkpoint {result.checkpoint}, K1/K2 launches {counts}")
    steps = result.policy_steps - start_step
    row = {"policy_steps": steps, "grad_steps": result.grad_steps, "seconds": result.seconds,
           "policy_steps_per_s": steps / result.seconds, "acting_seconds": result.env_seconds,
           "updating_seconds": result.train_seconds, "acting_share": result.env_seconds / result.seconds,
           "acting_policy_steps_per_s": steps / result.env_seconds, "k1_k2_launches": counts}
    log(f"{tag}: " + json.dumps(row))
    return result, row


def phase_entry_cli(device: torch.device, workdir: Path, base: list, tag: str, first_ckpt: str, resume_halves: bool = True) -> dict:
    """A PPO- or SAC-family train entry (``base``'s overrides): train, resume from
    ``first_ckpt``, evaluate the last checkpoint through the eval entry; no K1/K2 launch
    anywhere. ``resume_halves``: the resumed run takes half the first run's gradient
    steps (PPO's two updates); a SAC-family resume only has to train. Policy steps/s,
    split into acting (policy and env steps) and updating (the captured update or
    blocks, captures included)."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate
    from sheeprl_tpu_torch.ops.counters import launch_counts

    set_tf32(True)
    overrides = [*base, f"device={device.type}", f"log_root={workdir / 'logs'}"]
    first, out_train = _entry_run(overrides, f"{tag} train")
    mid = next(p for p in CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints() if p.name == first_ckpt)
    resumed, out_resume = _entry_run([*overrides, f"checkpoint.resume_from={mid}"], f"{tag} resume from {mid.name}", int(mid.name.split("_")[1]))
    if resumed.policy_steps != first.policy_steps or (resume_halves and resumed.grad_steps * 2 != first.grad_steps):
        raise AssertionError(f"{tag} resume: {resumed.policy_steps} policy steps, {resumed.grad_steps} gradient steps")
    zero_launches()
    start = time.perf_counter()
    result = evaluate([f"checkpoint_path={resumed.checkpoint}", "env.capture_video=False", f"log_root={workdir / 'logs'}"])
    counts = launch_counts()
    if any(counts.values()) or not math.isfinite(result.reward) or result.steps <= 0:
        raise AssertionError(f"{tag} eval: {result.steps} steps, reward {result.reward}, K1/K2 launches {counts}")
    log(f"{tag} eval of {Path(resumed.checkpoint).name}: reward {result.reward}, {result.steps} player steps in "
        f"{time.perf_counter() - start:.2f} s, K1/K2 launches {counts}")
    return {"train": out_train, "resume": out_resume, "eval": {"steps": result.steps, "k1_k2_launches": counts}}


# --------------------------------------------------------------------------- the SAC family


def _sac_setup(name: str):
    from sheeprl_tpu_torch.algos.droq.droq import droq_parts
    from sheeprl_tpu_torch.algos.sac.sac import sac_parts
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import sac_ae_parts

    return {"sac": sac_parts, "droq": droq_parts, "sac_ae": sac_ae_parts}[name]


def _sac_parts(overrides: list, device: torch.device, seed: int = 41):
    """``(cfg, parts, obs_space, act_space)``: the SAC-family algorithm of ``overrides``
    built on ``device`` at ``mesh.precision``'s dtype, over its env's spaces."""
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(overrides=[*overrides, "device=cpu"])
    env = make_env(cfg, cfg.seed, 0, None)()
    obs_space, act_space = env.observation_space, env.action_space
    env.close()
    ctx = RunContext(device, seed, compute_dtype(cfg.mesh.precision))
    return cfg, _sac_setup(cfg.algo.name)(ctx, cfg, obs_space, act_space), obs_space, act_space


class InjectedDraws:
    """A block's draws given in advance: each call copies the next tree of ``draws`` (on
    any device) into the step's static draws."""

    def __init__(self, draws: list):
        self.draws, self.i = draws, 0

    def __call__(self, out):
        from sheeprl_tpu_torch.utils.graphs import tree_tensors

        with torch.no_grad():
            for dst, src in zip(tree_tensors(out), tree_tensors(self.draws[self.i % len(self.draws)])):
                dst.copy_(src, non_blocking=True)
        self.i += 1


class EagerStep:
    """A captured step's function run eagerly on the same static inputs (the graph's
    parity and its eager turns)."""

    def __init__(self, step):
        self.step, self.inputs, self.device = step, step.inputs, step.device

    def __call__(self):
        return self.step.fn(self.step.inputs)


class Collect:
    """A stand-in aggregator: the last value of each metric a drain hands it."""

    def __init__(self):
        self.values = {}

    def update(self, key, value):
        self.values[key] = float(value)


def _sac_ring(cfg, parts, act_dim: int, device: torch.device, capacity: int, n_envs: int, gen: torch.Generator):
    """A ``DeviceTransitionRing`` of ``capacity`` rows per env filled with random
    transitions (frames uint8, the rest normal; ``dones`` one in ten) on ``device``."""
    from sheeprl_tpu_torch.data.device_buffer import DeviceTransitionRing
    import numpy as np

    specs = {"obs": parts.obs_spec, "next_obs": parts.obs_spec, "actions": ((act_dim,), np.float32),
             "rewards": ((1,), np.float32), "dones": ((1,), np.float32)}
    ring = DeviceTransitionRing(capacity, n_envs, specs, device)
    with torch.no_grad():
        for k, buf in ring.arrays.items():
            if buf.dtype == torch.uint8:
                for i in range(0, capacity, 8192):  # in chunks: a [n, cap, 12288] int64 draw would not fit
                    buf[:, i : i + 8192].copy_(torch.randint(0, 256, buf[:, i : i + 8192].shape, generator=gen, device=gen.device))
            elif k == "dones":
                buf.copy_((torch.rand(buf.shape, generator=gen, device=gen.device) < 0.1).float())
            elif k == "actions":
                buf.copy_(torch.rand(buf.shape, generator=gen, device=gen.device) * 2 - 1)
            else:
                buf.copy_(torch.randn(buf.shape, generator=gen, device=gen.device))
    return ring


def _sac_dispatcher(parts, cfg, ring, draws: list, tail_draws: list | None, eager: bool = False):
    """``(dispatcher, tail)``: the algorithm's captured step over ``ring`` (replayed as a
    block; ``eager``: its function run eagerly instead), the draws injected; DroQ's
    actor step as ``tail`` (or None)."""
    from sheeprl_tpu_torch.utils.blocks import IndexedBlockDispatcher

    table = torch.zeros(2 * cfg.algo.per_rank_batch_size + 1, dtype=torch.int64, device=ring.device)
    step, _, select = parts.make_step({"table": table, "gather": ring.gather})
    if eager:
        step = EagerStep(step)
        select = None if select is None else (lambda c, s=select: EagerStep(s(c)))
    dispatcher = IndexedBlockDispatcher(step, InjectedDraws(draws), parts.target_update_freq, count_offset=parts.count_offset, select=select)
    tail = getattr(parts.make_step, "tail", {}).get("step")
    if tail is not None:
        tail.draw = InjectedDraws(tail_draws)
        if eager:
            tail.step = EagerStep(tail.step)
    return dispatcher, tail


def _sac_draw_list(parts, cfg, n: int, act_dim: int, device: torch.device, gen: torch.Generator, tail: bool = False) -> list:
    """``n`` steps' draws of the algorithm, made from ``gen`` (normals; DroQ's dropout
    noise uniform)."""
    from sheeprl_tpu_torch.algos.dreamer_loop import fill_draws, zero_draws
    from sheeprl_tpu_torch.algos.droq.droq import DRAW_KINDS, draw_shapes
    from sheeprl_tpu_torch.algos.sac.sac import SACDraws

    B = cfg.algo.per_rank_batch_size
    if cfg.algo.name == "droq":
        shapes, kinds = draw_shapes(B, act_dim, cfg.algo.critic.n, cfg.algo.critic.hidden_size), DRAW_KINDS
    else:
        shapes, kinds = SACDraws((B, act_dim), (B, act_dim)), ("normal", "normal")
    return [fill_draws(zero_draws(shapes, device), kinds, gen) for _ in range(n)]


def _sac_indices(cfg, n: int, capacity: int, n_envs: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    B = cfg.algo.per_rank_batch_size
    return rng.integers(0, n_envs, (n, B)), rng.integers(0, capacity, (n, B))


def _sac_run_block(dispatcher, tail, envs, rows, start: int = 0) -> dict:
    """One iteration's block (and DroQ's actor step on the indices' last row), its last
    metrics read back."""
    import numpy as np

    n = envs.shape[0] - (tail is not None)
    dispatcher.dispatch(envs[:n], rows[:n], start)
    if tail is not None:
        dispatcher.track(tail(np.concatenate([envs[n:], rows[n:]], 1)))
    out = Collect()
    dispatcher.drain(out)
    return out.values


def phase_sac_train_agreement(device: torch.device, overrides: list, label: str, steps: int = 5) -> dict:
    """One block of ``steps`` gradient steps (DroQ: and its actor step) of a small
    SAC-family agent, the card's replayed from captured graphs, against the same block on
    the CPU: same weights, ring, indices and draws; float32, TF32 off;
    ``[train-agreement]``'s limits on the parameter change, the Adam moments and the last
    step's losses; no K1/K2 launch."""
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    set_tf32(False)
    cpu = torch.device("cpu")
    cfg, parts_c, _, act_space = _sac_parts([*overrides, "mesh.precision=32-true"], cpu)
    _, parts_d, _, _ = _sac_parts([*overrides, "mesh.precision=32-true"], device)
    parts_d.agent.load_state_dict(parts_c.agent.state_dict())
    act_dim = int(act_space.shape[0])
    gen = torch.Generator().manual_seed(5)
    ring_c = _sac_ring(cfg, parts_c, act_dim, cpu, 64, 2, gen)
    ring_d = _sac_ring(cfg, parts_d, act_dim, device, 64, 2, torch.Generator(device=device).manual_seed(5))
    for k in ring_c.arrays:
        ring_d.arrays[k].copy_(ring_c.arrays[k])
    tail = cfg.algo.name == "droq"
    draws = _sac_draw_list(parts_c, cfg, steps + tail, act_dim, cpu, gen)
    envs, rows = _sac_indices(cfg, steps + tail, 64, 2, 6)
    before = {k: v.clone() for k, v in parts_c.agent.state_dict().items()}
    disp_c, tail_c = _sac_dispatcher(parts_c, cfg, ring_c, draws[:steps], draws[steps:])
    disp_d, tail_d = _sac_dispatcher(parts_d, cfg, ring_d, draws[:steps], draws[steps:])
    zero_launches()
    met_c = _sac_run_block(disp_c, tail_c, envs, rows, 3)
    met_d = _sac_run_block(disp_d, tail_d, envs, rows, 3)
    torch.cuda.synchronize()
    counts = launch_counts()
    tol, lr = TRAIN_AGREEMENT_TOL, float(cfg.algo.critic.optimizer.lr)
    sd = parts_d.agent.state_dict()
    diff = torch.cat([(sd[k].float().cpu() - v.float()).abs().flatten() for k, v in parts_c.agent.state_dict().items()])
    moved = torch.cat([(v.float() - before[k].float()).abs().flatten() for k, v in parts_c.agent.state_dict().items()])
    changes = {"max_of_lr": (diff.max() / lr).item(), "share_over": (diff > tol["step_of_lr"] * lr).float().mean().item(),
               "moved_max_of_lr": (moved.max() / lr).item()}
    moments = max(
        ((q.cpu() - p).norm() / max(p.norm().item(), 1e-30)).item()
        for name in parts_c.opt_states for key in ("mu", "nu")
        for p, q in zip(parts_c.opt_states[name][key], parts_d.opt_states[name][key])
    )
    counts_equal = all(int(parts_c.opt_states[n]["count"]) == int(parts_d.opt_states[n]["count"]) for n in parts_c.opt_states)
    metrics = {k: (met_c[k], met_d[k]) for k in met_c}
    bad = [k for k, (c, d) in metrics.items() if abs(c - d) > tol["metrics_atol"] + tol["metrics_rtol"] * abs(c)]
    if changes["share_over"] > tol["off_share"]:
        bad.append(f"parameter change {changes}")
    if moments > tol["moments_rtol"] or not counts_equal:
        bad.append(f"moments {moments}, counts equal {counts_equal}")
    if any(counts.values()) or not tree_tensors(parts_d.opt_states):
        bad.append(f"kernel launches {counts}")
    log(f"{label} small {cfg.algo.name}, a block of {steps} steps{' and the actor step' if tail else ''} at 32-true, TF32 off, "
        f"{device} (captured) vs cpu: parameter change " + json.dumps(changes)
        + f" (share > {tol['step_of_lr']} lr <= {tol['off_share']}); Adam moments, the leaf furthest off {moments:.3g} "
        f"(<= {tol['moments_rtol']}), counts equal {counts_equal}; losses (cpu, card) " + json.dumps(metrics) + f"; K1/K2 launches {counts}")
    if bad:
        raise AssertionError(f"{label}: the card's block disagrees with the CPU's: {bad}")
    return {"changes": changes, "moments": moments, "metrics": metrics, "k1_k2_launches": counts}


def phase_sac_train_graph(device: torch.device, overrides: list, label: str, steps: int, timed_blocks: int, profiled: int, capacity: int) -> dict:
    """A SAC-family update at its exp's published widths (``overrides``, bf16-mixed):
    one block of ``steps`` gradient steps (DroQ: and its actor step) replayed from
    captured graphs over a ``DeviceTransitionRing`` of ``capacity`` random rows on the
    card, against the same block run eagerly twice from the same state, indices and
    draws (within ``GRAPH_SPREAD`` x the eager runs' spread, never looser than
    ``TRAIN_AGREEMENT_TOL``); no K1/K2 launch. Then eager, graph, graph, eager
    (``timed_blocks`` blocks each): gradient steps/s, peak memory, and device ms and
    kernels per gradient step from a block of ``profiled`` steps under the profiler
    (DroQ: its whole block, the actor step's kernels counted in it)."""
    from sheeprl_tpu_torch.ops.counters import launch_counts

    set_tf32(True)
    cfg, parts_g, _, act_space = _sac_parts(overrides, device)
    act_dim, tail = int(act_space.shape[0]), cfg.algo.name == "droq"
    eager_parts = [_sac_parts(overrides, device)[1] for _ in range(2)]
    for p in eager_parts:
        p.agent.load_state_dict(parts_g.agent.state_dict())
    gen = torch.Generator(device=device).manual_seed(8)
    start = time.perf_counter()
    ring = _sac_ring(cfg, parts_g, act_dim, device, capacity, 1, gen)
    fill_s = time.perf_counter() - start
    draws = _sac_draw_list(parts_g, cfg, steps + tail, act_dim, device, gen)
    envs, rows = _sac_indices(cfg, steps + tail, capacity, 1, 9)
    start = time.perf_counter()
    graph = _sac_dispatcher(parts_g, cfg, ring, draws[:steps], draws[steps:])
    capture_s = time.perf_counter() - start
    eagers = [_sac_dispatcher(p, cfg, ring, draws[:steps], draws[steps:], eager=True) for p in eager_parts]
    zero_launches()
    met_g = _sac_run_block(*graph, envs, rows)
    met_e = [_sac_run_block(*e, envs, rows) for e in eagers]
    torch.cuda.synchronize()
    counts = launch_counts()
    lr, tol, bad = float(cfg.algo.critic.optimizer.lr), TRAIN_AGREEMENT_TOL, []
    ma, m1, m2 = {"agent": parts_g.agent}, {"agent": eager_parts[0].agent}, {"agent": eager_parts[1].agent}
    d_spread, d_off = _param_diffs(m2, m1)["agent"], _param_diffs(ma, m1)["agent"]
    limit = min(GRAPH_SPREAD * d_spread.max().item() + GRAPH_FLOOR["params"] * lr, tol["step_of_lr"] * lr)
    share = (d_off > limit).float().mean().item()
    params = {"off_max_of_lr": d_off.max().item() / lr, "spread_max_of_lr": d_spread.max().item() / lr, "limit_of_lr": limit / lr, "share_over_limit": share}
    if share > tol["off_share"]:
        bad.append(f"parameters {params}")
    spread = {"moments": _moment_diff(eager_parts[1].opt_states, eager_parts[0].opt_states)}
    off = {"moments": _moment_diff(parts_g.opt_states, eager_parts[0].opt_states)}
    spread["losses"] = max(abs(met_e[1][k] - met_e[0][k]) / max(abs(met_e[0][k]), 1e-6) for k in met_g)
    off["losses"] = max(abs(met_g[k] - met_e[0][k]) / max(abs(met_e[0][k]), 1e-6) for k in met_g)
    if off["moments"] > min(GRAPH_SPREAD * spread["moments"] + GRAPH_FLOOR["moments"], tol["moments_rtol"]):
        bad.append(f"Adam moments {off['moments']} (eager spread {spread['moments']})")
    if off["losses"] > min(GRAPH_SPREAD * spread["losses"] + GRAPH_FLOOR["losses"], tol["metrics_rtol"]):
        bad.append(f"losses {off['losses']} (eager spread {spread['losses']})")
    if any(counts.values()) or not all(math.isfinite(v) for v in met_g.values()):
        bad.append(f"K1/K2 launches {counts}, losses {met_g}")
    n_params = sum(p.numel() for p in parts_g.agent.parameters())
    row = {"algo": cfg.algo.name, "precision": str(cfg.mesh.precision), "batch": cfg.algo.per_rank_batch_size, "parameters": n_params,
           "block_steps": steps, "actor_tail": tail, "ring_rows": capacity, "ring_bytes": ring.nbytes, "ring_fill_seconds": fill_s,
           "capture_seconds": capture_s, "params": params, "off": off, "eager_spread": spread, "losses": met_g, "k1_k2_launches": counts}
    log(label + " parity " + json.dumps(row))
    if bad:
        raise AssertionError(f"{label}: the graphed block disagrees with the eager one: {bad}")
    timings = []
    for mode in ("eager", "graph", "graph", "eager"):
        disp = eagers[0] if mode == "eager" else graph
        run_block = lambda d=disp: _sac_run_block(*d, envs, rows)  # noqa: E731  (reads the losses back: waits for the block)
        run_block()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start = time.perf_counter()
        for _ in range(timed_blocks):
            run_block()
        seconds = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated(device)
        short = lambda d=disp: _sac_run_block(*d, envs[:profiled + tail], rows[:profiled + tail])  # noqa: E731
        prof = profile_calls(short, 1, f"{label} {mode} block of {profiled} steps", {"mode": mode})
        device_ms = prof.get("device_ms_per_call")
        timings.append({
            "mode": mode, "grad_steps_per_s": timed_blocks * steps / seconds,
            "device_ms_per_step": device_ms / profiled if device_ms else None,
            "kernels_per_step": prof["kernels_per_call"] / profiled if prof else None,
            "busy_share_timed": device_ms / profiled * steps * timed_blocks / seconds / 1e3 if device_ms else None,
            "peak_allocated_bytes": peak, "reserved_bytes": torch.cuda.memory_reserved(device),
        })
    row["turns"] = timings
    log(label + f" turns (per gradient step; a block is {steps} steps{' and the actor step' if tail else ''}, its losses read back) "
        + json.dumps(timings))
    return row


# --------------------------------------------------------------------------- the decoupled entries


class _Recorder:
    """A logger that keeps what it was asked to log."""

    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, dict(metrics)))

    def close(self):
        pass


def phase_ppo_decoupled_agreement(device: torch.device, workdir: Path) -> dict:
    """``ppo_decoupled`` against the coupled ``ppo`` at ``rollout.pipeline_depth=0``, both
    through the train entry on the card on the same draws (the coupled entry's player
    and update generators seeded as the decoupled player's and learner's), three updates
    of ``SMALL_PPO_DECOUPLED`` at 32-true with TF32 off: the parameters (in units of the
    lr), the Adam moments (relative norm per leaf) and the logged losses within
    ``[train-agreement]``'s limits (``TRAIN_AGREEMENT_TOL``); no K1/K2 launch."""
    import sheeprl_tpu_torch.algos.ppo.ppo as ppo
    from sheeprl_tpu_torch.algos.decoupled import PLAYER_SEED_OFFSET
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.parallel.context import RunContext

    set_tf32(False)
    overrides = [*SMALL_PPO_DECOUPLED, f"device={device.type}"]
    lr = compose(overrides=[*SMALL_PPO_DECOUPLED, "device=cpu"]).algo.optimizer.lr
    get_logger, rng = ppo.get_logger, RunContext.rng

    def reseeded(ctx, device=None):
        draw = ctx._draws
        gen = rng(ctx, device)
        if draw == 1:
            gen.manual_seed(ctx.seed + PLAYER_SEED_OFFSET)
        elif draw == 2:
            gen.manual_seed(ctx.seed * 1_000_003 + 1)
        return gen

    out, logs = {}, {}
    zero_launches()
    try:
        for name, extra in (("decoupled", []), ("coupled", ["algo.name=ppo", "rollout.pipeline_depth=0"])):
            logs[name] = _Recorder()
            ppo.get_logger = lambda cfg, log_dir, log=logs[name]: log
            RunContext.rng = reseeded if name == "coupled" else rng
            out[name] = run([*overrides, *extra, f"log_root={workdir / name}"])
    finally:
        ppo.get_logger, RunContext.rng = get_logger, rng
    counts = launch_counts()
    states = {k: CheckpointManager.load(r.checkpoint) for k, r in out.items()}
    tol = TRAIN_AGREEMENT_TOL
    pd, pc = states["decoupled"]["params"], states["coupled"]["params"]
    diff = torch.cat([(pd[k].float() - v.float()).abs().flatten() for k, v in pc.items()])
    steps = {"max_of_lr": (diff.max() / lr).item(), "share_over": (diff > tol["step_of_lr"] * lr).float().mean().item(),
             "bit_identical": all(torch.equal(pd[k], v) for k, v in pc.items())}
    od, oc = states["decoupled"]["opt_state"], states["coupled"]["opt_state"]
    moments = {key: max(((a - b).norm() / max(b.norm().item(), 1e-12)).item() for a, b in zip(od[key], oc[key])) for key in ("mu", "nu")}
    losses = {k: [(s, {n: v for n, v in m.items() if n.startswith("Loss/")}) for s, m in log.logged] for k, log in logs.items()}
    flat = [(a, b) for (_, ma), (_, mb) in zip(losses["decoupled"], losses["coupled"]) for a, b in zip(ma.values(), mb.values())]
    bad = []
    if len(losses["decoupled"]) != 3 or [s for s, _ in losses["decoupled"]] != [s for s, _ in losses["coupled"]]:
        bad.append(f"logged steps {losses}")
    if any(abs(a - b) > tol["metrics_atol"] + tol["metrics_rtol"] * abs(b) for a, b in flat):
        bad.append(f"losses {losses}")
    if steps["share_over"] > tol["off_share"]:
        bad.append(f"parameters {steps}")
    if max(moments.values()) > tol["moments_rtol"]:
        bad.append(f"moments {moments}")
    if int(od["count"]) != int(oc["count"]) or out["decoupled"].grad_steps != out["coupled"].grad_steps or any(counts.values()):
        bad.append(f"counts {int(od['count'])} vs {int(oc['count'])}, launches {counts}")
    row = {"params": steps, "moments_rel": moments, "losses": losses["decoupled"], "grad_steps": out["decoupled"].grad_steps, "k1_k2_launches": counts,
           "param_staleness_steps": [m.get("Sebulba/param_staleness_steps") for _, m in logs["decoupled"].logged]}
    log("[ppo-decoupled-agreement] small ppo_decoupled vs ppo at depth 0, three updates at 32-true, TF32 off, same draws, "
        f"{device}: " + json.dumps(row))
    if bad:
        raise AssertionError(f"[ppo-decoupled-agreement]: the decoupled update disagrees with the coupled one: {bad}")
    return row


def phase_sac_decoupled_publish(device: torch.device, workdir: Path) -> dict:
    """A short ``sac_decoupled`` run over the device ring (``SAC_DECOUPLED_PUBLISH``) with
    spies on its publication: at each publication the phase snapshots the learner's
    actor (on the learner's stream), and after each adoption the player's actor (on the
    player's stream); every adopted publication must equal its snapshot bit for bit, the
    player's stream must be neither the default stream nor the learner's, and at least
    one publication must have been adopted. Then a graph captured on the main thread
    while another thread launches eager work on a stream of its own (``StepGraph``'s
    thread-local capture mode): both give their eager results."""
    import threading

    import sheeprl_tpu_torch.algos.sac.sac_decoupled as entry
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.utils.graphs import StepGraph

    set_tf32(True)
    publish, adopt = entry.publish, entry.adopt
    learner, player, streams = {}, {}, {"learner": set(), "player": set()}
    default = torch.cuda.default_stream(device) if device.type == "cuda" else None

    def spy_publish(tensors, stamp):
        learner[stamp["seq"]] = [t.detach().clone() for t in tensors]
        if default is not None:
            streams["learner"].add(torch.cuda.current_stream(device).cuda_stream)
        return publish(tensors, stamp)

    def spy_adopt(pub, dst):
        adopt(pub, dst)
        player[pub.stamp["seq"]] = [t.detach().clone() for t in dst]
        if default is not None:
            streams["player"].add(torch.cuda.current_stream(device).cuda_stream)

    zero_launches()
    get_logger, logged = entry.get_logger, _Recorder()
    entry.publish, entry.adopt, entry.get_logger = spy_publish, spy_adopt, lambda cfg, log_dir: logged
    try:
        result = run([*SAC_DECOUPLED_PUBLISH, f"device={device.type}", f"log_root={workdir / 'publish'}"])
    finally:
        entry.publish, entry.adopt, entry.get_logger = publish, adopt, get_logger
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts = launch_counts()
    mismatched = [seq for seq, ps in player.items() if not all(torch.equal(a, b) for a, b in zip(ps, learner[seq]))]
    own_streams = default is None or (streams["player"].isdisjoint(streams["learner"] | {default.cuda_stream}) and len(streams["player"]) == 1)
    row = {"publications": len(learner), "adopted": len(player), "mismatched": mismatched, "grad_steps": result.grad_steps,
           "param_staleness_steps": [m.get("Sebulba/param_staleness_steps") for _, m in logged.logged],
           "player_streams": len(streams["player"]), "learner_streams": len(streams["learner"]), "k1_k2_launches": counts}

    # a capture on this thread while another thread launches eager work on its own stream
    x = torch.randn(256, 256, device=device)
    fn = lambda inp: {"y": torch.tanh(inp["x"] @ inp["x"]).sum(0)}  # noqa: E731
    want = fn({"x": x})["y"]
    stop, eager_ok, errors = threading.Event(), [], []

    def eager():
        try:
            with (torch.cuda.stream(torch.cuda.Stream(device)) if device.type == "cuda" else contextlib.nullcontext()):
                z = torch.randn(128, 128, device=device, generator=torch.Generator(device=device).manual_seed(0))
                want = (z @ z).relu().sum().item()
                while not stop.is_set():
                    eager_ok.append((z @ z).relu().sum().item() == want)
        except Exception as exc:  # reported below
            errors.append(exc)

    t = threading.Thread(target=eager, daemon=True)
    t.start()
    try:
        time.sleep(0.05)
        got = StepGraph(fn, {"x": x})()["y"].clone()
    finally:
        stop.set()
        t.join(timeout=30)
    row["capture_beside_eager"] = {"eager_calls": len(eager_ok), "eager_all_right": all(eager_ok), "errors": [repr(e) for e in errors],
                                   "graph_rel_diff": ((got - want).abs().max() / want.abs().max()).item()}
    log(f"[sac-decoupled-publish] sac_decoupled over the device ring at exp=sac's widths, {device}: " + json.dumps(row))
    if (mismatched or not player or any(counts.values()) or not own_streams or t.is_alive() or errors or not all(eager_ok)
            or row["capture_beside_eager"]["graph_rel_diff"] > 1e-5):
        raise AssertionError(f"[sac-decoupled-publish]: {row}")
    return row


# --------------------------------------------------------------------------- serving


def register_serve_models(device: torch.device, registry: Path, families: dict = SERVE_FAMILIES) -> dict:
    """A freshly initialised checkpoint of each family (seeded), its run config beside
    it, registered under the family's name. Returns ``{name: observation template}``."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import compose, save_config
    from sheeprl_tpu_torch.parallel.context import make_run_context
    from sheeprl_tpu_torch.utils.env import make_env
    from sheeprl_tpu_torch.utils.model_manager import LocalModelManager
    from sheeprl_tpu_torch.utils.policy import build_policy

    manager, templates = LocalModelManager(registry / "registry"), {}
    for name, overrides in families.items():
        cfg = compose(overrides=[*overrides, f"device={device.type}", "env.num_envs=1", "env.capture_video=False"])
        ctx = make_run_context(cfg)
        env = make_env(cfg, cfg.seed, 0, None, "serve")()
        policy, agent = build_policy(ctx, cfg, env.observation_space, env.action_space)
        env.close()
        run = registry / "runs" / name
        ckpt = CheckpointManager(run / "checkpoints").save(0, {"params": agent.state_dict()})
        save_config(cfg, run / "config.yaml")
        manager.register_model(str(ckpt), name)
        templates[name] = policy.obs_template
    return templates


def _serve_obs(template: dict, rng, n: int) -> dict:
    return {k: (rng.integers(0, 256, (n, *s)) if np.issubdtype(np.dtype(d), np.integer) else rng.standard_normal((n, *s))).astype(np.dtype(d))
            for k, (s, d) in template.items()}


def drive_clients(port: int, policy: str, template: dict, clients: int, requests: int, stateful: bool) -> dict:
    """``clients`` threads, each with its own ``PolicyClient`` and ``requests`` requests
    on seeded observations (one session per client for a stateful policy): requests/s,
    client-side p50 and p99 ms, mean batch fill."""
    import threading

    from sheeprl_tpu_torch.serve.client import PolicyClient

    rows = [_serve_obs(template, np.random.default_rng(100 + i), 4) for i in range(clients)]
    latencies, fills, errors = [[] for _ in range(clients)], [[] for _ in range(clients)], []
    barrier = threading.Barrier(clients + 1)

    def worker(i):
        try:
            with PolicyClient("127.0.0.1", port) as client:
                barrier.wait()
                for r in range(requests):
                    obs = {k: v[r % 4] for k, v in rows[i].items()}
                    t = time.perf_counter()
                    _, meta = client.act(obs, policy, session=f"client{i}" if stateful else None)
                    latencies[i].append((time.perf_counter() - t) * 1e3)
                    fills[i].append(meta["batch_fill"] * meta["bucket"])
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    start = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - start
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve clients of {policy}: {errors or 'a client did not finish'}")
    lat = np.concatenate([np.asarray(x) for x in latencies])
    return {"requests": int(lat.size), "requests_per_s": lat.size / seconds, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)), "mean_batch_fill": float(np.mean(np.concatenate(fills)))}


def server_side(ep) -> dict:
    """The server's side of the requests an endpoint answered since its metrics were last
    reset: enqueue to batch done, and the dispatch alone (padding, copies, the replay and
    the wait on its event)."""
    m = ep.metrics.compute()
    return {"server_p50_ms": m["Serve/latency_ms/p50"], "server_p99_ms": m["Serve/latency_ms/p99"],
            "infer_p50_ms": m["Serve/infer_ms/p50"], "infer_p99_ms": m["Serve/infer_ms/p99"], "dispatches": int(m["Serve/dispatches"])}


def drive_clients_elsewhere(port: int, policy: str, template: dict, clients: int, requests: int, stateful: bool) -> dict:
    """``drive_clients`` from a child process: the same load with the clients' Python off
    the server's interpreter lock (``[serve]`` drives in-process threads, which share it)."""
    code = ("import json, sys\nimport chip_smoke as cs\na = json.loads(sys.argv[1])\n"
            "t = {k: (tuple(s), d) for k, (s, d) in a['template'].items()}\n"
            "print('RESULT ' + json.dumps(cs.drive_clients(a['port'], a['policy'], t, a['clients'], a['requests'], a['stateful'])))\n")
    arg = json.dumps({"port": port, "policy": policy, "template": template, "clients": clients, "requests": requests, "stateful": stateful})
    proc = subprocess.run([sys.executable, "-c", code, arg], cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"serve clients in a child process: exit {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def _bucket_inputs(ep, bucket: int, seed: int) -> tuple:
    """A bucket's seeded observations, and for a stateful policy the rows and
    ``is_first`` of a batch that continues sessions 0..bucket-1."""
    obs = _serve_obs(ep.policy.obs_template, np.random.default_rng(seed), bucket)
    if ep.state_cache is None:
        return obs, None, None
    return obs, np.arange(bucket, dtype=np.int64), np.zeros((bucket, 1), np.float32)


def check_serve_replays(ep, device: torch.device) -> dict:
    """Each bucket's graph replay against the eager act function on the same inputs (and,
    stateful, the same gathered rows): bit for bit, the scattered rows too."""
    from sheeprl_tpu_torch.serve.state_cache import _tree_map

    policy, cache = ep.policy, ep.state_cache
    for bucket, graph in ep.graphs.items():
        obs, idx, is_first = _bucket_inputs(ep, bucket, 7 + bucket)
        with torch.no_grad():
            obs_t = policy.obs_tensors(obs)
            if cache is None:
                want = policy.act_fn(policy.params, obs_t).cpu().numpy()
            else:
                idx_t = torch.as_tensor(idx, device=device)
                rows = _tree_map(lambda t: t.clone(), cache.gather(idx_t))
                want, new_rows = policy.act_fn(policy.params, obs_t, torch.as_tensor(is_first, device=device), rows)
                want, new_rows = want.cpu().numpy(), _tree_map(lambda t: t.cpu().clone(), new_rows)
        got = graph(obs, idx, is_first, stream=ep.stream, done=ep.done)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{ep.canonical} bucket {bucket}: the graph replay differs from the eager act function "
                                 f"(max |diff| {np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))})")
        if cache is not None:
            after = _tree_map(lambda t: t.cpu(), cache.gather(torch.as_tensor(idx, device=device)))
            same = _tree_map(lambda a, b: bool(torch.equal(a, b)), after, new_rows)
            if not all(torch.utils._pytree.tree_leaves(same)):
                raise AssertionError(f"{ep.canonical} bucket {bucket}: the graph's scattered state differs from the eager step's")
    return {"buckets_bit_equal": sorted(ep.graphs)}


def check_serve_cpu(ep, tier: str, registry: Path, device: torch.device, n: int = 64) -> dict:
    """The card's greedy actions (eager, TF32 off) against a CPU load of the same
    registered checkpoint at the same tier, on ``n`` seeded observations (stateful: an
    episode's first step). f32 and int8: discrete equal, continuous within
    ``SERVE_CPU_ATOL``; bf16 (the card's and the CPU's bfloat16 products round apart):
    the agreement fraction, reported."""
    from sheeprl_tpu_torch.config.core import load_config
    from sheeprl_tpu_torch.parallel.context import RunContext, compute_dtype
    from sheeprl_tpu_torch.precision import action_agreement
    from sheeprl_tpu_torch.utils.policy import load_policy

    payload = registry / "registry" / ep.name / f"v{ep.version}"
    run_cfg = load_config(payload / "config.yaml")
    ctx = RunContext(torch.device("cpu"), int(run_cfg.seed), compute_dtype(run_cfg.mesh.precision))
    cpu = load_policy(ctx, run_cfg, str(payload), precision=tier)
    obs = _serve_obs(ep.policy.obs_template, np.random.default_rng(11), n)
    set_tf32(False)
    try:
        with torch.no_grad():
            args = lambda p: (p.params, p.obs_tensors(obs)) + ((torch.ones((n, 1), device=p.device), p.zero_state_fn(n)) if p.stateful else ())  # noqa: E731
            card = ep.policy.act_fn(*args(ep.policy))
            host = cpu.act_fn(*args(cpu))
            card, host = (card[0], host[0]) if ep.policy.stateful else (card, host)
            card, host = card.cpu().numpy(), host.numpy()
    finally:
        set_tf32(True)
    agreement = action_agreement(host, card, continuous=ep.policy.is_continuous, atol=SERVE_CPU_ATOL)
    max_err = float(np.max(np.abs(card.astype(np.float64) - host.astype(np.float64))))
    if tier != "bf16" and agreement != 1.0:
        raise AssertionError(f"{ep.canonical} {tier}: card against CPU agreement {agreement}, max |diff| {max_err}")
    return {"card_cpu_agreement": agreement, "card_cpu_max_abs_diff": max_err}


def profile_replays(ep, bucket: int, label: str, calls: int = 20) -> dict:
    """Kernels and device ms per replay of one bucket's graph (``profile_calls``), and
    its device ms per replay between CUDA events (graph replays back to back)."""
    graph = ep.graphs[bucket].graph
    prof = profile_calls(graph.replay, calls, label, {"bucket": bucket})
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        graph.replay()
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    end.synchronize()
    return {"kernels_per_replay": prof.get("kernels_per_call"), "device_ms_per_replay": prof.get("device_ms_per_call"),
            "event_ms_per_replay": start.elapsed_time(end) / calls}


def phase_serve(device: torch.device, workdir: Path, families: dict = SERVE_FAMILIES, tiers=SERVE_TIERS,
                max_batch: int = SERVE_MAX_BATCH, clients: int = SERVE_CLIENTS, requests: int = SERVE_REQUESTS) -> dict:
    """``[serve]``: register each family's checkpoint, then per tier one ``PolicyServer``
    on ``device`` serving all of them: startup and capture seconds, ``clients`` x
    ``requests`` per family (requests/s, p50/p99 ms, mean batch fill), the parity stamp,
    graph replays against the eager act function bit for bit, the card against the CPU,
    kernels and device ms per replay at buckets 1 and ``max_batch``, no capture after
    warm-up, no K1/K2 launch. At the first tier the first family is driven once more by
    the same clients from a child process (``drive_clients_elsewhere``), and the server
    reports its side of the requests (enqueue to reply, and the dispatch alone)."""
    import threading

    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.serve.server import PolicyServer

    set_tf32(True)
    templates = register_serve_models(device, workdir, families)
    out = {}
    for tier in tiers:
        zero_launches()
        cfg = compose(config_name="serve_cli", overrides=[
            f"serve.policies=[{','.join(f'{n}:latest' for n in families)}]", f"model_manager.registry_dir={workdir / 'registry'}",
            f"device={device.type}", f"serve.max_batch_size={max_batch}", f"serve.precision={tier}", "serve.log_every_s=0",
        ])
        server = PolicyServer(cfg)
        rc = {}
        thread = threading.Thread(target=lambda: rc.update(rc=server.run()), daemon=True)
        thread.start()
        while server.listener is None:
            time.sleep(0.01)
        rows = {}
        try:
            for name in families:
                ep = server.endpoints[server.aliases[f"{name}:latest"]]
                row = {"startup_seconds": server.startup_seconds, "capture_seconds_all_policies": server.precompile_seconds,
                       "parity": server.parity.get(ep.canonical)}
                # untimed: the first requests pay first uses (connections, the endpoint's stream)
                drive_clients(server.listener.port, f"{name}:latest", templates[name], clients, SERVE_WARMUP_REQUESTS, ep.policy.stateful)
                ep.metrics.reset()
                row.update(drive_clients(server.listener.port, f"{name}:latest", templates[name], clients, requests, ep.policy.stateful))
                row.update(server_side(ep))
                if tier == tiers[0] and name == next(iter(families)):
                    ep.metrics.reset()
                    elsewhere = drive_clients_elsewhere(server.listener.port, f"{name}:latest", templates[name], clients, requests,
                                                        ep.policy.stateful)
                    row["clients_in_a_child_process"] = {**elsewhere, **server_side(ep)}
                rows[name] = row
        finally:
            server.shutdown()
            thread.join(timeout=120)
        counts = launch_counts()
        summary = server.summary()
        for name, row in rows.items():
            ep = server.endpoints[server.aliases[f"{name}:latest"]]
            row.update(check_serve_replays(ep, device))
            row.update(check_serve_cpu(ep, tier, workdir, device))
            if device.type == "cuda":
                for bucket in (1, max_batch):
                    row[f"bucket{bucket}"] = profile_replays(ep, bucket, f"[serve] {name} {tier} bucket {bucket}")
            row["captures_after_warm"] = server.watchdog.captures_after_warm
            row["k1_k2_launches"] = counts
            log(f"[serve] {name} {tier} " + json.dumps(row))
        if (rc.get("rc") != 0 or server.watchdog.violations or any(counts.values())
                or summary["accepted"] != summary["replied"] or summary["dropped"]):
            raise AssertionError(f"[serve] {tier}: rc {rc.get('rc')}, watchdog violations {server.watchdog.violations}, K1/K2 "
                                 f"launches {counts}, accepted {summary['accepted']}, replied {summary['replied']}, dropped {summary['dropped']}")
        out[tier] = rows
        del server
    return {"tiers": out, "templates": templates}


def phase_serve_cli(device: torch.device, workdir: Path, template: dict, policy: str = "sac") -> dict:
    """``python -m sheeprl_tpu_torch.serve`` as a subprocess over ``phase_serve``'s
    registry (``template``: the policy's observation template): it writes its ready
    file, answers a request, and exits 75 on SIGTERM after draining."""
    import signal

    from sheeprl_tpu_torch.serve.client import PolicyClient

    ready = workdir / "ready.json"
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch.serve", f"serve.policies=[{policy}:latest]",
           f"model_manager.registry_dir={workdir / 'registry'}", f"serve.ready_file={ready}", "serve.max_batch_size=4",
           "serve.log_every_s=0", f"device={device.type}"]
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        while not ready.is_file():
            if proc.poll() is not None or time.perf_counter() - start > 300:
                raise AssertionError(f"[serve-cli] no ready file; exit {proc.poll()}: {proc.communicate(timeout=30)[0][-4000:]}")
            time.sleep(0.1)
        info = json.loads(ready.read_text())
        ready_s = time.perf_counter() - start
        with PolicyClient(info["host"], int(info["port"])) as client:
            pong = client.ping()
            action, _ = client.act({k: v[0] for k, v in _serve_obs(template, np.random.default_rng(5), 1).items()}, f"{policy}:latest")
        proc.send_signal(signal.SIGTERM)
        output, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    row = {"ready_seconds": ready_s, "exit_code": proc.returncode, "policies": pong["policies"], "action_shape": list(np.shape(action)),
           "startup_seconds": info["startup_seconds"]}
    log("[serve-cli] " + json.dumps(row))
    if proc.returncode != 75 or not np.all(np.isfinite(action)):
        raise AssertionError(f"[serve-cli] exit code {proc.returncode} (want 75), action {action}: {output[-4000:]}")
    return row


# --------------------------------------------------------------------------- Anakin and population

ANAKIN_CLI = {
    # exp: (cut overrides, first checkpoint); PPO: two updates, SAC: the prefill and two dispatches
    "ppo_anakin": (["algo.total_steps=65536", "checkpoint.every=32768", "metric.log_every=32768"], "ckpt_32768"),
    "ppo_anakin_pop": (["algo.total_steps=16384", "checkpoint.every=8192", "metric.log_every=8192"], "ckpt_8192"),
    "sac_anakin": (["algo.total_steps=21376", "checkpoint.every=13184", "metric.log_every=8192"], "ckpt_13184"),
    "sac_anakin_pop": (["algo.total_steps=9088", "checkpoint.every=7040", "metric.log_every=4096"], "ckpt_7040"),
}
SMALL_ANAKIN_PPO = ["exp=ppo_anakin", "env.num_envs=16", "algo.rollout_steps=16", "algo.per_rank_batch_size=64", "algo.update_epochs=2",
                    "mesh.precision=32-true"]
SMALL_ANAKIN_SAC = ["exp=sac_anakin", "env.num_envs=16", "algo.hidden_size=64", "algo.per_rank_batch_size=64", "buffer.size=1024",
                    "mesh.precision=32-true"]


def _anakin_parts(overrides: list, device: torch.device):
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.engine.anakin import anakin_env
    from sheeprl_tpu_torch.engine.population import population_spec

    cfg = compose(overrides=[*overrides, f"device={device.type}"])
    env, params = anakin_env(cfg)
    return cfg, env, params, population_spec(cfg, "sac" if cfg.algo.name == "sac" else "ppo")


def _leaves(carry) -> list:
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    return [t.detach().clone() for t in tree_tensors(carry)]


def _as_carry(like, flat: list):
    """``flat`` (``_leaves`` of a carry shaped as ``like``) back in the carry's tree."""
    leaves = iter(flat)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v) for v in tree)
        return next(leaves) if isinstance(tree, torch.Tensor) else tree

    return rebuild(like)


def _unequal_leaves(a, b) -> list:
    """Indices of the leaves in which two carries differ in any bit."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return [f"{len(la)} leaves against {len(lb)}"]
    return [i for i, (x, y) in enumerate(zip(la, lb)) if x.device != y.device or not torch.equal(x, y)]


def _ppo_draws(member, gen: torch.Generator) -> dict:
    """Seeded draws for a ``PPOAnakin(injected=True)``'s whole rollout: Gumbel noise per
    head, the envs' reset draws."""
    T, N = member.T, member.num_envs
    draws = {"actions": [-torch.log(-torch.log(torch.rand(buf.shape, generator=gen, device=gen.device).clamp(1e-20, 1.0)))
                         for buf in member.inputs["actions"]],
             "reset": member.env.reset_draws(member.env_params, (T, N), gen, gen.device)}
    return draws


def _inject_ppo(member, draws: dict) -> None:
    with torch.no_grad():
        for buf, d in zip(member.inputs["actions"], draws["actions"]):
            buf.copy_(d)
        member.inputs["reset"].copy_(draws["reset"])


def _sac_draws(member, steps: int, rows_before: int, train: bool, gen: torch.Generator) -> dict:
    """Seeded draws for ``steps`` iterations of a ``SACAnakin(injected=True)``: the acting
    noise (or the prefill's env actions), the reset draws, ring indices within the rows
    each iteration's update can see, the update's normals."""
    dev, N, B, A = gen.device, member.num_envs, member.batch_size, member.act_dim
    G = member.inputs["envs"].shape[1]
    if train:
        act = torch.randn((steps, N, A), generator=gen, device=dev)
    else:
        act = member.env.sample_action(member.env_params, (steps, N), gen, dev)
    filled = torch.clamp(torch.arange(rows_before + 1, rows_before + steps + 1, device=dev), max=member.ring.capacity).float()
    return {
        "act": act, "reset": member.env.reset_draws(member.env_params, (steps, N), gen, dev),
        "envs": torch.randint(0, N, (steps, G, B), generator=gen, device=dev),
        "rows": (torch.rand((steps, G, B), generator=gen, device=dev) * filled[:, None, None]).long(),
        "next": torch.randn((steps, G, B, A), generator=gen, device=dev), "new": torch.randn((steps, G, B, A), generator=gen, device=dev),
    }


def _inject_sac(member, draws: dict) -> None:
    with torch.no_grad():
        for k, v in draws.items():
            member.inputs[k][: len(v)].copy_(v.to(member.inputs[k].device))


def _dispatch_turns(label: str, runs: dict, env_steps: int, grad_steps: int, reps: int) -> list:
    """Eager, graph, graph, eager: ``reps`` dispatches each (``runs[mode]()`` enqueues one),
    timed to a synchronize; env steps/s and gradient steps/s, the host's ms to enqueue a
    dispatch, device ms, kernels and the busy share of one profiled dispatch, peak and
    reserved memory."""
    turns = []
    for mode in ("eager", "graph", "graph", "eager"):
        fn = runs[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        host = []
        start = time.perf_counter()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        prof = profile_calls(fn, 1, f"{label} {mode} dispatch", {"mode": mode})
        device_ms = prof.get("device_ms_per_call")
        turns.append({
            "mode": mode, "env_steps_per_s": reps * env_steps / seconds, "grad_steps_per_s": reps * grad_steps / seconds,
            "host_ms_per_dispatch": 1e3 * sum(host) / reps, "device_ms_per_dispatch": device_ms,
            "kernels_per_dispatch": prof.get("kernels_per_call"),
            "busy_share_timed": device_ms * reps / seconds / 1e3 if device_ms else None,
            "peak_allocated_bytes": peak, "reserved_bytes": torch.cuda.memory_reserved(),
        })
    log(f"{label} turns " + json.dumps(turns))
    return turns


def phase_anakin_ppo_graph(device: torch.device) -> dict:
    """``exp=ppo_anakin`` at its published widths (256 batched CartPole envs x 128 steps, 4
    epochs x 16 minibatches of 2,048, bf16-mixed): one iteration replayed from captured
    graphs against the eager iteration from the same carry, draws and permutations, bit
    for bit; then eager, graph, graph, eager; no K1/K2 launch."""
    from sheeprl_tpu_torch.engine.anakin import PPOAnakin
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.parallel.context import RunContext

    set_tf32(True)
    label = "[anakin-ppo-graph]"
    cfg, env, params, _ = _anakin_parts(["exp=ppo_anakin"], device)
    num_updates = int(cfg.algo.total_steps) // (cfg.env.num_envs * cfg.algo.rollout_steps)
    members = {mode: PPOAnakin(RunContext(device, 31, torch.bfloat16), cfg, env, params, "state", num_updates, capture=mode == "graph", injected=True)
               for mode in ("graph", "eager")}
    gen = torch.Generator(device=device).manual_seed(8)
    draws = _ppo_draws(members["graph"], gen)
    perms = members["graph"].fns.permutations(gen)
    coefs = torch.tensor([cfg.algo.clip_coef, cfg.algo.ent_coef], dtype=torch.float32, device=device)
    if _unequal_leaves(members["graph"].carry(), members["eager"].carry()):
        raise AssertionError(f"{label}: the two members start from different carries")
    zero_launches()
    out = {}
    for mode, m in members.items():
        _inject_ppo(m, draws)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out[mode] = m.iterate(coefs, perms)
        torch.cuda.synchronize()
        out[f"{mode}_seconds"] = time.perf_counter() - start
    counts = launch_counts()
    differ = _unequal_leaves(members["graph"].carry(), members["eager"].carry())
    losses = {k: float(v) for k, v in out["graph"].items()}
    row = {"envs": cfg.env.num_envs, "rollout_steps": cfg.algo.rollout_steps, "grad_steps_per_iteration": members["graph"].fns.grad_steps_per_update,
           "first_graph_iteration_seconds": out["graph_seconds"], "first_eager_iteration_seconds": out["eager_seconds"],
           "carry_leaves_differing": differ, "metrics": losses, "k1_k2_launches": counts}
    log(f"{label} parity " + json.dumps(row))
    if differ or any(counts.values()) or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{label}: the captured iteration differs from the eager one in carry leaves {differ}, or launched {counts}")
    env_steps = cfg.env.num_envs * cfg.algo.rollout_steps
    runs = {mode: (lambda m=m: m.iterate(coefs, perms)) for mode, m in members.items()}
    row["turns"] = _dispatch_turns(label, runs, env_steps, members["graph"].fns.grad_steps_per_update, 3)
    row["breakdown"] = _ppo_breakdown(members["graph"], coefs, perms)
    log(f"{label} where a graphed iteration's device time goes (ms) " + json.dumps(row["breakdown"]))
    return row


def _env_step_ms(env, params, n: int, device: torch.device) -> float:
    """Device ms of one batched env step with its auto-reset (``n`` envs, random actions,
    injected reset draws) from a CUDA graph: the env's share of an Anakin step."""
    gen = torch.Generator(device=device).manual_seed(12)
    state, _ = env.reset(params, env.reset_draws(params, (n,), gen, device))
    actions = env.sample_action(params, (n,), gen, device)
    draws = env.reset_draws(params, (n,), gen, device)
    return graph_ms(lambda: env.step_autoreset(params, state, actions, draws=draws))


def _ppo_breakdown(m, coefs, perms) -> dict:
    """A graphed iteration split by CUDA events between its parts (each device-bound):
    the rollout's replays, the bootstrap value and GAE, the update; and the batched env
    step alone, times the rollout's steps."""
    from sheeprl_tpu_torch.algos.ppo.ppo import flat_batch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        m.t.zero_()
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(m.T):
        m._rollout_step()
    ev[1].record()
    traj = m.traj
    returns, advantages = m.fns.gae_fn(traj["rewards"][..., None], traj["values"][..., None], traj["dones"][..., None], m._bootstrap()["v"])
    ev[2].record()
    m.fns.launch_update_coefs(flat_batch(traj, returns, advantages, [m.obs_key, "actions", "logprobs", "values"]), perms, coefs)
    ev[3].record()
    torch.cuda.synchronize()
    env_ms = _env_step_ms(m.env, m.env_params, m.num_envs, m.device) * m.T
    rollout = ev[0].elapsed_time(ev[1])
    return {"rollout": rollout, "of_it_env_steps": env_ms, "of_it_acting_and_bookkeeping": rollout - env_ms,
            "bootstrap_and_gae": ev[1].elapsed_time(ev[2]), "update": ev[2].elapsed_time(ev[3])}


def phase_anakin_sac_graph(device: torch.device) -> dict:
    """``exp=sac_anakin`` at its published widths (128 batched Pendulum envs, MLPs 256 x 2,
    batch 256, a 1,000,000-row ring on the card, 64 iterations a dispatch, bf16-mixed):
    the prefill (39 iterations) and one training dispatch replayed from captured graphs
    against the eager ones from the same carry and draws, bit for bit; then eager, graph,
    graph, eager over training dispatches; no K1/K2 launch."""
    from sheeprl_tpu_torch.engine.anakin import SACAnakin, sac_ring
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.parallel.context import RunContext

    set_tf32(True)
    label = "[anakin-sac-graph]"
    cfg, env, params, _ = _anakin_parts(["exp=sac_anakin"], device)
    steps, prefill = int(cfg.algo.anakin_steps_per_dispatch), int(cfg.algo.learning_starts) // int(cfg.env.num_envs)
    members = {mode: SACAnakin(RunContext(device, 41, torch.bfloat16), cfg, env, params, "state", sac_ring(cfg, env, params, device),
                               capture=mode == "graph", injected=True, injected_steps=max(steps, prefill))
               for mode in ("graph", "eager")}
    gen = torch.Generator(device=device).manual_seed(9)
    g0 = members["graph"]
    pre = _sac_draws(g0, prefill, 0, False, gen)
    train = _sac_draws(g0, steps, prefill, True, gen)
    zero_launches()
    seconds = {}
    for mode, m in members.items():
        _inject_sac(m, pre)
        m.dispatch(prefill, 0, False)
        _inject_sac(m, train)
        torch.cuda.synchronize()
        start = time.perf_counter()
        met = m.dispatch(steps, 1, True)
        torch.cuda.synchronize()
        seconds[mode] = time.perf_counter() - start
    counts = launch_counts()
    differ = _unequal_leaves(members["graph"].carry(), members["eager"].carry())
    losses = {k: float(v) for k, v in met.items()}
    row = {"envs": cfg.env.num_envs, "ring_rows_per_env": g0.ring.capacity, "ring_bytes": sum(a.numel() * a.element_size() for a in g0.arrays.values()),
           "steps_per_dispatch": steps, "prefill_steps": prefill, "first_training_dispatch_seconds": seconds,
           "carry_leaves_differing": differ, "metrics": losses, "k1_k2_launches": counts}
    log(f"{label} parity " + json.dumps(row))
    if differ or any(counts.values()) or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{label}: the captured dispatch differs from the eager one in carry leaves {differ}, or launched {counts}")
    runs = {mode: (lambda m=m: m.dispatch(steps, 1, True)) for mode, m in members.items()}
    row["turns"] = _dispatch_turns(label, runs, steps * cfg.env.num_envs, steps, 2)
    # per iteration: a training one, a prefill one (uniform actions: env, ring write, no
    # update) and the batched env step alone, each device-bound (CUDA events)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    g0.dispatch(steps, 1, True)
    ev[1].record()
    g0.dispatch(steps, 0, False)
    ev[2].record()
    torch.cuda.synchronize()
    train_ms, prefill_ms = ev[0].elapsed_time(ev[1]) / steps, ev[1].elapsed_time(ev[2]) / steps
    env_ms = _env_step_ms(env, params, g0.num_envs, device)
    row["breakdown"] = {"training_iteration": train_ms, "prefill_iteration": prefill_ms, "of_it_env_step": env_ms,
                        "policy_acting_and_update": train_ms - prefill_ms}
    log(f"{label} where a graphed iteration's device time goes (ms) " + json.dumps(row["breakdown"]))
    return row


def _ppo_pop(device: torch.device) -> dict:
    from sheeprl_tpu_torch.engine.anakin import build_ppo_members
    from sheeprl_tpu_torch.engine.population import PopulationSpec
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg, env, params, pop = _anakin_parts(["exp=ppo_anakin_pop"], device)
    num_updates = int(cfg.algo.total_steps) // (cfg.env.num_envs * cfg.algo.rollout_steps)
    members, tables = build_ppo_members(RunContext(device, 51, torch.bfloat16), cfg, env, params, "state", num_updates, pop)
    start0 = _leaves(members[0].carry())

    def dispatch(u: int):
        return [m.iterate(tables[i][u]) for i, m in enumerate(members)]

    def alone(u_count: int):
        (one,), (table,) = build_ppo_members(RunContext(device, 99, torch.bfloat16), cfg, env, params, "state", num_updates, PopulationSpec())
        one.load_carry(_as_carry(one.carry(), start0))
        for u in range(u_count):
            one.iterate(table[u])
        return one

    def capture():  # the rollout's and the bootstrap's graphs of every member; the update's are captured in its first dispatch
        for m in members:
            m._programs()

    return {"cfg": cfg, "members": members, "dispatch": dispatch, "alone": alone, "env_steps": cfg.env.num_envs * cfg.algo.rollout_steps,
            "grad_steps": members[0].fns.grad_steps_per_update, "capture": capture, "first": lambda: dispatch(0), "steady": [1, 2]}


def _sac_pop(device: torch.device) -> dict:
    from sheeprl_tpu_torch.engine.anakin import build_sac_members
    from sheeprl_tpu_torch.engine.population import PopulationSpec
    from sheeprl_tpu_torch.parallel.context import RunContext

    cfg, env, params, pop = _anakin_parts(["exp=sac_anakin_pop"], device)
    steps, prefill = int(cfg.algo.anakin_steps_per_dispatch), int(cfg.algo.learning_starts) // int(cfg.env.num_envs)
    members = build_sac_members(RunContext(device, 61, torch.bfloat16), cfg, env, params, "state", pop)
    start0 = _leaves(members[0].carry())

    def dispatch(u: int):
        return [m.dispatch(prefill, 0, False) if u < 0 else m.dispatch(steps, 1, True) for m in members]

    def alone(u_count: int):
        (one,) = build_sac_members(RunContext(device, 99, torch.bfloat16), cfg, env, params, "state", PopulationSpec())
        one.load_carry(_as_carry(one.carry(), start0))
        one.dispatch(prefill, 0, False)
        for _ in range(u_count):
            one.dispatch(steps, 1, True)
        return one

    def capture():  # both graphs of every member (the prefill's and the training one)
        for m in members:
            m._program(0, False)
            m._program(1, True)

    def first():
        dispatch(-1)
        return dispatch(0)

    return {"cfg": cfg, "members": members, "dispatch": dispatch, "alone": alone, "env_steps": steps * cfg.env.num_envs,
            "grad_steps": steps, "capture": capture, "first": first, "steady": [1, 2]}


def phase_anakin_pop(device: torch.device) -> dict:
    """The two population presets at their published sizes (``exp=ppo_anakin_pop``: 16
    members x 64 envs; ``exp=sac_anakin_pop``: 16 x 32 envs, a 250,000-row ring each,
    bf16-mixed): every member's graphs captured (seconds; PPO captures its update's
    graphs in the first dispatch), the reserved memory the captures and the first
    dispatch add, two steady dispatches timed (env and gradient steps/s per member and in
    all), and member 0 against a standalone run from its starting carry, bit for bit; no
    K1/K2 launch."""
    from sheeprl_tpu_torch.ops.counters import launch_counts

    set_tf32(True)
    rows = {}
    for name, make in (("ppo_anakin_pop", _ppo_pop), ("sac_anakin_pop", _sac_pop)):
        label = f"[anakin-pop] {name}"
        zero_launches()
        parts = make(device)
        k = len(parts["members"])
        torch.cuda.synchronize()
        gc.collect()  # graphs of an earlier phase in reference cycles: freed now, not during this one
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        start = time.perf_counter()
        parts["capture"]()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - start
        start = time.perf_counter()
        parts["first"]()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - start
        graph_bytes = torch.cuda.memory_reserved() - reserved0
        start = time.perf_counter()
        for u in parts["steady"]:
            parts["dispatch"](u)
        torch.cuda.synchronize()
        steady_s = (time.perf_counter() - start) / len(parts["steady"])
        counts = launch_counts()
        alone = parts["alone"](1 + len(parts["steady"]))
        differ = _unequal_leaves(parts["members"][0].carry(), alone.carry())
        row = {"members": k, "envs_per_member": parts["cfg"].env.num_envs, "capture_seconds": capture_s, "first_dispatch_seconds": first_s,
               "steady_dispatch_seconds": steady_s, "reserved_bytes_added_by_captures_and_first_dispatch": graph_bytes,
               "env_steps_per_s_per_member": parts["env_steps"] / steady_s, "env_steps_per_s_total": k * parts["env_steps"] / steady_s,
               "grad_steps_per_s_per_member": parts["grad_steps"] / steady_s, "grad_steps_per_s_total": k * parts["grad_steps"] / steady_s,
               "member0_leaves_differing_from_standalone": differ, "k1_k2_launches": counts}
        log(f"{label} " + json.dumps(row))
        if differ or any(counts.values()):
            raise AssertionError(f"{label}: member 0 differs from its standalone run in leaves {differ}, or launched {counts}")
        rows[name] = row
        del parts, alone
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _tree_cpu(tree):
    if isinstance(tree, dict):
        return {k: _tree_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def _agreement_row(label: str, a_cpu, a_dev, before: dict, lr: float, met_c: dict, met_d: dict, opt_c: dict, opt_d: dict, extra: dict) -> dict:
    """``[train-agreement]``'s limits on one module's parameter change, the Adam moments
    and the losses, CPU (``a_cpu``) against the card (``a_dev``)."""
    tol = TRAIN_AGREEMENT_TOL
    sd = a_dev.state_dict()
    diff = torch.cat([(sd[k].float().cpu() - v.float()).abs().flatten() for k, v in a_cpu.state_dict().items()])
    moved = torch.cat([(v.float() - before[k].float()).abs().flatten() for k, v in a_cpu.state_dict().items()])
    steps = {"max_of_lr": (diff.max() / lr).item(), "share_over": (diff > tol["step_of_lr"] * lr).float().mean().item(),
             "moved_max_of_lr": (moved.max() / lr).item()}
    moments = _moment_diff(_tree_cpu(opt_d), opt_c)
    metrics = {k: (float(met_c[k]), float(met_d[k])) for k in met_c}
    bad = [k for k, (c, d) in metrics.items() if abs(c - d) > tol["metrics_atol"] + tol["metrics_rtol"] * abs(c)]
    if steps["share_over"] > tol["off_share"] or steps["moved_max_of_lr"] <= 0:
        bad.append(f"parameter change {steps}")
    if moments > tol["moments_rtol"]:
        bad.append(f"moments {moments}")
    row = {"steps": steps, "moments_rel": moments, "metrics": metrics, **extra}
    log(f"{label} " + json.dumps(row))
    if bad:
        raise AssertionError(f"{label}: the card disagrees with the CPU: {bad}")
    return row


def phase_anakin_agreement(device: torch.device) -> dict:
    """One small Anakin PPO iteration (16 envs x 16 steps, 2 epochs x 4 minibatches) and
    one small SAC prefill plus training dispatch (16 envs, MLPs 64 x 2, batch 64, 8 + 8
    iterations) on the card (captured) against the CPU: same weights, carry and draws,
    float32, TF32 off, under ``[train-agreement]``'s limits; the collected batch and the
    ring's rows within 1e-4."""
    from sheeprl_tpu_torch.engine.anakin import PPOAnakin, SACAnakin, sac_ring
    from sheeprl_tpu_torch.ops.counters import launch_counts
    from sheeprl_tpu_torch.parallel.context import RunContext

    set_tf32(False)
    cpu = torch.device("cpu")
    zero_launches()
    cfg, env, params, _ = _anakin_parts(SMALL_ANAKIN_PPO, cpu)
    reset = env.reset_draws(params, (cfg.env.num_envs,), torch.Generator().manual_seed(3))
    ppo = {d.type: PPOAnakin(RunContext(d, 21), cfg, env, params, "state", 4, injected=True, reset_draws=reset.to(d)) for d in (cpu, device)}
    gen = torch.Generator().manual_seed(4)
    draws, perms = _ppo_draws(ppo["cpu"], gen), ppo["cpu"].fns.permutations(gen)
    before = {k: v.clone() for k, v in ppo["cpu"].agent.state_dict().items()}
    met, batch = {}, {}
    for dev, m in ppo.items():
        _inject_ppo(m, {"actions": [a.to(m.device) for a in draws["actions"]], "reset": draws["reset"].to(m.device)})
        met[dev] = m.iterate(torch.tensor([cfg.algo.clip_coef, cfg.algo.ent_coef], device=m.device), perms.to(m.device))
        batch[dev] = {k: v.detach().float().cpu() for k, v in m.last_batch.items()}
    batch_off = max((batch["cpu"][k] - batch["cuda"][k]).abs().max().item() for k in batch["cpu"])
    out = {"ppo": _agreement_row("[anakin-agreement] ppo", ppo["cpu"].agent, ppo["cuda"].agent, before, cfg.algo.optimizer.lr, met["cpu"], met["cuda"],
                                 {"agent": ppo["cpu"].fns.opt_state}, {"agent": ppo["cuda"].fns.opt_state}, {"batch_max_diff": batch_off})}
    if batch_off > 1e-4:
        raise AssertionError(f"[anakin-agreement] ppo: the collected batches differ by {batch_off}")
    cfg, env, params, _ = _anakin_parts(SMALL_ANAKIN_SAC, cpu)
    reset = env.reset_draws(params, (cfg.env.num_envs,), torch.Generator().manual_seed(6))
    sac = {d.type: SACAnakin(RunContext(d, 22), cfg, env, params, "state", sac_ring(cfg, env, params, d), injected=True, injected_steps=8,
                             reset_draws=reset.to(d)) for d in (cpu, device)}
    gen = torch.Generator().manual_seed(5)
    pre, train = _sac_draws(sac["cpu"], 8, 0, False, gen), _sac_draws(sac["cpu"], 8, 8, True, gen)
    before = {k: v.clone() for k, v in sac["cpu"].agent.state_dict().items()}
    for dev, m in sac.items():
        _inject_sac(m, pre)
        m.dispatch(8, 0, False)
        _inject_sac(m, train)
        met[dev] = m.dispatch(8, 1, True)
    ring_off = max((sac["cpu"].arrays[k] - sac["cuda"].arrays[k].cpu()).abs().max().item() for k in sac["cpu"].arrays)
    out["sac"] = _agreement_row("[anakin-agreement] sac", sac["cpu"].agent, sac["cuda"].agent, before, cfg.algo.critic.optimizer.lr, met["cpu"],
                                met["cuda"], sac["cpu"].opt_states, sac["cuda"].opt_states, {"ring_max_diff": ring_off})
    counts = launch_counts()
    if ring_off > 1e-4 or any(counts.values()):
        raise AssertionError(f"[anakin-agreement] sac: the rings differ by {ring_off}, or K1/K2 launched {counts}")
    out["k1_k2_launches"] = counts
    return out


def phase_anakin_cli(device: torch.device, workdir: Path) -> dict:
    """Each Anakin exp through the train entry at its published widths (``ANAKIN_CLI``: cut
    total steps): train, resume from its first checkpoint to the same end, evaluate the
    last checkpoint through the eval entry; K1/K2 launches counted around each run (none)."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run
    from sheeprl_tpu_torch.ops.counters import launch_counts

    set_tf32(True)
    rows = {}
    for exp, (cuts, first_ckpt) in ANAKIN_CLI.items():
        tag = f"[anakin-cli] {exp}"
        overrides = [f"exp={exp}", *cuts, f"device={device.type}", f"log_root={workdir / exp}"]
        row = {}
        zero_launches()
        first = run(overrides)
        row["train"] = {"policy_steps": first.policy_steps, "grad_steps": first.grad_steps, "seconds": first.seconds,
                        "policy_steps_per_s": first.policy_steps / first.seconds, "test_reward": first.test_reward, "k1_k2_launches": launch_counts()}
        mid = next(p for p in CheckpointManager(Path(first.log_dir) / "checkpoints").list_checkpoints() if p.name == first_ckpt)
        zero_launches()
        resumed = run([*overrides, f"checkpoint.resume_from={mid}"])
        start = int(first_ckpt.split("_")[1])
        row["resume"] = {"policy_steps": resumed.policy_steps - start, "grad_steps": resumed.grad_steps, "seconds": resumed.seconds,
                         "k1_k2_launches": launch_counts()}
        zero_launches()
        result = evaluate([f"checkpoint_path={resumed.checkpoint}", "env.capture_video=False", f"log_root={workdir / exp}"])
        row["eval"] = {"steps": result.steps, "reward": result.reward, "k1_k2_launches": launch_counts()}
        log(f"{tag} " + json.dumps(row))
        if (first.grad_steps <= 0 or resumed.policy_steps != first.policy_steps or not 0 < resumed.grad_steps < first.grad_steps
                or result.steps <= 0 or not math.isfinite(result.reward) or any(any(r["k1_k2_launches"].values()) for r in row.values())):
            raise AssertionError(f"{tag}: {row}")
        rows[exp] = row
    return rows


# --------------------------------------------------------------------------- Sebulba
# the placed-process mode (python -m sheeprl_tpu_torch.sebulba): [sebulba-sac-cli] at
# exp=sac_decoupled's widths, two actors of 4 sync envs, [sac-decoupled-cli]'s steps;
# [sebulba-ppo-cli] at [ppo-decoupled-cli]'s run with one actor; [sebulba-kill] at small
# widths, learning from the first iteration (every block takes a gradient step) and a
# run long enough that actor 1 still acts while actor 0's respawn starts (2,500 iterations
# an actor; the kill window read 14-16 s on an NVIDIA H100 80GB HBM3 host at 700 W)
SEBULBA_SAC = ["exp=sac_decoupled", "env.sync_env=True", *SAC_CLI_STEPS["sac"], "distributed.num_actors=2", "algo.run_test=False"]
SEBULBA_KILL = ["exp=sac_decoupled", "algo.hidden_size=64", "algo.per_rank_batch_size=64", "env.sync_env=True", "algo.total_steps=20000",
                "algo.learning_starts=0", "algo.replay_ratio=0.25", "buffer.size=65536", "checkpoint.every=0", "metric.log_level=0",
                "algo.run_test=False", "distributed.num_actors=2", "distributed.respawn_backoff_s=0.2", "chaos.kill_actor_at_step=100",
                "chaos.kill_actor_index=0"]
SEBULBA_TIMEOUT_S = 300


def _sebulba(module: str, overrides: list, workdir: Path, tag: str, **env_extra) -> tuple:
    """``python -m <module> <overrides>`` in a session of its own (its children in its
    process group, killed whole on the way out); raises unless it exits 0. A run that
    outlasts ``SEBULBA_TIMEOUT_S`` first gets SIGABRT in every process of its group, which
    prints each one's Python stacks into the output (``PYTHONFAULTHANDLER``). Returns the
    learner's summary (``SHEEPRL_TPU_SEBULBA_SUMMARY``, if written) and the output."""
    import signal

    out_path, summary_path = workdir / f"{tag}.out", workdir / f"{tag}.json"
    env = {**os.environ, "OMP_NUM_THREADS": str(ENTRY_THREADS), "SHEEPRL_TPU_SEBULBA_SUMMARY": str(summary_path),
           "PYTHONFAULTHANDLER": "1", "PYTHONUNBUFFERED": "1", **{k: str(v) for k, v in env_extra.items()}}
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", module, *overrides], cwd=Path(__file__).resolve().parent, env=env,
                                stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            rc = proc.wait(timeout=SEBULBA_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGABRT)
            time.sleep(3.0)
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    output = out_path.read_text()
    if rc != 0:
        raise AssertionError(f"[{tag}] {module} exited {rc}:\n{output[-20000:]}")
    return (json.loads(summary_path.read_text()) if summary_path.is_file() else None), output


def _no_kernels(paths: dict, tag: str) -> None:
    if any(any(c.values()) for c in paths.values()):
        raise AssertionError(f"[{tag}] a Sebulba process launched K1 or K2: {paths}")


def _process_paths(summary: dict, prefix: str) -> dict:
    """Each process's launch counts from a learner's summary, by path name."""
    return {f"{prefix}_learner": summary["learner"]["launches"],
            **{f"{prefix}_actor{k}": a["launches"] for k, a in summary["actors"].items()}}


def _trace_rates(summary: dict, num_envs: int) -> dict:
    """Policy and gradient steps/s between the learner's first and last block, and over
    the learner's whole loop (the actors' start-up included)."""
    (t0, g0), (t1, g1) = summary["grad_step_trace"][0], summary["grad_step_trace"][-1]
    blocks = len(summary["grad_step_trace"])
    return {"policy_steps_per_s": (blocks - 1) * num_envs / (t1 - t0), "grad_steps_per_s": (g1 - g0) / (t1 - t0),
            "loop_policy_steps_per_s": summary["env_steps_total"] / summary["wall_time_s"], "loop_seconds": summary["wall_time_s"]}


def _sac_expected(cfg, num_actors: int) -> tuple:
    """Blocks, env steps, gradient steps and publications a SAC placement must account
    for: each actor's ``Ratio`` replayed as the actor calls it."""
    from sheeprl_tpu_torch.utils.utils import Ratio

    num_envs = int(cfg.env.num_envs)
    per_iter = num_envs * num_actors
    iters = int(cfg.algo.total_steps) // per_iter
    starts = int(cfg.algo.learning_starts) // per_iter
    grad, pubs = 0, 0
    for _ in range(num_actors):
        ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
        for it in range(starts, iters + 1):
            g = max(ratio((it * per_iter - max(starts - 1, 0) * per_iter) / num_actors), 0) if it >= max(starts, 1) else 0
            grad, pubs = grad + g, pubs + (g > 0)
    return num_actors * iters, num_actors * iters * num_envs, grad, pubs


def phase_sebulba_sac_cli(device: torch.device, workdir: Path) -> dict:
    """``[sebulba-sac-cli]``: train with two actors, account for every block, resume the
    learner from its checkpoint, evaluate the resumed run's last checkpoint."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.ops.counters import launch_counts

    overrides = [*SEBULBA_SAC, f"device={device.type}", f"log_root={workdir / 'logs'}"]
    cfg = compose(overrides=overrides)
    num_actors = int(cfg.distributed.num_actors)
    s, output = _sebulba("sheeprl_tpu_torch.sebulba", overrides, workdir, "sebulba-sac-cli")
    blocks, env_steps, grad, pubs = _sac_expected(cfg, num_actors)
    got = (s["blocks"], s["env_steps_total"], s["cumulative_grad_steps"], s["publishes"])
    trace = s["grad_step_trace"]
    batch_bytes = grad * int(cfg.algo.per_rank_batch_size) * (2 * 17 + 6 + 2) * 4  # obs, next_obs, actions, reward, done
    actor_bytes = sum(4 * n for n in (17 * 256 + 256, 256 * 256 + 256, 256 * 12 + 12))  # MLP 256 x 2, mean and log-std heads
    if (got != (blocks, env_steps, grad, pubs) or s["error"] is not None or len(trace) != blocks or trace[-1][1] != grad
            or s["bytes_received"] < batch_bytes or not pubs * actor_bytes <= s["bytes_published"] <= (pubs + num_actors) * num_actors * (actor_bytes + 8192)
            or sorted(s["actors"]) != [f"{i}_g0" for i in range(num_actors)]):
        raise AssertionError(f"[sebulba-sac-cli] the summary does not account for every block: blocks, env steps, gradient steps, "
                             f"publications {got} against {(blocks, env_steps, grad, pubs)}; {len(trace)} trace points; bytes "
                             f"received {s['bytes_received']} (blocks {batch_bytes}), published {s['bytes_published']} "
                             f"(one publication {actor_bytes}); actors {sorted(s['actors'])}; error {s['error']}")
    paths = _process_paths(s, "sebulba_sac")
    row = {"summary_counts": dict(zip(("blocks", "env_steps", "grad_steps", "publishes"), got)), **_trace_rates(s, int(cfg.env.num_envs)),
           "publish_ms": s["publish_ms"], "staleness_steps": s["staleness_steps"],
           "peak_bytes": {"learner": s["learner"]["peak_bytes"], **{k: a["peak_bytes"] for k, a in s["actors"].items()}},
           "bytes_received": s["bytes_received"], "bytes_published": s["bytes_published"]}
    log("[sebulba-sac-cli] train: " + json.dumps(row))
    # the resume as a dry run with one actor (one block): it loads the learner's
    # parameters and optimizer state, takes a block's gradient steps and checkpoints
    first = next(p for p in sorted(Path(s["checkpoint"]).parent.iterdir()) if p.name == "ckpt_1024")
    r, _ = _sebulba("sheeprl_tpu_torch.sebulba", [*overrides, f"checkpoint.resume_from={first}", "dry_run=True", "distributed.num_actors=1"],
                    workdir, "sebulba-sac-resume")
    counts = [int(CheckpointManager.load(c)["opt_state"]["critic"]["count"]) for c in (first, r["checkpoint"])]
    if r["blocks"] != 1 or r["cumulative_grad_steps"] <= 0 or counts[1] != counts[0] + r["cumulative_grad_steps"] or r["error"] is not None:
        raise AssertionError(f"[sebulba-sac-cli] resume from {first}: {r['blocks']} blocks, {r['cumulative_grad_steps']} gradient steps, "
                             f"the critic's optimizer count {counts[0]} -> {counts[1]}")
    paths.update(_process_paths(r, "sebulba_sac_resume"))
    zero_launches()
    result = evaluate([f"checkpoint_path={r['checkpoint']}", "env.capture_video=False", f"log_root={workdir / 'logs'}"])
    paths["sebulba_sac_eval"] = launch_counts()
    _no_kernels(paths, "sebulba-sac-cli")
    if not math.isfinite(result.reward) or result.steps <= 0:
        raise AssertionError(f"[sebulba-sac-cli] eval: {result.steps} steps, reward {result.reward}")
    log(f"[sebulba-sac-cli] resumed from {first.name}: {r['cumulative_grad_steps']} gradient steps, the critic's optimizer count "
        f"{counts[0]} -> {counts[1]}; eval of {Path(r['checkpoint']).name}: reward {result.reward}, {result.steps} steps; K1/K2 launches {paths}")
    return {"train": row, "resume_grad_steps": r["cumulative_grad_steps"], "k1_k2_launches": paths,
            "launcher_lines": [ln for ln in output.splitlines() if ln.startswith("[sebulba]") and "spawning" not in ln]}


def phase_sebulba_ppo_cli(device: torch.device, workdir: Path) -> dict:
    """``[sebulba-ppo-cli]``: ``[ppo-decoupled-cli]``'s run placed with one actor, beside
    the thread mode's run in this process; the learner consumes the thread path's batches
    line for line."""
    import concurrent.futures as cf

    from sheeprl_tpu_torch.cli import run

    base = ["exp=ppo_decoupled", *_PPO_DECOUPLED_CLI, f"device={device.type}"]
    digests = {m: workdir / f"{m}.digest" for m in ("thread", "sebulba")}
    with cf.ThreadPoolExecutor(1) as pool:
        placed = pool.submit(_sebulba, "sheeprl_tpu_torch.sebulba", [*base, f"log_root={workdir / 'sebulba'}", "distributed.num_actors=1"],
                             workdir, "sebulba-ppo-cli", SHEEPRL_TPU_BATCH_DIGEST=digests["sebulba"])
        os.environ["SHEEPRL_TPU_BATCH_DIGEST"] = str(digests["thread"])
        try:
            run([*base, f"log_root={workdir / 'thread'}"])
        finally:
            del os.environ["SHEEPRL_TPU_BATCH_DIGEST"]
        s, _ = placed.result()
    lines = {m: p.read_text().splitlines() for m, p in digests.items()}
    if len(lines["thread"]) != 4 or lines["sebulba"] != lines["thread"] or (s["blocks"], s["publishes"]) != (4, 4) or s["error"]:
        raise AssertionError(f"[sebulba-ppo-cli] batch digests: thread {lines['thread']}, sebulba {lines['sebulba']}; "
                             f"{s['blocks']} blocks, {s['publishes']} publications, error {s['error']}")
    paths = _process_paths(s, "sebulba_ppo")
    _no_kernels(paths, "sebulba-ppo-cli")
    row = {"digest_lines_equal": len(lines["thread"]), **_trace_rates(s, 128 * 4), "publish_ms": s["publish_ms"],
           "staleness_steps": s["staleness_steps"], "k1_k2_launches": paths,
           "peak_bytes": {"learner": s["learner"]["peak_bytes"], **{k: a["peak_bytes"] for k, a in s["actors"].items()}}}
    log("[sebulba-ppo-cli] " + json.dumps(row))
    return row


def phase_sebulba_kill(device: torch.device, workdir: Path) -> dict:
    """``[sebulba-kill]``: actor 0 SIGKILLed; its generation 1 reconnects and finishes, the
    learner's gradient-step trace rises strictly inside the kill window, exit 0."""
    overrides = [*SEBULBA_KILL, f"device={device.type}", f"log_root={workdir / 'logs'}"]
    s, output = _sebulba("sheeprl_tpu_torch.sebulba", overrides, workdir, "sebulba-kill")
    events = s["events"]
    kill_t = next((t for t, a, g, e in events if (a, g, e) == (0, 0, "closed")), None)
    respawn_t = next((t for t, a, g, e in events if (a, g, e) == (0, 1, "connected")), None)
    done = {(a, g) for _, a, g, e in events if e == "done"}
    inside = [g for t, g in s["grad_step_trace"] if kill_t is not None and respawn_t is not None and kill_t < t < respawn_t]
    if (kill_t is None or respawn_t is None or respawn_t <= kill_t or done != {(0, 1), (1, 0)} or len(inside) < 2
            or any(b <= a for a, b in zip(inside, inside[1:])) or s["error"] is not None):
        raise AssertionError(f"[sebulba-kill] events {events}; {len(inside)} trace points in the kill window, "
                             f"rising strictly: {all(b > a for a, b in zip(inside, inside[1:]))}; error {s['error']}")
    paths = _process_paths(s, "sebulba_kill")
    _no_kernels(paths, "sebulba-kill")
    row = {"kill_window_s": respawn_t - kill_t, "trace_points_in_window": len(inside), "grad_steps_in_window": inside[-1] - inside[0],
           "blocks": s["blocks"], "grad_steps": s["cumulative_grad_steps"], "k1_k2_launches": paths,
           "launcher_lines": [ln for ln in output.splitlines() if ln.startswith("[sebulba]") and "spawning" not in ln]}
    log("[sebulba-kill] " + json.dumps(row))
    return row


class _Recorder:
    """A logger that keeps what a run logs."""

    def __init__(self):
        self.logged = []

    def log_metrics(self, metrics, step):
        self.logged.append((step, dict(metrics)))

    def close(self):
        pass


def phase_obs(device: torch.device, workdir: Path) -> dict:
    """The observability plane through the train entry at size S (``OBS_RUN``), three
    runs: ``obs.enabled=True`` with a profiler window over two training updates
    (``OBS_CAPTURE``), ``obs.enabled=True`` without, ``obs.enabled=False``. Checks: ``trace.json`` holds ``Time/update`` and the ``Time/phase_*``
    spans; the profile under ``profile/`` holds device kernels, K1's among them;
    ``perf_report.json``'s ``mfu`` lies in (0, 1] and its goodput fractions sum to 1 within
    1e-6; the ``Memory/*`` gauges of a poll equal ``torch.cuda.memory_stats`` read beside
    it; no capture after warm-up (``Compile/recompiles`` 0); every logged ``Health/*``
    finite; policy steps/s of each run; no clean run leaves a blackbox; a small run whose training raises at its third block of
    gradient steps leaves ``blackbox/events.jsonl`` and ``meta.json``."""
    import sheeprl_tpu_torch.algos.dreamer_loop as loop
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.obs.telemetry import DeviceTelemetry
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    set_tf32(True)
    tag, bad, row = "[obs]", [], {}
    get_logger = loop.get_logger
    try:
        for case in ("window", "enabled", "disabled"):
            enabled = case != "disabled"
            log_ = _Recorder()
            loop.get_logger = lambda cfg, log_dir: log_  # noqa: B023
            extra = [f"obs.enabled={enabled}"]
            if case == "window":
                extra.append(f"obs.capture_steps=[{OBS_CAPTURE[0]},{OBS_CAPTURE[1]}]")
            zero_launches()
            result = run([*OBS_RUN, *extra, f"device={device.type}", f"log_root={workdir / f'obs_{case}'}"])
            fwd, bwd = launches()
            log_dir = Path(result.log_dir)
            logged = {}
            for _, m in log_.logged:
                logged.update(m)
            report = json.loads((log_dir / "perf_report.json").read_text())
            r = {"policy_steps": result.policy_steps, "grad_steps": result.grad_steps, "seconds": result.seconds,
                 "policy_steps_per_s": result.policy_steps / result.seconds, "k1_fwd": fwd, "k1_bwd": bwd,
                 "mfu": report["mfu"], "hbm_bw_util": report["hbm_bw_util"], "goodput_fractions": report["goodput_fractions"],
                 "cost_models": report["cost_models"], "cost_model_seconds": report["cost_model_seconds"],
                 "health": {k: v for k, v in logged.items() if k.startswith("Health/")}}
            # the step-time watchdog's auto-capture (the reference's too) may fire where the
            # prefill's fast updates give way to training's
            r["auto_captures"] = sorted(p.name for p in (log_dir / "profile").glob("auto_*.json"))
            r["anomalies"] = report["anomalies"]
            if bwd != 64 * (result.grad_steps + WARMUP_STEPS) or fwd == 0:
                bad.append(f"{case}: K1 launches {(fwd, bwd)} for {result.grad_steps} gradient steps")
            if not r["health"] or not all(math.isfinite(v) for v in r["health"].values()):
                bad.append(f"{case}: Health/* missing or not finite: {r['health']}")
            if not 0 < (report["mfu"] or 0) <= 1 or abs(sum(report["goodput_fractions"].values()) - 1) > 1e-6:
                bad.append(f"{case}: mfu {report['mfu']}, goodput {report['goodput_fractions']}")
            if (log_dir / "blackbox").exists():
                bad.append(f"{case}: a clean run left a blackbox")
            if case == "window":
                spans = {e["name"] for e in json.loads((log_dir / "trace.json").read_text())["traceEvents"] if e["ph"] == "X"}
                r["spans"] = sorted(n for n in spans if not n.endswith("_time"))
                want = {"Time/update", "Time/phase_player", "Time/phase_buffer_add", "Time/phase_dispatch", "Time/phase_env_step",
                        "Time/phase_drain"}
                if not want <= spans:
                    bad.append(f"trace.json lacks {sorted(want - spans)}")
                window = log_dir / "profile" / f"window_rank0_updates{OBS_CAPTURE[0]}-{OBS_CAPTURE[1]}.json"
                kernels = [e["name"] for e in json.loads(window.read_text())["traceEvents"] if e.get("cat") == "kernel"] if window.is_file() else []
                r["profile"] = {"window": window.name, "kernels": len(kernels), "k1": k1_launches(kernels)}
                if not kernels or not r["profile"]["k1"]["fwd"] or not r["profile"]["k1"]["bwd"]:
                    bad.append(f"the profile under profile/: {r['profile']}")
                r["compile"] = {k: v for k, v in logged.items() if k.startswith("Compile/")}
                if r["compile"].get("Compile/recompiles") != 0.0:
                    bad.append(f"captures after warm-up: {r['compile']}")
                r["memory_logged"] = {k: v for k, v in logged.items() if k.startswith("Memory/")}
                if "Memory/bytes_in_use" not in r["memory_logged"]:
                    bad.append(f"no device Memory/* gauge logged: {r['memory_logged']}")
            row[case] = r
        # a poll against memory_stats read beside it (no allocation between the two)
        polled = DeviceTelemetry(interval_s=0.0, devices=[device]).poll(force=True)
        stats = torch.cuda.memory_stats(device)
        row["memory_poll"] = {"polled": polled, "allocated_current": stats["allocated_bytes.all.current"],
                              "allocated_peak": stats["allocated_bytes.all.peak"]}
        if (polled.get("Memory/bytes_in_use/dev0"), polled.get("Memory/peak_bytes_in_use/dev0")) != (
                float(stats["allocated_bytes.all.current"]), float(stats["allocated_bytes.all.peak"])):
            bad.append(f"the Memory/* gauges against memory_stats: {row['memory_poll']}")

        # a run whose training raises at its third block of gradient steps leaves a blackbox
        make_replay = loop.make_device_replay

        def failing_replay(*args, **kwargs):
            dispatcher, mirror, prefetcher, run_block, rb_add = make_replay(*args, **kwargs)
            calls = {"n": 0}

            def failing_block(*a, **k):
                calls["n"] += 1
                if calls["n"] == 3:
                    raise FloatingPointError("injected at the third block of gradient steps")
                return run_block(*a, **k)

            return dispatcher, mirror, prefetcher, failing_block, rb_add

        loop.get_logger = get_logger
        loop.make_device_replay = failing_replay
        try:
            run([*OBS_CRASH, f"device={device.type}", f"log_root={workdir / 'obs_crash'}"])
            bad.append("the crashing run did not raise")
        except FloatingPointError as exc:
            row["crash"] = {"raised": str(exc)}
        finally:
            loop.make_device_replay = make_replay
        boxes = list((workdir / "obs_crash").rglob("blackbox"))
        if len(boxes) != 1 or not all((boxes[0] / f).is_file() for f in ("events.jsonl", "meta.json")):
            bad.append(f"the crashing run's blackbox: {boxes}")
        else:
            meta = json.loads((boxes[0] / "meta.json").read_text())
            row.setdefault("crash", {}).update({k: meta.get(k) for k in ("reason", "algo", "staged_state", "device_name", "torch_version")})
            row["crash"]["events"] = len((boxes[0] / "events.jsonl").read_text().splitlines())
    finally:
        loop.get_logger = get_logger
    log(f"{tag} " + json.dumps(row))
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    return row


# --------------------------------------------------------------------------- fault tolerance
# [fault-dv3]: the DreamerV3-S train entry at [train-cli]'s widths (bf16-mixed) with two
# sync envs (the prefill a sequence of 64 rows an env), SIGTERMed by the chaos schedule at
# policy step 192 and resumed in process (fault.autoresume): 33 gradient steps before the
# kill, 31 after (a resumed run trains again after another learning_starts), a graph
# captured in each attempt. [fault-supervise]: the same widths under python -m
# sheeprl_tpu_torch.supervise, its newest checkpoint (ckpt_128) corrupted at 128 and the
# child SIGKILLed at 136: the relaunch resumes from ckpt_64 (5 gradient steps, then 8).
# [fault-anakin]: exp=ppo_anakin at its published widths cut to two updates, killed at the
# first and resumed in process, beside the same run uninterrupted.
FAULT_DV3 = [*TRAIN_OVERRIDES, "env.sync_env=True", "algo.learning_starts=128", "algo.total_steps=384", "checkpoint.every=128",
             "metric.log_every=64", "algo.run_test=False"]
FAULT_DV3_KILL = 192
FAULT_SUPERVISE = [*TRAIN_OVERRIDES, "env.sync_env=True", "algo.learning_starts=128", "algo.total_steps=208", "checkpoint.every=64",
                   "metric.log_level=0", "algo.run_test=False"]
FAULT_SUPERVISE_AT = (128, 136)  # the corruption's step, the SIGKILL's
FAULT_ANAKIN = ["exp=ppo_anakin", "algo.total_steps=65536", "checkpoint.every=32768", "metric.log_level=0", "algo.run_test=False"]
FAULT_ANAKIN_KILL = 32768
# [fault-supervise]'s children report their K1 launches at each boundary of the training
# guard, the SIGKILLed one up to its last: this ``sitecustomize.py``, on their path, wraps
# ``TrainingGuard.boundary`` once the port imports it, writing ``<pid>.json`` in
# $CHIP_SMOKE_LAUNCH_DIR before each boundary (it imports nothing but the standard library
# at start-up, so the supervisor itself stays free of torch)
LAUNCH_HOOK = '''import importlib.abc, importlib.machinery, json, os, sys

class _GuardHook(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name != "sheeprl_tpu_torch.fault.guard":
            return None
        sys.meta_path.remove(self)
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            boundary = module.TrainingGuard.boundary

            def counted(self, step, save_ckpt=None):
                from sheeprl_tpu_torch.ops.counters import launch_counts
                out = os.path.join(os.environ["CHIP_SMOKE_LAUNCH_DIR"], f"{os.getpid()}.json")
                with open(out + ".tmp", "w") as f:
                    json.dump({"step": int(step), **launch_counts()}, f)
                os.replace(out + ".tmp", out)
                return boundary(self, step, save_ckpt)

            module.TrainingGuard.boundary = counted

        spec.loader.exec_module = exec_module
        return spec

if os.environ.get("CHIP_SMOKE_LAUNCH_DIR"):
    sys.meta_path.insert(0, _GuardHook())
'''


def fault_schedule(cfg, kill_at: int, resume_at=None) -> dict:
    """The Dreamer loop's counters and checkpoint names for a run of ``cfg`` killed at the
    first boundary at or past ``kill_at`` and resumed from its checkpoint at
    ``resume_at`` (None: the preemption's checkpoint at the kill; else a SIGKILL, which
    writes none), replayed from the loop's schedule: ``Ratio`` per iteration from
    ``learning_starts``, offset by the prefill; a resumed run's ``learning_starts`` moves
    on by its first iteration; a checkpoint every ``checkpoint.every`` policy steps and one
    at the end. Returns the final ``iter_num``, ``policy_step`` and
    ``cumulative_grad_steps``, each attempt's checkpoint steps and gradient steps."""
    from sheeprl_tpu_torch.utils.utils import Ratio

    num_envs, every = int(cfg.env.num_envs) * int(cfg.env.action_repeat), int(cfg.checkpoint.every)
    num_iters = max(int(cfg.algo.total_steps) // num_envs, 1)
    state = {"ratio": Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps), "iter": 0, "policy_step": 0,
             "grad": 0, "last_ckpt": 0}
    saved, attempts, grads, killed_at = {}, [], [], None
    for attempt in range(2):
        if attempt:
            state = copy.deepcopy(saved[killed_at if resume_at is None else resume_at])
        starts = int(cfg.algo.learning_starts) // num_envs + (state["iter"] + 1 if attempt else 0)
        prefill, ckpts, grad0 = max(starts - 1, 0), [], state["grad"]
        for it in range(state["iter"] + 1, num_iters + 1):
            if it >= starts:
                state["grad"] += max(state["ratio"](state["policy_step"] + num_envs - prefill * num_envs), 0)
            state["policy_step"] += num_envs
            state["iter"] = it
            killed = attempt == 0 and state["policy_step"] >= kill_at
            if (every > 0 and state["policy_step"] - state["last_ckpt"] >= every) or it == num_iters or (killed and resume_at is None):
                state["last_ckpt"] = state["policy_step"]
                ckpts.append(state["policy_step"])
                saved[state["policy_step"]] = copy.deepcopy(state)
            if killed:
                killed_at = state["policy_step"]
                break
        attempts.append(ckpts)
        grads.append(state["grad"] - grad0)
    return {"iter_num": state["iter"], "policy_step": state["policy_step"], "cumulative_grad_steps": state["grad"], "ckpts": attempts,
            "grad_steps": grads, "killed_at": killed_at}


def _ckpt_names(root: Path) -> list:
    """The checkpoint names under a run tree, ``version_N/ckpt_S``, in order."""
    return sorted((f"{p.parent.parent.name}/{p.name}" for p in root.rglob("checkpoints/ckpt_*")),
                  key=lambda s: (int(s.split("/")[0][8:]), int(s.split("_")[-1])))


def _final_counters(path) -> dict:
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    state = CheckpointManager.load(path)
    out = {k: int(state[k]) for k in ("iter_num", "policy_step", "cumulative_grad_steps")}
    out["world_model_count"] = int(state["opt_states"]["world_model"]["count"])
    return out


@contextlib.contextmanager
def _attempt_outcomes():
    """How each in-process attempt of the train entry ends (``cli.run_algorithm``'s
    exception type, or ``finished``), appended to the yielded list."""
    from sheeprl_tpu_torch import cli

    outcomes, run_algorithm = [], cli.run_algorithm

    def recorded(cfg):
        try:
            out = run_algorithm(cfg)
        except BaseException as exc:
            outcomes.append(type(exc).__name__)
            raise
        outcomes.append("finished")
        return out

    cli.run_algorithm = recorded
    try:
        yield outcomes
    finally:
        cli.run_algorithm = run_algorithm


def _reset_fault_state() -> None:
    from sheeprl_tpu_torch.fault import counters, preemption

    counters.reset()
    preemption.clear_preemption()


def phase_fault_dv3(device: torch.device, workdir: Path) -> dict:
    """``[fault-dv3]`` (``FAULT_DV3``): the kill at ``FAULT_DV3_KILL`` ends attempt 1 at the
    training guard's boundary with a checkpoint and ``PREEMPTED``; attempt 2 resumes from it
    in process and finishes. Checks: each attempt's K1 backward launches equal 64 x (its
    gradient steps + the capture's warm-up steps), its forward launches above 0; the final
    checkpoint's counters, the world model's optimizer count and the checkpoint names of
    each ``version_*`` equal ``fault_schedule``'s; the marker's step, signal and
    ``resume_from``; ``Fault/*`` in attempt 2's logged metrics. Reports the seconds from the
    kill to the resumed attempt's first gradient step finished on the card (the setup, the
    checkpoint's load and the graph's capture among them)."""
    import sheeprl_tpu_torch.algos.dreamer_loop as loop
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.fault import chaos
    from sheeprl_tpu_torch.fault.preemption import read_marker
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    set_tf32(True)
    tag = "[fault-dv3]"
    overrides = [*FAULT_DV3, f"device={device.type}", f"log_root={workdir}", f"chaos.kill_at_step={FAULT_DV3_KILL}", "fault.autoresume=True"]
    want = fault_schedule(compose(overrides=overrides), FAULT_DV3_KILL)
    attempts, stamps, logs = [], {}, []
    kill, make_replay, get_logger = chaos.ChaosMonkey._kill, loop.make_device_replay, loop.get_logger

    def counted_kill(self):
        attempts.append(launches())
        zero_launches()
        stamps["kill"] = time.monotonic()
        kill(self)

    def timed_replay(*args, **kwargs):
        dispatcher, mirror, prefetcher, run_block, rb_add = make_replay(*args, **kwargs)

        def first_after_kill(*a, **k):
            out = run_block(*a, **k)
            if "kill" in stamps and "first_grad" not in stamps:
                torch.cuda.synchronize(device)
                stamps["first_grad"] = time.monotonic()
            return out

        return dispatcher, mirror, prefetcher, first_after_kill, rb_add

    _reset_fault_state()
    chaos.ChaosMonkey._kill, loop.make_device_replay = counted_kill, timed_replay
    loop.get_logger = lambda cfg, log_dir: logs.append(_Recorder()) or logs[-1]
    try:
        with _attempt_outcomes() as outcomes:
            zero_launches()
            start = time.perf_counter()
            result = cli.run(overrides)
            seconds = time.perf_counter() - start
            attempts.append(launches())
    finally:
        chaos.ChaosMonkey._kill, loop.make_device_replay, loop.get_logger = kill, make_replay, get_logger
    (run_dir,) = {p.parent for p in workdir.rglob("version_*")}
    marker = read_marker(run_dir / "version_0") or {}
    fault = [{k: v for k, v in m.items() if k.startswith("Fault/")} for _, m in logs[-1].logged] if len(logs) == 2 else []
    row = {"outcomes": outcomes, "seconds": seconds, "kill_to_first_grad_s": stamps.get("first_grad", math.nan) - stamps["kill"],
           "k1": [{"fwd": f, "bwd": b} for f, b in attempts], "grad_steps": want["grad_steps"],
           "final": _final_counters(result.checkpoint), "expected": {k: want[k] for k in ("iter_num", "policy_step", "cumulative_grad_steps")},
           "ckpts": _ckpt_names(workdir), "marker": {k: marker.get(k) for k in ("step", "signal", "resume_from")},
           "fault_logged": fault[-1] if fault else None}
    log(f"{tag} " + json.dumps(row))
    bad = [] if outcomes == ["Preempted", "finished"] else [f"attempts ended {outcomes}"]
    if len(attempts) != 2 or any(f <= 0 or b != 64 * (g + WARMUP_STEPS) for (f, b), g in zip(attempts, want["grad_steps"])):
        bad.append(f"K1 launches per attempt {attempts}, gradient steps {want['grad_steps']}")
    if row["final"] != {**row["expected"], "world_model_count": want["cumulative_grad_steps"]}:
        bad.append(f"final counters {row['final']} against {row['expected']}")
    if row["ckpts"] != [f"version_{v}/ckpt_{s}" for v, steps in enumerate(want["ckpts"]) for s in steps]:
        bad.append(f"checkpoints {row['ckpts']} against {want['ckpts']}")
    if row["marker"] != {"step": want["killed_at"], "signal": "SIGTERM", "resume_from": str(run_dir / "version_0" / "checkpoints" / f"ckpt_{want['killed_at']}")}:
        bad.append(f"marker {row['marker']}")
    faults = {"Fault/chaos_injected": 1, "Fault/preemption_signals": 1, "Fault/preemptions": 1, "Fault/restarts": 1}
    if row["fault_logged"] != faults or any(k.startswith("Fault/") for _, m in logs[0].logged for k in m):
        bad.append(f"logged Fault/* {row['fault_logged']}")
    if not 0 < row["kill_to_first_grad_s"] < seconds:
        bad.append(f"kill to the first gradient step {row['kill_to_first_grad_s']} s")
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    return row


def phase_fault_supervise(device: torch.device, workdir: Path) -> dict:
    """``[fault-supervise]`` (``FAULT_SUPERVISE``): ``python -m sheeprl_tpu_torch.supervise``
    with ``chaos.corrupt_ckpt_at_step`` and a SIGKILL ``chaos.kill_at_step`` after it
    (``FAULT_SUPERVISE_AT``): the child dies with -9, the supervisor classifies RETRY, skips
    the corrupted newest checkpoint, resumes from the one before it and exits 0. Checks the
    supervisor's summary, the corrupted checkpoint failing verification, the final
    counters and each version's checkpoints against ``fault_schedule``, and each child's K1
    launches (read by ``LAUNCH_HOOK``): backward 64 x (its gradient steps + the capture's
    warm-up steps), forward above 0."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    tag = "[fault-supervise]"
    corrupt_at, kill_at = FAULT_SUPERVISE_AT
    site, counts = workdir / "site", workdir / "launches"
    site.mkdir()
    counts.mkdir()
    (site / "sitecustomize.py").write_text(LAUNCH_HOOK)
    summary_path = workdir / "supervise.json"
    overrides = [*FAULT_SUPERVISE, f"device={device.type}", f"log_root={workdir / 'logs'}", "run_name=fault_supervise",
                 f"chaos.corrupt_ckpt_at_step={corrupt_at}", f"chaos.kill_at_step={kill_at}", "chaos.kill_signal=SIGKILL",
                 "fault.backoff_s=0", f"fault.summary_path={summary_path}"]
    cfg = compose(overrides=overrides)
    resume_at = max(s for s in range(int(cfg.checkpoint.every), corrupt_at, int(cfg.checkpoint.every)))
    want = fault_schedule(cfg, kill_at, resume_at=resume_at)
    start = time.perf_counter()
    _, output = _sebulba("sheeprl_tpu_torch.supervise", overrides, workdir, "fault-supervise", CHIP_SMOKE_LAUNCH_DIR=counts,
                         PYTHONPATH=os.pathsep.join(p for p in (str(site), os.environ.get("PYTHONPATH")) if p))
    seconds = time.perf_counter() - start
    summary = json.loads(summary_path.read_text())
    run_dir = workdir / "logs" / "runs" / "dreamer_v3" / "discrete_dummy" / "fault_supervise"
    children = sorted((json.loads(p.read_text()) for p in counts.glob("*.json")), key=lambda c: c["step"])
    final = max(run_dir.glob("version_*/checkpoints/ckpt_*"), key=lambda p: int(p.name[5:]))
    row = {"rc": 0, "seconds": seconds, "summary": summary, "k1": [{"fwd": c["layernorm_gru"], "bwd": c["layernorm_gru_bwd"], "step": c["step"]}
                                                                      for c in children],
           "k2": [{"fwd": c["rssm_step"], "bwd": c["rssm_step_bwd"]} for c in children], "grad_steps": want["grad_steps"], "final": _final_counters(final),
           "expected": {k: want[k] for k in ("iter_num", "policy_step", "cumulative_grad_steps")}, "ckpts": _ckpt_names(run_dir),
           "supervisor_lines": [ln for ln in output.splitlines() if ln.startswith("[supervise]")]}
    log(f"{tag} " + json.dumps(row))
    bad = []
    if summary["outcome"] != "done" or [(a["rc"], a["verdict"]) for a in summary["attempts"]] != [(-9, "retry"), (0, "done")]:
        bad.append(f"attempts {summary['attempts']}, outcome {summary['outcome']}")
    elif summary["attempts"][1]["resume_from"] != str(run_dir / "version_0" / "checkpoints" / f"ckpt_{resume_at}"):
        bad.append(f"resumed from {summary['attempts'][1]['resume_from']}, not ckpt_{resume_at}")
    if CheckpointManager.verify(run_dir / "version_0" / "checkpoints" / f"ckpt_{corrupt_at}"):
        bad.append(f"ckpt_{corrupt_at} verifies: the chaos schedule corrupted nothing")
    if [c["step"] for c in children] != [want["killed_at"], want["policy_step"]] or any(any(k.values()) for k in row["k2"]) or any(
            k["fwd"] <= 0 or k["bwd"] != 64 * (g + WARMUP_STEPS) for k, g in zip(row["k1"], want["grad_steps"])):
        bad.append(f"children's K1 launches {row['k1']}, gradient steps {want['grad_steps']}, K2 {row['k2']}")
    if row["final"] != {**row["expected"], "world_model_count": want["cumulative_grad_steps"]}:
        bad.append(f"final counters {row['final']} against {row['expected']}")
    if row["ckpts"] != [f"version_{v}/ckpt_{s}" for v, steps in enumerate(want["ckpts"]) for s in steps]:
        bad.append(f"checkpoints {row['ckpts']} against {want['ckpts']}")
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    return row


def phase_fault_anakin(device: torch.device, workdir: Path) -> dict:
    """``[fault-anakin]`` (``FAULT_ANAKIN``): killed at ``FAULT_ANAKIN_KILL`` with
    ``fault.autoresume=True``, then the same run uninterrupted: the final checkpoints equal
    bit for bit (``torch.equal`` on every tensor, equality on every other value); no K1 or
    K2 launch."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.fault.counters import fault_metrics
    from sheeprl_tpu_torch.ops.counters import launch_counts

    set_tf32(True)
    tag = "[fault-anakin]"
    overrides = [*FAULT_ANAKIN, f"device={device.type}"]
    _reset_fault_state()
    row, results = {}, {}
    for case, extra in (("killed", [f"chaos.kill_at_step={FAULT_ANAKIN_KILL}", "fault.autoresume=True"]), ("clean", [])):
        with _attempt_outcomes() as outcomes:
            zero_launches()
            start = time.perf_counter()
            results[case] = cli.run([*overrides, *extra, f"log_root={workdir / case}"])
        row[case] = {"seconds": time.perf_counter() - start, "grad_steps": results[case].grad_steps, "k1_k2_launches": launch_counts(),
                     "checkpoint": Path(results[case].checkpoint).name, "version": Path(results[case].log_dir).name, "outcomes": outcomes}
    row["fault"] = fault_metrics()
    a, b = (CheckpointManager.load(results[c].checkpoint) for c in ("killed", "clean"))
    la, lb = dict(_leaf_items(a)), dict(_leaf_items(b))
    row["leaves"] = len(la)
    row["unequal"] = ["<keys>"] if sorted(la) != sorted(lb) else [
        k for k in la if not (torch.equal(la[k], lb[k]) if isinstance(la[k], torch.Tensor) else la[k] == lb[k])]
    log(f"{tag} " + json.dumps(row))
    if (row["unequal"] or row["killed"]["version"] != "version_1" or row["killed"]["checkpoint"] != row["clean"]["checkpoint"]
            or row["killed"]["outcomes"] != ["Preempted", "finished"] or row["clean"]["outcomes"] != ["finished"]
            or row["fault"] != {"Fault/chaos_injected": 1, "Fault/preemption_signals": 1, "Fault/preemptions": 1, "Fault/restarts": 1}
            or any(any(r["k1_k2_launches"].values()) for r in (row["killed"], row["clean"]))):
        raise AssertionError(f"{tag}: {row}")
    return row


# --------------------------------------------------------------------------- the env pool
# [pool]: DreamerV3-S's dummy env (rgb 3 x 64 x 64; episodes of 41 steps) x 8, stepped 256 times
POOL_ENVS = [*TRAIN_OVERRIDES, "env.num_envs=8", "env.wrapper.n_steps=40", "env.capture_video=False"]
POOL_STEPS = 256
POOL_WORKERS = (1, 4, 8)
# [pool-dv3-cli]: [train-cli]'s run on the pool, 2 workers, the player one step ahead
POOL_DV3_CLI = ["env.pool.enabled=True", "env.pool.num_workers=2", "rollout.pipeline_depth=1"]
# [pool-fault]: dense PPO on the discrete dummy env, 4 envs on 2 pool workers; 4 updates of
# 2 epochs x 2 minibatches; worker 1 faults at its 40th step (the second update)
POOL_FAULT = ["exp=ppo_dummy", "env=discrete_dummy", "env.num_envs=4", "algo.rollout_steps=32", "algo.update_epochs=2",
              "algo.per_rank_batch_size=64", "algo.total_steps=512", "env.pool.enabled=True", "env.pool.num_workers=2",
              "chaos.worker_fault_at_step=40", "chaos.worker_index=1", "rollout.restart_backoff_s=0", "checkpoint.every=0",
              "checkpoint.save_last=True", "algo.run_test=False", "metric.log_every=128"]
POOL_HANG_TIMEOUT_S = 5  # the hang drill's rollout.step_timeout_s


class _CudaProbe:
    """An env thunk whose env's reset info says whether its process has initialised CUDA
    and its pid: a pool worker must not touch the card."""

    def __init__(self, thunk):
        self.thunk = thunk

    def __call__(self):
        from sheeprl_tpu_torch.envs import core

        class Probe(core.Wrapper):
            def reset(self, *, seed=None, options=None):
                obs, info = self.env.reset(seed=seed, options=options)
                return obs, {**info, "cuda_initialized": torch.cuda.is_initialized(), "pid": os.getpid()}

        return Probe(self.thunk())


def _same_vector_info(a: dict, b: dict, path: str = "info") -> None:
    """Two batched infos equal: keys, masks, values and dtypes, ``final_obs`` observation by
    observation; the episode statistics' wall time left out."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{path}: keys {sorted(a)} against {sorted(b)}")
    for k in b:
        if k in ("t", "_t") and path.endswith("episode"):
            continue
        if k == "final_obs":
            for x, y in zip(a[k], b[k]):
                if (x is None) != (y is None) or (y is not None and any(not np.array_equal(x[kk], y[kk]) or np.asarray(x[kk]).dtype
                                                                       != np.asarray(y[kk]).dtype for kk in y)):
                    raise AssertionError(f"{path}.final_obs differs")
        elif isinstance(b[k], dict):
            _same_vector_info(a[k], b[k], f"{path}.{k}")
        elif np.asarray(a[k]).dtype != np.asarray(b[k]).dtype or not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{path}.{k}: {a[k]} against {b[k]}")


def _same_vector_step(a: tuple, b: tuple, what: str) -> None:
    """Two vector envs' steps (or resets) equal bit for bit."""
    if sorted(a[0]) != sorted(b[0]) or any(a[0][k].dtype != b[0][k].dtype or not np.array_equal(a[0][k], b[0][k]) for k in b[0]):
        raise AssertionError(f"{what}: observations differ")
    for x, y in zip(a[1:-1], b[1:-1]):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: rewards or flags differ")
    _same_vector_info(a[-1], b[-1], f"{what} info")


def _drive_vector_env(envs, actions: np.ndarray, seed: int) -> tuple:
    """Reset with ``seed`` and step ``actions``; the outputs and the steps' seconds."""
    outs = [envs.reset(seed=seed)]
    start = time.perf_counter()
    for a in actions:
        o, r, term, trunc, info = envs.step(a)
        outs.append(({k: v.copy() for k, v in o.items()}, r, term, trunc, info))
    return outs, time.perf_counter() - start


def phase_pool(device: torch.device, workdir: Path) -> dict:
    """The env pool on the card's host against the in-process vector env: 8 DreamerV3-S
    dummy envs (rgb 3 x 64 x 64), 256 steps that cross episode ends, with the same
    actions; the pool at 1, 4 and 8 workers and the one-process-per-env vector env each
    equal to the sync env bit for bit (observations, rewards, flags, infos). Env steps/s of
    each, each constructor's seconds (a pool's: its workers spawned and ready; one
    worker's is a worker's start), and a worker's CUDA state (none may initialise it)."""
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv, SyncVectorEnv
    from sheeprl_tpu_torch.rollout.pool import EnvPool
    from sheeprl_tpu_torch.utils.env import make_env

    cfg = compose(overrides=[*POOL_ENVS, f"device={device.type}"])
    n = int(cfg.env.num_envs)
    thunks = [make_env(cfg, cfg.seed + i, 0, vector_env_idx=i) for i in range(n)]
    start = time.perf_counter()
    sync = SyncVectorEnv(thunks)
    rows = {"sync": {"start_s": time.perf_counter() - start}}
    actions = np.random.default_rng(0).integers(0, sync.single_action_space.n, size=(POOL_STEPS, n))
    ref, rows["sync"]["seconds"] = _drive_vector_env(sync, actions, cfg.seed)
    sync.close()
    ends = sum("final_obs" in out[-1] for out in ref[1:])
    if ends == 0:
        raise AssertionError("[pool] no episode ended in the sync env's run")
    makers = {"async": lambda: AsyncVectorEnv(thunks), **{f"pool_{w}": (lambda w=w: EnvPool(thunks, num_workers=w)) for w in POOL_WORKERS}}
    for name, make in makers.items():
        start = time.perf_counter()
        envs = make()
        rows[name] = {"start_s": time.perf_counter() - start}
        try:
            outs, rows[name]["seconds"] = _drive_vector_env(envs, actions, cfg.seed)
            if name.startswith("pool_"):
                rows[name]["rollout"] = envs.rollout_metrics()
        finally:
            envs.close()
        for t, (a, b) in enumerate(zip(outs, ref)):
            _same_vector_step(a, b, f"[pool] {name} step {t}")
    for row in rows.values():
        row["env_steps_per_s"] = POOL_STEPS * n / row["seconds"]
    probe = EnvPool([_CudaProbe(t) for t in thunks[:2]], num_workers=2)
    try:
        _, info = probe.reset(seed=0)
    finally:
        probe.close()
    if info["cuda_initialized"].any() or os.getpid() in info["pid"].tolist():
        raise AssertionError(f"[pool] a worker initialised CUDA or ran in this process: {info}")
    out = {"envs": n, "steps": POOL_STEPS, "episode_ends": ends, "rows": rows, "worker_cuda_initialized": False,
           "worker_start_s": rows["pool_1"]["start_s"]}
    log("[pool] " + json.dumps(out))
    return out


def _logged(module, runner):
    """``runner()`` with ``module.get_logger`` replaced by a recorder; (its result, what was logged)."""
    rec, real = _Recorder(), module.get_logger
    module.get_logger = lambda cfg, log_dir: rec
    try:
        return runner(), rec.logged
    finally:
        module.get_logger = real


def _rollout(logged: list) -> dict:
    """The last logged ``Rollout/*`` (a test episode's reward is logged after them)."""
    flushes = [m for _, m in logged if "Rollout/env_steps" in m]
    return {k: v for k, v in flushes[-1].items() if k.startswith("Rollout/")} if flushes else {}


def phase_pool_dv3_cli(device: torch.device, workdir: Path) -> dict:
    """``[train-cli]``'s run (DreamerV3-S, 2 envs, 256 policy steps) on the env pool (2
    workers) with the player one step ahead (``rollout.pipeline_depth=1``): train,
    resume from ``ckpt_64``, eval. K1-bwd = 64 x (gradient steps + 2); K1-fwd the step's
    plan x (gradient steps + 2) plus at least one a policy-driven player step; the
    ``Rollout/*`` each run logs."""
    import sheeprl_tpu_torch.algos.dreamer_loop as dreamer_loop
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.cli import evaluate, run
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.utils.graphs import WARMUP_STEPS

    set_tf32(True)
    tag = "[pool-dv3-cli]"
    overrides = [*TRAIN_OVERRIDES, f"device={device.type}", f"log_root={workdir / 'logs'}", "algo.learning_starts=128",
                 "algo.total_steps=256", "checkpoint.every=64", "metric.log_every=64", *POOL_DV3_CLI]
    plan = k1_per_step(compose(overrides=overrides), is_continuous=False)
    out = {}
    for name in ("train", "resume"):
        if name == "resume":
            mid = next(p for p in CheckpointManager(Path(out["log_dir"]) / "checkpoints").list_checkpoints() if p.name == "ckpt_64")
            overrides = [*overrides, f"checkpoint.resume_from={mid}"]
        zero_launches()
        result, logged = _logged(dreamer_loop, lambda: run(overrides))
        fwd, bwd = launches()
        # the player acts with the policy after the prefill (its 64 iterations), and from the first iteration when resumed
        calls = 256 // 2 - (64 if name == "train" else 32)
        steps = result.policy_steps - (0 if name == "train" else 64)
        rollout = _rollout(logged)
        if (result.grad_steps <= 0 or bwd != plan["bwd"] * (result.grad_steps + WARMUP_STEPS)
                or fwd - plan["fwd"] * (result.grad_steps + WARMUP_STEPS) < calls or result.checkpoint is None
                or rollout.get("Rollout/num_workers") != 2.0 or rollout.get("Rollout/worker_restarts") != 0.0
                or rollout.get("Rollout/env_steps") != steps // 2):
            raise AssertionError(f"{tag} {name}: {result.grad_steps} gradient steps, launches (fwd, bwd) = {(fwd, bwd)}, "
                                 f"{calls} player calls, Rollout/* {rollout}, checkpoint {result.checkpoint}")
        out[name] = {"grad_steps": result.grad_steps, "fwd": fwd, "bwd": bwd, "player_calls": calls,
                     "player_fwd": fwd - plan["fwd"] * (result.grad_steps + WARMUP_STEPS), "policy_steps_per_s": steps / result.seconds,
                     "seconds": result.seconds, "train_seconds": result.train_seconds, "env_seconds": result.env_seconds, "rollout": rollout}
        out["log_dir"] = result.log_dir
        log(f"{tag} {name}: {steps} policy steps, {result.grad_steps} gradient steps in {result.seconds:.2f} s "
            f"({steps / result.seconds:.1f} policy steps/s), layernorm_gru launches fwd {fwd} bwd {bwd}; " + json.dumps(rollout))
        last = result.checkpoint
    zero_launches()
    start = time.perf_counter()
    ev = evaluate([f"checkpoint_path={last}", "env.capture_video=False", f"log_root={workdir / 'logs'}"])
    fwd, bwd = launches()
    if fwd != ev.steps or bwd != 0 or not math.isfinite(ev.reward):
        raise AssertionError(f"{tag} eval: {ev.steps} steps, launches {(fwd, bwd)}, reward {ev.reward}")
    out["eval"] = {"steps": ev.steps, "fwd": fwd}
    log(f"{tag} eval of {Path(last).name}: reward {ev.reward}, {ev.steps} player steps in {time.perf_counter() - start:.2f} s, "
        f"layernorm_gru launches fwd {fwd}")
    return out


def phase_pool_fault(device: torch.device, workdir: Path) -> dict:
    """The chaos worker fault on a pooled run (``POOL_FAULT``: dense PPO, 4 envs on 2
    workers): worker 1 crashes (exit code 117), then in another run hangs past a
    ``rollout.step_timeout_s`` of ``POOL_HANG_TIMEOUT_S``; each run restarts it once, logs
    ``Rollout/worker_crashes`` or ``Rollout/worker_timeouts`` = 1 and ends at its schedule's
    policy and gradient steps, with no K1/K2 launch. Then ``python -m sheeprl_tpu_torch``
    with ``rollout.max_restarts=0`` exits non-zero with ``RolloutAbortError`` and leaves a
    blackbox holding ``rollout_abort``."""
    import sheeprl_tpu_torch.algos.ppo.ppo as ppo
    from sheeprl_tpu_torch.config.core import compose

    set_tf32(True)
    base = [*POOL_FAULT, f"device={device.type}"]
    cfg = compose(overrides=base)
    per_update = int(cfg.env.num_envs) * int(cfg.algo.rollout_steps)
    updates = int(cfg.algo.total_steps) // per_update
    want_grad = updates * int(cfg.algo.update_epochs) * (per_update // int(cfg.algo.per_rank_batch_size))
    out = {}
    for mode, extra in (("crash", []), ("hang", [f"rollout.step_timeout_s={POOL_HANG_TIMEOUT_S}"])):
        tag = f"[pool-fault] {mode}"
        overrides = [*base, f"chaos.worker_fault_mode={mode}", *extra, f"log_root={workdir / mode}"]
        (result, row), logged = _logged(ppo, lambda: _entry_run(overrides, tag))
        rollout = _rollout(logged)
        fault = "Rollout/worker_crashes" if mode == "crash" else "Rollout/worker_timeouts"
        if (result.policy_steps != int(cfg.algo.total_steps) or result.grad_steps != want_grad or rollout.get("Rollout/worker_restarts") != 1.0
                or rollout.get(fault) != 1.0 or rollout.get("Rollout/env_steps") != int(cfg.algo.total_steps) // int(cfg.env.num_envs)):
            raise AssertionError(f"{tag}: {result.policy_steps} policy steps, {result.grad_steps} gradient steps (want {want_grad}), "
                                 f"Rollout/* {rollout}")
        out[mode] = {**row, "rollout": rollout}
        log(f"{tag}: Rollout/* " + json.dumps(rollout))
    env = {k: v for k, v in os.environ.items() if not k.startswith("SHEEPRL_TPU_")}
    env.update(SHEEPRL_TPU_QUIET="1", OMP_NUM_THREADS=str(ENTRY_THREADS))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", *base, "chaos.worker_fault_mode=crash", "rollout.max_restarts=0",
                           "metric.log_level=0", f"log_root={workdir / 'abort'}"], cwd=Path(__file__).resolve().parent, env=env,
                          capture_output=True, text=True, timeout=300)
    boxes = list((workdir / "abort").rglob("blackbox/events.jsonl"))
    kinds = [json.loads(line)["kind"] for line in boxes[0].read_text().splitlines()] if boxes else []
    if proc.returncode == 0 or "RolloutAbortError" not in proc.stderr or "rollout_abort" not in kinds:
        raise AssertionError(f"[pool-fault] abort: rc {proc.returncode}, blackbox events {kinds}: {proc.stderr[-3000:]}")
    out["abort"] = {"rc": proc.returncode, "seconds": time.perf_counter() - start, "events": [k for k in kinds if k.startswith("rollout_")]}
    log("[pool-fault] abort: " + json.dumps(out["abort"]))
    return out


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def entry_phases(device: torch.device) -> dict:
    """The phases that drive the train and eval entries (train, resume, eval through the
    CLI), by the names ``[phases]`` reports, each a thunk that runs it in a temporary
    directory of its own and returns its row."""

    def in_tmp(fn, *args, **kwargs):
        def thunk():
            with tempfile.TemporaryDirectory() as tmp:
                return fn(device, Path(tmp), *args, **kwargs)

        return thunk

    phases = {
        "train-cli": in_tmp(phase_train_cli),
        "train-cli-device": in_tmp(phase_train_cli, device_replay=True),
        **{f"dv2-train-cli-{buffer}": in_tmp(phase_dv2_train_cli, buffer) for buffer in ("device", "episode")},
        "dv1-train-cli": in_tmp(phase_dv1_train_cli),
        **{f"p2e-dv{version}-cli": in_tmp(phase_p2e_cli, version, overrides, schedule) for version, overrides, schedule in (
            (1, P2E_DV1_OVERRIDES, P2E_DV1_CLI), (2, P2E_DV2_OVERRIDES, P2E_DV2_CLI), (3, P2E_DV3_CLI_OVERRIDES, P2E_DV3_CLI))},
        **{f"ppo-cli-depth{depth}": in_tmp(phase_entry_cli, [*PPO_ATARI, *PPO_CLI, f"rollout.pipeline_depth={depth}"],
                                           f"[ppo-cli] pipeline_depth={depth}", "ckpt_1024") for depth in (0, 1)},
        "a2c-cli": in_tmp(phase_entry_cli, A2C_CLI, "[a2c-cli]", "ckpt_512"),
        **{f"ppo-recurrent-cli-{model}": in_tmp(phase_entry_cli, [*PPO_REC_CLI, f"algo.sequence_model={model}"],
                                                f"[ppo-recurrent-cli] {model}", "ckpt_512") for model in ("lstm", "attention")},
    }
    for case, (overrides, first_ckpt) in SAC_CLI.items():
        algo = overrides[0].split("=")[1]
        phases[f"{case}-cli"] = in_tmp(phase_entry_cli, [*overrides, "env.sync_env=True", *SAC_CLI_STEPS[algo]],
                                       f"[{algo.replace('_', '-')}-cli] {case}", first_ckpt, resume_halves=False)
    for case, (overrides, first_ckpt, halves) in DECOUPLED_CLI.items():
        algo = "ppo" if "algo.name=ppo" in overrides else overrides[0].split("=")[1]
        phases[f"{case}-cli"] = in_tmp(phase_entry_cli, overrides, f"[{algo.replace('_', '-')}-cli] {case}", first_ckpt, resume_halves=halves)
    phases["anakin-cli"] = in_tmp(phase_anakin_cli)
    phases["obs"] = in_tmp(phase_obs)
    phases["sebulba-sac-cli"] = in_tmp(phase_sebulba_sac_cli)
    phases["sebulba-ppo-cli"] = in_tmp(phase_sebulba_ppo_cli)
    phases["sebulba-kill"] = in_tmp(phase_sebulba_kill)
    phases["fault-dv3"] = in_tmp(phase_fault_dv3)
    phases["fault-supervise"] = in_tmp(phase_fault_supervise)
    phases["fault-anakin"] = in_tmp(phase_fault_anakin)
    phases["pool"] = in_tmp(phase_pool)
    phases["pool-dv3-cli"] = in_tmp(phase_pool_dv3_cli)
    phases["pool-fault"] = in_tmp(phase_pool_fault)
    return phases


# The entry phases are host-bound (Python, env stepping, checkpoints, captures), so after
# the measured phases ENTRY_GROUPS' worker processes run them side by side on the card,
# each group's phases in order; the groups take about equal seconds alone (an H100 host:
# ~135 s each). Their rates are read under that sharing; each run's launch counts are its
# own (every process has its own counters, zeroed around each run).
ENTRY_GROUPS = (
    ("p2e-dv2-cli", "p2e-dv3-cli", "sac_decoupled_host-cli", "sac_decoupled_device-cli", "ppo_decoupled-cli", "ppo_coupled-cli",
     "fault-dv3", "dv2-train-cli-episode"),
    ("train-cli", "train-cli-device", "p2e-dv1-cli", "dv2-train-cli-device", "sebulba-sac-cli", "pool-dv3-cli"),
    ("anakin-cli", "fault-anakin", *(f"{case}-cli" for case in SAC_CLI), "ppo-cli-depth0", "ppo-cli-depth1", "a2c-cli",
     "ppo-recurrent-cli-lstm", "ppo-recurrent-cli-attention", "dv1-train-cli", "pool-fault"),
    # the Sebulba phases and the supervisor's drill spawn processes of their own: this worker
    # mostly waits (sebulba-sac-cli runs in another, to keep the workers even)
    ("sebulba-kill", "sebulba-ppo-cli", "obs", "fault-supervise", "pool"),
)
ENTRY_TIMEOUT_S = 600  # all workers; alone they take ~140 s each
ENTRY_THREADS = 2  # torch's CPU threads in each worker: the workers share the host's cores


def port_ready() -> bool:
    """False without CUDA; else puts the checkout on the path and imports the port (which
    fails outside a checkout of the repo) and quiets the train entry's config dump."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return False
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import sheeprl_tpu_torch  # noqa: F401

    os.environ["SHEEPRL_TPU_QUIET"] = "1"
    return True


def entry_worker(names: list, out: Path) -> int:
    """``chip_smoke.py --entries NAME,... --out PATH``: run the named entry phases one after
    another in this process and write their rows and seconds to ``PATH`` as JSON."""
    if not port_ready():
        return 2
    torch.set_num_threads(ENTRY_THREADS)
    device = torch.device("cuda", 0)
    phase_build()  # loads the libraries the main process built
    phases = entry_phases(device)
    rows, seconds = {}, {}
    for name in names:
        start = time.perf_counter()
        rows[name] = phases[name]()
        seconds[name] = round(time.perf_counter() - start, 1)
    out.write_text(json.dumps({"rows": rows, "seconds": seconds, "peak_reserved_bytes": torch.cuda.max_memory_reserved(device)}))
    return 0


def run_entry_workers(device: torch.device, groups=ENTRY_GROUPS, timeout: float = ENTRY_TIMEOUT_S) -> tuple:
    """Every entry phase, ``groups`` of them in worker processes side by side (``--entries``);
    each worker's output printed after all have ended. Raises if a worker fails or the
    workers outlast ``timeout``; kills every worker's process group (its envs' processes
    too) before it returns. Returns ``(rows, seconds)`` by phase name."""
    import signal

    if sorted(n for g in groups for n in g) != sorted(entry_phases(device)):
        raise AssertionError(f"[entries] the groups {groups} do not hold each entry phase once")
    gc.collect()  # an earlier phase's graphs in reference cycles
    torch.cuda.empty_cache()
    log(f"[entries] {len(groups)} worker processes; this process keeps {torch.cuda.memory_reserved(device)} bytes reserved")
    rows, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        workers = []
        try:
            for i, names in enumerate(groups):
                files = [Path(tmp) / f"worker{i}.{ext}" for ext in ("json", "out", "err")]
                with open(files[1], "w") as so, open(files[2], "w") as se:
                    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--entries", ",".join(names), "--out", str(files[0])],
                                            stdout=so, stderr=se, start_new_session=True)
                workers.append((names, files, proc))
            deadline = time.monotonic() + timeout
            for _, _, proc in workers:
                proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for _, _, proc in workers:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            for _, (_, stdout, stderr), _ in workers:
                print(stdout.read_text(), end="", flush=True)
                print(stderr.read_text(), end="", file=sys.stderr, flush=True)
        for names, (result, _, stderr), proc in workers:
            if proc.returncode != 0 or not result.is_file():
                raise AssertionError(f"[entries] the worker of {names} exited {proc.returncode}: {stderr.read_text()[-4000:]}")
            data = json.loads(result.read_text())
            rows.update(data["rows"])
            seconds.update(data["seconds"])
            log(f"[entries] {names[0]}'s worker: {sum(data['seconds'].values()):.1f} s of phases, peak {data['peak_reserved_bytes']} bytes reserved")
    return rows, seconds


def main() -> int:
    if not port_ready():
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - start, 1)
        return out

    timed("build", phase_build)
    check_device_events(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    kernels = timed("kernels", phase_kernels, device)
    kernels_bwd = timed("kernels-bwd", phase_kernels_bwd, device)
    timed("geometry", check_gru_geometry)
    timed("step-geometry", check_step_geometry)
    step_fwd = timed("kernels-step", phase_kernels_step, device)
    step_bwd = timed("kernels-step-bwd", phase_kernels_step_bwd, device)
    timed("agreement", phase_agreement, device)
    with tempfile.TemporaryDirectory() as tmp:
        ev = timed("eval", phase_eval, device, Path(tmp))
    timed("batched", phase_batched, device)
    timed("train-agreement", phase_train_agreement, device)
    # 2 timed eager steps a row: the DreamerV3 phases leave the later ones room in the time limit
    train = timed("train", lambda: [
        phase_train(device, "bf16-mixed", steps=2), phase_train(device, "32-true", steps=2),
        phase_train(device, "bf16-mixed", env="continuous_dummy", steps=2, warmup=1),
    ])
    # 2 timed steps a turn: the fault drills' entry phases need room in the time limit
    graphed = timed("train-graph", lambda: [phase_train_graph(device, timed_steps=2, health_turn=True), phase_train_graph(device, env="continuous_dummy")])
    timed("dv2-train-agreement", phase_train_agreement, device, SMALL_DV2, "[dv2-train-agreement]")
    dv2_graph = timed("dv2-train-graph", phase_train_graph, device, overrides=DV2_OVERRIDES, tag="[dv2-train-graph]")
    timed("dv1-train-agreement", phase_train_agreement, device, SMALL_DV1, "[dv1-train-agreement]")
    timed("p2e-dv1-train-agreement", phase_train_agreement, device, SMALL_P2E_DV1, "[p2e-dv1-train-agreement]")
    timed("p2e-dv2-train-agreement", phase_train_agreement, device, SMALL_P2E_DV2, "[p2e-dv2-train-agreement]")
    dv1_graph = timed("dv1-train-graph", phase_train_graph, device, timed_steps=4, overrides=DV1_OVERRIDES, tag="[dv1-train-graph]")
    p2e_dv1_graph = timed(
        "p2e-dv1-train-graph", phase_train_graph, device, timed_steps=4, overrides=P2E_DV1_OVERRIDES, tag="[p2e-dv1-train-graph]"
    )
    p2e_graph = timed("p2e-dv2-train-graph", lambda: [
        phase_train_graph(device, timed_steps=4, overrides=P2E_DV2_OVERRIDES, tag="[p2e-dv2-train-graph]"),
        phase_train_graph(device, env="continuous_dummy", overrides=P2E_DV2_OVERRIDES, tag="[p2e-dv2-train-graph]"),
    ])
    timed("dv3-decoupled-train-agreement", phase_train_agreement, device, SMALL_DV3_DECOUPLED, "[dv3-decoupled-train-agreement]")
    dec_graph = timed(
        "dv3-decoupled-train-graph", phase_train_graph, device, timed_steps=2, overrides=DV3_DECOUPLED_OVERRIDES, tag="[dv3-decoupled-train-graph]"
    )
    timed("minedojo-actor", phase_minedojo_actor, device)
    timed("p2e-dv3-train-agreement", phase_train_agreement, device, SMALL_P2E_DV3, "[p2e-dv3-train-agreement]")
    p2e_dv3_graph = timed("p2e-dv3-train-graph", lambda: [
        phase_train_graph(device, timed_steps=2, overrides=P2E_DV3_OVERRIDES, tag="[p2e-dv3-train-graph]"),
        phase_train_graph(device, env="continuous_dummy", overrides=P2E_DV3_OVERRIDES, tag="[p2e-dv3-train-graph]"),
    ])
    timed("ppo-train-agreement", lambda: [
        phase_ppo_train_agreement(device, SMALL_PPO, "[ppo-train-agreement]"),
        phase_ppo_train_agreement(device, SMALL_A2C, "[a2c-train-agreement]"),
        phase_ppo_train_agreement(device, [*SMALL_PPO_REC, "algo.sequence_model=lstm"], "[ppo-recurrent-train-agreement] lstm"),
        phase_ppo_train_agreement(device, [*SMALL_PPO_REC, "algo.sequence_model=attention"], "[ppo-recurrent-train-agreement] attention"),
    ])
    ppo_graph = timed("ppo-train-graph", lambda: [phase_ppo_train_graph(device), phase_ppo_train_graph(device, env="continuous_dummy")])
    for name, small in SMALL_SAC.items():
        timed(f"{name.replace('_', '-')}-train-agreement", phase_sac_train_agreement, device, small, f"[{name.replace('_', '-')}-train-agreement]")
    sac_graph = {}
    for name, (overrides, steps, blocks, profiled, rows) in SAC_GRAPH.items():
        tag = name.replace("_", "-")
        sac_graph[name] = timed(f"{tag}-train-graph", phase_sac_train_graph, device, overrides, f"[{tag}-train-graph]", steps, blocks, profiled, rows)
    with tempfile.TemporaryDirectory() as tmp:
        dec_agree = timed("ppo-decoupled-agreement", phase_ppo_decoupled_agreement, device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        dec_publish = timed("sac-decoupled-publish", phase_sac_decoupled_publish, device, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        serve = timed("serve", phase_serve, device, Path(tmp))
        serve_cli = timed("serve-cli", phase_serve_cli, device, Path(tmp), serve["templates"]["sac"])
    serve_paths = {f"serve_{name}_{tier}": row["k1_k2_launches"] for tier, rows in serve["tiers"].items() for name, row in rows.items()}
    log("[serve-counts] " + json.dumps({
        "k1_k2_launches": serve_paths,
        "captures_after_warm": {f"{n}_{t}": r["captures_after_warm"] for t, rows in serve["tiers"].items() for n, r in rows.items()},
        "requests_per_s": {f"{n}_{t}": r["requests_per_s"] for t, rows in serve["tiers"].items() for n, r in rows.items()},
        "p99_ms": {f"{n}_{t}": r["p99_ms"] for t, rows in serve["tiers"].items() for n, r in rows.items()},
        "serve_cli_exit_code": serve_cli["exit_code"],
    }))
    ak_ppo = timed("anakin-ppo-graph", phase_anakin_ppo_graph, device)
    ak_sac = timed("anakin-sac-graph", phase_anakin_sac_graph, device)
    ak_pop = timed("anakin-pop", phase_anakin_pop, device)
    ak_agree = timed("anakin-agreement", phase_anakin_agreement, device)
    scan = timed("rssm-scan", phase_rssm_scan, device)

    entries, entry_seconds = timed("entries", run_entry_workers, device)
    seconds.update(entry_seconds)
    cli, cli_device = entries["train-cli"], entries["train-cli-device"]
    dv2_cli = {buffer: entries[f"dv2-train-cli-{buffer}"] for buffer in ("device", "episode")}
    dv1_cli = entries["dv1-train-cli"]
    p2e_cli = {version: entries[f"p2e-dv{version}-cli"] for version in (1, 2, 3)}
    ppo_cli = {depth: entries[f"ppo-cli-depth{depth}"] for depth in (0, 1)}
    a2c_cli = entries["a2c-cli"]
    rec_cli = {model: entries[f"ppo-recurrent-cli-{model}"] for model in ("lstm", "attention")}
    sac_cli = {case: entries[f"{case}-cli"] for case in SAC_CLI}
    dec_cli = {case: entries[f"{case}-cli"] for case in DECOUPLED_CLI}
    ak_cli = entries["anakin-cli"]
    sb_sac, sb_ppo, sb_kill = entries["sebulba-sac-cli"], entries["sebulba-ppo-cli"], entries["sebulba-kill"]
    obs = entries["obs"]
    pool, pool_cli, pool_fault = entries["pool"], entries["pool-dv3-cli"], entries["pool-fault"]
    log("[pool-counts] " + json.dumps({
        "env_steps_per_s": {k: r["env_steps_per_s"] for k, r in pool["rows"].items()},
        "start_s": {k: r["start_s"] for k, r in pool["rows"].items()}, "worker_start_s": pool["worker_start_s"],
        # the pooled DreamerV3-S entry at depth 1 beside [train-cli]'s (2 async envs, depth 0)
        "dv3_policy_steps_per_s": {"pool_depth1": pool_cli["train"]["policy_steps_per_s"], "train_cli": cli["train"]["policy_steps_per_s"]},
        "dv3_rollout": {k: pool_cli[k]["rollout"] for k in ("train", "resume")},
        "dv3_k1": {k: {c: pool_cli[k][c] for c in ("grad_steps", "fwd", "bwd", "player_calls", "player_fwd")} for k in ("train", "resume")},
        "fault_rollout": {k: pool_fault[k]["rollout"] for k in ("crash", "hang")},
        "fault_seconds": {k: pool_fault[k]["seconds"] for k in ("crash", "hang", "abort")}, "abort_events": pool_fault["abort"]["events"],
    }))
    log("[obs-counts] " + json.dumps({
        "policy_steps_per_s": {k: obs[k]["policy_steps_per_s"] for k in ("window", "enabled", "disabled")},
        "mfu": {k: obs[k]["mfu"] for k in ("window", "enabled", "disabled")},
        "cost_model_seconds": {k: obs[k]["cost_model_seconds"] for k in ("window", "enabled", "disabled")},
        "k1_launches": {k: [obs[k]["k1_fwd"], obs[k]["k1_bwd"]] for k in ("window", "enabled", "disabled")},
        "auto_captures": {k: obs[k]["auto_captures"] for k in ("window", "enabled", "disabled")},
        "train_graph_health": graphed[0]["health"],
    }))

    log("[dv2-counts] " + json.dumps({
        "k1_per_replay_capture": dv2_graph["k1_per_replay_capture"], "k1_per_replay_profiler": dv2_graph["k1_per_replay_profiler"],
        "k1_per_step_plan": dv2_graph["k1_per_step_plan"],
        "train_cli": {b: {k: c[k] for k in ("train", "resume", "eval")} for b, c in dv2_cli.items()},
    }))
    graph_counts = ("k1_per_replay_capture", "k1_per_replay_profiler", "k1_per_eager_step_profiler", "k1_per_step_plan")
    log("[p2e-counts] " + json.dumps({
        "p2e_dv2_exploration": {g["actor"]: {k: g[k] for k in graph_counts} for g in p2e_graph},
        "p2e_dv3_exploration_xl": {g["actor"]: {k: g[k] for k in graph_counts} for g in p2e_dv3_graph},
        "dv3_decoupled_s": {k: dec_graph[k] for k in graph_counts},
        "dv1_train_graph_k1_per_replay_capture": dv1_graph["k1_per_replay_capture"],
        "p2e_dv1_train_graph_k1_per_replay_capture": p2e_dv1_graph["k1_per_replay_capture"],
        "train_cli": {f"p2e_dv{v}": {k: {c: r[c] for c in ("grad_steps", "fwd", "bwd")} for k, r in runs.items() if "grad_steps" in r}
                      for v, runs in p2e_cli.items()},
        "dv1_train_cli": {k: {c: r[c] for c in ("grad_steps", "fwd", "bwd")} for k, r in dv1_cli.items() if "grad_steps" in r},
    }))
    log("[ppo-counts] " + json.dumps({
        "k1_k2_launches": {"ppo_train_graph": ppo_graph[0]["k1_k2_launches"],
                           **{f"ppo_cli_depth{d}": {k: r[k]["k1_k2_launches"] for k in r} for d, r in ppo_cli.items()},
                           "a2c_cli": {k: r["k1_k2_launches"] for k, r in a2c_cli.items()},
                           **{f"ppo_recurrent_cli_{m}": {k: r[k]["k1_k2_launches"] for k in r} for m, r in rec_cli.items()}},
        "ppo_cli_policy_steps_per_s": {d: r["train"]["policy_steps_per_s"] for d, r in ppo_cli.items()},
        "ppo_cli_acting_share": {d: r["train"]["acting_share"] for d, r in ppo_cli.items()},
    }))
    log("[sac-counts] " + json.dumps({
        "k1_k2_launches": {**{f"{n}_train_graph": g["k1_k2_launches"] for n, g in sac_graph.items()},
                           **{f"{c}_cli": {k: r[k]["k1_k2_launches"] for k in r} for c, r in sac_cli.items()}},
        "graph_grad_steps_per_s": {n: [t["grad_steps_per_s"] for t in g["turns"]] for n, g in sac_graph.items()},
        "cli_policy_steps_per_s": {c: r["train"]["policy_steps_per_s"] for c, r in sac_cli.items()},
        "cli_acting_share": {c: r["train"]["acting_share"] for c, r in sac_cli.items()},
    }))
    # overlap: the player's acting and the learner's updating seconds over the run's wall seconds
    log("[decoupled-counts] " + json.dumps({
        "k1_k2_launches": {"ppo_decoupled_agreement": dec_agree["k1_k2_launches"], "sac_decoupled_publish": dec_publish["k1_k2_launches"],
                           **{f"{c}_cli": {k: r[k]["k1_k2_launches"] for k in r} for c, r in dec_cli.items()}},
        "cli_policy_steps_per_s": {c: r["train"]["policy_steps_per_s"] for c, r in dec_cli.items()},
        "cli_acting_policy_steps_per_s": {c: r["train"]["acting_policy_steps_per_s"] for c, r in dec_cli.items()},
        "cli_acting_plus_updating_over_wall": {c: (r["train"]["acting_seconds"] + r["train"]["updating_seconds"]) / r["train"]["seconds"]
                                               for c, r in dec_cli.items()},
        "publications_adopted": [dec_publish["adopted"], dec_publish["publications"]],
    }))
    anakin_paths = {"anakin_ppo_graph": ak_ppo["k1_k2_launches"], "anakin_sac_graph": ak_sac["k1_k2_launches"],
                    **{f"anakin_pop_{n}": r["k1_k2_launches"] for n, r in ak_pop.items()}, "anakin_agreement": ak_agree["k1_k2_launches"],
                    **{f"anakin_cli_{e}_{k}": r[k]["k1_k2_launches"] for e, r in ak_cli.items() for k in ("train", "resume", "eval")}}
    log("[anakin-counts] " + json.dumps({
        "k1_k2_launches": anakin_paths,
        "graph_env_steps_per_s": {"ppo": [t["env_steps_per_s"] for t in ak_ppo["turns"]], "sac": [t["env_steps_per_s"] for t in ak_sac["turns"]]},
        "pop_env_steps_per_s_total": {n: r["env_steps_per_s_total"] for n, r in ak_pop.items()},
        "cli_policy_steps_per_s": {e: r["train"]["policy_steps_per_s"] for e, r in ak_cli.items()},
    }))
    if any(any(c.values()) for c in anakin_paths.values()):
        raise AssertionError(f"[anakin-counts] an Anakin path launched K1 or K2: {anakin_paths}")
    sebulba_paths = {**sb_sac["k1_k2_launches"], **sb_ppo["k1_k2_launches"], **sb_kill["k1_k2_launches"]}
    log("[sebulba-counts] " + json.dumps({
        "k1_k2_launches": sebulba_paths,
        # the placed processes against the thread mode's entry at the same widths and steps
        "policy_steps_per_s": {"sebulba_sac": sb_sac["train"]["policy_steps_per_s"], "sebulba_sac_loop": sb_sac["train"]["loop_policy_steps_per_s"],
                               "thread_sac_decoupled_host": dec_cli["sac_decoupled_host"]["train"]["policy_steps_per_s"],
                               "sebulba_ppo": sb_ppo["policy_steps_per_s"], "sebulba_ppo_loop": sb_ppo["loop_policy_steps_per_s"],
                               "thread_ppo_decoupled": dec_cli["ppo_decoupled"]["train"]["policy_steps_per_s"]},
        "learner_grad_steps_per_s": {"sebulba_sac": sb_sac["train"]["grad_steps_per_s"],
                                     "thread_sac_decoupled_host": dec_cli["sac_decoupled_host"]["train"]["grad_steps"]
                                     / dec_cli["sac_decoupled_host"]["train"]["updating_seconds"]},
        "publish_ms": {"sac": sb_sac["train"]["publish_ms"], "ppo": sb_ppo["publish_ms"]},
        "staleness_steps": {"sac": sb_sac["train"]["staleness_steps"], "ppo": sb_ppo["staleness_steps"]},
        "peak_bytes": {"sac": sb_sac["train"]["peak_bytes"], "ppo": sb_ppo["peak_bytes"]},
        "kill_window": {k: sb_kill[k] for k in ("kill_window_s", "trace_points_in_window", "grad_steps_in_window")},
    }))
    _no_kernels(sebulba_paths, "sebulba-counts")
    f_dv3, f_sup, f_ak = entries["fault-dv3"], entries["fault-supervise"], entries["fault-anakin"]
    ak_k = {f"fault_anakin_{c}": f_ak[c]["k1_k2_launches"] for c in ("killed", "clean")}
    fault_k1 = {**{f"fault_dv3_attempt{i + 1}": {"fwd": k["fwd"], "bwd": k["bwd"]} for i, k in enumerate(f_dv3["k1"])},
                **{f"fault_supervise_child{i + 1}": {"fwd": k["fwd"], "bwd": k["bwd"]} for i, k in enumerate(f_sup["k1"])},
                **{p: {"fwd": c["layernorm_gru"], "bwd": c["layernorm_gru_bwd"]} for p, c in ak_k.items()}}
    # the DreamerV3 attempts launch no K2 (``launches`` raises where one does)
    fault_k2 = {**{f"fault_dv3_attempt{i + 1}": {"fwd": 0, "bwd": 0} for i in range(len(f_dv3["k1"]))},
                **{f"fault_supervise_child{i + 1}": k for i, k in enumerate(f_sup["k2"])},
                **{p: {"fwd": c["rssm_step"], "bwd": c["rssm_step_bwd"]} for p, c in ak_k.items()}}
    log("[fault-counts] " + json.dumps({
        # in process, an attempt ends with Preempted (exit 75 without fault.autoresume) or finishes
        "attempts": {"fault_dv3": f_dv3["outcomes"], "fault_anakin_killed": f_ak["killed"]["outcomes"],
                     "fault_supervise_children_rc": [a["rc"] for a in f_sup["summary"]["attempts"]]},
        "rc": {"fault_supervise": f_sup["rc"]},
        "k1_launches": fault_k1, "k2_launches": fault_k2, "kill_to_first_grad_s": f_dv3["kill_to_first_grad_s"],
        "fault_anakin_leaves_equal": f_ak["leaves"],
        "seconds": {"fault_dv3": f_dv3["seconds"], "fault_supervise": f_sup["seconds"],
                    "fault_anakin": {c: f_ak[c]["seconds"] for c in ("killed", "clean")}},
    }))
    log("[phases] seconds " + json.dumps(seconds))
    line = {"kernels": []}
    # K1's launches on every path that runs it, each counted from zero around its run
    per_replay = lambda g: {"fwd": g["k1_per_replay_capture"]["layernorm_gru"], "bwd": g["k1_per_replay_capture"]["layernorm_gru_bwd"]}  # noqa: E731
    k1_paths = {
        "dv3_train_cli": cli["train"], "dv2_train_cli_device": dv2_cli["device"]["train"],
        **{f"dv3_obs_{k}": {"fwd": obs[k]["k1_fwd"], "bwd": obs[k]["k1_bwd"]} for k in ("window", "enabled", "disabled")},
        "p2e_dv2_explore": p2e_cli[2]["explore"], "p2e_dv2_finetune_load": p2e_cli[2]["finetune_load_True"],
        "p2e_dv2_finetune": p2e_cli[2]["finetune_load_False"],
        "dv3_decoupled_s_per_replay": per_replay(dec_graph),
        "p2e_dv3_xl_discrete_per_replay": per_replay(p2e_dv3_graph[0]), "p2e_dv3_xl_continuous_per_replay": per_replay(p2e_dv3_graph[1]),
        "p2e_dv3_explore": p2e_cli[3]["explore"], "p2e_dv3_finetune_load": p2e_cli[3]["finetune_load_True"],
        "p2e_dv3_finetune": p2e_cli[3]["finetune_load_False"],
        # the PPO family's paths, which run no K1 (checked zero in their phases)
        **{f"ppo_cli_depth{d}": {"fwd": r["train"]["k1_k2_launches"]["layernorm_gru"], "bwd": r["train"]["k1_k2_launches"]["layernorm_gru_bwd"]}
           for d, r in ppo_cli.items()},
        # the SAC family's, which run no K1 either (checked zero in their phases)
        **{f"{c}_cli": {"fwd": r["train"]["k1_k2_launches"]["layernorm_gru"], "bwd": r["train"]["k1_k2_launches"]["layernorm_gru_bwd"]}
           for c, r in sac_cli.items()},
        # the thread-decoupled entries', which run no K1 either (checked zero in their phases)
        **{f"{c}_cli": {"fwd": r["train"]["k1_k2_launches"]["layernorm_gru"], "bwd": r["train"]["k1_k2_launches"]["layernorm_gru_bwd"]}
           for c, r in dec_cli.items()},
        # the serving paths (each family at each tier), which run no K1 either (checked zero in [serve])
        **{p: {"fwd": c["layernorm_gru"], "bwd": c["layernorm_gru_bwd"]} for p, c in serve_paths.items()},
        # the Anakin and population paths, which run no K1 either (checked zero in [anakin-counts])
        **{p: {"fwd": c["layernorm_gru"], "bwd": c["layernorm_gru_bwd"]} for p, c in anakin_paths.items()},
        # every Sebulba process, which runs no K1 either (checked zero in [sebulba-counts])
        **{p: {"fwd": c["layernorm_gru"], "bwd": c["layernorm_gru_bwd"]} for p, c in sebulba_paths.items()},
        # the fault drills: each DreamerV3-S attempt and supervised child, and the Anakin runs (none)
        **fault_k1,
        # the env pool: DreamerV3-S's entry at depth 1, and the pooled PPO fault runs (none)
        "pool_dv3_cli": pool_cli["train"], "pool_dv3_cli_resume": pool_cli["resume"],
        **{f"pool_fault_{m}": {"fwd": pool_fault[m]["k1_k2_launches"]["layernorm_gru"], "bwd": pool_fault[m]["k1_k2_launches"]["layernorm_gru_bwd"]}
           for m in ("crash", "hang")},
    }
    # K2's: its one path, the scan bench, and the serving paths (none)
    k2_paths = {"rssm_scan": {"fwd": scan["launches"]["rssm_step"], "bwd": scan["launches"]["rssm_step_bwd"]},
                **{p: {"fwd": c["rssm_step"], "bwd": c["rssm_step_bwd"]} for p, c in serve_paths.items()},
                **{p: {"fwd": c["rssm_step"], "bwd": c["rssm_step_bwd"]} for p, c in anakin_paths.items()},
                **{p: {"fwd": c["rssm_step"], "bwd": c["rssm_step_bwd"]} for p, c in sebulba_paths.items()}, **fault_k2,
                # the env pool's paths (``launches`` raises where a DreamerV3 path launches K2)
                "pool_dv3_cli": {"fwd": 0, "bwd": 0}, "pool_dv3_cli_resume": {"fwd": 0, "bwd": 0},
                **{f"pool_fault_{m}": {"fwd": pool_fault[m]["k1_k2_launches"]["rssm_step"], "bwd": pool_fault[m]["k1_k2_launches"]["rssm_step_bwd"]}
                   for m in ("crash", "hang")}}
    for name, source, source_line, k, n in (
        ("layernorm_gru_fwd", "layernorm_gru.cu", "sheeprl_tpu/ops/gru.py:119", kernels, cli["train"]["fwd"]),
        ("layernorm_gru_bwd", "layernorm_gru.cu", "sheeprl_tpu/ops/gru.py:139", kernels_bwd, cli["train"]["bwd"]),
        ("rssm_step_fwd", "rssm_step.cu", "sheeprl_tpu/ops/rssm_step.py:139", step_fwd, scan["launches"]["rssm_step"]),
        ("rssm_step_bwd", "rssm_step.cu", "sheeprl_tpu/ops/rssm_step.py:152", step_bwd, scan["launches"]["rssm_step_bwd"]),
    ):
        row = k["main"]
        line["kernels"].append(
            {
                "name": name,
                "route": "cuda",
                "source": f"sheeprl_tpu_torch/csrc/{source}",
                "replaces": source_line,
                "launches": n,
                "max_abs_err": k["max_abs_err_f32"],
                "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": None,
            }
        )
        paths = k1_paths if name.startswith("layernorm_gru") else k2_paths
        line["kernels"][-1]["launches_by_path"] = {p: r["fwd" if name.endswith("fwd") else "bwd"] for p, r in paths.items()}
    log(f"[done] {time.perf_counter() - t0:.1f} s; eval launches {ev['launches']}; train steps/s "
        + ", ".join(f"{r['precision']} {r['actor']} {r['grad_steps_per_s']:.2f}" for r in train)
        + "; graphed train steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.2f}" for t in graphed[0]["turns"])
        + f"; train-cli policy steps/s host replay {cli['train']['policy_steps_per_s']:.1f}, device replay {cli_device['train']['policy_steps_per_s']:.1f}"
        + "; DreamerV2 graphed train steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.2f}" for t in dv2_graph["turns"])
        + "; DreamerV2 train-cli policy steps/s " + ", ".join(f"{b} {c['train']['policy_steps_per_s']:.1f}" for b, c in dv2_cli.items())
        + "; DreamerV1 graphed train steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.2f}" for t in dv1_graph["turns"])
        + "; P2E-DV1 graphed exploration steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.2f}" for t in p2e_dv1_graph["turns"])
        + "; P2E-DV2 graphed exploration steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.2f}" for t in p2e_graph[0]["turns"])
        + "; decoupled DreamerV3-S graphed train steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.2f}" for t in dec_graph["turns"])
        + "; P2E-DV3 XL graphed exploration steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.3f}" for t in p2e_dv3_graph[0]["turns"])
        + "; rssm scan device ms " + ", ".join(f"{n} {scan['line'][n]['device_ms_per_scan']:.3f}" for n in ("plain", "post_fused", "full_fused"))
        + "; PPO (ppo_atari) graphed update steps/s " + ", ".join(f"{t['mode']} {t['grad_steps_per_s']:.1f}" for t in ppo_graph[0]["turns"])
        + "; ppo-cli policy steps/s " + ", ".join(f"depth {d} {r['train']['policy_steps_per_s']:.1f} (acting share {r['train']['acting_share']:.3f})" for d, r in ppo_cli.items())
        + "; SAC-family graphed gradient steps/s " + ", ".join(f"{n} " + "/".join(f"{t['mode']} {t['grad_steps_per_s']:.1f}" for t in g["turns"]) for n, g in sac_graph.items())
        + "; SAC-family cli policy steps/s " + ", ".join(f"{c} {r['train']['policy_steps_per_s']:.1f}" for c, r in sac_cli.items())
        + "; decoupled cli policy steps/s " + ", ".join(f"{c} {r['train']['policy_steps_per_s']:.1f}" for c, r in dec_cli.items())
        + "; serve requests/s " + ", ".join(f"{n} {t} {r['requests_per_s']:.0f}" for t, rows in serve["tiers"].items() for n, r in rows.items())
        + "; Anakin env steps/s " + ", ".join(f"{n} " + "/".join(f"{t['mode']} {t['env_steps_per_s']:.0f}" for t in g["turns"]) for n, g in (("ppo", ak_ppo), ("sac", ak_sac)))
        + "; population env steps/s " + ", ".join(f"{n} {r['env_steps_per_s_total']:.0f}" for n, r in ak_pop.items())
        + f"; Sebulba policy steps/s sac {sb_sac['train']['policy_steps_per_s']:.1f}, ppo {sb_ppo['policy_steps_per_s']:.1f}"
        + "; obs policy steps/s " + ", ".join(f"{k} {obs[k]['policy_steps_per_s']:.1f}" for k in ("window", "enabled", "disabled"))
        + f"; fault-dv3 kill to the resumed attempt's first gradient step {f_dv3['kill_to_first_grad_s']:.2f} s"
        + "; env steps/s of 8 envs " + ", ".join(f"{k} {r['env_steps_per_s']:.0f}" for k, r in pool["rows"].items())
        + f"; pool-dv3-cli policy steps/s {pool_cli['train']['policy_steps_per_s']:.1f}")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--entries"] and sys.argv[3:4] == ["--out"] and len(sys.argv) == 5:
        sys.exit(entry_worker(sys.argv[2].split(","), Path(sys.argv[4])))
    sys.exit(main())
