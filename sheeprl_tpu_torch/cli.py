"""CLI entry points (counterpart of ``sheeprl_tpu/cli.py``): training and evaluation.

``python -m sheeprl_tpu_torch exp=<preset> [overrides]`` composes the config, merges a
checkpoint's config when ``checkpoint.resume_from`` is set, checks it and calls the
algorithm's registered train entry; with ``-m``/``--multirun`` every override whose
value is a bare comma-separated list becomes an axis of a grid whose jobs run one after
another (``expand_multirun``), each under ``multirun_<stamp>/job<i>_<run name>``.
``python -m sheeprl_tpu_torch.eval checkpoint_path=<run>/checkpoints/ckpt_N
[overrides]`` loads the run's saved ``config.yaml``, applies the overrides, and calls
the registered evaluation entry; the checkpoint may also be a registry spec
``name[:version|stage|latest]`` (``serve/router.py``). ``python -m
sheeprl_tpu_torch.registration checkpoint_path=<ckpt>`` registers a checkpoint in the
model registry. The train and eval entries run on ``device`` (``cuda`` unless
``device=cpu`` is given). An exception that escapes a train entry dumps the run's flight
recorder (``<log_dir>/blackbox/``, ``obs/flight_recorder.py``) before it propagates; a
graceful preemption does not. Not ported: autoresume under the fault policy, the compile
cache and the race detector.
"""

from __future__ import annotations

import datetime
import itertools
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from sheeprl_tpu_torch.checkpoint.manager import validate_resume_config
from sheeprl_tpu_torch.config.core import DotDict, _parse_value, _set_dotted, compose, load_config, print_config
from sheeprl_tpu_torch.parallel.context import make_run_context
from sheeprl_tpu_torch.utils.registry import get_algorithm, get_evaluation


def _import_algorithms() -> None:
    """Populate the registries."""
    import sheeprl_tpu_torch.algos  # noqa: F401  (registers on import)


def _default_run_name(cfg: Dict[str, Any]) -> str:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    return f"{stamp}_{cfg.get('exp_name', 'run')}_{cfg.get('seed', 0)}"


def resume_from_checkpoint(cfg: DotDict) -> DotDict:
    """Merge the config of the run that wrote ``checkpoint.resume_from``, keeping that
    run's values of the keys a resume must not change."""
    ckpt_path = Path(cfg.checkpoint.resume_from)
    run_dir = ckpt_path.parent.parent if ckpt_path.is_dir() else ckpt_path.parent
    old_cfg_path = run_dir / "config.yaml"
    if not old_cfg_path.is_file():
        old_cfg_path = ckpt_path.parent / "config.yaml"
    if not old_cfg_path.is_file():
        raise FileNotFoundError(f"Cannot resume from {ckpt_path}: no config.yaml found alongside the checkpoint")
    cfg = DotDict.wrap(validate_resume_config(load_config(old_cfg_path), cfg))
    cfg.checkpoint.resume_from = str(ckpt_path)
    return cfg


def check_configs(cfg: DotDict) -> None:
    """Refuse configurations the loop cannot run."""
    algo = cfg.get("algo", {})
    if not algo or "name" not in algo:
        raise ValueError("No algorithm selected: choose one with 'exp=<preset>' or 'algo=<name>'")
    entry = get_algorithm(algo["name"])
    if entry["decoupled"] and cfg.env.get("sync_env", False) is False and cfg.env.num_envs <= 0:
        raise ValueError("Decoupled algorithms need at least one environment")
    cnn_keys = algo.get("cnn_keys", {}).get("encoder", [])
    mlp_keys = algo.get("mlp_keys", {}).get("encoder", [])
    if not isinstance(cnn_keys, list) or not isinstance(mlp_keys, list):
        raise ValueError("algo.cnn_keys.encoder and algo.mlp_keys.encoder must be lists")
    if cfg.metric.get("log_level", 1) not in (0, 1):
        raise ValueError(f"Invalid metric.log_level: {cfg.metric.log_level}")
    # DreamerV1, DreamerV2 and their P2E variants pin the decoder to one 64x64 frame
    if str(algo.get("name", "")).startswith(("dreamer_v1", "dreamer_v2", "p2e_dv1", "p2e_dv2")) and cnn_keys:
        if int(cfg.env.get("screen_size") or 64) != 64 or int(cfg.env.get("frame_stack") or 1) > 1:
            raise ValueError(
                f"{algo['name']} pixel observations require env.screen_size=64 and "
                f"env.frame_stack<=1 (the decoder geometry is pinned to one 64x64 frame); "
                f"got screen_size={cfg.env.get('screen_size')}, "
                f"frame_stack={cfg.env.get('frame_stack')}."
            )
    # A sequence-sampling loop's prefill must leave every env's sub-buffer at least one
    # sequence long, or the first gradient step fails mid-run. A resumed run and a P2E
    # finetuning run that loads the exploration run's buffer start with rows.
    seq_len = int(algo.get("per_rank_sequence_length", 0) or 0)
    learning_starts = int(algo.get("learning_starts", 0) or 0)
    buffer_prefilled = bool(cfg.checkpoint.get("resume_from")) or bool(cfg.get("buffer", {}).get("load_from_exploration", False))
    if seq_len > 1 and learning_starts > 0 and not buffer_prefilled and not cfg.get("dry_run", False):
        steps_per_iter = max(cfg.env.num_envs * max(cfg.env.action_repeat, 1), 1)
        rows_per_env = learning_starts // steps_per_iter
        if rows_per_env < seq_len:
            raise ValueError(
                f"algo.learning_starts={learning_starts} prefills only ~{rows_per_env} steps per environment "
                f"({cfg.env.num_envs} envs x action_repeat {cfg.env.action_repeat}), but "
                f"algo.per_rank_sequence_length={seq_len} needs at least {seq_len} steps per env before the first "
                f"gradient step. Raise learning_starts to >= {seq_len * steps_per_iter} or lower the sequence length "
                "or the env count."
            )


def run_algorithm(cfg: DotDict) -> Any:
    """Registry lookup, run context, entry-point call; returns what the entry returns. For
    a P2E finetuning entry, the exploration run's config is first merged into ``cfg``
    (``algos/p2e::load_exploration_config``): the entry builds what that run built."""
    entry = get_algorithm(cfg.algo.name)
    if "finetuning" in cfg.algo.name and "p2e" in entry["module"]:
        from sheeprl_tpu_torch.algos.p2e import load_exploration_config

        load_exploration_config(cfg)
    ctx = make_run_context(cfg)
    from sheeprl_tpu_torch.fault.preemption import Preempted
    from sheeprl_tpu_torch.obs import flight_recorder
    from sheeprl_tpu_torch.obs import perf as obs_perf

    try:
        return entry["entrypoint"](ctx, cfg)
    except Preempted:
        raise  # not a crash: the final checkpoint is on disk
    except Exception as exc:
        dump = flight_recorder.dump_active("crash", exc)
        if dump:
            print(f"flight recorder: black box dumped to {dump}", file=sys.stderr)
        raise
    finally:
        # the recorder and the cost models are process-global: no run sees another's
        flight_recorder.install(None)
        obs_perf.reset()


def expand_multirun(overrides: List[str]) -> List[List[str]]:
    """Hydra's multirun grid: every override whose value is a bare comma-separated list
    is a sweep axis, and the jobs are their cartesian product (``algo.lr=1e-4,3e-4
    seed=1,2``: 4 jobs). A bracketed or quoted value (``cnn_keys.encoder=[rgb,depth]``)
    is one value, never an axis."""
    axes: List[List[str]] = []
    for ov in overrides:
        key, eq, val = ov.partition("=")
        if eq and "," in val and not val.lstrip().startswith(("[", "{", "(", "'", '"')):
            axes.append([f"{key}={v}" for v in val.split(",")])
        else:
            axes.append([ov])
    return [list(combo) for combo in itertools.product(*axes)]


def run(args: Optional[List[str]] = None) -> Any:
    """Train entry: ``python -m sheeprl_tpu_torch exp=... key=value ...``. Returns what
    the algorithm's entry returns; with ``-m``/``--multirun``, the list of what each job
    returned, the jobs run one after another."""
    _import_algorithms()
    overrides = list(args if args is not None else sys.argv[1:])
    multirun = bool({"-m", "--multirun"} & set(overrides))
    overrides = [ov for ov in overrides if ov not in ("-m", "--multirun")]
    jobs = expand_multirun(overrides) if multirun else [overrides]
    sweep = multirun and len(jobs) > 1
    if sweep:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        print(f"multirun: {len(jobs)} jobs")
    results = []
    for i, job in enumerate(jobs):
        cfg = compose(overrides=job)
        if cfg.checkpoint.get("resume_from"):
            cfg = resume_from_checkpoint(cfg)
        if sweep:
            cfg.run_name = f"multirun_{stamp}/job{i}_{cfg.get('run_name') or _default_run_name(cfg)}"
            print(f"multirun job {i}/{len(jobs) - 1}: {' '.join(job)}")
        elif not cfg.get("run_name"):
            cfg.run_name = _default_run_name(cfg)
        check_configs(cfg)
        if os.environ.get("SHEEPRL_TPU_QUIET", "0") != "1":
            print_config(cfg)
        results.append(run_algorithm(cfg))
    return results if multirun else results[0]


def eval_algorithm(cfg: DotDict) -> Any:
    """Evaluation dispatch: one process, one environment, on ``cfg.device``. ``cfg`` is
    the run's saved config with the user's overrides merged on top. Returns what the
    algorithm's evaluation entry returns."""
    ckpt_path = Path(cfg.checkpoint_path)
    if "capture_video" in cfg:  # top-level alias for env.capture_video
        cfg.env.capture_video = bool(cfg.capture_video)
    cfg.env.num_envs = 1
    cfg.run_name = cfg.get("run_name") or _default_run_name(cfg)
    evaluate_fn = get_evaluation(cfg.algo.name)
    ctx = make_run_context(cfg)
    return evaluate_fn(ctx, cfg, str(ckpt_path))


def _load_checkpoint_cfg(overrides: List[str], path_key: str) -> tuple:
    """Extract ``<path_key>=...`` from the overrides, load the checkpoint run's
    ``config.yaml`` (two levels up, beside the checkpoint, or inside it) and apply the
    remaining overrides on top.

    The value may also be a registry spec ``name[:version|stage|latest]``: it resolves
    through the model registry (a ``model_manager.registry_dir=`` override, or the
    default ``models_registry``) to the registered payload, which holds its own
    ``config.yaml``."""
    ckpt = None
    rest = []
    for ov in overrides:
        if ov.startswith(f"{path_key}="):
            ckpt = ov.split("=", 1)[1]
        else:
            rest.append(ov)
    if ckpt is None:
        raise ValueError(f"this entry point requires {path_key}=<path>")
    ckpt_path = Path(ckpt)
    if not ckpt_path.exists() and not ckpt.startswith(("/", ".", "~")):
        from sheeprl_tpu_torch.serve.router import resolve_registry_checkpoint

        name, version, ckpt_path = resolve_registry_checkpoint(ckpt, rest)
        print(f"resolved {ckpt!r} -> {name} v{version} ({ckpt_path})")
    run_dir = ckpt_path.parent.parent if ckpt_path.is_dir() else ckpt_path.parent
    cfg_path = run_dir / "config.yaml"
    if not cfg_path.is_file():
        cfg_path = ckpt_path.parent / "config.yaml"
    if not cfg_path.is_file() and ckpt_path.is_dir():
        cfg_path = ckpt_path / "config.yaml"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"No config.yaml found alongside checkpoint {ckpt}")
    cfg = load_config(cfg_path)
    for ov in rest:
        if "=" not in ov:
            raise ValueError(f"Malformed override {ov!r}")
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key.lstrip("+"), _parse_value(val))
    return DotDict.wrap(cfg), ckpt_path


def evaluate(args: Optional[List[str]] = None) -> Any:
    """Eval entry: ``python -m sheeprl_tpu_torch.eval checkpoint_path=... [overrides]``.
    Returns the evaluation entry's result."""
    _import_algorithms()
    overrides = list(args if args is not None else sys.argv[1:])
    cfg, ckpt_path = _load_checkpoint_cfg(overrides, "checkpoint_path")
    cfg.checkpoint_path = str(ckpt_path)
    # Eval records a video by default regardless of the training run's setting; an
    # explicit override still wins.
    overridden = {ov.partition("=")[0].lstrip("+") for ov in overrides}
    if not overridden & {"env.capture_video", "capture_video"}:
        cfg.env.capture_video = True
    return eval_algorithm(cfg)


def registration(args: Optional[List[str]] = None) -> int:
    """Model-registration entry: ``python -m sheeprl_tpu_torch.registration
    checkpoint_path=<ckpt_dir> [model_manager.name=...] [model_manager.registry_dir=...]``
    registers a training checkpoint as a new version in the model registry and returns
    the version."""
    from sheeprl_tpu_torch.utils.model_manager import build_model_manager

    overrides = list(args if args is not None else sys.argv[1:])
    cfg, ckpt_path = _load_checkpoint_cfg(overrides, "checkpoint_path")
    mm_cfg = cfg.get("model_manager", {}) or {}
    name = mm_cfg.get("name") or f"{cfg.algo.name}_{cfg.env.id}"
    manager = build_model_manager(cfg)
    version = manager.register_model(
        str(ckpt_path),
        name,
        model_keys=list(mm_cfg.get("models", {}) or []),
        metadata={"algo": cfg.algo.name, "env": cfg.env.id, "seed": cfg.seed},
    )
    print(f"Registered {name} version {version}")
    return version
