"""The PyTorch port stands alone: importing it loads no JAX, no Flax and nothing of the
JAX package ``sheeprl_tpu``; nor gymnasium, which the card's host does not have (the
port carries its own subset of gymnasium's API, ``envs/core.py``).

The test session itself has JAX loaded (``tests/conftest.py``), so the import check runs
in a fresh interpreter. Note the prefix trap: ``sheeprl_tpu_torch`` starts with
``sheeprl_tpu``, so a module of the JAX package is ``sheeprl_tpu`` or
``sheeprl_tpu.<...>``.
"""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sheeprl_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "chex", "sheeprl_tpu", "gymnasium"}

SLICE_MODULES = [
    "sheeprl_tpu_torch",
    "sheeprl_tpu_torch.cli",
    "sheeprl_tpu_torch.eval",
    "sheeprl_tpu_torch.__main__",
    "sheeprl_tpu_torch.algos",
    "sheeprl_tpu_torch.algos.a2c.a2c",
    "sheeprl_tpu_torch.algos.decoupled",
    "sheeprl_tpu_torch.algos.dreamer_loop",
    "sheeprl_tpu_torch.algos.dreamer_v1.agent",
    "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "sheeprl_tpu_torch.algos.dreamer_v1.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v1.loss",
    "sheeprl_tpu_torch.algos.dreamer_v1.utils",
    "sheeprl_tpu_torch.algos.dreamer_v2.agent",
    "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "sheeprl_tpu_torch.algos.dreamer_v2.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v2.loss",
    "sheeprl_tpu_torch.algos.dreamer_v2.utils",
    "sheeprl_tpu_torch.algos.dreamer_v3.agent",
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.dreamer_v3.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v3.loss",
    "sheeprl_tpu_torch.algos.dreamer_v3.params",
    "sheeprl_tpu_torch.algos.dreamer_v3.utils",
    "sheeprl_tpu_torch.algos.droq",
    "sheeprl_tpu_torch.algos.droq.droq",
    "sheeprl_tpu_torch.algos.droq.evaluate",
    "sheeprl_tpu_torch.algos.loop_common",
    "sheeprl_tpu_torch.algos.p2e",
    "sheeprl_tpu_torch.algos.p2e_dv1.agent",
    "sheeprl_tpu_torch.algos.p2e_dv1.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv1.utils",
    "sheeprl_tpu_torch.algos.p2e_dv2.agent",
    "sheeprl_tpu_torch.algos.p2e_dv2.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv2.utils",
    "sheeprl_tpu_torch.algos.p2e_dv3.agent",
    "sheeprl_tpu_torch.algos.p2e_dv3.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv3.utils",
    "sheeprl_tpu_torch.algos.ppo.agent",
    "sheeprl_tpu_torch.algos.ppo.evaluate",
    "sheeprl_tpu_torch.algos.ppo.loss",
    "sheeprl_tpu_torch.algos.ppo.ppo",
    "sheeprl_tpu_torch.algos.ppo.ppo_decoupled",
    "sheeprl_tpu_torch.algos.ppo.utils",
    "sheeprl_tpu_torch.algos.ppo_recurrent.agent",
    "sheeprl_tpu_torch.algos.ppo_recurrent.evaluate",
    "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
    "sheeprl_tpu_torch.algos.sac",
    "sheeprl_tpu_torch.algos.sac.agent",
    "sheeprl_tpu_torch.algos.sac.evaluate",
    "sheeprl_tpu_torch.algos.sac.loss",
    "sheeprl_tpu_torch.algos.sac.sac",
    "sheeprl_tpu_torch.algos.sac.sac_decoupled",
    "sheeprl_tpu_torch.algos.sac.utils",
    "sheeprl_tpu_torch.algos.sac_ae",
    "sheeprl_tpu_torch.algos.sac_ae.agent",
    "sheeprl_tpu_torch.algos.sac_ae.evaluate",
    "sheeprl_tpu_torch.algos.sac_ae.sac_ae",
    "sheeprl_tpu_torch.benchmarks",
    "sheeprl_tpu_torch.benchmarks.fused_step_bench",
    "sheeprl_tpu_torch.benchmarks.gru_kernel_ab",
    "sheeprl_tpu_torch.benchmarks.step_kernel_ab",
    "sheeprl_tpu_torch.benchmarks.train_bench",
    "sheeprl_tpu_torch.checkpoint.manager",
    "sheeprl_tpu_torch.config.core",
    "sheeprl_tpu_torch.data.buffers",
    "sheeprl_tpu_torch.data.device_buffer",
    "sheeprl_tpu_torch.data.prefetch",
    "sheeprl_tpu_torch.distributed",
    "sheeprl_tpu_torch.distributed.launcher",
    "sheeprl_tpu_torch.distributed.placement",
    "sheeprl_tpu_torch.distributed.publish",
    "sheeprl_tpu_torch.distributed.sebulba",
    "sheeprl_tpu_torch.distributed.transport",
    "sheeprl_tpu_torch.distributions",
    "sheeprl_tpu_torch.engine",
    "sheeprl_tpu_torch.engine.anakin",
    "sheeprl_tpu_torch.engine.population",
    "sheeprl_tpu_torch.envs.batched",
    "sheeprl_tpu_torch.envs.batched.cartpole",
    "sheeprl_tpu_torch.envs.batched.core",
    "sheeprl_tpu_torch.envs.batched.gym_adapter",
    "sheeprl_tpu_torch.envs.batched.mountain_car",
    "sheeprl_tpu_torch.envs.batched.pendulum",
    "sheeprl_tpu_torch.envs.core",
    "sheeprl_tpu_torch.envs.dummy",
    "sheeprl_tpu_torch.envs.spaces",
    "sheeprl_tpu_torch.envs.vector",
    "sheeprl_tpu_torch.envs.wrappers",
    "sheeprl_tpu_torch.fault",
    "sheeprl_tpu_torch.fault.chaos",
    "sheeprl_tpu_torch.fault.classify",
    "sheeprl_tpu_torch.fault.counters",
    "sheeprl_tpu_torch.fault.guard",
    "sheeprl_tpu_torch.fault.preemption",
    "sheeprl_tpu_torch.fault.supervisor",
    "sheeprl_tpu_torch.models.blocks",
    "sheeprl_tpu_torch.obs",
    "sheeprl_tpu_torch.obs.flight_recorder",
    "sheeprl_tpu_torch.obs.health",
    "sheeprl_tpu_torch.obs.monitor",
    "sheeprl_tpu_torch.obs.perf",
    "sheeprl_tpu_torch.obs.telemetry",
    "sheeprl_tpu_torch.obs.tracer",
    "sheeprl_tpu_torch.obs.watchdog",
    "sheeprl_tpu_torch.ops._build",
    "sheeprl_tpu_torch.ops.counters",
    "sheeprl_tpu_torch.ops.gru",
    "sheeprl_tpu_torch.ops.ring_attention",
    "sheeprl_tpu_torch.ops.rssm_step",
    "sheeprl_tpu_torch.parallel.context",
    "sheeprl_tpu_torch.precision",
    "sheeprl_tpu_torch.precision.loss_scale",
    "sheeprl_tpu_torch.precision.parity",
    "sheeprl_tpu_torch.precision.policy",
    "sheeprl_tpu_torch.precision.quantize",
    "sheeprl_tpu_torch.registration",
    "sheeprl_tpu_torch.sebulba",
    "sheeprl_tpu_torch.supervise",
    "sheeprl_tpu_torch.rollout",
    "sheeprl_tpu_torch.rollout.pipeline",
    "sheeprl_tpu_torch.rollout.pool",
    "sheeprl_tpu_torch.rollout.shared",
    "sheeprl_tpu_torch.rollout.sharding",
    "sheeprl_tpu_torch.rollout.worker",
    "sheeprl_tpu_torch.serve",
    "sheeprl_tpu_torch.serve.__main__",
    "sheeprl_tpu_torch.serve.batching",
    "sheeprl_tpu_torch.serve.client",
    "sheeprl_tpu_torch.serve.precompile",
    "sheeprl_tpu_torch.serve.router",
    "sheeprl_tpu_torch.serve.server",
    "sheeprl_tpu_torch.serve.state_cache",
    "sheeprl_tpu_torch.serve.watchdog",
    "sheeprl_tpu_torch.utils.blocks",
    "sheeprl_tpu_torch.utils.env",
    "sheeprl_tpu_torch.utils.graphs",
    "sheeprl_tpu_torch.utils.imports",
    "sheeprl_tpu_torch.utils.logger",
    "sheeprl_tpu_torch.utils.memmap",
    "sheeprl_tpu_torch.utils.metric",
    "sheeprl_tpu_torch.utils.model_manager",
    "sheeprl_tpu_torch.utils.policy",
    "sheeprl_tpu_torch.utils.registry",
    "sheeprl_tpu_torch.utils.timer",
    "sheeprl_tpu_torch.utils.utils",
]


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN_ROOTS


def test_importing_the_slice_loads_no_jax_nor_gymnasium_in_a_fresh_interpreter():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN_ROOTS)!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_no_source_file_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    # every module the fresh interpreter imports is scanned too (the SAC family's among them)
    scanned = {str(f.relative_to(REPO).with_suffix("")).replace("/", ".").removesuffix(".__init__") for f in files}
    assert set(SLICE_MODULES) <= scanned, sorted(set(SLICE_MODULES) - scanned)
    bad = [f"{f.relative_to(REPO)}:{line}: {mod}" for f in files for line, mod in _imports(f) if _forbidden(mod)]
    assert not bad, bad


def test_prefix_rule_tells_the_packages_apart():
    assert _forbidden("sheeprl_tpu") and _forbidden("sheeprl_tpu.ops.gru") and _forbidden("jax.numpy") and _forbidden("gymnasium.spaces")
    assert not _forbidden("sheeprl_tpu_torch") and not _forbidden("sheeprl_tpu_torch.ops.gru")
