"""K-step training blocks of the PyTorch port (``sheeprl_tpu_torch/utils/blocks.py``,
``utils/graphs.py``) and its optimizer's device step count.

On the CPU the captured step runs eagerly, so a block of G steps must equal G sequential
``train_step`` calls given the same batches, draws and target flags, bit for bit (it is
the same code). The block's chunking and its target-critic cadence are held against the
reference's ``chunk_sizes`` and ``make_train_block``, and the optimizer with its step
count on the device against optax at ``test_optimizer_matches_optax``'s tolerances. The
graph-captured step against the eager step runs on the card only (marked ``cuda``).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

T, B, HORIZON, G = 4, 2, 3, 3
# test_torch_dv3_agent.py's tiny agent; repeated here because that module imports JAX
# and gymnasium, which the card's host does not have, and this file's cuda-marked test
# runs there
TINY = [
    "exp=dreamer_v3_dummy",
    "algo=dreamer_v3_XS",
    "env=discrete_dummy",
    "env.screen_size=64",
    "algo.dense_units=16",
    "algo.mlp_layers=2",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.world_model.recurrent_model.recurrent_state_size=32",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=4",
    "algo.world_model.reward_model.bins=15",
    "algo.critic.bins=15",
]


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the tiny agent gains nothing from more, and the suite's
    other workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _obs_space():
    from sheeprl_tpu_torch.envs import spaces

    return spaces.Dict(
        {"rgb": spaces.Box(0, 255, (3, 64, 64), np.uint8), "state": spaces.Box(-20, 20, (10,), np.float32)}
    )


def _agent(is_continuous: bool, device="cpu", seed: int = 0):
    """A tiny agent (float32), its train step and its optimizer states and moments."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext

    extra = ["env=continuous_dummy"] if is_continuous else []
    cfg = compose(overrides=[*TINY, *extra, f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}",
                             f"algo.horizon={HORIZON}", "mesh.precision=32-true", "device=cpu"])
    device = torch.device(device)
    wm, actor, critic, target, _ = build_agent(RunContext(device, seed), (2,), is_continuous, cfg, _obs_space())
    modules = {"world_model": wm, "actor": actor, "critic": critic, "target_critic": target}
    step, init = make_train_step(wm, actor, critic, target, cfg, ["rgb"], ["state"])
    return modules, step, init(), init_moments(device), cfg


def _twin(is_continuous: bool, device="cpu"):
    a = _agent(is_continuous, device)
    modules, step, opt, moments, cfg = a
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step

    m2 = {k: copy.deepcopy(v) for k, v in modules.items()}
    step2, init2 = make_train_step(*m2.values(), cfg, ["rgb"], ["state"])
    opt2 = init2()
    moments2 = {k: v.clone() for k, v in moments.items()}
    return a, (m2, step2, opt2, moments2, cfg)


def _rows(rng, steps, n_envs, is_continuous):
    """``steps`` loop rows (``[1, n_envs, ...]``) of the tiny agent's keys."""
    out = []
    for _ in range(steps):
        a = rng.uniform(-1, 1, (1, n_envs, 2)) if is_continuous else np.eye(2)[rng.integers(0, 2, (1, n_envs))]
        out.append({
            "rgb": rng.integers(0, 256, size=(1, n_envs, 3, 64, 64), dtype=np.uint8),
            "state": rng.normal(size=(1, n_envs, 10)).astype(np.float32),
            "actions": a.astype(np.float32),
            "rewards": rng.normal(size=(1, n_envs, 1)).astype(np.float32),
            "terminated": (rng.random((1, n_envs, 1)) < 0.2).astype(np.float32),
            "truncated": np.zeros((1, n_envs, 1), np.float32),
            "is_first": (rng.random((1, n_envs, 1)) < 0.2).astype(np.float32),
        })
    return out


class _Collect:
    def __init__(self):
        self.last = {}

    def update(self, name, value):
        self.last[name] = value


def _assert_same_state(a, b):
    (ma, _, oa, moma, _), (mb, _, ob, momb, _) = a, b
    for name in ma:
        for (k, x), (_, y) in zip(ma[name].state_dict().items(), mb[name].state_dict().items()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=lambda m: f"{name}.{k}: {m}")
    from sheeprl_tpu_torch.utils.graphs import tree_tensors

    for x, y in zip(tree_tensors(oa), tree_tensors(ob), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for k in moma:
        torch.testing.assert_close(moma[k], momb[k], rtol=0, atol=0)


@pytest.mark.parametrize("replay", ["host", "device"])
@pytest.mark.parametrize("actor", ["discrete", "continuous"])
def test_block_equals_sequential_train_steps(replay, actor):
    """G steps as one block (chunks 2 + 1) against G ``train_step`` calls with the draws
    of a generator seeded alike and the reference's target flags (freq 2, from a
    start count of 5): parameters, optimizer states, moments and the last metrics."""
    from sheeprl_tpu_torch.algos.dreamer_loop import make_captured_step
    from sheeprl_tpu_torch.data import device_buffer as db
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher, IndexedBlockDispatcher, target_flags

    is_continuous = actor == "continuous"
    blocked, seq = _twin(is_continuous)
    modules, step, opt, moments, cfg = blocked
    cpu = torch.device("cpu")
    rb = EnvIndependentReplayBuffer(16, n_envs=3, obs_keys=("rgb", "state"), buffer_cls=SequentialReplayBuffer)
    rb.seed(1)
    extra = [("actions", 2), ("rewards", 1), ("terminated", 1), ("truncated", 1), ("is_first", 1)]
    mirror = db.make_mirror_for(rb, ["rgb"], ["state"], _obs_space(), extra, cpu)
    add = db.make_rb_add(mirror, rb, contextlib.nullcontext(), 3)
    for row in _rows(np.random.default_rng(0), 10, 3, is_continuous):
        add(row)
    envs, starts = db.sample_index_block(rb, B, T, G)
    gather = mirror.make_gather_fn(T)
    batches = [gather(torch.from_numpy(envs[g]), torch.from_numpy(starts[g])) for g in range(G)]

    make_step = make_captured_step(step, modules, opt, moments, T, B, torch.Generator().manual_seed(7))
    if replay == "device":
        captured, draw = make_step({"table": torch.zeros(2 * B + 1, dtype=torch.int64), "gather": gather})
        dispatcher = IndexedBlockDispatcher(captured, draw, target_update_freq=2)
        dispatcher.dispatch(envs, starts, 5)
    else:
        static = {k: torch.zeros_like(v) for k, v in batches[0].items()}
        captured, draw = make_step({"table": torch.zeros(1, dtype=torch.int64), "batch": static})
        dispatcher = BlockDispatcher(captured, draw, target_update_freq=2)
        dispatcher.dispatch({k: torch.stack([b[k] for b in batches]) for k in static}, 5)
    assert captured.graph is None
    collected = _Collect()
    dispatcher.drain(collected)

    m2, step2, opt2, moments2, _ = seq
    gen = torch.Generator().manual_seed(7)
    for g, flag in enumerate(target_flags(5, G, 2)):
        draws = step2.sample_draws(T, B, gen, cpu)
        moments2, metrics = step2(opt2, moments2, batches[g], bool(flag), draws=draws)
    _assert_same_state(blocked, (m2, step2, opt2, moments2, cfg))
    assert collected.last == {k: v.item() for k, v in metrics.items()}


@pytest.mark.parametrize("count_offset", [0, 1])
@pytest.mark.parametrize("freq", [1, 2, 3])
def test_block_flag_cadence_equals_make_train_block(count_offset, freq):
    """The flags the port's block hands its step (the table's last entry) over blocks of
    1, 3, 2 and 4 steps equal those the reference's ``make_train_block`` hands its step
    function."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.utils.blocks import make_train_block as jax_block
    from sheeprl_tpu_torch.utils.blocks import make_train_block
    from sheeprl_tpu_torch.utils.graphs import StepGraph

    seen = []

    def fn(inp):
        seen.append(bool(inp["table"][-1]))
        return {"x": torch.zeros(())}

    step = StepGraph(fn, {"table": torch.zeros(1, dtype=torch.int64), "draws": torch.zeros(1)})
    block = make_train_block(step, lambda out: None, freq, count_offset)

    def step_fn(carry, batch, key, update_target):
        i, flags = carry
        return (i + 1, flags.at[i].set(update_target)), {}

    jblock = jax_block(step_fn, freq, count_offset)
    count = 0
    for n in (1, 3, 2, 4):
        (_, flags), _ = jblock((jnp.asarray(0), jnp.zeros(n, bool)), [jnp.zeros(1)] * n, jax.random.PRNGKey(0), count)
        seen.clear()
        block(count, n)
        assert seen == [bool(f) for f in np.asarray(flags)], (freq, count_offset, count, n)
        count += n


@pytest.mark.parametrize("max_chunk", [1, 2, 4, 8, 16])
def test_chunk_sizes_equal_the_reference(max_chunk):
    from sheeprl_tpu.utils.blocks import chunk_sizes as jax_chunks
    from sheeprl_tpu_torch.utils.blocks import chunk_sizes

    for n in range(65):
        assert chunk_sizes(n, max_chunk) == jax_chunks(n, max_chunk), n


def _optax_run(case, n, params, grads):
    import jax.numpy as jnp
    import optax

    from sheeprl_tpu.algos.ppo.ppo import make_optimizer as jax_make_optimizer
    from tests.test_torch_dv3_train import OPT_CASES, _adam_state

    jopt = jax_make_optimizer(OPT_CASES[case], 0.0)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    for g in grads[:n]:
        updates, jstate = jopt.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    return jparams, _adam_state(jstate)


def _seeded(seed=2):
    rng = np.random.default_rng(seed)
    shapes = [(4, 3), (3,), (2, 2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("case", ["adam", "adam_l2", "adamw"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_optimizer_device_count_matches_optax(case, n):
    """After ``n`` updates: the count is a 0-d int64 tensor on the parameters' device
    equal to optax's, and the parameters and Adam moments equal optax's (atol = rtol =
    1e-6, as ``test_optimizer_matches_optax``)."""
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer
    from tests.test_torch_dv3_train import OPT_CASES

    params, grads = _seeded()
    jparams, jstate = _optax_run(case, n, params, grads)
    topt = make_optimizer(OPT_CASES[case], 0.0)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    state = topt.init(tparams)
    for g in grads[:n]:
        topt.update(tparams, [torch.from_numpy(x) for x in g], state)
    assert isinstance(state["count"], torch.Tensor) and state["count"].shape == () and state["count"].dtype == torch.int64
    assert int(state["count"]) == int(jstate.count) == n
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
    for moment in ("mu", "nu"):
        for t, j in zip(state[moment], getattr(jstate, moment)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)


def test_optimizer_loads_an_int_count_from_an_older_checkpoint(tmp_path):
    """A state saved with a Python int count (as checkpoints were written before the
    count moved to the device) loads into a live state in place, and two more updates
    give the bits of four uninterrupted ones."""
    from sheeprl_tpu_torch.algos.ppo.ppo import Optimizer, make_optimizer
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from tests.test_torch_dv3_train import OPT_CASES

    params, grads = _seeded(3)
    opt = make_optimizer(OPT_CASES["adam"], 0.5)
    straight = [torch.from_numpy(p.copy()) for p in params]
    s_state = opt.init(straight)
    for g in grads[:4]:
        opt.update(straight, [torch.from_numpy(x) for x in g], s_state)

    resumed = [torch.from_numpy(p.copy()) for p in params]
    r_state = opt.init(resumed)
    for g in grads[:2]:
        opt.update(resumed, [torch.from_numpy(x) for x in g], r_state)
    old = {"count": int(r_state["count"]), "mu": [t.clone() for t in r_state["mu"]], "nu": [t.clone() for t in r_state["nu"]]}
    path = CheckpointManager(tmp_path).save(2, {"opt": old, "params": [t.clone() for t in resumed]})
    saved = CheckpointManager.load(path)
    assert saved["opt"]["count"] == 2 and isinstance(saved["opt"]["count"], int)
    live = opt.init(resumed)
    pointers = [t.data_ptr() for t in live["mu"]] + [live["count"].data_ptr()]
    Optimizer.load_state(live, saved["opt"])
    assert [t.data_ptr() for t in live["mu"]] + [live["count"].data_ptr()] == pointers, "load_state copies in place"
    for g in grads[2:4]:
        opt.update(resumed, [torch.from_numpy(x) for x in g], live)
    assert int(live["count"]) == 4
    for a, b in zip(resumed + live["mu"] + live["nu"], straight + s_state["mu"] + s_state["nu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="keys"):
        Optimizer.load_state(live, {"count": 1, "mu": live["mu"]})


def test_step_graph_runs_eagerly_on_the_cpu_and_counts_no_launch():
    from sheeprl_tpu_torch.ops import counters
    from sheeprl_tpu_torch.utils.graphs import StepGraph

    calls = []
    x = torch.zeros(3)

    def fn(inp):
        calls.append(1)
        x.add_(inp["v"])
        return {"sum": x.sum()}

    before = counters.launch_counts()
    step = StepGraph(fn, {"v": torch.ones(3)}, state=[x])
    assert step.graph is None and step.launches_per_replay == {} and calls == []
    step.inputs["v"].fill_(2.0)
    out = step()
    assert out["sum"].item() == 6.0 and step()["sum"].item() == 12.0
    assert len(calls) == 2
    assert counters.launch_counts() == before


def test_launch_counters_set_and_add():
    from sheeprl_tpu_torch.ops import counters

    before = counters.launch_counts()
    try:
        counters.zero_launches()
        counters.add_launches({"layernorm_gru": 79, "layernorm_gru_bwd": 64})
        counters.add_launches({"layernorm_gru": 79, "layernorm_gru_bwd": 64})
        assert counters.launch_counts() == {"rssm_step": 0, "rssm_step_bwd": 0, "layernorm_gru": 158, "layernorm_gru_bwd": 128}
    finally:
        counters.set_launches(before)
    assert counters.launch_counts() == before


def test_windowed_futures_drain_and_window_rate():
    from sheeprl_tpu_torch.utils.blocks import WindowedFutures

    futures = WindowedFutures(max_pending=2)
    assert futures.pop_window_sps() is None
    futures.track((["a", "b"], torch.tensor([1.0, 2.0])), 3)
    futures.track((["a", "b"], torch.tensor([3.0, 4.0])), 1)  # the backlog cap fetches both
    futures.track((["a", "b"], torch.tensor([5.0, 6.0])), 2)
    seen = []

    class Agg:
        def update(self, name, value):
            seen.append((name, value))

    futures.drain(Agg())
    assert seen == [("a", 1.0), ("b", 2.0), ("a", 3.0), ("b", 4.0), ("a", 5.0), ("b", 6.0)]
    assert futures.pop_window_sps() > 0 and futures.pop_window_sps() is None


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the step is captured as a CUDA graph only on a card")
    return torch.device("cuda")


def _max_diffs(ma, mb):
    return {name: max((x.float() - y.float()).abs().max().item() for x, y in zip(ma[name].state_dict().values(), mb[name].state_dict().values())) for name in ma}


@pytest.mark.cuda
@pytest.mark.parametrize("actor", ["discrete", "continuous"])
def test_cuda_graphed_block_equals_the_eager_steps(cuda_device, actor):
    """On the card the block replays the captured step; with the same batches and draws
    its parameters lie as close to one eager run's as a second eager run's do (TF32 off;
    a kernel whose summation order is not fixed makes two eager runs differ), and its
    last metrics equal the eager step's to rtol 1e-4."""
    from sheeprl_tpu_torch.algos.dreamer_loop import make_captured_step
    from sheeprl_tpu_torch.utils.blocks import BlockDispatcher, target_flags

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    is_continuous = actor == "continuous"
    (modules, step, opt, moments, cfg), eager = _twin(is_continuous, cuda_device)
    eager2 = (
        {k: copy.deepcopy(v) for k, v in eager[0].items()}, *eager[1:]
    )
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(G):
        rows = _rows(rng, T, B, is_continuous)
        batches.append({k: torch.from_numpy(np.concatenate([r[k] for r in rows], 0)).to(cuda_device) for k in rows[0]})
    static = {k: torch.zeros_like(v) for k, v in batches[0].items()}
    make_step = make_captured_step(step, modules, opt, moments, T, B, torch.Generator(device=cuda_device).manual_seed(7))
    captured, draw = make_step({"table": torch.zeros(1, dtype=torch.int64, device=cuda_device), "batch": static})
    assert captured.graph is not None and captured.launches_per_replay["layernorm_gru"] == T + HORIZON
    dispatcher = BlockDispatcher(captured, draw, target_update_freq=2)
    dispatcher.dispatch({k: torch.stack([b[k] for b in batches]) for k in static}, 5)
    collected = _Collect()
    dispatcher.drain(collected)
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step

    runs = []
    for mods in (eager[0], eager2[0]):
        step2, init2 = make_train_step(*mods.values(), cfg, ["rgb"], ["state"])
        opt2, moments2 = init2(), {k: v.clone() for k, v in eager[3].items()}
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        for g, flag in enumerate(target_flags(5, G, 2)):
            draws = step2.sample_draws(T, B, gen, cuda_device)
            moments2, metrics = step2(opt2, moments2, batches[g], bool(flag), draws=draws)
        runs.append((moments2, metrics))
    torch.cuda.synchronize()
    spread, off = _max_diffs(eager[0], eager2[0]), _max_diffs(modules, eager[0])
    for name in modules:
        assert off[name] <= 2 * spread[name] + 1e-7, (name, off[name], spread[name])
    for k in moments:
        torch.testing.assert_close(moments[k], runs[0][0][k], rtol=1e-5, atol=1e-6)
    for k, v in runs[0][1].items():
        np.testing.assert_allclose(collected.last[k], v.item(), rtol=1e-4, atol=1e-6, err_msg=k)
