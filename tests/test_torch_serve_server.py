"""The PyTorch port's policy server in-process on the CPU (``device=cpu``): registry load,
the bucket ladder (the eager act function per bucket on the CPU), continuous batching,
sessions, the capture watchdog, the drain, and the wire shared with the JAX package.

Tiny PPO and recurrent-PPO checkpoints are written and registered by the port once per
module (serving does not depend on the weights' values); each test runs a server thread
over them. Actions are held equal to the endpoint's own act function on the same
observations.
"""

import threading
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.distributed.transport import ChannelClosed
from sheeprl_tpu_torch.fault.preemption import clear_preemption, request_preemption
from sheeprl_tpu_torch.serve.client import PolicyClient, ServerDraining

TINY = {
    "ppo": ["exp=ppo_dummy", "env=discrete_dummy", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=8",
            "algo.encoder.mlp_features_dim=8"],
    "rec": ["exp=ppo_recurrent", "env=discrete_dummy", "algo.mlp_keys.encoder=[state]", "algo.dense_units=8", "algo.rnn.lstm.hidden_size=8"],
}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """The registry dir: ``ppo`` v1 (stage production) and v2 (the same checkpoint),
    ``rec`` v1."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.config.core import compose, save_config
    from sheeprl_tpu_torch.parallel.context import make_run_context
    from sheeprl_tpu_torch.utils.env import make_env
    from sheeprl_tpu_torch.utils.model_manager import LocalModelManager
    from sheeprl_tpu_torch.utils.policy import build_policy

    tmp = tmp_path_factory.mktemp("serve")
    mm = LocalModelManager(tmp / "registry")
    for name, overrides in TINY.items():
        cfg = compose(overrides=[*overrides, "device=cpu", "env.num_envs=1"])
        env = make_env(cfg, 0, 0, None, "serve_test")()
        _, agent = build_policy(make_run_context(cfg), cfg, env.observation_space, env.action_space)
        env.close()
        ckpt = CheckpointManager(tmp / name / "checkpoints").save(0, {"params": agent.state_dict()})
        save_config(cfg, tmp / name / "config.yaml")
        for _ in range(2 if name == "ppo" else 1):
            mm.register_model(str(ckpt), name)
    mm.transition_model("ppo", 1, "production")
    return tmp / "registry"


def dispatchers(server):
    return [t for t in list(server._threads) if t.name.startswith("serve-dispatch")]


def start_server(registry, policies, max_batch=4, delay_ms=2.0, extra=()):
    """A ``serve_cli`` server over ``registry`` running in a thread; ``(server, thread,
    rc_box)`` once it listens and every endpoint's dispatcher has started."""
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.serve.server import PolicyServer

    cfg = compose(config_name="serve_cli", overrides=[
        f"serve.policies=[{','.join(policies)}]", f"model_manager.registry_dir={registry}", "device=cpu",
        f"serve.max_batch_size={max_batch}", f"serve.max_batch_delay_ms={delay_ms}", "serve.log_every_s=0", *extra,
    ])
    server = PolicyServer(cfg)
    rc_box = {}
    thread = threading.Thread(target=lambda: rc_box.update(rc=server.run()), daemon=True)
    thread.start()
    deadline = time.monotonic() + 30.0
    while server.listener is None or len(dispatchers(server)) < len(server.endpoints):
        assert time.monotonic() < deadline, "server never started listening"
        time.sleep(0.01)
    return server, thread, rc_box


def stop(server, thread):
    server.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def own_actions(ep, obs, is_first=None, state=None):
    """The endpoint's act function, eagerly, on ``[n, ...]`` numpy observations."""
    with torch.no_grad():
        obs_t = ep.policy.obs_tensors(obs)
        if is_first is None:
            return ep.policy.act_fn(ep.policy.params, obs_t).numpy(), None
        act, new = ep.policy.act_fn(ep.policy.params, obs_t, torch.from_numpy(is_first), state)
        return act.numpy(), new


def seeded_obs(ep, n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n, *shape)).astype(np.dtype(dt)) for k, (shape, dt) in ep.policy.obs_template.items()}


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_ping_act_routes_and_batches_concurrent_requests(registry, precision):
    server, thread, rc_box = start_server(registry, ["ppo:production", "ppo:latest"], delay_ms=20.0, extra=[f"serve.precision={precision}"])
    try:
        assert sorted(server.endpoints) == ["ppo:1", "ppo:2"]
        ep = server.endpoints["ppo:1"]
        obs = seeded_obs(ep, 40, 1)
        want, _ = own_actions(ep, obs)
        with PolicyClient("127.0.0.1", server.listener.port) as client:
            pong = client.ping()
            assert pong["policies"] == ["ppo:1", "ppo:2"] and not pong["draining"] and pong["precision"] == precision
            assert {"ppo", "ppo:latest", "ppo:production", "ppo:1", "ppo:2"} <= set(pong["aliases"])
            assert (pong["parity"]["ppo:1"]["precision"] == "int8") if precision == "int8" else pong["parity"] == {}
            for spec in ("ppo:production", "ppo:1", "ppo:latest"):
                action, meta = client.act({k: v[0] for k, v in obs.items()}, spec)
                np.testing.assert_array_equal(action, want[0])
                assert meta["bucket"] == 1 and meta["batch_fill"] == 1.0
        metas, errors = [[] for _ in range(4)], []

        def worker(i):
            try:
                with PolicyClient("127.0.0.1", server.listener.port) as c:
                    for r in range(10):
                        row = 10 * i + r
                        action, meta = c.act({k: v[row] for k, v in obs.items()}, "ppo:production")
                        np.testing.assert_array_equal(action, want[row])
                        metas[i].append(meta)
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        fills = [m["batch_fill"] * m["bucket"] for per in metas for m in per]
        assert max(fills) > 1 and all(m["bucket"] in ep.ladder and m["infer_ms"] > 0 for per in metas for m in per)
    finally:
        stop(server, thread)
    assert rc_box["rc"] == 0
    summary = server.summary()
    assert summary["accepted"] == summary["replied"] == 43 and summary["dropped"] == 0 and summary["recompiles"] == 0
    assert summary["perf"] is None and summary["policies"]["ppo:1"]["metrics"]["Serve/latency_ms/count"] == 43


def test_recurrent_sessions_continue_and_reset_restarts_them(registry):
    server, thread, _ = start_server(registry, ["rec"])
    try:
        ep = server.endpoints["rec:1"]
        obs = seeded_obs(ep, 5, 2)
        rows = [{k: v[i] for k, v in obs.items()} for i in range(5)]
        with PolicyClient("127.0.0.1", server.listener.port) as client:
            got = [client.act(rows[i], "rec", session="a")[0] for i in range(3)]
            got.append(client.act(rows[3], "rec", session="a", reset=True)[0])
            got.append(client.act(rows[4], "rec")[0])  # no session: a fresh episode on the scratch row
        state = ep.policy.zero_state_fn(1)
        for i in range(5):
            fresh = i in (0, 3, 4)
            if fresh:
                state = ep.policy.zero_state_fn(1)
            want, state = own_actions(ep, {k: v[i : i + 1] for k, v in obs.items()}, np.full((1, 1), float(fresh), np.float32), state)
            np.testing.assert_array_equal(got[i], want[0])
        assert ep.state_cache.stats() == {"capacity": 256, "sessions": 1, "evictions": 0}
    finally:
        stop(server, thread)
    assert server.summary()["policies"]["rec:1"]["sessions"]["sessions"] == 1


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")  # the dispatcher ends on the CaptureError
def test_strict_mode_raises_in_a_dispatch_whose_shape_has_no_graph(registry):
    server, thread, _ = start_server(registry, ["ppo:1"], extra=["analysis.strict=True"])
    try:
        ep = server.endpoints["ppo:1"]
        del ep.graphs[1]  # a batch of one now has no graph
        (dispatcher,) = dispatchers(server)
        with PolicyClient("127.0.0.1", server.listener.port) as client:
            with pytest.raises(RuntimeError, match="no CUDA graph for a bucket-1 batch"):
                client.act({k: v[0] for k, v in seeded_obs(ep, 1, 3).items()}, "ppo:1")
        dispatcher.join(timeout=10)
        assert not dispatcher.is_alive()  # the CaptureError ended the dispatcher
        assert server.watchdog.missing_graphs == 1 and server.watchdog.violations == 1 and server.watchdog.captures_after_warm == 0
        assert ep.dispatch_counter == 0  # nothing ran eagerly
    finally:
        stop(server, thread)
    assert server.summary()["recompiles"] == 1


def test_preemption_drains_and_replies_to_everything_accepted(registry):
    server, thread, rc_box = start_server(registry, ["ppo:1"])
    obs = {k: v[0] for k, v in seeded_obs(server.endpoints["ppo:1"], 1, 4).items()}
    replies = [0, 0, 0]

    def streamer(i):
        try:
            with PolicyClient("127.0.0.1", server.listener.port) as client:
                while True:
                    client.act(obs, "ppo", timeout=30)
                    replies[i] += 1
        except (ServerDraining, ChannelClosed, ConnectionError, TimeoutError, OSError):
            pass  # a "draining" reply or a closed channel: both clean endings

    try:
        threads = [threading.Thread(target=streamer, args=(i,), daemon=True) for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 20.0
        while sum(replies) < 30 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sum(replies) >= 30, "clients never got going"
        request_preemption("test: simulated SIGTERM")
        thread.join(timeout=30)
        assert not thread.is_alive()
        for t in threads:
            t.join(timeout=30)
    finally:
        clear_preemption()
        server.shutdown()
    assert rc_box.get("rc") == 75
    summary = server.summary(preempted=True)
    assert summary["preempted"] is True and summary["accepted"] == summary["replied"] >= sum(replies) and summary["dropped"] == 0


def test_the_reference_client_talks_to_the_port_server(registry):
    from sheeprl_tpu.serve.client import PolicyClient as ReferenceClient

    server, thread, _ = start_server(registry, ["ppo:1", "rec:1"])
    try:
        for name in ("ppo:1", "rec:1"):
            ep = server.endpoints[name]
            obs = seeded_obs(ep, 1, 5)
            stateful = ep.policy.stateful
            want, _ = own_actions(ep, obs, *((np.ones((1, 1), np.float32), ep.policy.zero_state_fn(1)) if stateful else ()))
            with ReferenceClient("127.0.0.1", server.listener.port) as client:
                assert name in client.ping()["policies"]
                action, meta = client.act({k: v[0] for k, v in obs.items()}, name, session="s" if stateful else None)
            assert action.dtype == want.dtype and meta["bucket"] == 1
            np.testing.assert_array_equal(action, want[0])
    finally:
        stop(server, thread)


@pytest.mark.parametrize("override,match", [
    ("+obs.enabled=True", r"obs\.enabled"),
    ("+compile_cache.enabled=True", r"compile_cache\.enabled"),
    ("device=cuda", "CUDA is not available"),
])
def test_the_server_refuses_what_it_cannot_do(registry, monkeypatch, override, match):
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.serve.server import PolicyServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = compose(config_name="serve_cli", overrides=["serve.policies=[ppo:1]", f"model_manager.registry_dir={registry}", "device=cpu", override])
    with pytest.raises((NotImplementedError, RuntimeError), match=match):
        PolicyServer(cfg)


def test_sampling_draws_from_the_endpoints_seeded_generator(registry):
    """``serve.greedy=False``: each dispatch samples with draws from the endpoint's
    generator, seeded from ``seed``; two servers with one seed answer the same request
    sequence alike."""
    from sheeprl_tpu_torch.serve.client import parse_endpoint, wait_for_server

    runs = []
    for _ in range(2):
        server, thread, _ = start_server(registry, ["ppo:1"], extra=["serve.greedy=False", "seed=5", "serve.precision=int8"])
        try:
            assert server.parity["ppo:1"]["action_agreement"] > 0.9  # both sides sample with the same draws
            host, port = parse_endpoint(f"127.0.0.1:{server.listener.port}")
            assert (host, port) == parse_endpoint((host, str(port)))
            assert wait_for_server(host, port, timeout_s=10)["policies"] == ["ppo:1"]
            ep = server.endpoints["ppo:1"]
            assert ep.policy.samples and ep.generator.initial_seed() == 5
            obs = {k: v[0] for k, v in seeded_obs(ep, 1, 6).items()}
            with PolicyClient(host, port) as client:
                runs.append([int(client.act(obs, "ppo:1")[0][0]) for _ in range(12)])
        finally:
            stop(server, thread)
    n = server.endpoints["ppo:1"].policy.action_dims[0]
    assert runs[0] == runs[1] and all(0 <= a < n for a in runs[0]) and len(set(runs[0])) > 1
