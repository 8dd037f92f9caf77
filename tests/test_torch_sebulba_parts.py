"""The algorithm-free parts of the port's Sebulba mode against the JAX package's, in
process on the CPU:

* ``PlacementSpec``/``placement_from_cfg``: the same config dicts and environment
  variables give equal specs, equal error types and messages, and equal
  ``child_overrides``; the composed ``distributed`` and ``chaos`` groups equal the
  reference's;
* ``shard_worker_count`` over a grid, ``shard_pool_cfg``, ``backoff_seconds``,
  ``run_dir_for`` and ``_strip_override``;
* ``ChannelWeightPublisher``: its frames, decoded by the reference's ``Channel``, carry
  the published arrays and the reference publisher's stamps; a welcome before and after
  the first publication; a dead channel skipped; publications racing a welcome decode
  whole and the consumer keeps the freshest (``_freshest`` against the reference's);
* ``LearnerInbox``: a scripted actor over a real socket gives the port's inbox the
  reference inbox's items and event sequence (``_SlotAccounting`` and ``_stamp_of``
  alike);
* ``maybe_actor_fault`` kills only actor ``i`` of generation 0 from its step on, as the
  reference's; a real child dies by SIGKILL;
* ``distributed.mode=sebulba`` is refused by name on a loop without a player/learner
  split, and a mode other than ``thread`` or ``sebulba`` on the decoupled entries (the
  chaos worker fault runs since the env pool is ported: ``tests/test_torch_rollout_*``);
* the launcher's entry imports no torch (so it never initialises CUDA)."""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu.distributed import placement as ref_placement
from sheeprl_tpu.distributed import publish as ref_publish
from sheeprl_tpu.distributed import sebulba as ref_sebulba
from sheeprl_tpu.distributed import transport as ref_transport
from sheeprl_tpu_torch.distributed import placement, publish, sebulba, transport
from tests.torch_sebulba_common import REPO

PLACEMENTS = [
    ({}, {}),
    ({"mode": "sebulba", "role": "learner", "num_actors": 3, "port": 4242, "queue_depth": 5}, {}),
    ({"mode": "sebulba", "role": "actor", "num_actors": 2, "actor_id": 1, "connect_timeout_s": 7}, {"SHEEPRL_TPU_ACTOR_GENERATION": "3"}),
    ({"mode": "sebulba", "num_actors": 4, "respawn": False, "respawn_backoff_s": 1.5, "max_actor_respawns": 0, "publish": "host"},
     {"SHEEPRL_TPU_SEBULBA_ROLE": "actor", "SHEEPRL_TPU_SEBULBA_ACTOR_ID": "2", "SHEEPRL_TPU_SEBULBA_HOST": "10.0.0.1",
      "SHEEPRL_TPU_SEBULBA_PORT": "5555"}),
    ({"mode": "sebulba", "port": None, "host": None, "role": None}, {"SHEEPRL_TPU_SEBULBA_PORT": ""}),
    ({"role": "coordinator"}, {}),
    ({"publish": "nccl"}, {}),
    ({"num_actors": 0}, {}),
    ({"num_actors": 2, "actor_id": 2}, {}),
    ({"queue_depth": 0}, {}),
    ({}, {"SHEEPRL_TPU_SEBULBA_ROLE": "observer"}),
]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _spec_or_error(mod, dist, env):
    try:
        return mod.placement_from_cfg({"distributed": dist}, env=env), None
    except Exception as exc:  # noqa: BLE001 - compared with the reference's
        return None, (type(exc).__name__, str(exc))


@pytest.mark.parametrize("dist,env", PLACEMENTS)
def test_placement_equals_the_reference(dist, env):
    port, port_err = _spec_or_error(placement, dist, env)
    ref, ref_err = _spec_or_error(ref_placement, dist, env)
    assert port_err == ref_err
    if ref is None:
        return
    assert port.__dict__ == ref.__dict__
    assert (port.is_sebulba, port.is_learner, port.is_actor) == (ref.is_sebulba, ref.is_learner, ref.is_actor)
    for role, actor_id in (("learner", 0), ("actor", 0), ("actor", ref.num_actors - 1)):
        assert port.child_overrides(role, 31337, actor_id) == ref.child_overrides(role, 31337, actor_id)
    names = ("ROLE_ENV_VAR", "ACTOR_ID_ENV_VAR", "HOST_ENV_VAR", "PORT_ENV_VAR", "GENERATION_ENV_VAR", "SUMMARY_ENV_VAR")
    assert [getattr(placement, n) for n in names] == [getattr(ref_placement, n) for n in names]


@pytest.mark.parametrize("exp", ["sac_decoupled", "ppo_decoupled"])
def test_composed_groups_equal_the_references(exp):
    from sheeprl_tpu.config.core import compose as ref_compose
    from sheeprl_tpu_torch.config.core import compose

    overrides = [f"exp={exp}", "distributed.num_actors=3", "chaos.kill_actor_at_step=5"]
    port, ref = compose(overrides=overrides), ref_compose(overrides=overrides)
    for group in ("distributed", "chaos"):
        assert dict(port[group]) == dict(ref[group]), group
    assert placement.placement_from_cfg(port, env={}).__dict__ == ref_placement.placement_from_cfg(ref, env={}).__dict__


def test_sharding_and_supervisor_helpers_equal_the_references():
    from sheeprl_tpu.fault import supervisor as ref_sup
    from sheeprl_tpu.rollout import sharding as ref_sharding
    from sheeprl_tpu_torch.config.core import DotDict
    from sheeprl_tpu_torch.fault import supervisor
    from sheeprl_tpu_torch.rollout import sharding

    for workers in (None, 1, 3, 8, 13):
        for actors in (1, 2, 3, 5):
            for actor_id in range(actors):
                assert sharding.shard_worker_count(workers, actors, actor_id) == ref_sharding.shard_worker_count(workers, actors, actor_id)
    for bad in ((4, 2, 2), (4, 3, -1)):
        with pytest.raises(ValueError) as port_exc:
            sharding.shard_worker_count(*bad)
        with pytest.raises(ValueError) as ref_exc:
            ref_sharding.shard_worker_count(*bad)
        assert str(port_exc.value) == str(ref_exc.value)
    for pool, actors, actor_id in (({"enabled": True, "num_workers": 7}, 3, 0), ({"enabled": True, "num_workers": 7}, 3, 2),
                                   ({"enabled": False, "num_workers": 7}, 3, 1), ({"enabled": True, "num_workers": 7}, 1, 0)):
        a, b = DotDict.wrap({"env": {"pool": dict(pool)}}), DotDict.wrap({"env": {"pool": dict(pool)}})
        sharding.shard_pool_cfg(a, actors, actor_id)
        ref_sharding.shard_pool_cfg(b, actors, actor_id)
        assert a.env.pool.num_workers == b.env.pool.num_workers
    for retries in range(0, 9):
        for base, cap in ((0.5, 30.0), (0.2, 1.0), (2.0, 5.0)):
            assert supervisor.backoff_seconds(retries, base, cap) == ref_sup.backoff_seconds(retries, base, cap)
    cfg = {"log_root": "/x", "root_dir": "sac_decoupled/env", "run_name": "r"}
    assert supervisor.run_dir_for(cfg) == ref_sup.run_dir_for(cfg)
    ovs = ["a=1", "run_name=x", "b=run_name=y", "run_name=z"]
    assert supervisor._strip_override(ovs, "run_name") == ref_sup._strip_override(ovs, "run_name")


# --------------------------------------------------------------------------- publisher
def _pair():
    """A port channel (the publisher's end) and a reference channel (the actor's)."""
    listener = ref_transport.Listener("127.0.0.1", 0)
    port_ch = transport.connect("127.0.0.1", listener.port, timeout_s=5.0)
    ref_ch = listener.accept(timeout=5.0)
    listener.close()
    return port_ch, ref_ch


def _params(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"actor": {"model.0.weight": torch.randn(4, 3, generator=g), "model.0.bias": torch.randn(4, generator=g),
                      "log_std": torch.randn(2, generator=g).to(torch.float64), "steps": torch.arange(3)}}


def test_publisher_frames_decode_in_the_reference_channel():
    port_ch, ref_ch = _pair()
    pub = publish.ChannelWeightPublisher(lambda: [port_ch])
    ref_pub = ref_publish.ChannelWeightPublisher(lambda: [])
    pub.maybe_welcome(port_ch)  # before the first publication: nothing
    assert not ref_ch.poll(0.2)
    for i, (grad_step, policy_step) in enumerate(((0, 8), (2, 16), (6, 24))):
        params = _params(i)
        stamp = pub.publish(params, grad_step=grad_step, policy_step=policy_step)
        ref_stamp = ref_pub.publish({k: {n: t.numpy() for n, t in v.items()} for k, v in params.items()},
                                    grad_step=grad_step, policy_step=policy_step)
        assert stamp == ref_stamp
        kind, meta, payload = ref_ch.recv(timeout=5.0)
        assert kind == ref_publish.PARAMS_KIND == publish.PARAMS_KIND and meta["stamp"] == ref_stamp
        assert abs(meta["t_pub"] - time.time()) < 60
        assert set(payload["actor"]) == set(params["actor"])
        for name, t in params["actor"].items():
            assert payload["actor"][name].dtype == t.numpy().dtype and np.array_equal(payload["actor"][name], t.numpy())
    assert pub.seq == 3 and pub.bytes_published == port_ch.bytes_sent == ref_ch.bytes_received
    pub.maybe_welcome(port_ch)  # after: the last publication again, its stamp unchanged
    kind, meta, payload = ref_ch.recv(timeout=5.0)
    assert meta["stamp"] == stamp and np.array_equal(payload["actor"]["model.0.bias"], _params(2)["actor"]["model.0.bias"].numpy())
    port_ch.close()
    ref_ch.close()


def test_publisher_skips_a_dead_channel():
    dead, dead_peer = _pair()
    live, live_peer = _pair()
    dead_peer.close()
    dead.close()
    pub = publish.ChannelWeightPublisher(lambda: [dead, live])
    pub.publish({"w": torch.ones(5)}, grad_step=1, policy_step=2)
    kind, meta, payload = live_peer.recv(timeout=5.0)
    assert meta["stamp"] == {"seq": 1, "grad_step": 1, "policy_step": 2} and np.array_equal(payload["w"], np.ones(5, np.float32))
    assert pub.bytes_published == live.bytes_sent
    pub.maybe_welcome(dead)  # a dead channel's welcome is dropped too
    live.close()
    live_peer.close()


def test_publications_racing_a_welcome_decode_whole_and_the_freshest_wins():
    port_ch, ref_ch = _pair()
    pub = publish.ChannelWeightPublisher(lambda: [port_ch])
    n = 40
    received = []

    def consume():
        while len(received) < 2 * n:
            received.append(ref_ch.recv(timeout=10.0))

    reader = threading.Thread(target=consume)
    reader.start()
    welcomer = threading.Thread(target=lambda: [pub.maybe_welcome(port_ch) for _ in range(n)])
    pub.publish({"w": torch.zeros(64)}, grad_step=0, policy_step=0)
    welcomer.start()
    for i in range(1, n):
        pub.publish({"w": torch.full((64,), float(i))}, grad_step=i, policy_step=i)
    welcomer.join()
    reader.join()
    for kind, meta, payload in received:  # every frame whole: its values are its seq's
        assert kind == "params" and np.all(payload["w"] == meta["stamp"]["seq"] - 1)
    latest = None
    for kind, meta, payload in received:
        latest = sebulba._freshest(latest, (payload, sebulba._stamp_of(meta)))
    assert latest[1]["seq"] == n
    port_ch.close()
    ref_ch.close()


def test_freshest_stamp_of_and_slots_equal_the_references():
    cands = [None, ("a", {"seq": 3}), ("b", {"seq": 2}), ("c", {"seq": 3}), ("d", {}), ("e", {"seq": 9})]
    for latest in cands:
        for cand in cands[1:]:
            assert sebulba._freshest(latest, cand) == ref_sebulba._freshest(latest, cand)
    for meta in ({}, {"stamp": {"seq": 1, "grad_step": 2, "policy_step": 3}}, {"stamp": {"seq": 1}, "t_pub": 5}, {"t_pub": None}):
        assert sebulba._stamp_of(meta) == ref_sebulba._stamp_of(meta)
    a, b = sebulba._SlotAccounting(), ref_sebulba._SlotAccounting()
    for op, args in (("report", (0, 8)), ("report", (1, 4)), ("report", (0, 6)), ("fold", (0,)), ("report", (0, 2)),
                     ("fold", (3,)), ("report", (1, 12))):
        getattr(a, op)(*args)
        getattr(b, op)(*args)
        assert a.total == b.total
    assert sebulba.SEBULBA_METRIC_KEYS == ref_sebulba.SEBULBA_METRIC_KEYS
    assert (sebulba.HELLO_KIND, sebulba.BLOCK_KIND, sebulba.DONE_KIND, sebulba.ABANDON_KIND) == (
        ref_sebulba.HELLO_KIND, ref_sebulba.BLOCK_KIND, ref_sebulba.DONE_KIND, ref_sebulba.ABANDON_KIND)


# --------------------------------------------------------------------------- inbox
def _script(port: int) -> None:
    """Actor 0 connects, sends two blocks and its done; actor 1 connects, sends a block and
    dies; the launcher abandons slot 1."""
    a0 = transport.connect("127.0.0.1", port, timeout_s=5.0)
    a0.send("hello", None, actor_id=0, generation=0, algo="sac")
    a0.send("block", {"batches": {"obs": np.arange(6, dtype=np.float32).reshape(2, 3)}}, iter_num=1, grad_steps=2)
    a0.send("block", {"batches": None}, iter_num=2, grad_steps=0)
    a0.send("done", None, env_steps=4)
    time.sleep(0.3)
    a1 = transport.connect("127.0.0.1", port, timeout_s=5.0)
    a1.send("hello", None, actor_id=1, generation=2, algo="sac")
    a1.send("block", {"batches": None}, iter_num=1, grad_steps=0)
    time.sleep(0.3)
    a1.close()
    time.sleep(0.3)
    ab = transport.connect("127.0.0.1", port, timeout_s=5.0)
    ab.send("abandon", None, actor_id=1)
    ab.close()
    a0.close()


def _drive(listener_cls, inbox_cls, spec) -> tuple:
    listener = listener_cls("127.0.0.1", 0)
    inbox = inbox_cls(listener, spec)
    script = threading.Thread(target=_script, args=(listener.port,))
    script.start()
    items = []
    while len(items) < 6:
        kind, actor_id, meta, payload = inbox.get(timeout=10.0)
        batches = (payload or {}).get("batches")
        items.append((kind, actor_id, {k: v for k, v in meta.items()},
                      None if batches is None else {k: v.tolist() for k, v in batches.items()}))
    script.join()
    inbox.close()
    return items, [e[1:] for e in inbox.events], inbox.bytes_received()


def test_inbox_gives_the_references_items_and_events():
    port = _drive(transport.Listener, sebulba.LearnerInbox, placement.PlacementSpec(mode="sebulba", role="learner", num_actors=2))
    ref = _drive(ref_transport.Listener, ref_sebulba.LearnerInbox,
                 ref_placement.PlacementSpec(mode="sebulba", role="learner", num_actors=2))
    assert port[0] == ref[0]
    assert [kind for kind, *_ in port[0]] == ["block", "block", "done", "block", "closed", "abandon"]
    assert port[1] == ref[1] == [[0, 0, "connected"], [1, 2, "connected"], [1, 2, "closed"]]
    assert port[2] == ref[2] > 0


# --------------------------------------------------------------------------- chaos
def test_actor_fault_fires_as_the_references(monkeypatch):
    from sheeprl_tpu.fault import chaos as ref_chaos
    from sheeprl_tpu_torch.fault import chaos

    cfg = {"chaos": {"kill_actor_at_step": 4, "kill_actor_index": 1}}
    for mod in (chaos, ref_chaos):
        mod.install(cfg)
    fired = {}
    for name, mod in (("port", chaos), ("ref", ref_chaos)):
        signals, out = [], []
        monkeypatch.setattr(mod.os, "kill", lambda pid, sig, signals=signals: signals.append(sig))
        for actor_id in (0, 1):
            for gen in (0, 1):
                for step in (1, 3, 4, 7):
                    before = len(signals)
                    mod.maybe_actor_fault(actor_id, gen, step)
                    out.append((actor_id, gen, step, len(signals) > before))
        fired[name] = (out, signals)
    assert fired["port"] == fired["ref"]
    assert [o[:3] for o in fired["port"][0] if o[3]] == [(1, 0, 4), (1, 0, 7)]
    for mod in (chaos, ref_chaos):
        mod.install({})
        mod.maybe_actor_fault(1, 0, 9)  # no schedule: nothing


def test_actor_fault_kills_a_real_child_by_sigkill():
    code = ("from sheeprl_tpu_torch.fault import chaos\n"
            "chaos.install({'chaos': {'kill_actor_at_step': 2, 'kill_actor_index': 0}})\n"
            "chaos.maybe_actor_fault(0, 1, 5)\nchaos.maybe_actor_fault(1, 0, 5)\nchaos.maybe_actor_fault(0, 0, 1)\n"
            "print('alive', flush=True)\nchaos.maybe_actor_fault(0, 0, 2)\nprint('survived')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == -9 and proc.stdout == "alive\n", (proc.returncode, proc.stdout, proc.stderr)


# --------------------------------------------------------------------------- refusals
@pytest.mark.parametrize(
    "exp,override,pattern",
    [
        ("ppo_dummy", "distributed.mode=sebulba", r"distributed\.mode='sebulba': the ppo loop has no player/learner split"),
        ("sac", "distributed.mode=sebulba", r"distributed\.mode='sebulba': the sac loop has no player/learner split"),
        ("sac_decoupled", "distributed.mode=mesh", r"distributed\.mode='mesh': the sac_decoupled loop runs .* there is no other mode"),
        ("ppo_decoupled", "distributed.mode=process", r"distributed\.mode='process': the ppo_decoupled loop runs"),
    ],
)
def test_refusals_name_the_key(tmp_path, monkeypatch, exp, override, pattern):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    small = ["algo.total_steps=16", "env.num_envs=2", "env.sync_env=True", "algo.hidden_size=8", "algo.dense_units=8"]
    with pytest.raises(NotImplementedError, match=pattern):
        run([f"exp={exp}", override, "device=cpu", *small, f"log_root={tmp_path}"])


def test_the_launcher_imports_no_torch():
    code = "import sys, sheeprl_tpu_torch.sebulba\nprint(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout == "[]\n", (proc.stdout, proc.stderr)
