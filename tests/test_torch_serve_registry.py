"""The model registry, the registry router and continuous batching of the PyTorch port
against the JAX package, and the registration round trip through the port's entries.

The same calls on both packages give the same results: the registry index after the
same register, transition, delete and download calls (apart from paths and times) and
the same files on disk; every spec form of ``howto/serving.md`` through ``parse_spec``,
``resolve_version`` and ``resolve_policy``; the bucket ladders, bucket picks and padded
batches. Then a tiny PPO run registers its last checkpoint at its end
(``model_manager.disabled=False``), ``sheeprl_tpu_torch.registration`` registers it again
and ``sheeprl_tpu_torch.eval checkpoint_path=<name>:latest`` evaluates it.
"""

import queue
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _normalized(index: dict, root: Path) -> dict:
    out = {}
    for name, entry in index.items():
        out[name] = [
            {**{k: v for k, v in e.items() if k not in ("timestamp", "path")}, "path": str(Path(e["path"]).relative_to(root))}
            for e in entry["versions"]
        ]
    return out


def _files(root: Path) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file() and not p.name.startswith(".registry.json."))


def test_registry_calls_give_the_references_index(tmp_path):
    from sheeprl_tpu.utils.model_manager import LocalModelManager as JaxManager
    from sheeprl_tpu_torch.utils.model_manager import LocalModelManager

    ckpt = tmp_path / "run" / "checkpoints" / "ckpt_8"
    ckpt.mkdir(parents=True)
    (ckpt / "params.pt").write_bytes(b"p")
    (tmp_path / "run" / "config.yaml").write_text("algo: {name: ppo}\n")
    managers = {"jax": JaxManager(tmp_path / "jax"), "torch": LocalModelManager(tmp_path / "torch")}
    for mm in managers.values():
        assert mm.register_model(str(ckpt), "m", model_keys=["agent"], metadata={"seed": 1}) == 1
        assert mm.register_model(str(ckpt), "m") == 2
        mm.transition_model("m", 1, "production")
        mm.transition_model("m", None, "staging")  # None: the latest version
        assert mm.register_model(str(ckpt), "n") == 1
        mm.delete_model("n", 1)
        assert mm.download_model("m", 2, str(tmp_path / "dl" / mm.__module__)).name == "v2"
        with pytest.raises(ValueError, match="no version 7"):
            mm.transition_model("m", 7, "production")
    want, got = (_normalized(managers[k].get_models(), tmp_path / k) for k in ("jax", "torch"))
    assert got == want and [e["stage"] for e in got["m"]] == ["production", "staging"] and got["n"] == []
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert (tmp_path / "torch" / "m" / "v1" / "config.yaml").is_file()


def test_mlflow_backend_raises_naming_the_key():
    from sheeprl_tpu_torch.utils.model_manager import build_model_manager

    with pytest.raises(ModuleNotFoundError, match=r"model_manager\.backend=mlflow"):
        build_model_manager({"model_manager": {"backend": "mlflow"}})


SPECS = ["cartpole_ppo", "cartpole_ppo:latest", "cartpole_ppo:3", "cartpole_ppo:1", "cartpole_ppo:production",
         "cartpole_ppo:PRODUCTION", "cartpole_ppo:staging", "pendulum_sac:production", " padded : 2 ", "name:"]


def test_router_agrees_with_the_reference(tmp_path):
    from sheeprl_tpu.serve import router as jr
    from sheeprl_tpu.utils.model_manager import LocalModelManager as JaxManager
    from sheeprl_tpu_torch.serve import router as tr
    from sheeprl_tpu_torch.utils.model_manager import LocalModelManager

    versions = [{"version": v, "stage": s, "path": f"/reg/m/v{v}"} for v, s in ((1, "Production"), (3, "production"), (2, "staging"))]
    for spec in SPECS:
        assert tr.parse_spec(spec) == jr.parse_spec(spec)
        _, selector = jr.parse_spec(spec)
        assert tr.resolve_version(versions, selector) == jr.resolve_version(versions, selector)
    for selector in (9, "archived"):
        with pytest.raises(ValueError) as want:
            jr.resolve_version(versions, selector)
        with pytest.raises(ValueError) as got:
            tr.resolve_version(versions, selector)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="empty policy name"):
        tr.parse_spec(":latest")

    ckpt = tmp_path / "ckpt_1"
    ckpt.mkdir()
    (ckpt / "params.pt").write_bytes(b"p")
    for root, manager in ((tmp_path / "jax", JaxManager), (tmp_path / "torch", LocalModelManager)):
        mm = manager(registry_dir=root)
        for _ in range(3):
            mm.register_model(str(ckpt), "cartpole_ppo")
        mm.transition_model("cartpole_ppo", 1, "production")
    for spec in ("cartpole_ppo", "cartpole_ppo:latest", "cartpole_ppo:2", "cartpole_ppo:production"):
        name, want = jr.resolve_policy(JaxManager(tmp_path / "jax"), spec)
        assert tr.resolve_policy(LocalModelManager(tmp_path / "torch"), spec)[1]["version"] == want["version"]
        got = tr.resolve_registry_checkpoint(spec, [f"model_manager.registry_dir={tmp_path / 'torch'}"])
        assert got[:2] == (name, want["version"]) and got[2] == tmp_path / "torch" / name / f"v{want['version']}"
    with pytest.raises(ValueError, match="no registered model named 'other'"):
        tr.resolve_policy(LocalModelManager(tmp_path / "torch"), "other")


def test_batching_agrees_with_the_reference():
    from sheeprl_tpu.serve import batching as jb
    from sheeprl_tpu_torch.serve import batching as tb

    for max_batch, explicit in ((1, None), (5, None), (32, None), (33, None), (8, [1, 8, 4]), (8, [2, 2, 8])):
        ladder = tb.bucket_ladder(max_batch, explicit)
        assert ladder == jb.bucket_ladder(max_batch, explicit)
        assert [tb.pick_bucket(ladder, n) for n in range(1, max_batch + 1)] == [jb.pick_bucket(ladder, n) for n in range(1, max_batch + 1)]
    for args in ((0, None), (8, [1, 4]), (8, [0, 8])):
        with pytest.raises(ValueError):
            tb.bucket_ladder(*args)
    with pytest.raises(ValueError, match="exceeds the ladder maximum"):
        tb.pick_bucket([1, 2, 4], 5)
    template = {"rgb": ((3, 4, 4), "uint8"), "state": ((5,), "float32")}
    rng = np.random.default_rng(0)
    rows = [{"rgb": rng.integers(0, 256, (3, 4, 4)).astype(np.uint8), "state": rng.standard_normal(5)} for _ in range(3)]
    got, want = tb.pad_obs_batch(rows, template, 4), jb.pad_obs_batch(rows, template, 4)
    for k in template:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for bad, match in (([{"rgb": rows[0]["rgb"]}], "missing obs key 'state'"), ([{**rows[0], "state": np.zeros(4)}], "request shape")):
        with pytest.raises((KeyError, ValueError), match=match):
            tb.pad_obs_batch(bad, template, 1)
    q = queue.Queue()
    for i in range(5):
        q.put(i)
    assert tb.collect_batch(q, 4, 0.05) == [0, 1, 2, 3] and tb.collect_batch(q, 4, 0.0) == [4] and tb.collect_batch(q, 4, 0.0, 0.01) == []


TINY_PPO = ["exp=ppo_dummy", "device=cpu", "env.sync_env=True", "env.num_envs=2", "algo.rollout_steps=8", "algo.total_steps=32",
            "algo.per_rank_batch_size=8", "algo.update_epochs=1", "checkpoint.every=16", "metric.log_every=16",
            "env.max_episode_steps=3", "algo.dense_units=8", "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=8"]


def test_a_run_registers_then_registration_and_eval_take_a_registry_spec(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import evaluate, registration, run
    from sheeprl_tpu_torch.utils.model_manager import LocalModelManager

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    registry = tmp_path / "registry"
    mm = [f"model_manager.registry_dir={registry}", "model_manager.name=tiny_ppo"]
    result = run([*TINY_PPO, f"log_root={tmp_path / 'logs'}", "model_manager.disabled=False", *mm])
    index = LocalModelManager(registry).get_models()
    (entry,) = index["tiny_ppo"]["versions"]
    assert Path(entry["source_checkpoint"]) == Path(result.checkpoint) and entry["metadata"]["algo"] == "ppo"
    assert (Path(entry["path"]) / "config.yaml").is_file() and (Path(entry["path"]) / "manifest.json").is_file()

    assert registration([f"checkpoint_path={result.checkpoint}", *mm]) == 2
    evaluated = evaluate(["checkpoint_path=tiny_ppo:latest", f"model_manager.registry_dir={registry}", "device=cpu",
                          "env.capture_video=False", f"log_root={tmp_path / 'eval'}"])
    assert evaluated.steps >= 1 and evaluated.reward == 0.0
    with pytest.raises(ValueError, match="no version 5"):
        evaluate(["checkpoint_path=tiny_ppo:5", f"model_manager.registry_dir={registry}", "device=cpu"])


@pytest.mark.parametrize("exp", ["a2c", "droq"])
def test_loops_whose_reference_does_not_register_refuse_the_key(tmp_path, monkeypatch, exp):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_TPU_QUIET", "1")
    env = ["env=discrete_dummy", "algo.mlp_keys.encoder=[state]"] if exp == "a2c" else []
    with pytest.raises(NotImplementedError, match=rf"model_manager\.disabled=False: the reference's {exp} loop does not register"):
        run([f"exp={exp}", *env, "device=cpu", "env.sync_env=True", "model_manager.disabled=False", f"log_root={tmp_path}"])
