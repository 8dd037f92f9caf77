"""The local model registry (counterpart of ``sheeprl_tpu/utils/model_manager.py``).

``LocalModelManager`` keeps a JSON index and copied checkpoint payloads under
``<registry_dir>``, in the reference's layout: ``registry.json`` (``{name: {"versions":
[{version, path, source_checkpoint, model_keys, stage, timestamp, metadata}]}}``),
``registry.lock`` and ``<name>/v<version>/``, each version's payload carrying its copy
of the run's ``config.yaml``. Its API: ``register_model(ckpt_path, name, model_keys,
metadata)``, ``get_models()``, ``transition_model(name, version, stage)``,
``delete_model(name, version)`` and ``download_model(name, version, output_dir)``.

Every mutation is a read-modify-write of ``registry.json`` under an ``fcntl`` advisory
lock, saved through a unique temp file and ``os.replace``, so concurrent writers cannot
drop entries and readers never see a torn index.

``model_manager.backend=mlflow`` raises, naming the key: the reference's MLflow backend
needs the ``mlflow`` package, which the port's hosts do not have (the reference raises
alike where it is missing).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

REGISTRY_INDEX = "registry.json"
REGISTRY_LOCK = "registry.lock"


class LocalModelManager:
    def __init__(self, registry_dir: str = "models_registry"):
        self.registry_dir = Path(registry_dir)
        self.registry_dir.mkdir(parents=True, exist_ok=True)
        self._index_path = self.registry_dir / REGISTRY_INDEX
        self._lock_path = self.registry_dir / REGISTRY_LOCK

    # -- index ---------------------------------------------------------------
    @contextlib.contextmanager
    def _locked(self):
        """Advisory inter-process lock around a read-modify-write of the index."""
        try:
            import fcntl
        except ImportError:  # pragma: no cover - non-POSIX fallback
            yield
            return
        with open(self._lock_path, "a+") as lock_f:
            try:
                fcntl.flock(lock_f.fileno(), fcntl.LOCK_EX)
            except OSError:  # pragma: no cover - e.g. NFS without lock support
                yield
                return
            try:
                yield
            finally:
                fcntl.flock(lock_f.fileno(), fcntl.LOCK_UN)

    def _load(self) -> Dict[str, Any]:
        if self._index_path.is_file():
            with open(self._index_path) as f:
                return json.load(f)
        return {}

    def _save(self, index: Dict[str, Any]) -> None:
        # Unique temp name per writer: a shared .tmp would let two concurrent
        # savers interleave write/replace and publish a torn or stale index.
        fd, tmp_name = tempfile.mkstemp(
            prefix=f".{REGISTRY_INDEX}.", suffix=".tmp", dir=self.registry_dir
        )
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(index, f, indent=2)
            os.replace(tmp_name, self._index_path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp_name)
            raise

    @staticmethod
    def _find_run_config(src: Path) -> Optional[Path]:
        """The training run's config.yaml for a checkpoint dir, searched the same
        way ``cli._load_checkpoint_cfg`` does (run dir, then the checkpoints dir,
        then inside the payload itself for re-registered downloads)."""
        candidates = [src / "config.yaml"] if src.is_dir() else []
        candidates += [src.parent.parent / "config.yaml", src.parent / "config.yaml"]
        for cand in candidates:
            if cand.is_file():
                return cand
        return None

    # -- API -----------------------------------------------------------------
    def register_model(
        self,
        ckpt_path: str,
        name: str,
        model_keys: Optional[List[str]] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> int:
        """Copy the checkpoint payload into the registry as a new version of ``name``.

        The run's ``config.yaml`` rides along inside the version dir so the payload
        is self-contained: evaluation and the serve entry can rebuild the agent from
        the registry alone, without the original run directory."""
        src = Path(ckpt_path)
        run_cfg = self._find_run_config(src)
        with self._locked():
            index = self._load()
            entry = index.setdefault(name, {"versions": []})
            versions = entry["versions"]
            version = (max((v["version"] for v in versions), default=0)) + 1
            dest = self.registry_dir / name / f"v{version}"
            dest.parent.mkdir(parents=True, exist_ok=True)
            if src.is_dir():
                shutil.copytree(src, dest, dirs_exist_ok=True)
            else:
                dest.mkdir(parents=True, exist_ok=True)
                shutil.copy2(src, dest / src.name)
            if run_cfg is not None and not (dest / "config.yaml").is_file():
                shutil.copy2(run_cfg, dest / "config.yaml")
            versions.append(
                {
                    "version": version,
                    "path": str(dest),
                    "source_checkpoint": str(src),
                    "model_keys": list(model_keys or []),
                    "stage": "None",
                    "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                    "metadata": metadata or {},
                }
            )
            self._save(index)
        return version

    def get_models(self) -> Dict[str, Any]:
        return self._load()

    def _version_entry(self, index, name: str, version: Optional[int]):
        if name not in index or not index[name]["versions"]:
            raise ValueError(f"No registered model named {name!r}")
        versions = index[name]["versions"]
        if version is None:
            return versions[-1]
        for entry in versions:
            if entry["version"] == version:
                return entry
        raise ValueError(f"Model {name!r} has no version {version}")

    def transition_model(self, name: str, version: Optional[int], stage: str) -> None:
        """Move a version to a stage (staging/production/archived), as MLflow's stage
        transition does."""
        with self._locked():
            index = self._load()
            self._version_entry(index, name, version)["stage"] = stage
            self._save(index)

    def delete_model(self, name: str, version: Optional[int] = None) -> None:
        with self._locked():
            index = self._load()
            if version is None:
                for entry in index.get(name, {}).get("versions", []):
                    shutil.rmtree(entry["path"], ignore_errors=True)
                index.pop(name, None)
            else:
                entry = self._version_entry(index, name, version)
                shutil.rmtree(entry["path"], ignore_errors=True)
                index[name]["versions"] = [
                    e for e in index[name]["versions"] if e["version"] != version
                ]
            self._save(index)

    def download_model(self, name: str, version: Optional[int], output_dir: str) -> Path:
        index = self._load()
        entry = self._version_entry(index, name, version)
        dest = Path(output_dir) / name / f"v{entry['version']}"
        shutil.copytree(entry["path"], dest, dirs_exist_ok=True)
        return dest



def build_model_manager(cfg) -> LocalModelManager:
    mm_cfg = cfg.get("model_manager", {}) or {}
    backend = str(mm_cfg.get("backend", "local")).lower()
    if backend == "mlflow":
        raise ModuleNotFoundError(
            "model_manager.backend=mlflow: mlflow is not installed; use model_manager.backend=local "
            "(the LocalModelManager) instead"
        )
    return LocalModelManager(registry_dir=mm_cfg.get("registry_dir", "models_registry"))


def maybe_register_models(cfg, log_dir: str) -> Optional[int]:
    """End-of-training registration: with ``model_manager.disabled=False`` the run's last
    checkpoint becomes a new version of ``model_manager.name`` (default
    ``<algo>_<env>``). Returns the version, or None when disabled or nothing was
    checkpointed."""
    mm_cfg = cfg.get("model_manager", {}) or {}
    if mm_cfg.get("disabled", True):
        return None
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

    ckpts = CheckpointManager(Path(log_dir) / "checkpoints", keep_last=None).list_checkpoints()
    if not ckpts:
        return None
    name = mm_cfg.get("name") or f"{cfg.algo.name}_{cfg.env.id}"
    manager = build_model_manager(cfg)
    return manager.register_model(
        str(ckpts[-1]),
        name,
        model_keys=list(mm_cfg.get("models", {}) or []),
        metadata={"algo": cfg.algo.name, "env": cfg.env.id, "seed": cfg.seed, "run_name": cfg.get("run_name", "")},
    )
