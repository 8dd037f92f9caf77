"""Checkpoint save and restore with end-to-end integrity (counterpart of
``sheeprl_tpu/checkpoint/manager.py``, for ``torch`` state).

One directory per checkpoint, ``<ckpt_dir>/ckpt_<step>/``: each entry of the saved state
is one ``<name>.pt`` file written with ``torch.save`` (tensors moved to the CPU first),
and ``manifest.json`` lists the entries with the sha256 of each file.

The crash-safety rules are the reference's:

* every file is flushed and fsynced, then the temporary directory, and it is renamed
  into place, then the parent directory is fsynced: a checkpoint exists completely or
  not at all, even across a power cut;
* ``load()`` verifies every checksum before it deserialises anything and, on damage,
  falls back to the newest earlier checkpoint that verifies;
* a new manager removes ``.tmp_ckpt_*`` directories left by a writer that was killed;
* ``keep_last`` bounds the number of checkpoints kept.

Files are read back with ``torch.load(weights_only=True)``: tensors, containers and
plain Python values only.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

#: Manifest format written by this version.
MANIFEST_FORMAT = 1

#: Config keys a resumed run takes from the checkpoint's run, whatever the command says.
PROTECTED_RESUME_KEYS = ("env", "algo", "buffer", "checkpoint", "distribution", "exp_name", "seed")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed verification: a missing, truncated or altered file, or an
    unreadable manifest."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _fsync_write(path: Path, data: bytes) -> str:
    """Write ``data`` durably (flush + fsync) and return its sha256 hex digest."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return _sha256(data)


def _fsync_dir(path: Path) -> None:
    """fsync a directory so its entries (and a rename into it) reach the journal."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _to_cpu(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


def _serialize(value: Any) -> bytes:
    buf = io.BytesIO()
    torch.save(_to_cpu(value), buf)
    return buf.getvalue()


class CheckpointManager:
    def __init__(self, ckpt_dir: os.PathLike, keep_last: Optional[int] = 5):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._sweep_orphan_tmp()

    def _sweep_orphan_tmp(self) -> None:
        """Remove ``.tmp_ckpt_*`` dirs of a writer that died: only the rename makes a
        checkpoint visible, so a tmp dir seen at start-up is garbage."""
        if not self.ckpt_dir.exists():
            return
        orphans = [p for p in self.ckpt_dir.iterdir() if p.is_dir() and p.name.startswith(".tmp_ckpt_")]
        for orphan in orphans:
            shutil.rmtree(orphan, ignore_errors=True)
        if orphans:
            warnings.warn(f"swept {len(orphans)} orphaned .tmp_ckpt_* dir(s) in {self.ckpt_dir}")

    def save(self, step: int, state: Dict[str, Any]) -> Path:
        """Write ``state`` (name -> tensors, containers of them, or plain values) as
        ``ckpt_<step>`` and return its path."""
        out = self.ckpt_dir / f"ckpt_{step}"
        tmp = self.ckpt_dir / f".tmp_ckpt_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        checksums = {f"{name}.pt": _fsync_write(tmp / f"{name}.pt", _serialize(value)) for name, value in state.items()}
        manifest = {"step": step, "entries": sorted(state), "checksums": checksums, "format": MANIFEST_FORMAT}
        _fsync_write(tmp / "manifest.json", json.dumps(manifest, indent=1).encode())
        _fsync_dir(tmp)
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)
        _fsync_dir(self.ckpt_dir)
        self._gc()
        return out

    def _gc(self) -> None:
        if not self.keep_last:
            return
        for old in self.list_checkpoints()[: -self.keep_last]:
            shutil.rmtree(old, ignore_errors=True)

    def list_checkpoints(self) -> List[Path]:
        return _sorted_ckpts(self.ckpt_dir)

    # ------------------------------------------------------------------ integrity
    @classmethod
    def verify(cls, ckpt_path: os.PathLike) -> bool:
        """True iff the manifest reads and every checksum matches."""
        try:
            cls._verify(Path(ckpt_path))
            return True
        except CheckpointCorruptError:
            return False

    @staticmethod
    def _verify(ckpt_path: Path) -> Dict[str, Any]:
        try:
            manifest = json.loads((ckpt_path / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(f"{ckpt_path}: unreadable manifest.json: {e}") from e
        if not isinstance(manifest, dict) or not {"step", "entries", "checksums"} <= set(manifest):
            raise CheckpointCorruptError(f"{ckpt_path}: malformed manifest.json")
        for name in manifest["entries"]:
            if f"{name}.pt" not in manifest["checksums"]:
                raise CheckpointCorruptError(f"{ckpt_path}: no checksum for {name}.pt")
        for fname, digest in manifest["checksums"].items():
            fpath = ckpt_path / fname
            if not fpath.is_file():
                raise CheckpointCorruptError(f"{ckpt_path}: missing {fname}")
            if _sha256(fpath.read_bytes()) != digest:
                raise CheckpointCorruptError(f"{ckpt_path}: checksum mismatch on {fname}")
        return manifest

    @classmethod
    def latest_valid(cls, ckpt_dir: os.PathLike) -> Optional[Path]:
        """Newest checkpoint under ``ckpt_dir`` that verifies; None when there is none."""
        for ckpt in reversed(_sorted_ckpts(Path(ckpt_dir))):
            if cls.verify(ckpt):
                return ckpt
        return None

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, ckpt_path: os.PathLike, map_location: Any = "cpu", fallback: bool = True) -> Dict[str, Any]:
        """Load a checkpoint directory: ``{"_step": step, name: value, ...}``.

        Verifies checksums first; on corruption with ``fallback=True``, loads the newest
        earlier sibling ``ckpt_*`` that verifies. Raises
        :class:`CheckpointCorruptError` when nothing valid remains."""
        ckpt_path = Path(ckpt_path)
        try:
            return cls._load_one(ckpt_path, map_location)
        except CheckpointCorruptError as primary:
            if not fallback:
                raise
            for candidate in reversed(_sorted_ckpts(ckpt_path.parent)):
                if candidate == ckpt_path:
                    continue
                try:
                    state = cls._load_one(candidate, map_location)
                except CheckpointCorruptError:
                    continue
                warnings.warn(f"checkpoint {ckpt_path} is corrupt ({primary}); fell back to {candidate} (step {state['_step']})")
                return state
            raise CheckpointCorruptError(
                f"{ckpt_path} is corrupt and no earlier valid checkpoint exists in {ckpt_path.parent}"
            ) from primary

    @classmethod
    def _load_one(cls, ckpt_path: Path, map_location: Any) -> Dict[str, Any]:
        manifest = cls._verify(ckpt_path)
        state: Dict[str, Any] = {"_step": manifest["step"]}
        for name in manifest["entries"]:
            try:
                state[name] = torch.load(ckpt_path / f"{name}.pt", map_location=map_location, weights_only=True)
            except Exception as e:  # checksummed bytes that still fail to parse
                raise CheckpointCorruptError(f"{ckpt_path}: entry {name!r} failed to deserialize: {e}") from e
        return state


def _sorted_ckpts(ckpt_dir: Path) -> List[Path]:
    if not ckpt_dir.exists():
        return []
    ckpts = [p for p in ckpt_dir.iterdir() if p.is_dir() and p.name.startswith("ckpt_") and p.name[5:].isdigit()]
    return sorted(ckpts, key=lambda p: int(p.name[5:]))


def validate_resume_config(old_cfg: Dict[str, Any], new_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Merge a checkpoint's config into the current one, keeping the checkpoint's
    values of the keys a resume must not change."""
    merged = dict(new_cfg)
    for key in PROTECTED_RESUME_KEYS:
        if key in old_cfg:
            merged[key] = old_cfg[key]
    return merged
