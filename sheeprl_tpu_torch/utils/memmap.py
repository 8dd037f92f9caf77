"""Disk-backed ndarray with ownership transfer (counterpart of
``sheeprl_tpu/utils/memmap.py``).

Host-side only: replay data lives in numpy memmaps on the host; device transfer happens
explicitly at the train-step boundary. Semantics, as in the reference:

* ``MemmapArray(dtype, shape, mode, filename)`` creates/open a ``np.memmap``;
* ``from_array`` copies an existing ndarray in;
* pickling drops the mmap handle and transfers *ownership is not* carried across
  processes (``__getstate__`` semantics, reference ``:240-258``);
* the owner flushes and removes the file on ``__del__`` (reference ``:213-227``).
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np


class MemmapArray:
    def __init__(
        self,
        dtype: Any = np.float32,
        shape: Tuple[int, ...] = (),
        mode: str = "r+",
        filename: Optional[os.PathLike] = None,
    ):
        self._dtype = np.dtype(dtype)
        self._shape = tuple(shape)
        if filename is None:
            fd, filename = tempfile.mkstemp(suffix=".memmap")
            os.close(fd)
            mode = "w+"
        else:
            Path(filename).parent.mkdir(parents=True, exist_ok=True)
            if not Path(filename).exists():
                mode = "w+"
        self._filename = str(Path(filename).resolve())
        self._mode = mode
        self._array: Optional[np.memmap] = np.memmap(self._filename, dtype=self._dtype, mode=mode, shape=self._shape)
        self._has_ownership = True

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def has_ownership(self) -> bool:
        return self._has_ownership

    @has_ownership.setter
    def has_ownership(self, value: bool) -> None:
        self._has_ownership = bool(value)

    @property
    def array(self) -> np.memmap:
        if self._array is None:
            self._array = np.memmap(self._filename, dtype=self._dtype, mode="r+", shape=self._shape)
        return self._array

    @array.setter
    def array(self, value: np.ndarray) -> None:
        if value.shape != self._shape:
            raise ValueError(f"shape mismatch: {value.shape} vs {self._shape}")
        self.array[:] = value

    @classmethod
    def from_array(
        cls,
        array: np.ndarray,
        filename: Optional[os.PathLike] = None,
    ) -> "MemmapArray":
        if isinstance(array, MemmapArray):
            src = array.array
            out = cls(dtype=src.dtype, shape=src.shape, filename=filename)
            same_file = out.filename == array.filename
            if not same_file:
                out.array[:] = src
            else:
                # Same backing file: the new instance does not steal ownership.
                out._has_ownership = False
            return out
        array = np.asarray(array)
        out = cls(dtype=array.dtype, shape=array.shape, filename=filename)
        out.array[:] = array
        return out

    # -- numpy interop ------------------------------------------------------
    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        arr = self.array
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        return np.array(arr, copy=True) if copy else np.asarray(arr)

    def __getitem__(self, idx):
        return self.array[idx]

    def __setitem__(self, idx, value):
        self.array[idx] = value

    def __len__(self) -> int:
        return self._shape[0] if self._shape else 0

    def flush(self) -> None:
        """Force buffered writes to the backing file (checkpoint durability)."""
        if self._array is not None:
            self._array.flush()

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, file={self._filename})"

    # -- pickling: drop the live mmap handle (reference :240-258) -----------
    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["_array"] = None
        state["_has_ownership"] = False
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def __del__(self) -> None:
        try:
            if self._array is not None:
                self._array.flush()
            if getattr(self, "_has_ownership", False) and os.path.isfile(self._filename):
                del self._array
                self._array = None
                os.unlink(self._filename)
        except Exception:
            pass
