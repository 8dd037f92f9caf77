"""Observation and action spaces: the subset of ``gymnasium.spaces`` the port's
environments use (``Box``, ``Discrete``, ``MultiDiscrete``, ``Dict``), with the same
constructor arguments and attributes.

The port carries its own because the hosts it targets need not have gymnasium: the
card's host has PyTorch, numpy and the CUDA toolkit, and the dummy-env evaluation path
needs nothing more. Spaces sample from their own ``numpy`` generator (``seed``).
``create_empty_array`` and ``batch_space`` give a space's layout over ``n`` envs, as
gymnasium's ``vector.utils`` do (the env pool's shared slabs and batched spaces).
"""

from __future__ import annotations

from typing import Any, Dict as TDict, Mapping, Optional, Sequence, Tuple

import numpy as np


class Space:
    def __init__(self, shape: Optional[Sequence[int]] = None, dtype: Any = None, seed: Optional[int] = None):
        self._shape = None if shape is None else tuple(int(s) for s in shape)
        self.dtype = None if dtype is None else np.dtype(dtype)
        self._np_random: Optional[np.random.Generator] = None
        if seed is not None:
            self.seed(seed)

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return self._shape

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self.seed()
        return self._np_random

    def seed(self, seed: Optional[int] = None) -> list:
        self._np_random = np.random.default_rng(seed)
        return [seed]

    def sample(self) -> Any:
        raise NotImplementedError

    def contains(self, x: Any) -> bool:
        raise NotImplementedError

    def __contains__(self, x: Any) -> bool:
        return self.contains(x)


class Box(Space):
    """A box in R^n (or Z^n): ``low <= x <= high`` elementwise."""

    def __init__(self, low: Any, high: Any, shape: Optional[Sequence[int]] = None, dtype: Any = np.float32, seed: Optional[int] = None):
        if shape is None:
            shape = np.broadcast_shapes(np.shape(low), np.shape(high))
        super().__init__(shape, dtype, seed)
        self.low = np.broadcast_to(np.asarray(low, dtype=self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype=self.dtype), self.shape).copy()

    def sample(self) -> np.ndarray:
        if np.issubdtype(self.dtype, np.integer):
            return self.np_random.integers(self.low, self.high, endpoint=True, dtype=self.dtype)
        low = np.where(np.isfinite(self.low), self.low, -1e6).astype(np.float64)
        high = np.where(np.isfinite(self.high), self.high, 1e6).astype(np.float64)
        return self.np_random.uniform(low, high).astype(self.dtype)

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= self.low) and np.all(x <= self.high))

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Box)
            and self.shape == other.shape
            and self.dtype == other.dtype
            and np.array_equal(self.low, other.low)
            and np.array_equal(self.high, other.high)
        )


class Discrete(Space):
    """``{start, ..., start + n - 1}``."""

    def __init__(self, n: int, seed: Optional[int] = None, start: int = 0):
        super().__init__((), np.int64, seed)
        self.n = int(n)
        self.start = int(start)

    def sample(self) -> np.int64:
        return np.int64(self.start + self.np_random.integers(self.n))

    def contains(self, x: Any) -> bool:
        return self.start <= int(x) < self.start + self.n

    def __repr__(self) -> str:
        return f"Discrete({self.n})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Discrete) and self.n == other.n and self.start == other.start


class MultiDiscrete(Space):
    """A vector of independent discrete choices, ``0 <= x[i] < nvec[i]``."""

    def __init__(self, nvec: Sequence[int], dtype: Any = np.int64, seed: Optional[int] = None):
        self.nvec = np.asarray(nvec, dtype=dtype)
        super().__init__(self.nvec.shape, dtype, seed)

    def sample(self) -> np.ndarray:
        return (self.np_random.random(self.nvec.shape) * self.nvec).astype(self.dtype)

    def contains(self, x: Any) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all(x >= 0) and np.all(x < self.nvec))

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MultiDiscrete) and np.array_equal(self.nvec, other.nvec)


class Dict(Space, Mapping):
    """A dictionary of spaces. Like gymnasium's, a plain ``dict`` is stored with its
    keys sorted."""

    def __init__(self, spaces: Optional[Mapping[str, Space]] = None, seed: Optional[int] = None):
        spaces = dict(spaces or {})
        self.spaces: TDict[str, Space] = {k: spaces[k] for k in sorted(spaces)}
        super().__init__(None, None)
        if seed is not None:
            self.seed(seed)

    def seed(self, seed: Optional[int] = None) -> list:
        super().seed(seed)
        seeds = self._np_random.integers(2**31, size=len(self.spaces)) if seed is not None else [None] * len(self.spaces)
        for space, s in zip(self.spaces.values(), seeds):
            space.seed(None if s is None else int(s))
        return [seed]

    def sample(self) -> TDict[str, Any]:
        return {k: space.sample() for k, space in self.spaces.items()}

    def contains(self, x: Any) -> bool:
        return isinstance(x, Mapping) and set(x) == set(self.spaces) and all(x[k] in s for k, s in self.spaces.items())

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __iter__(self):
        return iter(self.spaces)

    def __len__(self) -> int:
        return len(self.spaces)

    def __repr__(self) -> str:
        return "Dict(" + ", ".join(f"{k!r}: {s}" for k, s in self.spaces.items()) + ")"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Dict) and self.spaces == other.spaces


def create_empty_array(space: Space, n: int) -> Any:
    """Zeros for ``n`` stacked samples of ``space``, as gymnasium's
    ``vector.utils.create_empty_array(space, n, fn=np.zeros)``: ``[n, *shape]`` in the
    space's dtype (``[n]`` int64 for ``Discrete``), a dict of them for ``Dict``."""
    if isinstance(space, Dict):
        return {k: create_empty_array(s, n) for k, s in space.spaces.items()}
    if isinstance(space, (Box, Discrete, MultiDiscrete)):
        return np.zeros((n, *space.shape), dtype=space.dtype)
    raise TypeError(f"no batched layout for {space!r}: Box, Discrete, MultiDiscrete and Dict have one")


def batch_space(space: Space, n: int) -> Space:
    """The space of ``n`` stacked samples of ``space``, as gymnasium's
    ``vector.utils.batch_space``: a ``Box`` repeats its bounds, ``Discrete(k)`` becomes
    ``MultiDiscrete([k] * n)``, ``MultiDiscrete`` a ``Box`` of ``[0, nvec - 1]``, ``Dict``
    batches each entry."""
    if isinstance(space, Dict):
        return Dict({k: batch_space(s, n) for k, s in space.spaces.items()})
    if isinstance(space, Box):
        return Box(np.stack([space.low] * n), np.stack([space.high] * n), dtype=space.dtype)
    if isinstance(space, Discrete):
        if space.start != 0:
            raise TypeError(f"no batched space for {space!r} with start {space.start}: the port's MultiDiscrete starts at 0")
        return MultiDiscrete(np.full((n,), space.n, dtype=space.dtype), dtype=space.dtype)
    if isinstance(space, MultiDiscrete):
        return Box(np.zeros((n, *space.shape), space.dtype), np.stack([space.nvec - 1] * n), dtype=space.dtype)
    raise TypeError(f"no batched space for {space!r}: Box, Discrete, MultiDiscrete and Dict have one")
