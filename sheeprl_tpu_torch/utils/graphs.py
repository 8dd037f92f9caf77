"""A training step captured once as a CUDA graph and replayed (counterpart of
``jax.jit(train_step)``, ``bench.py:96``).

``StepGraph(fn, inputs, state)``: ``fn(inputs)`` is one step. It reads everything that
changes between steps from ``inputs``, a tree (dicts, tuples) of tensors that the
caller fills in place before each call (the batch or its replay indices, the target
flag, the draws); it updates the ``state`` tensors (parameters, optimizer states,
moments) in place; and it returns its outputs, a dict of tensors.

On a CUDA device the constructor warms ``fn`` up on a side stream, as PyTorch's graph
docs ask for autograd, then captures one call. Each call replays the graph and returns
the same output tensors, overwritten by the next replay: a caller that keeps outputs
clones them. The warm-up runs real steps, so the constructor copies ``state`` aside
before it and back after the capture: building a captured step changes no parameter.
A capture that fails raises; a card never falls back to the eager step.

On the CPU each call runs ``fn`` eagerly on the same inputs: the same function, which is
what the tests run.

Launch counts: the kernels' wrappers count the launches they record while the graph is
captured. A capture launches nothing, so those counts are taken back and become
``launches_per_replay``, which every replay adds to the counters (``ops/counters.py``).
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, List, Sequence

import torch

from sheeprl_tpu_torch.ops import counters

WARMUP_STEPS = 2  # eager steps on a side stream before the capture


def tree_tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return []


class StepGraph:
    """One step, replayed from a CUDA graph on a card and run eagerly on the CPU."""

    def __init__(
        self,
        fn: Callable[[Any], Dict[str, torch.Tensor]],
        inputs: Any,
        state: Sequence[torch.Tensor] = (),
        warmup: int = WARMUP_STEPS,
    ):
        self.fn = fn
        self.inputs = inputs
        self.device = tree_tensors(inputs)[0].device
        self.graph = None
        self.outputs: Dict[str, torch.Tensor] = {}
        self.launches_per_replay: Dict[str, int] = {}
        if self.device.type == "cuda":
            self._capture(list(state), warmup)

    @torch.no_grad()
    def _restore(self, state: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
        if state:
            torch._foreach_copy_(state, saved)

    def _capture(self, state: List[torch.Tensor], warmup: int) -> None:
        with torch.no_grad():
            saved = [t.detach().clone() for t in state]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.fn(self.inputs)
        current.wait_stream(side)
        before = counters.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # No garbage collection while capturing: a collection that frees an earlier
        # graph caught in a reference cycle resets it, which a capturing stream forbids
        # (an H100 run failed so, mid-capture of a 1,024-step loop)
        gc.collect()
        gc.disable()
        try:
            # thread_local: a replay-prefetch thread may copy batches meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.outputs = self.fn(self.inputs)
        except Exception as exc:
            raise RuntimeError(f"capturing the train step as a CUDA graph failed on {self.device}") from exc
        finally:
            gc.enable()
            recorded = counters.launch_counts()
            counters.set_launches(before)
        self.launches_per_replay = {k: recorded[k] - before[k] for k in recorded}
        self._restore(state, saved)
        self.graph = graph

    def __call__(self) -> Dict[str, torch.Tensor]:
        """One step on the current ``inputs``; its outputs (static tensors on a card)."""
        if self.graph is None:
            return self.fn(self.inputs)
        self.graph.replay()
        counters.add_launches(self.launches_per_replay)
        return self.outputs
