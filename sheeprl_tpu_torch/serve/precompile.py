"""One CUDA graph per ladder bucket (counterpart of
``sheeprl_tpu/serve/precompile.py::precompile_ladder``, which compiles each bucket ahead
of time).

A :class:`BucketGraph` holds a bucket's static input tensors on the device, its act step
captured once as a CUDA graph (``utils/graphs.py::StepGraph``) and, on a card, pinned
host buffers: a dispatch writes the padded batch into the pinned staging buffers, copies
them into the static inputs on its endpoint's stream, replays the graph, copies the
actions back into a pinned buffer and waits on an event recorded after that copy. For
the recurrent family the session gather, the step and the scatter are in the same graph,
reading a static index tensor. A non-greedy policy draws from the endpoint's
``torch.Generator`` inside the graph (its state registered with the capture), so each
replay advances the generator's Philox offset: the port's counterpart of the
reference's per-dispatch ``dispatch_key(seed, counter)``.

On the CPU each bucket runs the eager act function on the same static inputs. The
reference's IR-audit hooks (``lower_for_audit``) wait for the port's audit.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils.graphs import StepGraph


class BucketGraph:
    """One bucket of one policy: its static inputs and its captured act step."""

    def __init__(self, policy, bucket: int, generator: Optional[torch.Generator] = None, cache=None):
        self.bucket = int(bucket)
        self.policy = policy
        device = policy.device
        self.cuda = device.type == "cuda"
        self.inputs: Dict[str, Any] = {"obs": {k: torch.from_numpy(v).to(device) for k, v in policy.zero_obs(self.bucket).items()}}
        if cache is not None:
            self.inputs["idx"] = torch.full((self.bucket,), cache.scratch, dtype=torch.int64, device=device)
            self.inputs["is_first"] = torch.ones((self.bucket, 1), device=device)

        def step(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
            with torch.no_grad():
                draws = policy.make_draws(self.bucket, generator)
                if cache is None:
                    return {"action": policy.act_fn(policy.params, inputs["obs"], draws)}
                rows = cache.gather(inputs["idx"])
                actions, new_rows = policy.act_fn(policy.params, inputs["obs"], inputs["is_first"], rows, draws)
                cache.scatter(inputs["idx"], new_rows)
                return {"action": actions}

        self.step = StepGraph(
            step,
            self.inputs,
            state=cache.tensors() if cache is not None else (),
            generators=[generator] if policy.samples and generator is not None else (),
        )
        out = self.step()["action"]  # one run on zeros: a bucket that cannot run fails at startup
        if self.cuda:
            torch.cuda.synchronize(device)
            self.staging = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for k, t in self._flat_inputs().items()}
            self.out_host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)

    def _flat_inputs(self) -> Dict[str, torch.Tensor]:
        flat = {f"obs/{k}": t for k, t in self.inputs["obs"].items()}
        flat.update({k: self.inputs[k] for k in ("idx", "is_first") if k in self.inputs})
        return flat

    @property
    def graph(self):
        """The captured CUDA graph (None on the CPU)."""
        return self.step.graph

    def __call__(
        self,
        obs: Dict[str, np.ndarray],
        idx: Optional[np.ndarray] = None,
        is_first: Optional[np.ndarray] = None,
        stream: Optional[torch.cuda.Stream] = None,
        done: Optional[torch.cuda.Event] = None,
    ) -> np.ndarray:
        """One dispatch of a padded ``[bucket, ...]`` batch; the actions ``[bucket,
        ...]`` as a numpy array of their own."""
        host = {f"obs/{k}": v for k, v in obs.items()}
        if idx is not None:
            host["idx"], host["is_first"] = idx, is_first
        targets = self._flat_inputs()
        if not self.cuda:
            for k, t in targets.items():
                t.copy_(torch.from_numpy(np.ascontiguousarray(host[k])))
            return self.step()["action"].numpy().copy()
        for k, buf in self.staging.items():
            buf.numpy()[...] = host[k]
        stream = stream if stream is not None else torch.cuda.current_stream(self.policy.device)
        done = done if done is not None else torch.cuda.Event()
        with torch.cuda.stream(stream):
            for k, t in targets.items():
                t.copy_(self.staging[k], non_blocking=True)
            self.out_host.copy_(self.step()["action"], non_blocking=True)
            done.record(stream)
        done.synchronize()
        return self.out_host.numpy().copy()


def precompile_ladder(
    policy, ladder: Sequence[int], generator: Optional[torch.Generator] = None, cache=None
) -> Tuple[Dict[int, BucketGraph], float]:
    """One :class:`BucketGraph` per bucket of ``ladder``, each run once on zeros; returns
    ``(bucket -> graph, seconds)``. A capture that fails raises: the server then fails
    to start, it never serves a bucket eagerly."""
    t0 = time.perf_counter()
    graphs = {int(b): BucketGraph(policy, int(b), generator, cache) for b in ladder}
    return graphs, time.perf_counter() - t0
