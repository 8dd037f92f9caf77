"""Hand-written CUDA kernels for the port's hot operations, each beside its plain
PyTorch version.

* ``gru.layernorm_gru`` and ``gru.layernorm_gru_backward``: the LayerNorm-GRU gate step
  after the cell's fused projection and its gradient (counterpart of
  ``sheeprl_tpu/ops/gru.py``), on the DreamerV3 paths.
* ``rssm_step.gru_step`` and ``rssm_step.gru_step_backward``: the same step with the
  ``[B, K] @ [K, 3H]`` projection inside the kernel (counterpart of
  ``sheeprl_tpu/ops/rssm_step.py``), driven by ``benchmarks/fused_step_bench.py``.

Kernels build at first use (``_build.py``); on CPU tensors the wrappers run the plain
version. ``counters`` zeroes and reads every wrapper's launch counter.
"""
