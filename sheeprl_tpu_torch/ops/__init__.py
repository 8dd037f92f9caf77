"""Hand-written CUDA kernels for the port's hot operations, each beside its plain
PyTorch version.

Currently: ``gru.layernorm_gru`` and ``gru.layernorm_gru_backward``, the LayerNorm-GRU
gate step after the cell's fused projection and its gradient (counterpart of
``sheeprl_tpu/ops/gru.py``). Kernels build at first use (``_build.py``); on CPU tensors
the wrappers run the plain version.
"""
