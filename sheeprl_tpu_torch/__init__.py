"""sheeprl-tpu-torch: the PyTorch and CUDA port of sheeprl-tpu, for NVIDIA Hopper.

The JAX package ``sheeprl_tpu`` is the reference; this package mirrors its layout, so
the counterpart of ``sheeprl_tpu/<path>.py`` is ``sheeprl_tpu_torch/<path>.py``. It
imports ``torch`` and nothing of JAX or of the reference package. Each kernel that the
reference wrote in Pallas is a hand-written CUDA kernel here (``csrc/``), with a plain
PyTorch version of the same math beside it (``ops/``).

Ported so far: DreamerV3 training through the train entry (``python -m
sheeprl_tpu_torch exp=<preset> ...``) and inference through the evaluation entry
(``python -m sheeprl_tpu_torch.eval checkpoint_path=<dir>``), with the LayerNorm-GRU
forward and backward kernels.
"""

__version__ = "0.1.0"
