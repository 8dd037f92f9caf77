"""sheeprl-tpu-torch: the PyTorch and CUDA port of sheeprl-tpu, for NVIDIA Hopper.

The JAX package ``sheeprl_tpu`` is the reference; this package mirrors its layout, so
the counterpart of ``sheeprl_tpu/<path>.py`` is ``sheeprl_tpu_torch/<path>.py``. It
imports ``torch`` and nothing of JAX or of the reference package. Each kernel that the
reference wrote in Pallas is a hand-written CUDA kernel here (``csrc/``), with a plain
PyTorch version of the same math beside it (``ops/``).

Entries: training (``python -m sheeprl_tpu_torch exp=<preset> ...``), evaluation
(``python -m sheeprl_tpu_torch.eval checkpoint_path=<dir or name:selector>``),
registration in the local model registry (``python -m sheeprl_tpu_torch.registration``)
and serving (``python -m sheeprl_tpu_torch.serve serve.policies=[name:selector]``).
``README.md`` lists the algorithms ported so far.
"""

__version__ = "0.1.0"
