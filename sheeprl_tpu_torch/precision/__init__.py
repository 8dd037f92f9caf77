"""Precision (counterpart of ``sheeprl_tpu/precision``): dtype policies (``policy.py``),
loss scaling as a library (``loss_scale.py``), int8 weight-only quantization for the
serving path (``quantize.py``) and the parity metrics of the serve parity stamp
(``parity.py``)."""

from sheeprl_tpu_torch.precision.loss_scale import DynamicLossScale, NoOpLossScale, StaticLossScale, all_finite
from sheeprl_tpu_torch.precision.parity import action_agreement, action_agreement_mask, categorical_kl, gaussian_mean_divergence
from sheeprl_tpu_torch.precision.policy import PrecisionPolicy, resolve_policy, train_policy
from sheeprl_tpu_torch.precision.quantize import Int8Weight, dequantize_params, quantize_params, quantize_weight

__all__ = [
    "PrecisionPolicy",
    "resolve_policy",
    "train_policy",
    "NoOpLossScale",
    "StaticLossScale",
    "DynamicLossScale",
    "all_finite",
    "Int8Weight",
    "quantize_weight",
    "quantize_params",
    "dequantize_params",
    "action_agreement",
    "action_agreement_mask",
    "categorical_kl",
    "gaussian_mean_divergence",
]
