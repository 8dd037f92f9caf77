"""Fault handling (counterpart of ``sheeprl_tpu/fault``): so far the signal half of
graceful preemption (``preemption.py``), which the policy server drains on."""
