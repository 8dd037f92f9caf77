"""Fault handling (counterpart of ``sheeprl_tpu/fault``): the signal half of graceful
preemption (``preemption.py``), which the policy server and the Sebulba learner end on,
the chaos harness's Sebulba actor kill (``chaos.py``) and the supervisor's helpers that
the Sebulba launcher uses (``supervisor.py``) and the ``Fault/*`` counters that every
metric flush folds in (``counters.py``)."""
