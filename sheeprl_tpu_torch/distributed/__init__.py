"""What the decoupled entries share between their player and learner, and the wire the
policy server speaks (counterpart of ``sheeprl_tpu/distributed``): the stamped,
freshest-wins publication of parameters (``publish.py``), the framed array channel and
the batch digest (``transport.py``), and the Sebulba placed-process mode: the placement
spec (``placement.py``), the learner and actor processes (``sebulba.py``) and their
launcher (``launcher.py``, ``python -m sheeprl_tpu_torch.sebulba``)."""
