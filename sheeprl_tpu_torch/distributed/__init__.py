"""What the decoupled entries share between their player and learner, and the wire the
policy server speaks (counterpart of ``sheeprl_tpu/distributed``): the stamped,
freshest-wins publication of parameters (``publish.py``), and the framed array channel
and the batch digest (``transport.py``). The Sebulba placed-process mode, its launcher
and publishers are not ported: the decoupled entries run their player and learner as two
threads of one process."""
