"""What the decoupled entries share between their player and learner (counterpart of
``sheeprl_tpu/distributed``): the stamped, freshest-wins publication of parameters
(``publish.py``) and the batch digest (``transport.py``). The Sebulba placed-process
mode, its launcher, transport channel and publishers are not ported: the decoupled
entries run their player and learner as two threads of one process."""
