"""Fault tolerance (counterpart of ``sheeprl_tpu/fault``):

* ``preemption``: SIGTERM/SIGINT set a sticky flag that every training loop polls at its
  safe boundary; the ``PREEMPTED`` marker and exit code 75;
* ``guard``: ``TrainingGuard``, the boundary hook each loop calls once per update (chaos
  faults, then the final checkpoint, the marker and ``Preempted``);
* ``supervisor``: ``python -m sheeprl_tpu_torch.supervise`` relaunches a crashed or
  preempted run from the newest valid checkpoint; ``fault.autoresume=True`` does the
  same in process (``cli.run``);
* ``classify``: the retry/fatal matrix;
* ``chaos``: the seeded fault schedule (kill, corrupt, delay at step N; the Sebulba
  actor kill; the env pool's worker crash or hang);
* ``counters``: the ``Fault/*`` counters that every metric flush folds in.

Not ported: the serving fleet's supervisor (``serve.fleet.enabled``).
"""
