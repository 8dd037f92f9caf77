"""Autoresume supervisor (counterpart of ``sheeprl_tpu/supervise.py``):

    python -m sheeprl_tpu_torch.supervise exp=... [device=cpu] [overrides]

relaunches a crashed or preempted training run (``python -m sheeprl_tpu_torch``) from
the newest checkpoint that verifies, with bounded exponential-backoff retries;
``--serve`` keeps one ``python -m sheeprl_tpu_torch.serve`` replica alive instead (a
SIGTERM'd replica drains, exits 75 and is respawned at once). See
``fault/supervisor.py``.
"""

from sheeprl_tpu_torch.fault.supervisor import main

if __name__ == "__main__":
    main()
