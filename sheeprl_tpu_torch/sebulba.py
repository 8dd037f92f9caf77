"""Sebulba launcher (counterpart of ``sheeprl_tpu/sebulba.py``):

    python -m sheeprl_tpu_torch.sebulba exp=sac_decoupled distributed.num_actors=2 [device=cpu] [overrides]

places one learner process and ``distributed.num_actors`` actor processes, respawns a
dead actor with a bumped generation, and exits with the learner's code
(``distributed/launcher.py``).
"""

from sheeprl_tpu_torch.distributed.launcher import main

if __name__ == "__main__":
    main()
