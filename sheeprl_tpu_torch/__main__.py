"""Training launcher (counterpart of ``sheeprl_tpu/__main__.py``):

    python -m sheeprl_tpu_torch exp=dreamer_v3_dummy env=discrete_dummy [device=cpu] [overrides]
"""

from sheeprl_tpu_torch.cli import run

if __name__ == "__main__":
    run()
