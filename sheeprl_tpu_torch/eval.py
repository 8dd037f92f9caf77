"""Evaluation launcher (counterpart of ``sheeprl_tpu/eval.py``):

    python -m sheeprl_tpu_torch.eval checkpoint_path=<run>/checkpoints/ckpt_N [device=cpu] [overrides]

Loads the run's saved config, merges the overrides, and dispatches to the algorithm's
registered evaluation entry on ``device`` (``cuda`` by default).
"""

from sheeprl_tpu_torch.cli import evaluate

if __name__ == "__main__":
    evaluate()
