"""Model-registration launcher (counterpart of ``sheeprl_tpu/registration.py``):

    python -m sheeprl_tpu_torch.registration checkpoint_path=<run>/checkpoints/ckpt_N \
        [model_manager.name=...] [model_manager.registry_dir=...]

Registers a training checkpoint in the local model registry; the version's payload
keeps a copy of the run's ``config.yaml``, so the serve and eval entries rebuild the
agent from the registry alone.
"""

from sheeprl_tpu_torch.cli import registration

if __name__ == "__main__":
    registration()
