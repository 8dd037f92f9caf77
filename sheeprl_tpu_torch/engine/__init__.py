"""The Anakin engine (``anakin.py``) and its population member axis (``population.py``):
counterpart of ``sheeprl_tpu/engine``."""
