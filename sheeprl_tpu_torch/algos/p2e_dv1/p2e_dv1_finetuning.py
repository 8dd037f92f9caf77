"""P2E on DreamerV1, the finetuning run (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_finetuning.py``).

The run starts from the exploration run's checkpoint (``checkpoint.exploration_ckpt_path``;
a resumed finetuning run from its own) and trains the task slice, ``{world_model,
actor_task, critic_task}``, with DreamerV1's step. It checkpoints every module of the
exploration run and every optimizer state: the untrained entries as they were loaded.
The player acts from the first step, with ``algo.player.actor_type``'s actor, and
switches to the task actor at the first training iteration; the run tests the task
actor. With ``buffer.load_from_exploration`` the replay starts with the exploration
run's rows (its checkpointed buffer).
"""

from __future__ import annotations

from sheeprl_tpu_torch.algos.dreamer_loop import LoopParts, TrainResult, run_loop, sequential_buffer
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_step as make_dv1_train_step
from sheeprl_tpu_torch.algos.p2e import finetuning_parts
from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration import make_train_step as make_expl_train_step
from sheeprl_tpu_torch.algos.p2e_dv1.utils import AGGREGATOR_KEYS
from sheeprl_tpu_torch.utils.registry import register_algorithm

# the task slice: the names of DreamerV1's step -> the names of the checkpoint
TASK_SLICE = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task"}


@register_algorithm(name="p2e_dv1_finetuning")
def main(ctx, cfg) -> TrainResult:
    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        return finetuning_parts(
            ctx, cfg, build_agent, make_expl_train_step, make_dv1_train_step, TASK_SLICE, make_player_step, sequential_buffer,
            obs_space, actions_dim, is_continuous, log_dir, train_gen,
        )

    return run_loop(ctx, cfg, setup, AGGREGATOR_KEYS)
