"""P2E on DreamerV3, the finetuning run (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py``).

The run starts from the exploration run's checkpoint (``checkpoint.exploration_ckpt_path``;
a resumed finetuning run from its own) and trains the task slice, ``{world_model,
actor_task, critic_task, target_critic_task}``, with DreamerV3's step, carrying on the
task's return moments (the target EMA at ``count_offset=0``). It checkpoints every
module of the exploration run, every optimizer state and the moments: the untrained
entries as they were loaded. The player acts from the first step, with
``algo.player.actor_type``'s actor, and switches to the task actor at the first training
iteration; the run tests the task actor. With ``buffer.load_from_exploration`` the replay
starts with the exploration run's rows.
"""

from __future__ import annotations

import numpy as np

from sheeprl_tpu_torch.algos.dreamer_loop import LoopParts, TrainResult, run_loop, sequential_buffer
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step as make_dv3_train_step
from sheeprl_tpu_torch.algos.p2e import finetuning_parts
from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent, make_player_step
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import DECOUPLED, make_train_step as make_expl_train_step
from sheeprl_tpu_torch.algos.p2e_dv3.utils import AGGREGATOR_KEYS
from sheeprl_tpu_torch.utils.registry import register_algorithm

# the task slice: the names of DreamerV3's step -> the names of the checkpoint
TASK_SLICE = {"world_model": "world_model", "actor": "actor_task", "critic": "critic_task", "target_critic": "target_critic_task"}


@register_algorithm(name="p2e_dv3_finetuning")
def main(ctx, cfg) -> TrainResult:
    discrete = cfg.algo.world_model.discrete_size

    def setup(obs_space, actions_dim, is_continuous, log_dir, train_gen) -> LoopParts:
        parts = finetuning_parts(
            ctx, cfg, build_agent, make_expl_train_step, make_dv3_train_step, TASK_SLICE,
            lambda wm, actor, dims, _: make_player_step(wm, actor, dims, discrete), sequential_buffer,
            obs_space, actions_dim, is_continuous, log_dir, train_gen, moments=True,
        )
        return parts._replace(clip_reward=lambda r: np.clip(r, -1, 1), exploration=None)

    return run_loop(ctx, cfg, setup, AGGREGATOR_KEYS, handled=(DECOUPLED,))
