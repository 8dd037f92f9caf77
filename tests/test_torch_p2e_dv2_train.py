"""P2E on DreamerV2: the exploration step of the PyTorch port against the JAX package's.

As ``test_torch_p2e_dv1_train.py`` does for DreamerV1, from the ``p2e_dv2_dummy`` exp: all
eight trees (world model, task and exploration actors, critics and target critics, the
stacked ensembles) carried from the JAX package, one step of each package on the same
batch and the same draws (each imagination's in a field of its own), then every new
parameter, the Adam moments of the six optimizers and the metrics compared at the limits
of ``test_torch_dv2_train.py`` (float32). Two cases: a discrete actor over the image and
vector keys, whose objective is REINFORCE with the target critic's baseline and no
dynamics term, with the hard copies of both critics into their targets (the step's
flag set); a continuous actor (``trunc_normal``) over the vector key, whose objective is
dynamics backpropagation through the imagination, with the continue head on and no
copy. The loop's copy cadence is DreamerV2's (``count_offset=0``: the first step copies).
"""

import pytest
import torch

from tests.test_torch_dv3_agent import OBS_SPACE
from tests.test_torch_p2e_dv1_train import CASES, METRICS, build_p2e_pair, check_p2e_step, few_threads, run_p2e_pair  # noqa: F401

TARGETS = {"target_critic_task": "critic_task", "target_critic_exploration": "critic_exploration"}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_exploration_step_f32_matches_jax(kind):
    from sheeprl_tpu_torch.algos.dreamer_v3.params import params_from_jax

    pair = build_p2e_pair(2, kind)
    old = params_from_jax(pair["params"], pair["modules"])
    check_p2e_step(pair, run_p2e_pair(pair, kind), METRICS)
    # each target critic holds its critic as it stood before the step where the flag is
    # set, and is left as it was where not
    for target, critic in TARGETS.items():
        want = old[critic] if CASES[kind]["update_target"] else old[target]
        assert not torch.equal(old[critic]["head.weight"], old[target]["head.weight"])
        torch.testing.assert_close(pair["modules"][target].state_dict(), want, rtol=0, atol=0)


def test_loop_copies_on_the_first_step_and_every_freq_steps(monkeypatch, tmp_path):
    """The train entry hands the loop ``count_offset=0``: with ``target_update_freq`` f the
    copy flags of steps 0, 1, 2, ... are set at 0, f, 2f, ..., as the reference's block
    (``make_train_block(step, f, 0)``) sets them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sheeprl_tpu.utils.blocks import make_train_block
    from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration
    from sheeprl_tpu_torch.config.core import compose
    from sheeprl_tpu_torch.parallel.context import RunContext
    from sheeprl_tpu_torch.utils.blocks import target_flags

    cfg = compose(overrides=["exp=p2e_dv2_dummy", "env=discrete_dummy", "device=cpu", f"log_root={tmp_path}", "buffer.memmap=False"])
    monkeypatch.setattr(p2e_dv2_exploration, "run_loop", lambda ctx, cfg, setup, keys: setup(OBS_SPACE, (2,), False, str(tmp_path), None))
    parts = p2e_dv2_exploration.main(RunContext(torch.device("cpu"), 0), cfg)
    assert set(parts.modules) == {"world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration", "critic_exploration", "target_critic_exploration", "ensembles"}
    assert set(parts.opt_states) == {"world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles"}
    freq = cfg.algo.critic.per_rank_target_network_update_freq

    def step_fn(carry, batch, key, update_target):
        i, flags = carry
        return (i + 1, flags.at[i].set(update_target)), {}

    block, count = make_train_block(step_fn, freq, 0), 0
    for n in (1, 3, 2, 150):
        (_, flags), _ = block((jnp.asarray(0), jnp.zeros(n, bool)), [jnp.zeros(1)] * n, jax.random.PRNGKey(0), count)
        assert target_flags(count, n, freq, parts.count_offset).tolist() == [bool(f) for f in np.asarray(flags)]
        count += n
