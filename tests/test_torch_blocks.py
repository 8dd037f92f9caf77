"""``MLP`` and ``LayerNormGRUCell`` of the PyTorch port against the JAX package's Flax
blocks, with the Flax parameters carried across (``module_state_from_jax``).

Tolerance: atol 1e-5 in float32 (sums in another order; the MLP's LayerNorm copies
Flax's ``E[x^2] - E[x]^2`` variance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.params import module_state_from_jax
from sheeprl_tpu_torch.models.blocks import MLP, LayerNormGRUCell

ATOL = 1e-5


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (np.asarray(x) + rng.normal(0.0, 0.1, x.shape)).astype(np.float32), params)


@pytest.mark.parametrize("layer_norm,output_dim", [(True, None), (False, 7)])
def test_mlp_matches_flax(layer_norm, output_dim):
    from sheeprl_tpu.models.blocks import MLP as FlaxMLP

    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    fmlp = FlaxMLP(hidden_sizes=(16, 16), output_dim=output_dim, activation="silu", layer_norm=layer_norm, norm_eps=1e-3)
    params = _perturbed(jax.device_get(fmlp.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 1)
    ref = fmlp.apply({"params": params}, x)
    mlp = MLP(12, (16, 16), output_dim, activation="silu", layer_norm=layer_norm, norm_eps=1e-3)
    mlp.load_state_dict(module_state_from_jax(params, mlp))
    with torch.no_grad():
        out = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _check_gru_cell(lead, hidden, in_dim):
    from sheeprl_tpu.models.blocks import LayerNormGRUCell as FlaxCell

    rng = np.random.default_rng(2)
    h = rng.normal(size=(*lead, hidden)).astype(np.float32)
    x = rng.normal(size=(*lead, in_dim)).astype(np.float32)
    fcell = FlaxCell(hidden_size=hidden)
    params = _perturbed(jax.device_get(fcell.init(jax.random.PRNGKey(1), h, x)["params"]), 3)
    ref, _ = fcell.apply({"params": params}, h, x)
    cell = LayerNormGRUCell(in_dim, hidden)
    cell.load_state_dict(
        {
            "linear.weight": torch.from_numpy(np.ascontiguousarray(params["Dense_0"]["kernel"].T)),
            "ln_scale": torch.from_numpy(params["ln_scale"]),
            "ln_bias": torch.from_numpy(params["ln_bias"]),
        }
    )
    with torch.no_grad():
        out = cell(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_layernorm_gru_cell_matches_flax(fused, monkeypatch):
    """Against both paths of the Flax cell: the plain one and the Pallas kernel
    (interpret mode)."""
    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    _check_gru_cell((8,), 32, 24)


@pytest.mark.parametrize("fused", ["0", "1"])
def test_layernorm_gru_cell_folds_leading_axes(fused, monkeypatch):
    """``[2, 5, H]`` state: the port folds the leading axes into the kernel's batch and
    back. (The Flax cell runs its plain path for inputs that are not 2-D.)"""
    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", fused)
    _check_gru_cell((2, 5), 16, 8)
