"""LayerNorm-GRU gate step of the PyTorch port against the JAX package.

The port's plain version (``layernorm_gru_reference``) and its wrapper on CPU tensors
are held against JAX's ``reference_layernorm_gru`` and against the Pallas kernel
``fused_layernorm_gru`` run in interpret mode (``SHEEPRL_TPU_FUSED_GRU=1``), on the same
numpy inputs. f32 tolerance: atol 1e-5, as the JAX package's own kernel test
(``tests/test_models/test_fused_gru.py``). bf16 inputs are held against the f32
reference, as ``tests/test_models/test_precision_ops.py`` does.

The test marked ``cuda`` launches the CUDA kernel; it skips where there is no card.
JAX is imported inside the tests that use it, so that on a machine with the card and
without JAX the ``cuda`` test still runs (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops.gru import layernorm_gru, layernorm_gru_reference

F32_ATOL = 1e-5
# bf16 keeps an 8-bit mantissa (~0.4% relative); the gate chain compounds it
# (the JAX package's test_precision_ops.py uses the same bound).
BF16_ATOL = 2e-2

SHAPES = [(8, 128), (12, 128), (16, 256)]


def _operands(batch, hidden, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(batch, 3 * hidden)).astype(np.float32),
        rng.normal(size=(batch, hidden)).astype(np.float32),
        rng.normal(1.0, 0.1, size=(3 * hidden,)).astype(np.float32),
        rng.normal(0.0, 0.1, size=(3 * hidden,)).astype(np.float32),
    )


def _jax_reference(ops):
    import jax.numpy as jnp

    from sheeprl_tpu.ops.gru import reference_layernorm_gru

    return np.asarray(reference_layernorm_gru(*(jnp.asarray(o) for o in ops)))


@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_plain_version_matches_jax_reference(batch, hidden):
    ops = _operands(batch, hidden)
    ref = _jax_reference(ops)
    out = layernorm_gru_reference(*(torch.from_numpy(o) for o in ops))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_wrapper_on_cpu_matches_pallas_kernel_interpret(batch, hidden, monkeypatch):
    import jax.numpy as jnp

    from sheeprl_tpu.ops.gru import fused_layernorm_gru

    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", "1")
    ops = _operands(batch, hidden, seed=1)
    fused = np.asarray(fused_layernorm_gru(*(jnp.asarray(o) for o in ops)))
    before = layernorm_gru.launches
    out = layernorm_gru(*(torch.from_numpy(o) for o in ops))
    assert layernorm_gru.launches == before, "the CPU path launches no kernel"
    np.testing.assert_allclose(out.numpy(), fused, atol=F32_ATOL)


def test_plain_version_bf16_tracks_f32_reference():
    ops = _operands(8, 128, seed=2)
    ref = _jax_reference(ops)
    proj, h, gamma, beta = (torch.from_numpy(o) for o in ops)
    out = layernorm_gru_reference(proj.bfloat16(), h.bfloat16(), gamma, beta)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_ATOL)


def test_plain_version_takes_leading_batch_dims():
    ops = _operands(12, 64, seed=3)
    ref = _jax_reference(ops)
    proj, h, gamma, beta = (torch.from_numpy(o) for o in ops)
    out = layernorm_gru_reference(proj.reshape(3, 4, -1), h.reshape(3, 4, -1), gamma, beta)
    np.testing.assert_allclose(out.reshape(12, -1).numpy(), ref, atol=F32_ATOL)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(1, 512), (13, 512), (1024, 512), (16, 4096), (3, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda_device, batch, hidden, dtype):
    proj, h, gamma, beta = (torch.from_numpy(o).to(cuda_device) for o in _operands(batch, hidden, seed=4))
    proj, h = proj.to(dtype), h.to(dtype)
    before = layernorm_gru.launches
    out = layernorm_gru(proj, h, gamma, beta)
    torch.cuda.synchronize()
    assert layernorm_gru.launches == before + 1
    assert out.dtype == dtype
    ref = layernorm_gru_reference(proj, h, gamma, beta)
    atol = F32_ATOL if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


def _bad_operands(case):
    proj, h, gamma, beta = torch.zeros(4, 24), torch.zeros(4, 8), torch.ones(24), torch.zeros(24)
    if case == "shape":
        return proj[:, :12], h, gamma, beta
    if case == "dtype":
        return proj.half(), h.half(), gamma, beta
    if case == "gamma_dtype":
        return proj, h, gamma.double(), beta
    if case == "contiguous":
        return torch.zeros(24, 4).t(), h, gamma, beta
    return proj.requires_grad_(), h, gamma, beta  # grad: no backward kernel yet


@pytest.mark.parametrize(
    "case,error",
    [("shape", ValueError), ("dtype", TypeError), ("gamma_dtype", TypeError), ("contiguous", ValueError), ("grad", RuntimeError)],
)
def test_kernel_checks_reject_what_the_kernel_does_not_take(case, error):
    from sheeprl_tpu_torch.ops.gru import _check

    with pytest.raises(error):
        _check(*_bad_operands(case))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        layernorm_gru(torch.zeros(2, 6, device="meta"), torch.zeros(2, 2, device="meta"), torch.ones(6), torch.zeros(6))
