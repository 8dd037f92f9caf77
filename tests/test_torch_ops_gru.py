"""LayerNorm-GRU gate step of the PyTorch port against the JAX package.

The port's plain version (``layernorm_gru_reference``) and its wrapper on CPU tensors
are held against JAX's ``reference_layernorm_gru`` and against the Pallas kernel
``fused_layernorm_gru`` run in interpret mode (``SHEEPRL_TPU_FUSED_GRU=1``), on the same
numpy inputs. f32 tolerance: atol 1e-5, as the JAX package's own kernel test
(``tests/test_models/test_fused_gru.py``). bf16 inputs are held against the f32
reference, as ``tests/test_models/test_precision_ops.py`` does.

Gradients: the port's path (autograd through the wrapper on CPU tensors, which is the
plain version of the backward kernel) against ``jax.grad`` through both JAX functions,
f32 atol 2e-4 (the JAX package's own kernel-gradient bound) and, for bf16 inputs
against the f32 reference, atol 6e-2 (``test_precision_ops.py``'s ``GRAD_ATOL``).

The tests marked ``cuda`` launch the CUDA kernels; they skip where there is no card.
JAX is imported inside the tests that use it, so that on a machine with the card and
without JAX the ``cuda`` test still runs (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops.gru import (
    layernorm_gru,
    layernorm_gru_backward,
    layernorm_gru_backward_reference,
    layernorm_gru_reference,
)

F32_ATOL = 1e-5
# bf16 keeps an 8-bit mantissa (~0.4% relative); the gate chain compounds it
# (the JAX package's test_precision_ops.py uses the same bound).
BF16_ATOL = 2e-2

SHAPES = [(8, 128), (12, 128), (16, 256)]
GRAD_F32_ATOL = 2e-4
GRAD_BF16_ATOL = 6e-2


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


def _jax_grads(fn_name, ops, g):
    """``(dproj, dh, dgamma, dbeta)`` of ``sum(out * g)`` through the JAX function."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.ops import gru as jgru

    fn = getattr(jgru, fn_name)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * g), argnums=(0, 1, 2, 3))(*(jnp.asarray(o) for o in ops))
    return [np.asarray(x, np.float32) for x in grads]


@pytest.mark.parametrize("batch,hidden", SHAPES)
@pytest.mark.parametrize("jax_fn", ["fused_layernorm_gru", "reference_layernorm_gru"])
def test_port_gradients_match_jax(batch, hidden, jax_fn, monkeypatch):
    """``fused_layernorm_gru`` runs the Pallas forward and backward kernels in interpret
    mode; ``reference_layernorm_gru`` is differentiated by JAX itself."""
    monkeypatch.setenv("SHEEPRL_TPU_FUSED_GRU", "1")
    ops = _operands(batch, hidden, seed=5)
    g = np.random.default_rng(6).normal(size=(batch, hidden)).astype(np.float32)
    ref = _jax_grads(jax_fn, ops, g)
    leaves = [torch.from_numpy(o).requires_grad_(True) for o in ops]
    torch.autograd.backward(layernorm_gru(*leaves), torch.from_numpy(g))
    for leaf, r, name in zip(leaves, ref, ["proj", "h", "gamma", "beta"]):
        np.testing.assert_allclose(leaf.grad.numpy(), r, atol=GRAD_F32_ATOL, err_msg=name)


def test_port_bf16_gradients_track_jax_f32_reference():
    ops = _operands(8, 128, seed=7)
    g = np.random.default_rng(8).normal(size=(8, 128)).astype(np.float32)
    ref = _jax_grads("reference_layernorm_gru", ops, g)
    proj, h, gamma, beta = (torch.from_numpy(o) for o in ops)
    grads = layernorm_gru_backward(proj.bfloat16(), h.bfloat16(), gamma, beta, torch.from_numpy(g).bfloat16())
    assert [t.dtype for t in grads] == [torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]
    for got, r, name in zip(grads, ref, ["proj", "h", "gamma", "beta"]):
        np.testing.assert_allclose(got.float().numpy(), r, atol=GRAD_BF16_ATOL, err_msg=name)


def test_backward_wrapper_on_cpu_is_the_plain_version():
    ops = [torch.from_numpy(o) for o in _operands(6, 32, seed=9)]
    g = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    before = layernorm_gru_backward.launches
    got = layernorm_gru_backward(*ops, g)
    assert layernorm_gru_backward.launches == before, "the CPU path launches no kernel"
    for a, b in zip(got, layernorm_gru_backward_reference(*ops, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(1, 512), (16, 512), (1024, 512), (16, 4096), (300, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_kernel_matches_plain_version(cuda_device, batch, hidden, dtype):
    """The backward kernel through autograd against autograd through the plain
    version on f32 inputs: f32 atol 2e-4, bf16 atol 6e-2."""
    ops = [torch.from_numpy(o).to(cuda_device) for o in _operands(batch, hidden, seed=10)]
    g = torch.from_numpy(np.random.default_rng(11).normal(size=(batch, hidden)).astype(np.float32)).to(cuda_device)
    ref = layernorm_gru_backward_reference(*ops, g)
    leaves = [ops[0].to(dtype), ops[1].to(dtype), ops[2], ops[3]]
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    before = layernorm_gru_backward.launches
    torch.autograd.backward(layernorm_gru(*leaves), g.to(dtype))
    torch.cuda.synchronize()
    assert layernorm_gru_backward.launches == before + 1
    atol = GRAD_F32_ATOL if dtype == torch.float32 else GRAD_BF16_ATOL
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.dtype == leaf.dtype
        torch.testing.assert_close(leaf.grad.float(), r.float(), atol=atol, rtol=0)


def _bad_operands(case):
    proj, h, gamma, beta = torch.zeros(4, 24), torch.zeros(4, 8), torch.ones(24), torch.zeros(24)
    if case == "shape":
        return proj[:, :12], h, gamma, beta
    if case == "dtype":
        return proj.half(), h.half(), gamma, beta
    if case == "gamma_dtype":
        return proj, h, gamma.double(), beta
    return torch.zeros(24, 4).t(), h, gamma, beta  # contiguous


@pytest.mark.parametrize(
    "case,error",
    [("shape", ValueError), ("dtype", TypeError), ("gamma_dtype", TypeError), ("contiguous", ValueError)],
)
def test_kernel_checks_reject_what_the_kernel_does_not_take(case, error):
    from sheeprl_tpu_torch.ops.gru import _check

    with pytest.raises(error):
        _check(*_bad_operands(case))


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguous"])
def test_backward_checks_reject_a_gradient_the_kernel_does_not_take(case):
    from sheeprl_tpu_torch.ops.gru import _check_grad

    h = torch.zeros(4, 8)
    g = {"shape": torch.zeros(4, 9), "dtype": torch.zeros(4, 8, dtype=torch.bfloat16), "contiguous": torch.zeros(8, 4).t()}[case]
    _check_grad(h, torch.zeros(4, 8))
    with pytest.raises(ValueError):
        _check_grad(h, g)


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        layernorm_gru(torch.zeros(2, 6, device="meta"), torch.zeros(2, 2, device="meta"), torch.ones(6), torch.zeros(6))
