"""Fused RSSM step of the PyTorch port against the JAX package.

The port's plain version (``gru_step_reference``) and its wrapper on CPU tensors
(``gru_step``, which is the plain version there) are held against JAX's
``reference_gru_step`` and against the Pallas kernel ``fused_gru_step``, which runs in
interpret mode off a TPU, on the same numpy inputs, with the JAX package's own shapes
and tolerances (``tests/test_models/test_fused_rssm_step.py``): forward rtol = atol =
1e-5, the five gradients 2e-4, the 8-step scan's states 1e-5 and its weight gradient
2e-4. bf16 operands are held against the f32 reference as
``tests/test_models/test_precision_ops.py`` holds them: forward atol 2e-2, gradients 6e-2.

The tests marked ``cuda`` launch the CUDA kernels at the shapes of ``chip_smoke.py``;
they skip where there is no card. JAX is imported inside the tests that use it, so that
on a machine with the card and without JAX the ``cuda`` tests still run (``pytest
--noconftest -m cuda``).
"""

import math

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops.rssm_step import (
    fused_step_supported,
    geometry,
    gru_step,
    gru_step_backward,
    gru_step_backward_reference,
    gru_step_forward,
    gru_step_reference,
)

FWD_ATOL = 1e-5
GRAD_ATOL = 2e-4
BF16_FWD_ATOL = 2e-2
BF16_GRAD_ATOL = 6e-2
PORT_FNS = {"gru_step_reference": gru_step_reference, "gru_step": gru_step}
NAMES = ("xh", "h", "w", "gamma", "beta")


def _operands(batch, k, hidden, seed):
    """The JAX package's kernel-test operands: xh, h ~ N(0, 1), w ~ 0.05 N(0, 1),
    gamma ~ N(0, 1), beta ~ 0.1 N(0, 1), drawn in this order."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(batch, k)).astype(np.float32),
        rng.normal(size=(batch, hidden)).astype(np.float32),
        rng.normal(size=(k, 3 * hidden)).astype(np.float32) * 0.05,
        rng.normal(size=(3 * hidden,)).astype(np.float32),
        rng.normal(size=(3 * hidden,)).astype(np.float32) * 0.1,
    ), rng


def _precision_operands(seed, batch=8, k=96, hidden=64):
    """``test_precision_ops.py``'s ``_step_operands``: w ~ N(0, 1/K), gamma ~ N(1, 0.1)."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(batch, k)).astype(np.float32),
        rng.normal(size=(batch, hidden)).astype(np.float32),
        rng.normal(scale=k**-0.5, size=(k, 3 * hidden)).astype(np.float32),
        rng.normal(1.0, 0.1, size=(3 * hidden,)).astype(np.float32),
        rng.normal(0.0, 0.1, size=(3 * hidden,)).astype(np.float32),
    )


def _jax_fn(name):
    from sheeprl_tpu.ops import rssm_step

    return getattr(rssm_step, name)


@pytest.mark.parametrize("jax_fn", ["reference_gru_step", "fused_gru_step"])
@pytest.mark.parametrize("port_fn", list(PORT_FNS))
@pytest.mark.parametrize("batch,k,hidden", [(16, 96, 32), (64, 128, 64)])
def test_forward_matches_jax(batch, k, hidden, port_fn, jax_fn):
    import jax.numpy as jnp

    ops, _ = _operands(batch, k, hidden, seed=0)
    ref = np.asarray(_jax_fn(jax_fn)(*(jnp.asarray(o) for o in ops)))
    before = gru_step.launches
    out = PORT_FNS[port_fn](*(torch.from_numpy(o) for o in ops))
    assert gru_step.launches == before, "the CPU path launches no kernel"
    assert out.dtype == torch.float32 and out.shape == (batch, hidden)
    np.testing.assert_allclose(out.numpy(), ref, rtol=FWD_ATOL, atol=FWD_ATOL)


def _jax_grads(jax_fn, ops, tgt):
    import jax
    import jax.numpy as jnp

    fn = _jax_fn(jax_fn)
    grads = jax.grad(lambda *a: jnp.sum((fn(*a) - tgt) ** 2), argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(o) for o in ops))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("jax_fn", ["reference_gru_step", "fused_gru_step"])
def test_gradients_match_jax(jax_fn):
    """``test_fused_step_gradient_parity``'s loss: the port's autograd through the wrapper
    on CPU tensors against ``jax.grad`` (through the Pallas backward kernel for
    ``fused_gru_step``)."""
    ops, rng = _operands(16, 96, 32, seed=1)
    tgt = rng.normal(size=(16, 32)).astype(np.float32)
    ref = _jax_grads(jax_fn, ops, tgt)
    leaves = [torch.from_numpy(o).requires_grad_(True) for o in ops]
    ((gru_step(*leaves) - torch.from_numpy(tgt)) ** 2).sum().backward()
    for name, leaf, r in zip(NAMES, leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=GRAD_ATOL, atol=GRAD_ATOL, err_msg=name)


def test_forward_with_projection_on_cpu_is_the_plain_version():
    """``gru_step_forward`` gives the step and its float32 projection, the backward's
    residual; on the CPU the plain version and ``xh @ w``, with no launch."""
    ops = [torch.from_numpy(o) for o in _operands(6, 40, 32, seed=8)[0]]
    before = gru_step.launches
    out, proj = gru_step_forward(*ops)
    assert gru_step.launches == before
    torch.testing.assert_close(out, gru_step_reference(*ops), rtol=0, atol=0)
    assert proj.dtype == torch.float32 and proj.shape == (6, 96)
    torch.testing.assert_close(proj, ops[0] @ ops[2], rtol=0, atol=0)


def test_backward_wrapper_on_cpu_is_the_plain_version():
    ops = [torch.from_numpy(o) for o in _operands(6, 40, 32, seed=9)[0]]
    g = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    before = gru_step_backward.launches
    got = gru_step_backward(*ops, g, gru_step_forward(*ops)[1])
    assert gru_step_backward.launches == before, "the CPU path launches no kernel"
    for a, b in zip(got, gru_step_backward_reference(*ops, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _torch_rollout(xs, w, gamma, beta):
    w = w.clone().requires_grad_(True)
    h = torch.zeros(xs.shape[1], gamma.shape[0] // 3)
    hs = []
    for x in xs:
        h = gru_step(torch.cat([x, h], -1), h, w, gamma, beta)
        hs.append(h)
    hs = torch.stack(hs)
    (hs**2).sum().backward()
    return hs.detach().numpy(), w.grad.numpy()


@pytest.mark.parametrize("jax_fn", ["reference_gru_step", "fused_gru_step"])
def test_scan_matches_jax(jax_fn):
    """``test_fused_step_in_scan``: 8 steps carrying h; the states and d(sum hs^2)/dw."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    T, batch, k_in, hidden = 8, 16, 32, 32
    xs = rng.normal(size=(T, batch, k_in)).astype(np.float32)
    w = rng.normal(size=(k_in + hidden, 3 * hidden)).astype(np.float32) * 0.05
    gamma, beta = np.ones(3 * hidden, np.float32), np.zeros(3 * hidden, np.float32)
    fn = _jax_fn(jax_fn)

    def run(w_):
        def step(h, x):
            h2 = fn(jnp.concatenate([x, h], -1), h, w_, jnp.asarray(gamma), jnp.asarray(beta))
            return h2, h2

        _, hs = jax.lax.scan(step, jnp.zeros((batch, hidden)), jnp.asarray(xs))
        return jnp.sum(hs**2), hs

    (_, hs_ref), dw_ref = jax.value_and_grad(run, has_aux=True)(jnp.asarray(w))
    hs, dw = _torch_rollout(*(torch.from_numpy(a) for a in (xs, w, gamma, beta)))
    np.testing.assert_allclose(hs, np.asarray(hs_ref), rtol=FWD_ATOL, atol=FWD_ATOL)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), rtol=GRAD_ATOL, atol=GRAD_ATOL)


def test_bf16_forward_tracks_jax_f32_reference():
    import jax.numpy as jnp

    ops = _precision_operands(2)
    ref = np.asarray(_jax_fn("reference_gru_step")(*(jnp.asarray(o) for o in ops)))
    out = gru_step(*(torch.from_numpy(o).bfloat16() for o in ops))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_FWD_ATOL)


def test_bf16_gradients_track_jax_f32_reference():
    import jax
    import jax.numpy as jnp

    ops = _precision_operands(3)
    fn = _jax_fn("reference_gru_step")
    ref = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32)), argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(o) for o in ops))
    leaves = [torch.from_numpy(o).bfloat16().requires_grad_(True) for o in ops]
    gru_step(*leaves).float().sum().backward()
    for name, leaf, r in zip(NAMES, leaves, ref):
        assert leaf.grad.dtype == torch.bfloat16, name
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(r), atol=BF16_GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize(
    "batch,k,hidden,itemsize",
    [
        (16, 1024, 512, 2),
        (16, 1024, 512, 4),
        (256, 1024, 512, 4),
        (16, 96, 32, 4),
        (64, 128, 64, 4),
        (8, 96, 64, 4),
        (256, 8192, 512, 4),
        (16, 8192, 512, 4),
    ],
)
def test_budget_takes_size_s_and_the_jax_test_shapes(batch, k, hidden, itemsize):
    """Size S, B = 256 and the JAX package's test shapes; and K = 8192, which the design
    of one cluster per row tile refused and the split design takes: K no longer bounds
    the shared memory (the card holds both rows to the plain version,
    ``test_cuda_kernels_match_plain_version_at_long_k``)."""
    assert fused_step_supported(batch, k, hidden, itemsize)


@pytest.mark.parametrize(
    "batch,k,hidden,itemsize",
    [(512, 4096, 4096, 4), (16, 1020, 512, 2), (16, 1024, 48, 4), (16, 1024, 1024, 2), (16, 1024, 544, 4), (512, 1024, 512, 4)],
)
def test_budget_refuses_what_the_kernel_does_not_take(batch, k, hidden, itemsize):
    """Past VMEM's budget in the JAX package's own test; K not a multiple of 8; H not a
    multiple of 32, or above 512 (1,024 and the next multiple of 32, 544); B past the
    JAX budget's cap of 256."""
    assert not fused_step_supported(batch, k, hidden, itemsize)


@pytest.mark.parametrize(
    "batch,k,itemsize,backward,nbytes",
    [
        (16, 1024, 4, False, 49_680),
        (16, 1024, 2, False, 49_680),
        (16, 1024, 4, True, 203_040),
        (16, 1024, 2, True, 182_944),
        (256, 1024, 4, True, 203_040),
        (256, 1024, 2, True, 182_944),
        (256, 1024, 4, False, 86_544),
        (256, 1024, 2, False, 86_544),
    ],
)
def test_shared_memory_is_the_kernels_layout(batch, k, itemsize, backward, nbytes):
    """``geometry``'s ``fwd_smem`` / ``prod_smem`` are those of ``csrc/rssm_step.cu``, which
    it restates, at H = 512: the forward's product-pass block (its row tiles grow with B up
    to 4; the two tiles of its K-slice in flight), the backward's product-pass block
    (independent of B and K), at size S and at B = 256."""
    assert geometry(batch, k, 512, itemsize)["prod_smem" if backward else "fwd_smem"] == nbytes


@pytest.mark.parametrize(
    "batch,itemsize,want",
    [
        (16, 2, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=1, groups=1, dp_rows=16, dp_ld=1544, prod_blocks=128)),
        (16, 4, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=1, groups=1, dp_rows=16, dp_ld=1540, prod_blocks=128)),
        (13, 4, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=1, groups=1, dp_rows=16, dp_ld=1540, prod_blocks=128)),
        (64, 2, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=4, groups=1, dp_rows=64, dp_ld=1544, prod_blocks=128)),
        (64, 4, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=4, groups=1, dp_rows=64, dp_ld=1540, prod_blocks=128)),
        (256, 2, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=4, groups=4, dp_rows=256, dp_ld=1544, prod_blocks=128)),
        (256, 4, dict(col_blocks=12, slice_k=128, slices=8, row_tiles=4, groups=4, dp_rows=256, dp_ld=1540, prod_blocks=128)),
    ],
)
def test_geometry_is_the_kernels_launch(batch, itemsize, want):
    """The grids and workspaces the wrapper sizes at K = 1024, H = 512: the forward's
    product pass's 12 blocks of 128 projection columns x 8 K-slices of 128 rows x row groups of up to 64, and the backward's
    dp workspace (rows padded to the product pass's tile, 16 in bf16 and 8 in float32;
    3H plus 16 bytes per row) and its 1024 / 8 product blocks."""
    geo = geometry(batch, 1024, 512, itemsize)
    assert {name: geo[name] for name in want} == want


def _bad_operands(case):
    xh, h, w = torch.zeros(4, 16), torch.zeros(4, 32), torch.zeros(16, 96)
    gamma, beta = torch.ones(96), torch.zeros(96)
    if case == "shape":
        return xh, h, w[:, :48].contiguous(), gamma, beta
    if case == "xw_dtype":
        return xh.bfloat16(), h, w, gamma, beta
    if case == "half":
        return xh.half(), h, w.half(), gamma, beta
    if case == "gamma_dtype":
        return xh, h, w, gamma.double(), beta
    if case == "contiguous":
        return torch.zeros(16, 4).t(), h, w, gamma, beta
    if case == "aligned":
        return torch.zeros(1 + 4 * 16)[1:].view(4, 16), h, w, gamma, beta
    if case == "k":
        return torch.zeros(4, 12), h, torch.zeros(12, 96), gamma, beta
    if case == "hidden":
        return xh, torch.zeros(4, 48), torch.zeros(16, 144), torch.ones(144), torch.zeros(144)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case,error",
    [
        ("shape", ValueError),
        ("xw_dtype", TypeError),
        ("half", TypeError),
        ("gamma_dtype", TypeError),
        ("contiguous", ValueError),
        ("aligned", ValueError),
        ("k", ValueError),
        ("hidden", ValueError),
    ],
)
def test_kernel_checks_reject_what_the_kernel_does_not_take(case, error):
    from sheeprl_tpu_torch.ops.rssm_step import _check

    with pytest.raises(error):
        _check(*_bad_operands(case))


def test_kernel_checks_take_the_mixed_types_of_the_scan():
    from sheeprl_tpu_torch.ops.rssm_step import _check

    xh, h, w, gamma, beta = torch.zeros(4, 16), torch.zeros(4, 32), torch.zeros(16, 96), torch.ones(96), torch.zeros(96)
    _check(xh.bfloat16(), h, w.bfloat16(), gamma, beta)
    _check(xh.bfloat16(), h.bfloat16(), w.bfloat16(), gamma.bfloat16(), beta.bfloat16())


@pytest.mark.parametrize("case", ["shape", "dtype", "contiguous"])
def test_backward_checks_reject_a_gradient_the_kernel_does_not_take(case):
    from sheeprl_tpu_torch.ops.rssm_step import _check_grad

    h = torch.zeros(4, 32)
    g = {"shape": torch.zeros(4, 33), "dtype": torch.zeros(4, 32, dtype=torch.bfloat16), "contiguous": torch.zeros(32, 4).t()}[case]
    _check_grad(h, torch.zeros(4, 32))
    with pytest.raises(ValueError):
        _check_grad(h, g)


def test_wrappers_refuse_other_devices():
    meta = [torch.zeros(2, 8, device="meta"), torch.zeros(2, 32, device="meta"), torch.zeros(8, 96, device="meta")]
    with pytest.raises(ValueError):
        gru_step(*meta, torch.ones(96), torch.zeros(96))
    with pytest.raises(ValueError):
        gru_step_backward(*meta, torch.ones(96), torch.zeros(96), torch.zeros(2, 32, device="meta"), torch.zeros(2, 96, device="meta"))


# ----- on the card ---------------------------------------------------------------------

CARD_SHAPES = [(16, 1024, 512), (13, 1024, 512), (64, 1024, 512), (256, 1024, 512)]
CARD_TYPES = {
    "float32": (torch.float32, torch.float32, torch.float32),
    "bfloat16": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    "bf16_xw": (torch.bfloat16, torch.float32, torch.float32),
}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_operands(batch, k, hidden, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (
        torch.randn(batch, k, device=device, generator=g),
        torch.randn(batch, hidden, device=device, generator=g),
        torch.randn(k, 3 * hidden, device=device, generator=g) * k**-0.5,
        1 + 0.1 * torch.randn(3 * hidden, device=device, generator=g),
        0.1 * torch.randn(3 * hidden, device=device, generator=g),
        torch.randn(batch, hidden, device=device, generator=g),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("types", list(CARD_TYPES))
@pytest.mark.parametrize("batch,k,hidden", CARD_SHAPES)
def test_cuda_forward_kernel_matches_plain_version(cuda_device, batch, k, hidden, types):
    ti, th, tg = CARD_TYPES[types]
    xh, h, w, gamma, beta, _ = _card_operands(batch, k, hidden, cuda_device, seed=0)
    args = (xh.to(ti), h.to(th), w.to(ti), gamma.to(tg), beta.to(tg))
    before = gru_step.launches
    out = gru_step(*args)
    torch.cuda.synchronize()
    assert gru_step.launches == before + 1
    assert out.dtype == th
    atol = FWD_ATOL if th == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), gru_step_reference(*args).float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("types", list(CARD_TYPES))
@pytest.mark.parametrize("batch,k,hidden", CARD_SHAPES)
def test_cuda_backward_kernel_matches_plain_version(cuda_device, batch, k, hidden, types):
    """Through autograd against autograd through the plain version on f32 inputs: f32
    atol 2e-4; with bf16 operands 6e-2, and for the gradients that sum the rows (dw,
    dgamma, dbeta) 6e-2 * sqrt(max(B, 8) / 8), as ``chip_smoke.py``.

    With bf16 operands also against autograd through the plain version on the same bf16
    operands, which leaves out their rounding: each entry within one bf16 rounding
    (2^-7 of its value) plus 2^-8 of the gradient's largest entry. The JAX package's
    kernel, in interpret mode at these shapes, stays within 0.0021 of the largest entry
    past one rounding, and reaches 0.079 on dw at B = 16 against float32 operands
    (``python -m tests.torch_rssm_step_bf16_readings``)."""
    ti, th, tg = CARD_TYPES[types]
    xh, h, w, gamma, beta, g = _card_operands(batch, k, hidden, cuda_device, seed=1)
    ref = gru_step_backward_reference(xh, h, w, gamma, beta, g)
    leaves = [t.detach().requires_grad_(True) for t in (xh.to(ti), h.to(th), w.to(ti), gamma.to(tg), beta.to(tg))]
    same = gru_step_backward_reference(*leaves, g.to(th))
    before = gru_step_backward.launches
    torch.autograd.backward(gru_step(*leaves), g.to(th))
    torch.cuda.synchronize()
    assert gru_step_backward.launches == before + 1
    for name, leaf, r, s in zip(NAMES, leaves, ref, same):
        assert leaf.grad.dtype == leaf.dtype, name
        got = leaf.grad.float()
        atol = GRAD_ATOL if types == "float32" else BF16_GRAD_ATOL * (math.sqrt(max(batch, 8) / 8) if name in ("w", "gamma", "beta") else 1.0)
        torch.testing.assert_close(got, r.float(), atol=atol, rtol=0, msg=lambda m: f"{name}: {m}")
        if types != "float32":
            s = s.float()
            torch.testing.assert_close(got, s, atol=2**-8 * s.abs().max().item(), rtol=2**-7, msg=lambda m: f"{name} (same bf16 operands): {m}")


def _card_args(batch, k, hidden, types, device, seed):
    ti, th, tg = CARD_TYPES[types]
    xh, h, w, gamma, beta, g = _card_operands(batch, k, hidden, device, seed)
    return (xh.to(ti), h.to(th), w.to(ti), gamma.to(tg), beta.to(tg)), g.to(th)


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["bf16_xw", "float32"])
@pytest.mark.parametrize("batch", [16, 256])
def test_cuda_kernels_give_the_same_bits_twice(cuda_device, batch, types):
    """Every sum runs in a fixed order and no float atomic is used: two forward calls
    give bit-identical h', two backward calls bit-identical dxh, dh, dw, dgamma and dbeta."""
    args, g = _card_args(batch, 1024, 512, types, cuda_device, seed=4)
    (first, proj), (second, _) = gru_step_forward(*args), gru_step_forward(*args)
    grads = [gru_step_backward(*args, g, proj), gru_step_backward(*args, g, proj)]
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for name, a, b in zip(("dxh", "dh", "dw", "dgamma", "dbeta"), *grads):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,hidden", CARD_SHAPES + [(16, 96, 32), (64, 128, 64), (8, 96, 64)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_cuda_geometry_is_the_wrappers(cuda_device, batch, k, hidden, itemsize):
    """The built source's geometry (``rssm_step_geometry``) is the wrapper's restatement,
    by which it sizes the workspaces."""
    from sheeprl_tpu_torch.ops.rssm_step import kernel_geometry

    assert kernel_geometry(batch, k, hidden, itemsize) == geometry(batch, k, hidden, itemsize)


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["bf16_xw", "float32"])
def test_cuda_kernels_replay_in_a_graph(cuda_device, types):
    """A CUDA graph of a forward and a backward call, replayed three times, gives the eager
    calls' bits each time: the kernels keep no state between launches and the workspaces
    are written in full before they are read."""
    args, g = _card_args(64, 1024, 512, types, cuda_device, seed=5)
    want_out, proj = gru_step_forward(*args)
    want_grads = gru_step_backward(*args, g, proj)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gru_step_backward(*args, g, gru_step_forward(*args)[1])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, proj = gru_step_forward(*args)
        grads = gru_step_backward(*args, g, proj)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want_out)
        for a, b in zip(grads, want_grads):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,hidden", [(16, 96, 32), (64, 128, 64), (8, 96, 64), (250, 200, 96)])
def test_cuda_kernels_match_plain_version_at_small_shapes(cuda_device, batch, k, hidden):
    """The JAX test shapes and a ragged one (B past a row group, K not a multiple of the
    TMA box, one K-slice short), float32, forward and backward."""
    args, g = _card_args(batch, k, hidden, "float32", cuda_device, seed=6)
    out, proj = gru_step_forward(*args)
    torch.testing.assert_close(out, gru_step_reference(*args), atol=FWD_ATOL, rtol=0)
    for name, got, want in zip(NAMES, gru_step_backward(*args, g, proj), gru_step_backward_reference(*args, g)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0, msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,types", [(16, 2048, "bf16_xw"), (256, 2048, "bfloat16"), (16, 8192, "float32"), (256, 8192, "bf16_xw")])
def test_cuda_kernels_match_plain_version_at_long_k(cuda_device, batch, k, types):
    """K past size S's, where a forward K-slice holds more than its two tiles in flight
    (4 tiles at K = 2048 in bf16, 16 at K = 8192 in bf16, 32 in float32): forward and
    backward against the plain version, held as the size-S rows are."""
    args, g = _card_args(batch, k, 512, types, cuda_device, seed=7)
    th = args[1].dtype
    out, proj = gru_step_forward(*args)
    torch.testing.assert_close(out.float(), gru_step_reference(*args).float(), atol=FWD_ATOL if th == torch.float32 else 1e-2, rtol=0)
    f32 = [t.float() for t in args]
    for name, got, want in zip(NAMES, gru_step_backward(*args, g, proj), gru_step_backward_reference(*f32, g.float())):
        atol = GRAD_ATOL if types == "float32" else BF16_GRAD_ATOL * (math.sqrt(max(batch, 8) / 8) if name in ("w", "gamma", "beta") else 1.0)
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=0, msg=lambda m: f"{name}: {m}")
