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

The kernels' launch plan (``geometry``) is checked on the CPU: every row covered once,
the clusters, where the backward is one launch, the scratch it sizes. The tests marked
``cuda`` launch the CUDA kernels; they skip where there is no card.
JAX is imported inside the tests that use it, so that on a machine with the card and
without JAX the ``cuda`` test still runs (``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops.gru import (
    MAX_CLUSTER,
    _cdiv,
    geometry,
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


# Shapes for the launch plan: the model's (16 and 1024 rows at H = 512), the eval entry's
# one row, ragged batches around the cluster and tile edges, and every path.
PLAN_BATCHES = [1, 8, 13, 16, 17, 63, 64, 65, 128, 129, 1024, 1025, 4096]


def bwd_rows(geo, batch, cta, group):
    """The rows that row group ``group`` of backward CTA ``cta`` walks (the source's
    indexing: ``cta * rows_per_cta * rows_per_group + group + j * rows_per_cta``), rows
    past the batch left out."""
    rpc, rpg = geo["rows_per_cta"], geo["rows_per_group"]
    first = cta * rpc * rpg + group
    return [r for r in range(first, first + rpg * rpc, rpc) if r < batch]
PLAN_HIDDEN = [64, 200, 512, 600, 2048, 2056, 4096, 5000, 16384]


@pytest.mark.parametrize("hidden", PLAN_HIDDEN)
@pytest.mark.parametrize("aligned", [True, False])
def test_geometry_covers_every_row_once(hidden, aligned):
    """The forward's CTAs (one row a group) and the backward's CTAs (each group walking
    ``rows_per_group`` rows) take every row of the batch exactly once; a group is whole
    warps, a CTA at most 1024 threads, and a thread's units per segment cover H."""
    for batch in PLAN_BATCHES:
        geo = geometry(batch, hidden, aligned)
        tpr, rpc = geo["threads_per_row"], geo["rows_per_cta"]
        assert tpr % 32 == 0 and tpr * rpc <= 1024 and (geo["path"] == 1 or tpr * geo["units"] >= hidden)
        fwd = sorted(cta * rpc + k for cta in range(geo["fwd_grid"]) for k in range(rpc) if cta * rpc + k < batch)
        assert fwd == list(range(batch)), (batch, geo)
        bwd = [r for cta in range(geo["bwd_grid"]) for k in range(rpc) for r in bwd_rows(geo, batch, cta, k)]
        assert sorted(bwd) == list(range(batch)), (batch, geo)
        whole = 4 if geo["path"] == 1 else geo["units"]
        assert geo["vec"] == (whole if aligned and hidden % whole == 0 else 1)


@pytest.mark.parametrize("hidden", PLAN_HIDDEN)
def test_geometry_clusters_divide_the_grid(hidden):
    """A backward cluster has at most 16 CTAs (8 on the two-launch path), a power of two
    that divides the grid; the two-launch path has at most 128 CTAs that hold rows and
    one partial row per cluster (per CTA on the wide path); a CTA's slots, one share of
    the 2 x 3H columns per group of its cluster, stay under the 48 KB a CTA takes without
    opting in to more, and a single CTA with a single group needs none."""
    from sheeprl_tpu_torch.ops.gru import share_of

    for batch in PLAN_BATCHES:
        geo = geometry(batch, hidden)
        cluster, grid = geo["cluster"], geo["bwd_grid"]
        assert cluster <= MAX_CLUSTER and cluster & (cluster - 1) == 0 and grid % cluster == 0, (batch, geo)
        rows_per_cta = geo["rows_per_cta"] * geo["rows_per_group"]
        assert -(-batch // rows_per_cta) <= 128 or geo["bwd_launches"] == 1, (batch, geo)
        assert grid - -(-batch // rows_per_cta) < cluster, "no cluster is idle"
        if geo["bwd_launches"] == 2:
            assert geo["partial_rows"] == (grid if geo["path"] == 1 else grid // 8) and (geo["path"] == 1 or cluster == 8)
        slots = geo["path"] == 0 and (cluster > 1 or geo["rows_per_cta"] > 1)
        share = share_of(6 * hidden, cluster)
        assert share % 8 == 0 and share * cluster >= 6 * hidden
        assert geo["bwd_smem"] == (cluster * geo["rows_per_cta"] * share * 4 if slots else 0) <= 48 * 1024


@pytest.mark.parametrize("hidden", PLAN_HIDDEN)
def test_geometry_is_one_launch_where_the_ctas_fit_one_cluster(hidden):
    """The backward is one launch, with no scratch, exactly where its CTAs at one row a
    group fit one cluster of 16 (the wide path: where the batch is one CTA); else two."""
    for batch in PLAN_BATCHES:
        geo = geometry(batch, hidden)
        fits = geo["fwd_grid"] <= 16 if geo["path"] == 0 else geo["bwd_grid"] == 1
        assert geo["bwd_launches"] == (1 if fits else 2), (batch, geo)
        assert (geo["partial_rows"] == 0) == fits
        if fits and geo["path"] == 0:
            assert geo["rows_per_group"] == 1 and geo["bwd_grid"] < 2 * geo["fwd_grid"]


def test_geometry_at_the_models_shapes():
    """DreamerV3-S's GRU (H = 512). The unroll's 16 rows: 2 units a thread, 256 threads
    (8 warps) per row, one row per CTA, the backward one launch of a cluster of 16. The
    imagination's 1024 rows: 4 units a thread, 128 threads per row, two rows per CTA, the
    backward 128 CTAs walking 4 rows a group, 16 clusters of 8 and 16 partial rows. The eval
    entry's one row: one CTA whose backward writes dgamma/dbeta itself (no shared memory)."""
    small, large = geometry(16, 512), geometry(1024, 512)
    assert (small["units"], small["threads_per_row"], small["rows_per_cta"], small["fwd_grid"]) == (2, 256, 1, 16)
    assert (small["bwd_launches"], small["cluster"], small["bwd_grid"], small["partial_rows"]) == (1, 16, 16, 0)
    assert (large["units"], large["threads_per_row"], large["rows_per_cta"], large["fwd_grid"]) == (4, 128, 2, 512)
    assert (large["bwd_grid"], large["rows_per_group"], large["bwd_launches"], large["cluster"], large["partial_rows"]) == (128, 4, 2, 8, 16)
    single = geometry(1, 512)
    assert (single["bwd_grid"], single["cluster"], single["bwd_smem"]) == (1, 1, 0)
    assert geometry(1, 16384)["bwd_launches"] == 1


def test_geometry_at_dreamer_v2s_width():
    """DreamerV2's GRU (H = 600). The unroll's 16 rows: 2 units a thread would take 320
    threads, over a CTA's 256, so 4 units a thread, 160 threads a row of which 150 own
    units (the first plan whose row has a partly idle warp), one row per CTA, the backward
    one launch of a cluster of 16 with 14,848 B of dynamic shared memory. The
    imagination's 800 rows (T 50 x B 16): 7 rows a group, 120 backward CTAs in clusters of
    8 (115 with rows), two launches and 15 partial rows."""
    unroll, imagination = geometry(16, 600), geometry(800, 600)
    assert (unroll["units"], unroll["vec"], unroll["threads_per_row"], unroll["rows_per_cta"], unroll["fwd_grid"]) == (4, 4, 160, 1, 16)
    assert _cdiv(600, unroll["units"]) == 150 < unroll["threads_per_row"]
    assert (unroll["bwd_launches"], unroll["cluster"], unroll["bwd_grid"], unroll["partial_rows"], unroll["bwd_smem"]) == (1, 16, 16, 0, 14848)
    assert (imagination["units"], imagination["threads_per_row"], imagination["fwd_grid"]) == (4, 160, 800)
    assert (imagination["rows_per_group"], imagination["bwd_grid"], imagination["cluster"]) == (7, 120, 8)
    assert (imagination["bwd_launches"], imagination["partial_rows"]) == (2, 15)
    assert _cdiv(800, imagination["rows_per_group"]) == 115


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 800])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_at_dreamer_v2s_width(cuda_device, batch, dtype):
    """Both kernels at H = 600 (the unroll's 16 rows and the imagination's 800) against
    the plain version in float32, through autograd as the model calls them, twice giving
    the same bits."""
    proj, h, gamma, beta, g = _card_operands(batch, 600, cuda_device, seed=50)
    args = (proj.to(dtype), h.to(dtype), gamma, beta)
    fwd, bwd = layernorm_gru.launches, layernorm_gru_backward.launches
    leaves = [t.detach().requires_grad_(True) for t in args]
    out = layernorm_gru(*leaves)
    torch.autograd.backward(out, g.to(dtype))
    torch.cuda.synchronize()
    assert (layernorm_gru.launches, layernorm_gru_backward.launches) == (fwd + 1, bwd + 1)
    _assert_forward_close(out.detach(), args)
    _assert_backward_close([t.grad for t in leaves], args, g.to(dtype))
    with torch.inference_mode():
        assert torch.equal(layernorm_gru(*args), out.detach())
    again = layernorm_gru_backward(*args, g.to(dtype))
    for name, a, b in zip(("dproj", "dh", "dgamma", "dbeta"), again, [t.grad for t in leaves]):
        assert torch.equal(a, b), name


def test_geometry_at_dreamer_v3_xls_width():
    """DreamerV3-XL's GRU (H = 4096, P2E-DV3 at its published widths): the wide plan at
    both of its shapes, a row alone in a CTA of 1024 threads (4 units each, 4 a load).
    The unroll's 16 rows: 16 forward CTAs; the backward two launches, 16 CTAs and 16
    partial rows for the sum launch. The imagination's 1024 rows: 1024 forward CTAs; the
    backward 128 CTAs whose groups walk 8 rows, and 128 partial rows (12.6 MB)."""
    unroll, imagination = geometry(16, 4096), geometry(1024, 4096)
    for geo in (unroll, imagination):
        assert (geo["path"], geo["units"], geo["vec"], geo["threads_per_row"], geo["rows_per_cta"], geo["cluster"]) == (1, 4, 4, 1024, 1, 1)
        assert (geo["bwd_launches"], geo["bwd_smem"]) == (2, 0)
    assert (unroll["fwd_grid"], unroll["rows_per_group"], unroll["bwd_grid"], unroll["partial_rows"]) == (16, 1, 16, 16)
    assert (imagination["fwd_grid"], imagination["rows_per_group"], imagination["bwd_grid"], imagination["partial_rows"]) == (1024, 8, 128, 128)
    assert imagination["partial_rows"] * 2 * 3 * 4096 * 4 == 12_582_912


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_at_dreamer_v3_xls_width(cuda_device, batch, dtype):
    """Both kernels at H = 4096 (the unroll's 16 rows and the imagination's 1024, the
    wide plan, a backward of two launches) against the plain version in float32, through
    autograd as the model calls them, twice giving the same bits."""
    proj, h, gamma, beta, g = _card_operands(batch, 4096, cuda_device, seed=51)
    args = (proj.to(dtype), h.to(dtype), gamma, beta)
    fwd, bwd = layernorm_gru.launches, layernorm_gru_backward.launches
    leaves = [t.detach().requires_grad_(True) for t in args]
    out = layernorm_gru(*leaves)
    torch.autograd.backward(out, g.to(dtype))
    torch.cuda.synchronize()
    assert (layernorm_gru.launches, layernorm_gru_backward.launches) == (fwd + 1, bwd + 1)
    _assert_forward_close(out.detach(), args)
    _assert_backward_close([t.grad for t in leaves], args, g.to(dtype))
    with torch.inference_mode():
        assert torch.equal(layernorm_gru(*args), out.detach())
    again = layernorm_gru_backward(*args, g.to(dtype))
    for name, a, b in zip(("dproj", "dh", "dgamma", "dbeta"), again, [t.grad for t in leaves]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("batch,hidden", [(16, 512), (1024, 512), (129, 512), (16, 5000), (1, 16384), (800, 600), (1024, 4096)])
def test_backward_scratch_is_sized_from_the_geometry(batch, hidden):
    """The wrapper's scratch is ``partial_rows`` rows of [2][3H] float32, none for a
    one-launch call."""
    from sheeprl_tpu_torch.ops.gru import _partials

    rows = geometry(batch, hidden)["partial_rows"]
    got = _partials(batch, hidden, True, torch.device("cpu"))
    if rows == 0:
        assert got is None
    else:
        assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 2, 3 * hidden)


def test_geometry_refuses_what_the_kernels_do_not_plan():
    for args in [(0, 512), (16, 0), (-1, 512), (16, -512)]:
        with pytest.raises(ValueError):
            geometry(*args)


CARD_BATCHES = [1, 8, 16, 17, 128, 129, 1024, 4096]
CARD_HIDDEN = [64, 512, 600, 4096, 5000, 16384]


def _card_operands(batch, hidden, device, seed):
    proj, h, gamma, beta = (torch.from_numpy(o).to(device) for o in _operands(batch, hidden, seed=seed))
    g = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(batch, hidden)).astype(np.float32)).to(device)
    return proj, h, gamma, beta, g


# A bf16 output is the kernel's float32 result rounded once: within half a bf16 step
# (2^-8 of the value) of the float32 reference computed from the same bf16 inputs, beyond
# the float32 bound.
BF16_HALF_STEP = 2.0**-8


def _assert_forward_close(out, args):
    ref = layernorm_gru_reference(*(t.float() for t in args))
    rtol = 0.0 if out.dtype == torch.float32 else BF16_HALF_STEP
    torch.testing.assert_close(out.float(), ref, atol=F32_ATOL, rtol=rtol)


def _assert_backward_close(got, args, g):
    """The backward kernel against autograd through the plain forward on the same values
    in float32: f32 atol 2e-4 for every gradient; a bf16 dproj/dh also within half a bf16
    step (dgamma/dbeta are float32)."""
    dtype = args[0].dtype
    ref = layernorm_gru_backward_reference(*(t.float() for t in args), g.float())
    assert [t.dtype for t in got] == [dtype, dtype, torch.float32, torch.float32]
    for name, a, r in zip(("dproj", "dh", "dgamma", "dbeta"), got, ref):
        rtol = BF16_HALF_STEP if a.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(a.float(), r, atol=GRAD_F32_ATOL, rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", CARD_HIDDEN)
@pytest.mark.parametrize("batch", CARD_BATCHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_version_across_shapes(cuda_device, batch, hidden, dtype):
    """Both kernels against the plain version in float32 on the same values, on every path
    (narrow and wide; one launch and two): forward atol 1e-5, backward 2e-4, and a bf16
    output within half a bf16 step beyond that."""
    proj, h, gamma, beta, g = _card_operands(batch, hidden, cuda_device, seed=20)
    args = (proj.to(dtype), h.to(dtype), gamma, beta)
    with torch.inference_mode():
        out = layernorm_gru(*args)
    assert out.dtype == dtype
    _assert_forward_close(out, args)
    got = layernorm_gru_backward(*args, g.to(dtype))
    torch.cuda.synchronize()
    _assert_backward_close(got, args, g.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(16, 512), (17, 512), (1024, 512), (16, 4096), (16, 5000), (300, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_give_the_same_bits_twice(cuda_device, batch, hidden, dtype):
    """Fixed-order sums, no atomics: two calls of either kernel give the same bits."""
    proj, h, gamma, beta, g = _card_operands(batch, hidden, cuda_device, seed=30)
    args = (proj.to(dtype), h.to(dtype), gamma, beta)
    with torch.inference_mode():
        assert torch.equal(layernorm_gru(*args), layernorm_gru(*args))
    first, second = layernorm_gru_backward(*args, g.to(dtype)), layernorm_gru_backward(*args, g.to(dtype))
    for name, a, b in zip(("dproj", "dh", "dgamma", "dbeta"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 1024])
def test_cuda_kernels_replay_in_graphs_on_two_streams(cuda_device, batch):
    """The kernels keep nothing between calls: two CUDA graphs of the forward and the
    backward, each on its own inputs, replayed at once on two streams, give the eager
    results."""
    graphs, inputs, outs, want = [], [], [], []
    for seed in (40, 41):
        proj, h, gamma, beta, g = _card_operands(batch, 512, cuda_device, seed=seed)
        args = (proj.bfloat16(), h.bfloat16(), gamma, beta, g.bfloat16())
        inputs.append(args)  # a graph reads its inputs where they were at capture
        want.append((layernorm_gru(*args[:4]), *layernorm_gru_backward(*args)))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            layernorm_gru(*args[:4]), layernorm_gru_backward(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = (layernorm_gru(*args[:4]), *layernorm_gru_backward(*args))
        graphs.append(graph)
        outs.append(out)
    for out in outs:
        for t in out:
            t.zero_()
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        for graph, stream in zip(graphs, streams):
            with torch.cuda.stream(stream):
                graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, want):
        for name, a, b in zip(("out", "dproj", "dh", "dgamma", "dbeta"), out, ref):
            assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3 * 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_take_a_view_with_a_storage_offset(cuda_device, offset, dtype):
    """A contiguous view that starts ``offset`` elements into its storage: one element in
    takes the scalar path (not 16-byte aligned), a whole row in the vector path."""
    from sheeprl_tpu_torch.ops.gru import _aligned

    batch, hidden = 16, 512
    proj, h, gamma, beta, g = _card_operands(batch, hidden, cuda_device, seed=50)
    store = torch.zeros(offset + batch * 3 * hidden, dtype=dtype, device=cuda_device)
    view = store[offset:].view(batch, 3 * hidden)
    view.copy_(proj.to(dtype))
    assert view.is_contiguous() and _aligned(view) == (offset * view.element_size() % 16 == 0)
    args = (view, h.to(dtype), gamma, beta)
    with torch.inference_mode():
        _assert_forward_close(layernorm_gru(*args), args)
    got = layernorm_gru_backward(*args, g.to(dtype))
    torch.cuda.synchronize()
    _assert_backward_close(got, args, g.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", PLAN_HIDDEN)
def test_cuda_geometry_is_the_wrappers(cuda_device, hidden):
    """The built source's plan (``layernorm_gru_geometry``) is the wrapper's restatement
    at every batch and alignment; every one-launch cluster of the model's and the tests'
    shapes fits the card (``cudaOccupancyMaxActiveClusters`` >= 1) in either type."""
    from sheeprl_tpu_torch.ops.gru import kernel_geometry, max_active_clusters

    for batch in PLAN_BATCHES:
        for aligned in (True, False):
            assert kernel_geometry(batch, hidden, aligned) == geometry(batch, hidden, aligned), (batch, aligned)
        for dtype in (torch.float32, torch.bfloat16):
            assert max_active_clusters(batch, hidden, dtype) >= 1, (batch, dtype)
