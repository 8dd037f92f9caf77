"""The port's RSSM step scan bench (``sheeprl_tpu_torch/benchmarks/fused_step_bench.py``)
on the CPU at a small size, T 8 x B 16 x k_in 32 x H 32, in float32.

Its plain scan is held against ``jax.grad`` of the same scan through the JAX package's
``fused_gru_step`` (the Pallas kernels in interpret mode): the states at rtol = atol =
1e-5 and the weight gradient at 2e-4, the JAX package's own scan-test tolerances. The
three variants agree with each other at the same tolerances, and the JSON line has the
JAX bench's keys plus the launch counts and the device-time fields.
"""

import json

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.benchmarks.fused_step_bench import VARIANTS, main, run

T, B, K_IN, H = 8, 16, 32, 32
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-4


@pytest.fixture(scope="module")
def bench():
    return run(T, B, K_IN, H, device="cpu", reps=1)


def _jax_scan():
    """``benchmarks/fused_step_bench.py``'s inputs and loss, through ``fused_gru_step``."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.ops.rssm_step import fused_gru_step

    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(T, B, K_IN)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(K_IN + H, 3 * H)).astype(np.float32) * 0.02)
    gamma, beta = jnp.ones((3 * H,), jnp.float32), jnp.zeros((3 * H,), jnp.float32)

    def loss(w_):
        def step(h, x):
            h2 = fused_gru_step(jnp.concatenate([x, h], -1), h, w_, gamma, beta)
            return h2, h2

        _, hs = jax.lax.scan(step, jnp.zeros((B, H)), xs)
        return jnp.sum(hs**2), hs

    (_, hs), dw = jax.value_and_grad(loss, has_aux=True)(w)
    return np.asarray(hs), np.asarray(dw)


def test_plain_scan_matches_jax(bench):
    _, outputs = bench
    hs, dw = outputs["plain"]
    hs_ref, dw_ref = _jax_scan()
    assert hs.shape == (T, B, H) and dw.shape == (K_IN + H, 3 * H)
    np.testing.assert_allclose(hs.numpy(), hs_ref, rtol=FWD_ATOL, atol=FWD_ATOL)
    np.testing.assert_allclose(dw.numpy(), dw_ref, rtol=GRAD_ATOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("variant", ["post_fused", "full_fused"])
def test_variants_agree(bench, variant):
    _, outputs = bench
    hs, dw = outputs[variant]
    hs_p, dw_p = outputs["plain"]
    torch.testing.assert_close(hs, hs_p, rtol=FWD_ATOL, atol=FWD_ATOL)
    torch.testing.assert_close(dw, dw_p, rtol=GRAD_ATOL, atol=GRAD_ATOL)


def test_json_line_has_its_keys(bench):
    line, _ = bench
    json.dumps(line)
    assert line["bench"] == "rssm_step_scan_fwd_bwd" and line["backend"] == "cpu"
    assert line["shape"] == {"T": T, "B": B, "K": K_IN + H, "H": H, "dtype": "float32"}
    for name in VARIANTS:
        row = line[name]
        assert {"ms_per_scan", "us_per_step", "speedup_vs_plain", "launches_per_scan", "device_ms_per_scan", "device_ms_source"} <= set(row)
        assert row["ms_per_scan"] > 0 and row["device_ms_per_scan"] is None, "a CPU run gives no device time"
        assert row["launches_per_scan"] == {"rssm_step": 0, "rssm_step_bwd": 0, "layernorm_gru": 0, "layernorm_gru_bwd": 0}


def test_main_prints_one_json_line(capsys):
    main(["2", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip())
    assert line["shape"] == {"T": 2, "B": 2, "K": 1024, "H": 512, "dtype": "float32"}


def test_bench_asks_for_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="--device cpu"):
        run(2, 2, 8, 32)

