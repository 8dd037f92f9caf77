"""The kernel benches on the CPU: what they can be checked for without a card.

``benchmarks/step_kernel_ab.py`` holds the fused step's kernel rows (``STEP_SHAPES`` x
``STEP_TYPES``) and their operands, and ``benchmarks/gru_kernel_ab.py`` the LayerNorm-GRU
kernels' rows (``KERNEL_SHAPES``), which ``chip_smoke.py`` takes from them; each builds an
older source of its kernels through ``ops/_build.py`` to time it in turns with the
current one.
"""

import ctypes
import subprocess
from pathlib import Path

import pytest
import torch

from sheeprl_tpu_torch.benchmarks import gru_kernel_ab, step_kernel_ab
from sheeprl_tpu_torch.ops import _build


def test_kernel_ab_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        step_kernel_ab.run()


def test_gru_kernel_ab_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        gru_kernel_ab.run()


@pytest.mark.parametrize("types", list(step_kernel_ab.STEP_TYPES))
def test_step_operands_are_seeded_and_take_the_rows_types(types):
    """The same generator seed gives the same operands; ``typed`` casts xh and w, h (and
    g), gamma and beta to the row's three types; w is scaled by K^-1/2."""
    batch, k, hidden = 5, 64, 32
    ops = step_kernel_ab.step_operands(batch, k, hidden, torch.device("cpu"), torch.Generator().manual_seed(1))
    again = step_kernel_ab.step_operands(batch, k, hidden, torch.device("cpu"), torch.Generator().manual_seed(1))
    assert [tuple(t.shape) for t in ops] == [(5, 64), (5, 32), (64, 96), (96,), (96,), (5, 32)]
    assert all(torch.equal(a, b) for a, b in zip(ops, again))
    assert ops[2].std().item() < 0.3, "w ~ N(0, 1/K)"
    (xh, h, w, gamma, beta), g = step_kernel_ab.typed(ops, types)
    ti, th, tg = step_kernel_ab.STEP_TYPES[types]
    assert (xh.dtype, w.dtype, h.dtype, g.dtype, gamma.dtype, beta.dtype) == (ti, ti, th, th, tg, tg)


def test_load_kernel_library_builds_a_given_source(monkeypatch, tmp_path):
    """``load_kernel_library(name, source)`` compiles that file with the port's flags
    into a library named after ``name`` and the file's digest, and loads it under
    ``name``."""
    source = tmp_path / "rssm_step_old.cu"
    source.write_text("// an older version of the kernels\n")
    calls = []

    def fake_nvcc(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    lib = _build.load_kernel_library("rssm_step_baseline", source)
    assert len(calls) == 1 and calls[0][-1] == str(source) and calls[0][1:1 + len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
    assert lib[0] == "loaded" and Path(lib[1]).name.startswith("librssm_step_baseline_")
    assert _build.load_kernel_library("rssm_step_baseline", source) is lib and len(calls) == 1


def test_baseline_binds_the_earlier_interface(monkeypatch):
    """``build_baseline`` loads the older source as ``rssm_step_baseline`` and binds its
    single-launch C functions: six pointers (forward) and eleven (backward) before B, K,
    H, eps, the three type codes and the stream."""

    class Fn:
        pass

    class Lib:
        rssm_step_fwd, rssm_step_bwd = Fn(), Fn()

    seen = []
    monkeypatch.setattr(_build, "load_kernel_library", lambda name, source=None: seen.append((name, source)) or Lib)
    monkeypatch.setattr(_build, "build_seconds", lambda name: 0.0)
    fwd, bwd = step_kernel_ab.build_baseline(Path("old.cu"))
    assert seen == [("rssm_step_baseline", Path("old.cu"))]
    tail = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert fwd.argtypes == [ctypes.c_void_p] * 6 + tail and bwd.argtypes == [ctypes.c_void_p] * 11 + tail
    assert fwd.restype is ctypes.c_int and bwd.restype is ctypes.c_int


def test_gru_baseline_binds_the_earlier_interface(monkeypatch):
    """``gru_kernel_ab.build_baseline`` loads the older source as ``layernorm_gru_baseline``
    and binds its C functions: five pointers, B, H, eps, the type code and the stream
    (forward); ten pointers, B, H, rows_per_tile, eps, the type code and the stream
    (backward)."""

    class Fn:
        pass

    class Lib:
        layernorm_gru_fwd, layernorm_gru_bwd = Fn(), Fn()

    seen = []
    monkeypatch.setattr(_build, "load_kernel_library", lambda name, source=None: seen.append((name, source)) or Lib)
    monkeypatch.setattr(_build, "build_seconds", lambda name: 0.0)
    fwd, bwd = gru_kernel_ab.build_baseline(Path("old.cu"))
    assert seen == [("layernorm_gru_baseline", Path("old.cu"))]
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    assert fwd.argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + tail
    assert bwd.argtypes == [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + tail
    assert fwd.restype is ctypes.c_int and bwd.restype is ctypes.c_int


def test_gru_kernel_shapes_are_the_models():
    """The rows ``chip_smoke.py`` and the A/B bench time: DreamerV3-S's eval entry's one
    row, a ragged batch, the unroll's 16 rows and the imagination's 1024 at H = 512,
    DreamerV3-XL's unroll and imagination at H = 4096, and DreamerV2's unroll (16 rows)
    and imagination (800) at H = 600."""
    assert gru_kernel_ab.KERNEL_SHAPES == [(1, 512), (13, 512), (16, 512), (1024, 512), (16, 4096), (1024, 4096), (16, 600), (800, 600)]
    assert set(gru_kernel_ab.DTYPES.values()) == {torch.float32, torch.bfloat16}
