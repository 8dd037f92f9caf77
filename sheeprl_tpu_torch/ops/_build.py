"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes``. Nothing here includes
PyTorch's headers, so a build takes seconds. The build happens at the first call that
needs the kernel, never at import: the CPU tests import every module, on hosts with
neither ``nvcc`` nor a card.

Libraries land in ``sheeprl_tpu_torch/_build/`` (listed in ``.gitignore``), named by the
sha256 of the source and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. A build writes to a temporary name and renames it into place, so a
process that dies mid-build leaves no half-written library behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

# name -> (loaded library, seconds the build took; 0.0 when it was already built)
_LOADED: Dict[str, Tuple[ctypes.CDLL, float]] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH")
    return found


def load_kernel_library(name: str, source: Path | None = None) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (or ``source``, another version of a kernel's file,
    loaded under ``name``) if needed and return the loaded library."""
    if name in _LOADED:
        return _LOADED[name][0]
    source = CSRC_DIR / f"{name}.cu" if source is None else Path(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds = 0.0
    if not target.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {source} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    _LOADED[name] = (lib, seconds)
    return lib


def build_seconds(name: str) -> float:
    """Seconds the first load of ``name`` in this process spent in ``nvcc`` (0.0 if cached)."""
    return _LOADED[name][1]
