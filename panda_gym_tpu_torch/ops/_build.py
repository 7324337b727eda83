"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  ``load(name)`` compiles it
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/panda_gym_tpu_torch/`` at the root of the checkout, and loads it with
``ctypes``.  The library's name carries a hash of the source and the flags,
so a stale build is never loaded; the compiler writes to a temporary name
that is renamed into place, so an interrupted build leaves no half-written
library and no lock file behind.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "panda_gym_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels round as their plain PyTorch versions
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 180

_LIBS: dict = {}
# name -> {"seconds": wall time of the build (0.0 if cached), "ptxas": lines}
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    ptxas = []
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        try:
            # run in the build directory, so that no header in the
            # caller's working directory shadows the toolkit's
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=BUILD_TIMEOUT_S, cwd=BUILD_DIR)
        except subprocess.TimeoutExpired as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc timed out after {BUILD_TIMEOUT_S} s on {src}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {src} (exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib_path)
        ptxas = [ln.strip() for ln in res.stderr.splitlines()
                 if any(w in ln for w in ("Function properties", "registers",
                                          "spill", "stack"))]
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas}
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib
