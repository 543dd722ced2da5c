"""Build and load the hand-written CUDA kernels.

Each source under ``tpu_cnn_torch/csrc`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/tpu_cnn_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source so that an edit rebuilds it, and loaded with
``ctypes``. Nothing is built when a module is imported: the first call on
a CUDA tensor builds, later calls reuse the loaded library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build",
                         "tpu_cnn_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[str, str, float]:
    """Compile ``csrc/<name>.cu`` if its hash has no library yet. Returns
    (library path, nvcc's output, seconds spent building; 0 when cached)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, proc.stderr + proc.stdout, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(build(name)[0])
