"""Build and load the hand-written CUDA kernels and the native oracle.

Each source under ``tpu_cnn_torch/csrc`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/tpu_cnn_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source and of every header it includes from its own
directory (``source_digest``), so that an edit to either rebuilds it, and
loaded with
``ctypes``. Nothing is built when a module is imported: the first call on
a CUDA tensor builds, later calls reuse the loaded library. The C++ oracle
``tpu_cnn_torch/native/cnn_oracle.cpp`` is built the same way with ``g++``
(``build_host``) on its first use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NATIVE_DIR = os.path.join(os.path.dirname(CSRC_DIR), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build",
                         "tpu_cnn_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


# g++ flag sets for the native oracle, tried in order
GXX_FLAG_SETS = (["-O3", "-march=native", "-fopenmp"], ["-O3", "-fopenmp"],
                 ["-O3"])


class KernelBuildError(RuntimeError):
    """nvcc or g++ is missing or refused a source."""


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(src: str, extra: bytes = b"") -> str:
    """SHA-256 (hex) of ``src``, of every file it ``#include "..."``s
    relative to its own directory (recursively, each once) and of
    ``extra``. System headers (``<...>``) are not hashed."""
    digest = hashlib.sha256()
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in seen or not os.path.exists(path):
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        digest.update(text + b"\0")
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    digest.update(extra)
    return digest.hexdigest()


def _compile(src: str, name: str, commands) -> tuple[str, str, float]:
    """Build ``src`` into ``BUILD_DIR`` with the first of ``commands`` (each
    a function of the output path -> argv) that succeeds, unless a library
    of the same sources (``source_digest``) and commands exists. Returns
    (library path, the compiler's output, seconds spent building; 0 when
    cached)."""
    digest = source_digest(src, repr([cmd("") for cmd in commands]).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    if os.path.exists(lib):
        return lib, "", 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    errors = []
    try:
        for cmd in commands:
            argv = cmd(tmp)
            proc = subprocess.run(argv, capture_output=True, text=True)
            if proc.returncode == 0:
                os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
                return lib, proc.stderr + proc.stdout, time.perf_counter() - t0
            errors.append(f"{argv[0]} failed on {src} (exit {proc.returncode}):"
                          f"\n{proc.stderr}{proc.stdout}")
        raise KernelBuildError("\n".join(errors))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[str, str, float]:
    """Compile ``csrc/<name>.cu`` with nvcc if its hash has no library yet.
    Returns (library path, nvcc's output, seconds spent building; 0 when
    cached)."""
    nvcc = _nvcc()
    src = os.path.join(CSRC_DIR, name + ".cu")
    return _compile(src, name, [lambda out: [nvcc, *NVCC_FLAGS, "-o", out, src]])


@functools.lru_cache(maxsize=None)
def build_host(name: str) -> str:
    """Compile ``native/<name>.cpp`` with g++ into a shared library (with
    OpenMP where the compiler has it) and return its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError("g++ not found: the native oracle needs it")
    src = os.path.join(NATIVE_DIR, name + ".cpp")
    return _compile(src, name, [
        lambda out, flags=flags: [gxx, "-std=c++17", "-shared", "-fPIC",
                                  *flags, "-o", out, src]
        for flags in GXX_FLAG_SETS])[0]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(build(name)[0])
