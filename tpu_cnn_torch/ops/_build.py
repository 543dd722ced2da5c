"""Build and load the hand-written CUDA kernels and the native oracle.

Each source under ``tpu_cnn_torch/csrc`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/tpu_cnn_torch/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, of every header it includes from its own
directory and of ``NVCC_FLAGS`` (the arch among them; ``kernel_digest``),
so that an edit to either rebuilds it, and loaded with ``ctypes``. The
name holds nothing of the host (not the compiler's path): a library built
on one host, or shipped in a deployable (``apps.export_model``), is found
in the cache on another, and a host with the library cached needs no
``nvcc``. Nothing is built when a module is imported: the first call on
a CUDA tensor builds, later calls reuse the loaded library. The host
library ``tcnn_host`` is built the same way with ``g++`` (``build_host``)
on its first use, from the sources ``HOST_SOURCES`` lists under
``tpu_cnn_torch/native``: the C++ oracle and batched frame preprocess
(``cnn_oracle.cpp``), the frame ring (``frame_ring.cpp``, which calls that
preprocess) and the HTTP front (``http_front.cpp``), as the JAX package
links them into one shared object. Its name hashes all three, so an edit
to any one rebuilds it.
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
from typing import Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
NATIVE_DIR = os.path.join(os.path.dirname(CSRC_DIR), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build",
                         "tpu_cnn_torch")
ARCH = "sm_90a"  # the one architecture the kernels are built for
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=" + ARCH, "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


# g++ flag sets for the host library, tried in order
GXX_FLAG_SETS = (["-O3", "-march=native", "-fopenmp"], ["-O3", "-fopenmp"],
                 ["-O3"])
# the host library's sources under native/, linked into one shared object
HOST_SOURCES = ("cnn_oracle.cpp", "frame_ring.cpp", "http_front.cpp")


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


def source_digest(src: str | Sequence[str], extra: bytes = b"") -> str:
    """SHA-256 (hex) of ``src`` (one path or several), of every file they
    ``#include "..."`` relative to their own directory (recursively, each
    once) and of ``extra``. System headers (``<...>``) are not hashed."""
    digest = hashlib.sha256()
    srcs = [src] if isinstance(src, str) else list(src)
    seen, todo = set(), [os.path.abspath(s) for s in srcs]
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


def kernel_digest(name: str) -> str:
    """``source_digest`` of ``csrc/<name>.cu`` (and its headers) with
    ``NVCC_FLAGS``: what names the kernel's library."""
    return source_digest(os.path.join(CSRC_DIR, name + ".cu"),
                         repr(NVCC_FLAGS).encode())


def kernel_library(name: str) -> str:
    """The path the kernel's library has in the cache, built or not."""
    return os.path.join(BUILD_DIR, f"lib{name}_{kernel_digest(name)[:16]}.so")


def _compile(srcs: Sequence[str], lib: str,
             commands) -> tuple[str, str, float]:
    """Build ``srcs`` into the library ``lib`` with the first of
    ``commands`` (each a function of the output path -> argv) that
    succeeds. Returns (library path, the compiler's output, seconds spent
    building)."""
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
            errors.append(f"{argv[0]} failed on {', '.join(srcs)} "
                          f"(exit {proc.returncode}):"
                          f"\n{proc.stderr}{proc.stdout}")
        raise KernelBuildError("\n".join(errors))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def build(name: str) -> tuple[str, str, float]:
    """Compile ``csrc/<name>.cu`` with nvcc if the cache has no library of
    its ``kernel_digest`` yet (nvcc is looked for only then). Returns
    (library path, nvcc's output, seconds spent building; 0 when
    cached)."""
    lib = kernel_library(name)
    if os.path.exists(lib):
        return lib, "", 0.0
    nvcc = _nvcc()
    src = os.path.join(CSRC_DIR, name + ".cu")
    return _compile([src], lib,
                    [lambda out: [nvcc, *NVCC_FLAGS, "-o", out, src]])


@functools.lru_cache(maxsize=None)
def build_host() -> str:
    """Compile the host library ``tcnn_host`` (the ``HOST_SOURCES``) with
    g++ into one shared library (with OpenMP where the compiler has it)
    and return its path. Its name hashes the sources and the flag sets;
    g++ is looked for only when the cache lacks it."""
    srcs = [os.path.join(NATIVE_DIR, f) for f in HOST_SOURCES]
    digest = source_digest(srcs, repr(GXX_FLAG_SETS).encode())
    lib = os.path.join(BUILD_DIR, f"libtcnn_host_{digest[:16]}.so")
    if os.path.exists(lib):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise KernelBuildError("g++ not found: the host library needs it")
    return _compile(srcs, lib, [
        lambda out, flags=flags: [gxx, "-std=c++17", "-shared", "-fPIC",
                                  *flags, "-o", out, *srcs]
        for flags in GXX_FLAG_SETS])[0]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(build(name)[0])
