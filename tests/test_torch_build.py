"""The kernel build cache (``tpu_cnn_torch.ops._build``): a library is named
by ``source_digest``, the hash of its source and of every header the
source includes from its own directory, so that an edit to a header the
kernel includes rebuilds it and an edit to any other file does not. Needs
no ``nvcc``: the digest is plain file hashing."""

import os

import pytest

pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn_torch.ops import _build  # noqa: E402


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture
def csrc(tmp_path):
    """kernel.cu includes layer.cuh, which includes prims.cuh; other.cuh is
    included by nothing; <cstdint> is a system header."""
    _write(tmp_path / "kernel.cu",
           '#include <cstdint>\n#include "layer.cuh"\nint f() { return g(); }\n')
    _write(tmp_path / "layer.cuh", '#pragma once\n  #  include "prims.cuh"\n'
                                   'int g() { return h(); }\n')
    _write(tmp_path / "prims.cuh", "#pragma once\nint h() { return 1; }\n")
    _write(tmp_path / "other.cuh", "int unused() { return 2; }\n")
    return tmp_path


@pytest.mark.parametrize("header,changes", [
    ("kernel.cu", True),   # the source itself
    ("layer.cuh", True),   # included by the source
    ("prims.cuh", True),   # included by an included header
    ("other.cuh", False),  # included by nothing
])
def test_digest_follows_the_included_headers(csrc, header, changes):
    src = os.fspath(csrc / "kernel.cu")
    before = _build.source_digest(src)
    assert _build.source_digest(src) == before  # deterministic
    with open(csrc / header, "a") as f:
        f.write("// edited\n")
    assert (_build.source_digest(src) != before) == changes


def test_digest_covers_the_build_command(csrc):
    src = os.fspath(csrc / "kernel.cu")
    assert (_build.source_digest(src, b"nvcc -O3")
            != _build.source_digest(src, b"nvcc -O2"))


def test_repo_kernels_hash_their_shared_headers():
    """The two layer-kernel sources include conv_layer.cuh, which includes
    int8_mma.cuh and path_counts.cuh; the megakernel includes both of
    those, and the bitcast kernel path_counts.cuh. Each library's digest
    therefore reads those headers (a missing include would leave a stale
    library after a header edit)."""
    seen = {}
    for name in ("conv_act", "conv_pool_layer", "mega_cnn", "bitcast"):
        with open(os.path.join(_build.CSRC_DIR, name + ".cu"), "rb") as f:
            seen[name] = set(_build._INCLUDE.findall(f.read()))
    assert seen["conv_act"] == seen["conv_pool_layer"] == {b"conv_layer.cuh"}
    assert seen["mega_cnn"] == {b"int8_mma.cuh", b"path_counts.cuh"}
    assert seen["bitcast"] == {b"path_counts.cuh"}
    with open(os.path.join(_build.CSRC_DIR, "conv_layer.cuh"), "rb") as f:
        assert _build._INCLUDE.findall(f.read()) == [b"int8_mma.cuh", b"path_counts.cuh"]
    for name in seen:
        read = {os.path.basename(p) for p, _t in _build.local_sources(
            os.path.join(_build.CSRC_DIR, name + ".cu"))}
        assert "path_counts.cuh" in read and (name == "bitcast") != ("int8_mma.cuh" in read)
