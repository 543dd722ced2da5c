"""The port of the bitcast/roll probe (``tpu_cnn_torch.ops.bitcast``, the
port of K5, ``scripts/probe_bitcast.py``'s Pallas kernel) against the JAX
kernel bodies ``k_narrow``, ``k_widen`` and ``k_packed_roll`` run through
``pl.pallas_call(..., interpret=True)`` on the CPU (the script's own
``run`` hardcodes ``interpret=False``), against the probe's numpy
expectations, and the probe CLI on ``--device cpu``.

On a CPU tensor each wrapper runs its plain version. The CUDA kernel has
no CPU or interpret mode: the tests marked ``cuda`` hold it against the
plain version on the card and skip elsewhere (``python -m pytest -m cuda
tests/test_torch_bitcast.py`` on a machine with a GPU and nvcc).

Tolerance: none. Every function here moves bytes, so every comparison is
bit-equal."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from tpu_cnn_torch.apps import probe_bitcast  # noqa: E402
from tpu_cnn_torch.ops import bitcast  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(8, 256), (16, 128), (5, 37), (1, 1)]


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "probe_bitcast_script", os.path.join(REPO, "scripts", "probe_bitcast.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _probe_module()


def _k5(body, x: np.ndarray, shape, dtype) -> np.ndarray:
    """One K5 body through pallas_call in interpret mode, with the
    script's whole-array VMEM specs."""
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(shape, dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(x)))


def _words(seed, r, l):
    """Full-range int32 words, the extremes included."""
    x = np.random.RandomState(seed).randint(
        -2**31, 2**31, (r, l), dtype=np.int64).astype(np.int32)
    x.reshape(-1)[:4] = (-2**31, 2**31 - 1, 0, -1)[:x.size]
    return x


@pytest.mark.parametrize("r,l", SHAPES)
def test_narrow_matches_k5_interpret(r, l):
    x = _words(1, r, l)
    got = bitcast.narrow_i32_to_i8(torch.from_numpy(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == (4 * r, l)
    np.testing.assert_array_equal(
        got.numpy(), _k5(PROBE.k_narrow, x, (4 * r, l), jnp.int8))


@pytest.mark.parametrize("r,l", SHAPES)
def test_widen_matches_k5_interpret(r, l):
    x8 = np.random.RandomState(2).randint(0, 256, (4 * r, l)).astype(np.uint8)
    got = bitcast.widen_u8_to_i32(torch.from_numpy(x8))
    assert got.dtype == torch.int32 and tuple(got.shape) == (r, l)
    np.testing.assert_array_equal(
        got.numpy(), _k5(PROBE.k_widen, x8, (r, l), jnp.int32))


@pytest.mark.parametrize("r,l", SHAPES)
def test_roll_matches_k5_interpret(r, l):
    """K5's roll is by 3; the plain version's other shifts against
    np.roll."""
    x = _words(3, r, l)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        bitcast.packed_roll(xt, 3).numpy(),
        _k5(PROBE.k_packed_roll, x, (r, l), jnp.int32))
    for k in (0, -1, l + 2, -5 * l - 1):
        np.testing.assert_array_equal(bitcast.packed_roll(xt, k).numpy(),
                                      np.roll(x, k, axis=1), err_msg=f"k={k}")


def test_layouts_are_the_probes_expectations():
    """probe_bitcast.py's own checks, on its seeds and shapes: narrow puts
    byte b of word row r at row 4r+b (not b*R+r), widen inverts it."""
    r, l = PROBE.R, PROBE.L
    rs = np.random.RandomState(0)
    x = rs.randint(-2**31, 2**31, size=(r, l)).astype(np.int32)
    y = bitcast.narrow_i32_to_i8(torch.from_numpy(x)).numpy()
    bytes_le = x.view(np.uint8).reshape(r, l, 4)
    for row in range(r):
        for b in range(4):
            np.testing.assert_array_equal(y[row * 4 + b].astype(np.uint8),
                                          bytes_le[row, :, b])
    assert not np.array_equal(y[1].astype(np.uint8), bytes_le[1, :, 0])
    x8 = rs.randint(0, 256, size=(4 * r, l)).astype(np.uint8)
    got = bitcast.widen_u8_to_i32(torch.from_numpy(x8)).numpy()
    want = np.zeros((r, l), np.uint32)
    for row in range(r):
        for b in range(4):
            want[row] |= x8[row * 4 + b].astype(np.uint32) << (8 * b)
    np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("r,l", SHAPES)
def test_widen_inverts_narrow(r, l):
    x = torch.from_numpy(_words(4, r, l))
    narrow = bitcast.narrow_i32_to_i8(x)
    assert torch.equal(bitcast.widen_u8_to_i32(narrow), x)  # int8 input
    assert torch.equal(bitcast.widen_u8_to_i32(narrow.view(torch.uint8)), x)


def test_cpu_runs_the_plain_version_without_launching():
    x = torch.from_numpy(_words(5, 3, 10))
    before = bitcast.launches
    bitcast.narrow_i32_to_i8(x)
    bitcast.widen_u8_to_i32(bitcast.narrow_i32_to_i8_reference(x))
    bitcast.packed_roll(x, 1)
    assert bitcast.launches == before


def test_other_devices_raise_instead_of_falling_back():
    x = torch.from_numpy(_words(6, 2, 8)).to("meta")
    before = bitcast.launches
    for fn in (bitcast.narrow_i32_to_i8, lambda t: bitcast.packed_roll(t, 1)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bitcast.widen_u8_to_i32(torch.zeros((8, 4), dtype=torch.uint8,
                                            device="meta"))
    assert bitcast.launches == before


def test_bad_inputs_raise():
    x = torch.from_numpy(_words(7, 4, 8))
    with pytest.raises(ValueError, match="int32"):
        bitcast.narrow_i32_to_i8(x.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        bitcast.narrow_i32_to_i8(x[0])  # 1-D
    with pytest.raises(ValueError, match="multiple of 4"):
        bitcast.widen_u8_to_i32(torch.zeros((6, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        bitcast.widen_u8_to_i32(x)
    with pytest.raises(ValueError, match="at least one column"):
        bitcast.packed_roll(torch.zeros((2, 0), dtype=torch.int32), 1)


def test_probe_cli_on_cpu(capsys):
    assert probe_bitcast.main(["--device", "cpu"]) == 0
    lines = [ln.strip() for ln in capsys.readouterr().out.splitlines()]
    assert "Q1 narrow OK, shape (32, 256)" in lines
    assert "layout r*4+b (word-major rows): MATCH" in lines
    assert "layout b*R+r (byte-plane rows): no" in lines
    assert "layout r*4+b: MATCH" in lines and "layout b*R+r: no" in lines
    assert "Q3 packed i32 roll: MATCH" in lines


def test_probe_cli_exits_1_on_a_wrong_layout(monkeypatch, capsys):
    """A kernel that laid the bytes out plane by plane fails the probe."""
    def byte_planes(x):
        r, l = x.shape
        return x.view(torch.uint8).view(r, l, 4).permute(2, 0, 1).reshape(
            4 * r, l).view(torch.int8)

    monkeypatch.setattr(bitcast, "narrow_i32_to_i8", byte_planes)
    assert probe_bitcast.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "layout b*R+r (byte-plane rows): MATCH" in out
    assert "Q2" not in out  # it stops at the first failure


def test_probe_cli_exits_1_when_a_launch_raises(monkeypatch, capsys):
    def broken(x):
        raise RuntimeError("bitcast_narrow failed: cudaError 98")

    monkeypatch.setattr(bitcast, "narrow_i32_to_i8", broken)
    assert probe_bitcast.main(["--device", "cpu"]) == 1
    assert "Q1 narrow FAILED: RuntimeError" in capsys.readouterr().out


def test_probe_cli_without_a_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert probe_bitcast.main(["--device", "cuda"]) == 2


# ── the kernel, on the card ──────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA bitcast kernel "
                    "has no CPU or interpret mode (on the card: python -m "
                    "pytest -m cuda tests/test_torch_bitcast.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", SHAPES + [(1024, 4096), (3, 100003)])
def test_kernel_matches_plain_version_on_card(cuda_device, r, l):
    x = torch.from_numpy(_words(8, r, l)).to(cuda_device)
    x8 = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (4 * r, l)).astype(np.uint8)).to(cuda_device)
    before = bitcast.launches
    narrow = bitcast.narrow_i32_to_i8(x)
    got = {"narrow": (narrow, bitcast.narrow_i32_to_i8_reference(x)),
           "widen": (bitcast.widen_u8_to_i32(x8),
                     bitcast.widen_u8_to_i32_reference(x8)),
           "widen(narrow)": (bitcast.widen_u8_to_i32(narrow), x)}
    for k in (3, 0, -1, l + 2):
        got[f"roll {k}"] = (bitcast.packed_roll(x, k),
                            bitcast.packed_roll_reference(x, k))
    torch.cuda.synchronize()
    assert bitcast.launches == before + 7
    for name, (a, b) in got.items():
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
def test_kernel_on_offset_views_on_card(cuda_device):
    """Views one element into their storage, at widths that are multiples
    of 4: misaligned for the kernel's vector path, so its one-word path
    runs (the roll still stores vectors: its output is fresh)."""
    flat = torch.from_numpy(_words(10, 1, 8 * 64 + 1)[0]).to(cuda_device)
    x = flat[1:].view(8, 64)
    x8 = flat.view(torch.uint8)[1:4 * 8 * 64 + 1].view(32, 64)
    assert x.data_ptr() % 16 and x8.data_ptr() % 4
    got = {"narrow": (bitcast.narrow_i32_to_i8(x),
                      bitcast.narrow_i32_to_i8_reference(x)),
           "widen": (bitcast.widen_u8_to_i32(x8),
                     bitcast.widen_u8_to_i32_reference(x8)),
           "roll": (bitcast.packed_roll(x, 5),
                    bitcast.packed_roll_reference(x, 5))}
    torch.cuda.synchronize()
    for name, (a, b) in got.items():
        assert a.dtype == b.dtype and torch.equal(a, b), name
