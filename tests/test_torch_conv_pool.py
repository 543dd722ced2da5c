"""The port's layer kernel wrapper (``tpu_cnn_torch.ops.conv_pool``) against
the JAX package's two single-layer kernels, ``pallas_poly.conv_pool_layer_poly``
(K2) and ``pallas_poly.conv_pool_layer_phase`` (K3), run in Pallas interpret
mode on the CPU, and against the numpy oracle, on the same inputs.

On a CPU tensor the wrapper runs the kernel's plain version, so these tests
hold the plain version (and the wrapper's contract) against the TPU
kernels. K3 writes K2's function as ``phase_split_nchw(out, h)`` rows; the
port writes NCHW, so the K3 cases apply ``phase_split_nchw`` to the port's
output. The CUDA kernel itself has no CPU or interpret mode: the test marked
``cuda`` holds it against the plain version on the card and skips elsewhere
(``python -m pytest -m cuda tests/test_torch_conv_pool.py`` on a machine
with a GPU and nvcc).

Tolerance: none. The layer is integer arithmetic, so every comparison is
bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.engine.cpu_ref import numpy_conv_layer  # noqa: E402
from tpu_cnn.ops import pallas_poly  # noqa: E402
from tpu_cnn_torch.ops import conv_pool, mega  # noqa: E402


def _case(seed, batch, ic, oc, size):
    """Full-range int8 weights and uniform u8 inputs from a numpy seed."""
    rs = np.random.RandomState(seed)
    k = rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
    x = rs.randint(0, 256, (batch, ic, size, size)).astype(np.uint8)
    return x, k


def _port(x, k, shift, device="cpu", layer=0):
    shifts = torch.tensor([0] * layer + [shift], dtype=torch.int32)
    return conv_pool.conv_pool_layer(torch.from_numpy(x).to(device),
                                     torch.from_numpy(k).to(device),
                                     shifts.to(device), layer)


def _oracle(x, k, shift):
    return np.stack([numpy_conv_layer(im, k, shift) for im in x])


def test_layer_matches_k2_interpret():
    """lyr4-wide's L0 geometry (1 -> 16 at 256^2), B=5: not a multiple of
    the TPU kernel's batch tile of 4, so its padding is exercised too."""
    x, k = _case(31, 5, 1, 16, 256)
    want = np.asarray(pallas_poly.conv_pool_layer_poly(
        jnp.asarray(x), jnp.asarray(k), jnp.int32(3), interpret=True))
    got = _port(x, k, 3)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (5, 16, 128, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ic,oc,size,h,batch", [
    (4, 8, 64, 4, 5),     # multi-channel, small
    (1, 16, 256, 8, 3),   # lyr4-wide's L0 as the JAX chain runs it (h = 2^3)
])
def test_layer_matches_k3_interpret(ic, oc, size, h, batch):
    x, k = _case(32 + ic, batch, ic, oc, size)
    want = np.asarray(pallas_poly.conv_pool_layer_phase(
        jnp.asarray(x), jnp.asarray(k), jnp.int32(2), h=h, interpret=True))
    got = np.asarray(pallas_poly.phase_split_nchw(
        jnp.asarray(_port(x, k, 2).numpy()), h))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [0, 31])
@pytest.mark.parametrize("ic,oc,size", [(1, 16, 64), (20, 35, 38), (3, 5, 10)])
def test_layer_matches_numpy_oracle(ic, oc, size, shift):
    """Full-range weights at the extreme shifts: 0 saturates almost every
    output at 255 or 0, 31 leaves only 0 (and -1 -> 0 after the clip);
    (20, 35, 38) crosses the kernel's 16-channel chunks and a ragged tile."""
    x, k = _case(33, 2, ic, oc, size)
    got = _port(x, k, shift, layer=1)
    np.testing.assert_array_equal(got.numpy(), _oracle(x, k, shift))


@pytest.mark.parametrize("ic,oc,size", [(1, 16, 256), (4, 8, 64)])
def test_layer_with_packed_weights_matches_k2_k3_interpret(ic, oc, size):
    """``packed=`` (``mega.pack_layer``, made once by the weights' owner)
    does not change the answer on a CPU tensor, nor launch anything: the
    one-channel recast's packing against K2, the multi-channel packing
    against K3 (the geometries each TPU kernel takes)."""
    x, k = _case(39 + ic, 3, ic, oc, size)
    kt = torch.from_numpy(k)
    before = conv_pool.launches
    got = conv_pool.conv_pool_layer(torch.from_numpy(x), kt,
                                    torch.tensor([3], dtype=torch.int32), 0,
                                    packed=mega.pack_layer(kt))
    assert conv_pool.launches == before
    if ic == 1:
        want = pallas_poly.conv_pool_layer_poly(
            jnp.asarray(x), jnp.asarray(k), jnp.int32(3), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        want = pallas_poly.conv_pool_layer_phase(
            jnp.asarray(x), jnp.asarray(k), jnp.int32(3), h=4, interpret=True)
        np.testing.assert_array_equal(
            np.asarray(pallas_poly.phase_split_nchw(jnp.asarray(got.numpy()), 4)),
            np.asarray(want))


def test_reference_paths_agree():
    """The f32 and int32 plain versions agree bit for bit."""
    x, k = _case(34, 2, 16, 32, 32)
    t = (torch.from_numpy(x), torch.from_numpy(k),
         torch.tensor([5], dtype=torch.int32))
    assert torch.equal(conv_pool.conv_pool_reference(*t, 0),
                       conv_pool.conv_pool_reference(*t, 0,
                                                     compute_dtype="int32"))


def test_cpu_runs_the_plain_version_without_launching():
    x, k = _case(35, 2, 4, 8, 16)
    before = conv_pool.launches
    got = _port(x, k, 4)
    assert conv_pool.launches == before
    np.testing.assert_array_equal(got.numpy(), _oracle(x, k, 4))


def test_other_devices_raise_instead_of_falling_back():
    x, k = _case(36, 2, 4, 8, 16)
    before = conv_pool.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port(x, k, 4, device="meta")
    assert conv_pool.launches == before


def test_bad_inputs_raise():
    x, k = _case(37, 2, 4, 8, 16)
    with pytest.raises(ValueError, match="uint8"):
        _port(x.astype(np.int32), k, 2)
    with pytest.raises(ValueError, match="uint8"):
        _port(x[:, 0], k, 2)  # 3-D
    with pytest.raises(ValueError, match="even side"):
        _port(x[:, :, :15, :15].copy(), k, 2)
    with pytest.raises(ValueError, match="int8"):
        _port(x, k[:, :2].copy(), 2)  # ic mismatch
    with pytest.raises(ValueError, match="int32"):
        conv_pool.conv_pool_layer(torch.from_numpy(x), torch.from_numpy(k),
                                  torch.tensor([2], dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="layer"):
        conv_pool.conv_pool_layer(torch.from_numpy(x), torch.from_numpy(k),
                                  torch.tensor([2], dtype=torch.int32), 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA layer kernel has "
                    "no CPU or interpret mode (on the card: python -m pytest "
                    "-m cuda tests/test_torch_conv_pool.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc,size,batch", [
    (1, 16, 256, 37), (16, 32, 128, 37), (20, 35, 38, 5), (3, 5, 10, 37)])
@pytest.mark.parametrize("shift", [0, 3, 31])
def test_kernel_matches_plain_version_on_card(cuda_device, ic, oc, size,
                                              batch, shift):
    x, k = _case(38, batch, ic, oc, size)
    shifts = torch.tensor([7, shift], dtype=torch.int32, device=cuda_device)
    t = (torch.from_numpy(x).to(cuda_device),
         torch.from_numpy(k).to(cuda_device), shifts)
    want = conv_pool.conv_pool_reference(*t, 1, compute_dtype="int32")
    before = conv_pool.launches
    got = conv_pool.conv_pool_layer(*t, 1)
    torch.cuda.synchronize()
    assert conv_pool.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc,size,batch", [
    (1, 16, 256, 37), (1, 5, 10, 37), (1, 128, 32, 3), (64, 128, 32, 5),
    (3, 13, 38, 5), (1, 35, 6, 37)])
def test_kernel_with_packed_weights_on_card(cuda_device, ic, oc, size, batch):
    """Packed once (as ``CUDAEngine`` does) and packed per call agree with
    the plain version: the one-channel recast at lyr4-wide's L0 and with
    padded N tiles, the multi-channel path with padded K."""
    x, k = _case(38, batch, ic, oc, size)
    kt = torch.from_numpy(k).to(cuda_device)
    xt = torch.from_numpy(x).to(cuda_device)
    pk = mega.pack_layer(kt)
    for shift in (0, 4, 31):
        shifts = torch.tensor([shift], dtype=torch.int32, device=cuda_device)
        want = conv_pool.conv_pool_reference(xt, kt, shifts, 0, compute_dtype="int32")
        got = conv_pool.conv_pool_layer(xt, kt, shifts, 0, packed=pk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(conv_pool.conv_pool_layer(xt, kt, shifts, 0), want)
