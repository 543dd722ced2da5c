"""The port's per-layer backends (``tpu_cnn_torch.ops.int8``) against the
JAX package's ``pallas_int8`` (its Pallas kernel ``_conv_mxu``, K4, in
interpret mode on the CPU) on the same inputs, and the shift-range repair.

On a CPU tensor ``conv_act`` runs the kernel's plain version, so these
tests hold the plain version and the wrapper's contract against the TPU
kernel. The CUDA kernel has no CPU or interpret mode: the test marked
``cuda`` holds it against the plain version on the card and skips
elsewhere (``python -m pytest -m cuda tests/test_torch_int8.py`` on a
machine with a GPU and nvcc).

Tolerance: none. Every function here is integer arithmetic, so every
comparison is bit-equal."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_cnn.apps.common import load_model  # noqa: E402
from tpu_cnn.models.registry import get_config  # noqa: E402
from tpu_cnn.ops import pallas_int8  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch import bench_gate  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.ops import conv_pool, int8, mega, quant  # noqa: E402

ART = default_artifacts()


def _case(seed, batch, ic, oc, h, w=None):
    """Full-range int8 weights and uniform u8 inputs from a numpy seed."""
    rs = np.random.RandomState(seed)
    k = rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
    x = rs.randint(0, 256, (batch, ic, h, w or h)).astype(np.uint8)
    return x, k


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _shifts(*values):
    return torch.tensor(values, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _jax_conv_mxu(h, w):
    """K4 in interpret mode, compiled once per rectangle; the shift is a
    traced argument, as on the chip."""
    return jax.jit(lambda x, kmat, shift: pallas_int8._conv_mxu(
        x, kmat, shift, True, h=h, w=w))


@pytest.mark.parametrize("ic,oc,h,w", [
    (1, 16, 32, 32), (16, 32, 16, 16), (32, 64, 8, 8),
    (3, 5, 6, 10),  # a rectangle, as K4's banded callers pass it
])
def test_conv_act_matches_k4_interpret(ic, oc, h, w):
    x, k = _case(51 + ic, 5, ic, oc, h, w)
    kmat = pallas_int8.pack_kernel_matrix(k)
    fn = _jax_conv_mxu(h, w)
    xt, kt = _t(x, k)
    for shift in (0, 3, 31):
        want = np.asarray(fn(jnp.asarray(x.reshape(5, ic, h * w)), kmat,
                             jnp.int32(shift)))
        got = int8.conv_act(xt, kt, _shifts(7, shift), 1)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (5, oc, h, w)
        np.testing.assert_array_equal(got.numpy().reshape(5, oc, h * w), want,
                                      err_msg=f"shift {shift}")


@pytest.mark.parametrize("ic,oc,size,batch", [
    (1, 16, 256, 2),  # lyr4-wide's L0: the JAX package reroutes it to XLA
    (16, 32, 32, 4),
    (3, 5, 10, 3),
])
def test_fused_conv_layer_matches_jax(ic, oc, size, batch):
    x, k = _case(61 + ic, batch, ic, oc, size)
    want = np.asarray(pallas_int8.fused_conv_layer(
        jnp.asarray(x), pallas_int8.pack_kernel_matrix(k), jnp.int32(3),
        interpret=True))
    got = int8.fused_conv_layer(*_t(x, k), _shifts(3), 0)
    assert tuple(got.shape) == (batch, oc, size // 2, size // 2)
    np.testing.assert_array_equal(got.numpy(), want)


def _net(variant):
    """(images, kernels, shifts): lyr3-std with the shipped weights on 2
    test images + 2 noise images; lyr3-tiny with seeded weights."""
    if variant == "lyr3-std":
        imgs = bench_gate.load_gate_images(ART, n_real=2, n_noise=2)
        return imgs, art.load_bundle(ART).kernels, (2, 4, 6)
    rs = np.random.RandomState(71)
    cfg = get_config(variant)
    ks = [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
          for ic, oc, _ in cfg.layer_configs]
    s = cfg.img_size
    return rs.randint(0, 256, (5, s, s)).astype(np.uint8), ks, (2, 4, 6)


@pytest.mark.parametrize("name", ["cnn_forward_pallas", "cnn_forward_hybrid"])
@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr3-std"])
def test_cnn_forward_matches_jax(name, variant):
    imgs, ks, sh = _net(variant)
    want = np.asarray(getattr(pallas_int8, name)(
        jnp.asarray(imgs), [jnp.asarray(k) for k in ks],
        jnp.asarray(sh, jnp.int32), interpret=True))
    fn = getattr(int8, name)
    got = fn(torch.from_numpy(imgs), _t(*ks), _shifts(*sh))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the (B, S, S, 1) form takes the same path
    np.testing.assert_array_equal(
        fn(torch.from_numpy(imgs[..., None]), _t(*ks), _shifts(*sh)).numpy(),
        want)


@pytest.mark.parametrize("ic,oc,h,w", [
    (1, 16, 32, 32), (16, 32, 16, 16), (3, 5, 6, 10)])
def test_conv_act_with_packed_weights_matches_k4_interpret(ic, oc, h, w):
    """``packed=`` (the layer kernel's weights, made once by their owner)
    does not change the answer on a CPU tensor."""
    x, k = _case(51 + ic, 5, ic, oc, h, w)
    fn = _jax_conv_mxu(h, w)
    xt, kt = _t(x, k)
    packed = mega.pack_layer(kt)
    for shift in (0, 3):
        want = np.asarray(fn(jnp.asarray(x.reshape(5, ic, h * w)),
                             pallas_int8.pack_kernel_matrix(k), jnp.int32(shift)))
        got = int8.conv_act(xt, kt, _shifts(7, shift), 1, packed=packed)
        np.testing.assert_array_equal(got.numpy().reshape(5, oc, h * w), want,
                                      err_msg=f"shift {shift}")


@pytest.mark.parametrize("ic,oc,size,batch", [(1, 16, 64, 2), (16, 32, 32, 4),
                                              (3, 5, 10, 3)])
def test_fused_conv_layer_with_packed_weights_matches_jax(ic, oc, size, batch):
    x, k = _case(62 + ic, batch, ic, oc, size)
    want = np.asarray(pallas_int8.fused_conv_layer(
        jnp.asarray(x), pallas_int8.pack_kernel_matrix(k), jnp.int32(4),
        interpret=True))
    xt, kt = _t(x, k)
    before = int8.launches
    got = int8.fused_conv_layer(xt, kt, _shifts(4), 0, packed=mega.pack_layer(kt))
    assert int8.launches == before  # a CPU tensor runs the plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["cnn_forward_pallas", "cnn_forward_hybrid"])
def test_cnn_forward_with_packed_weights_matches_jax(name):
    imgs, ks, sh = _net("lyr3-tiny")
    want = np.asarray(getattr(pallas_int8, name)(
        jnp.asarray(imgs), [jnp.asarray(k) for k in ks],
        jnp.asarray(sh, jnp.int32), interpret=True))
    kts = _t(*ks)
    got = getattr(int8, name)(torch.from_numpy(imgs), kts, _shifts(*sh),
                              packed=[mega.pack_layer(k) for k in kts])
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_weights_of_another_kernel_raise():
    x, k = _case(89, 2, 1, 16, 8)
    xt, kt = _t(x, k)
    wrong = mega.pack_weights(kt)  # K1's layout, not the one-channel recast
    for fn in (int8.conv_act, int8.fused_conv_layer, conv_pool.conv_pool_layer):
        with pytest.raises(ValueError, match="pack_layer"):
            fn(xt, kt, _shifts(2), 0, packed=wrong)
    with pytest.raises(ValueError, match="pack_layer"):
        int8.cnn_forward_pallas(torch.from_numpy(x[:, 0]), [kt], _shifts(2),
                                packed=[])


def test_pack_kernel_matrix_round_trip():
    _, k = _case(81, 1, 5, 7, 4)
    kmat = int8.pack_kernel_matrix(torch.from_numpy(k))
    assert kmat.dtype == torch.float32 and tuple(kmat.shape) == (7, 45)
    np.testing.assert_array_equal(kmat.numpy(),
                                  np.asarray(pallas_int8.pack_kernel_matrix(k)))
    back = int8.unpack_kernel_matrix(kmat, 5)
    assert back.dtype == torch.int8 and back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), k)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(pallas_int8._unpack_kernel_matrix(jnp.asarray(kmat.numpy()), 5)))


def test_reference_paths_agree():
    """The f32 and int32 plain versions agree bit for bit (every sum of
    this case is below 2^24: 255 * 127 * 288 = 9.3 M)."""
    x, k = _case(82, 2, 32, 16, 12, 9)
    t = (*_t(x, k), _shifts(5))
    assert torch.equal(int8.conv_act_reference(*t, 0),
                       int8.conv_act_reference(*t, 0, compute_dtype="int32"))


def test_cpu_runs_the_plain_version_without_launching():
    x, k = _case(83, 2, 4, 8, 7, 12)
    before = int8.launches
    got = int8.conv_act(*_t(x, k), _shifts(4), 0)
    assert int8.launches == before
    assert torch.equal(got, int8.conv_act_reference(*_t(x, k), _shifts(4), 0,
                                                    compute_dtype="int32"))


def test_other_devices_raise_instead_of_falling_back():
    x, k = _case(84, 2, 4, 8, 16)
    before = int8.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8.conv_act(*[t.to("meta") for t in _t(x, k)],
                      _shifts(4).to("meta"), 0)
    assert int8.launches == before


def test_bad_inputs_raise():
    x, k = _case(85, 2, 4, 8, 16)
    xt, kt = _t(x, k)
    with pytest.raises(ValueError, match="uint8"):
        int8.conv_act(xt.to(torch.int32), kt, _shifts(2), 0)
    with pytest.raises(ValueError, match="uint8"):
        int8.conv_act(xt[:, 0], kt, _shifts(2), 0)  # 3-D
    with pytest.raises(ValueError, match="int8"):
        int8.conv_act(xt, kt[:, :2].contiguous(), _shifts(2), 0)  # ic mismatch
    with pytest.raises(ValueError, match="int32"):
        int8.conv_act(xt, kt, torch.tensor([2]), 0)
    with pytest.raises(ValueError, match="layer"):
        int8.conv_act(xt, kt, _shifts(2), 1)
    with pytest.raises(ValueError, match="even"):
        int8.fused_conv_layer(xt[:, :, :15].contiguous(), kt, _shifts(2), 0)
    with pytest.raises(ValueError, match="images"):
        int8.cnn_forward_pallas(xt, [kt], _shifts(2))  # (B, 4, S, S)


# ── the shift range: 0..31, the reference's unsigned register ────────


def test_plain_versions_disagree_outside_the_register():
    """The fault the range check repairs: at shift -1 the f32 plain version
    doubles the accumulator and the int32 one gives 0. No answer is the
    contract's, so the wrappers refuse the shift instead."""
    x, k = _case(86, 1, 1, 4, 8)
    xt, kt = _t(x, np.abs(k))
    shift = torch.tensor(-1, dtype=torch.int32)
    f32 = quant.shift_relu_clamp(quant.conv3x3_same(xt, kt, "float32"), shift)
    i32 = quant.shift_relu_clamp(quant.conv3x3_same(xt, kt, "int32"), shift)
    assert f32.max().item() == 255 and not torch.equal(f32.to(torch.int32), i32)


def _wrappers():
    """name -> fn(shift) calling one wrapper with that shift at layer 0."""
    x, k = _case(87, 1, 1, 16, 8)
    xt, kt = _t(x, k)
    imgs = torch.from_numpy(x[:, 0])
    return {
        "conv_act": lambda s: int8.conv_act(xt, kt, _shifts(s), 0),
        "fused_conv_layer": lambda s: int8.fused_conv_layer(xt, kt, _shifts(s), 0),
        "cnn_forward_pallas": lambda s: int8.cnn_forward_pallas(imgs, [kt], _shifts(s)),
        "cnn_forward_hybrid": lambda s: int8.cnn_forward_hybrid(imgs, [kt], _shifts(s)),
        "conv_pool_layer": lambda s: conv_pool.conv_pool_layer(xt, kt, _shifts(s), 0),
        "cnn_forward_mega": lambda s: mega.cnn_forward_mega(imgs, [kt], _shifts(s)),
    }


@pytest.mark.parametrize("shift", [-1, 32])
@pytest.mark.parametrize("name", list(_wrappers()))
def test_shift_outside_the_register_raises(name, shift):
    with pytest.raises(ValueError, match=f"shift {shift} of layer 0 is "
                                         f"outside 0..31"):
        _wrappers()[name](shift)


@pytest.mark.parametrize("name", list(_wrappers()))
def test_shift_31_still_runs(name):
    out = _wrappers()[name](31)
    assert out.dtype == torch.uint8 and int(out.max()) == 0


def test_engine_refuses_shifts_outside_the_register():
    for bad in ((-1, 4, 6), (2, 32, 6)):
        with pytest.raises(ValueError, match="outside 0..31"):
            CUDAEngine(load_model(ART, shifts=list(bad)), device="cpu")
    engine = CUDAEngine(load_model(ART), device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="shift -1 of layer 2"):
        engine.set_shifts(2, 4, -1)
    assert engine.net.shifts.tolist() == [2, 4, 6]  # the register kept its value
    engine.set_shifts(0, 31, 5)
    assert engine.net.shifts.tolist() == [0, 31, 5]


# ── the kernel, on the card ──────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA conv kernel has "
                    "no CPU or interpret mode (on the card: python -m pytest "
                    "-m cuda tests/test_torch_int8.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc,h,w,batch", [
    (1, 16, 256, 256, 37), (16, 32, 64, 64, 37), (32, 64, 32, 32, 37),
    (20, 35, 38, 38, 5), (3, 5, 6, 10, 37), (4, 7, 7, 12, 3), (2, 3, 1, 1, 4)])
@pytest.mark.parametrize("shift", [0, 3, 31])
def test_kernel_matches_plain_version_on_card(cuda_device, ic, oc, h, w,
                                              batch, shift):
    x, k = _case(88, batch, ic, oc, h, w)
    shifts = torch.tensor([7, shift], dtype=torch.int32, device=cuda_device)
    t = (torch.from_numpy(x).to(cuda_device),
         torch.from_numpy(k).to(cuda_device), shifts)
    want = int8.conv_act_reference(*t, 1, compute_dtype="int32")
    before = int8.launches
    got = int8.conv_act(*t, 1)
    torch.cuda.synchronize()
    assert int8.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)


# the pooled entry and the layer kernel, unpacked and packed, at the main
# paths' layers and the tensor-core path's edges: padded K (ic 3, 20),
# padded N tiles (oc 5, 13, 35), 128 channels, rectangles and 38x38
CARD_POOLED = [(1, 16, 256, 256, 37), (16, 32, 64, 64, 37), (32, 64, 32, 32, 37),
               (64, 128, 32, 32, 5), (1, 5, 6, 10, 37), (3, 13, 6, 10, 37),
               (20, 35, 38, 38, 5), (1, 35, 38, 38, 5), (1, 128, 32, 32, 3),
               (64, 5, 16, 16, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ic,oc,h,w,batch", CARD_POOLED)
def test_pooled_kernel_matches_plain_version_on_card(cuda_device, ic, oc, h, w,
                                                     batch, packed):
    x, k = _case(90, batch, ic, oc, h, w)
    xt = torch.from_numpy(x).to(cuda_device)
    kt = torch.from_numpy(k).to(cuda_device)
    pk = mega.pack_layer(kt) if packed else None
    for shift in (0, 3, 31):
        shifts = torch.tensor([7, shift], dtype=torch.int32, device=cuda_device)
        want = conv_pool.conv_pool_reference(xt, kt, shifts, 1, compute_dtype="int32")
        before, layer_before = int8.launches, conv_pool.launches
        got = int8.fused_conv_layer(xt, kt, shifts, 1, packed=pk)
        torch.cuda.synchronize()
        assert int8.launches == before + 1 and conv_pool.launches == layer_before
        assert got.dtype == torch.uint8 and torch.equal(got, want), shift
        if h == w:
            got = conv_pool.conv_pool_layer(xt, kt, shifts, 1, packed=pk)
            torch.cuda.synchronize()
            assert torch.equal(got, want), shift


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [127, -128])
@pytest.mark.parametrize("ic,oc,h,w", [(1, 16, 64, 64), (16, 32, 32, 32),
                                       (64, 128, 16, 16), (20, 13, 7, 12)])
def test_extreme_sums_match_plain_version_on_card(cuda_device, ic, oc, h, w, fill):
    """All-255 inputs on all +127 or all -128 weights (the largest and most
    negative sums), then 0/255 inputs on ±127/-128 weights, at shifts 0 and
    31, unpooled and (even sizes) pooled."""
    rs = np.random.RandomState(91)
    cases = [(np.full((3, ic, h, w), 255, np.uint8),
              np.full((oc, ic, 3, 3), fill, np.int8)),
             ((rs.randint(0, 2, (3, ic, h, w)) * 255).astype(np.uint8),
              np.where(rs.randint(0, 2, (oc, ic, 3, 3)) == 1, 127, fill).astype(np.int8))]
    for x, k in cases:
        xt = torch.from_numpy(x).to(cuda_device)
        kt = torch.from_numpy(k).to(cuda_device)
        for shift in (0, 31):
            shifts = torch.tensor([shift], dtype=torch.int32, device=cuda_device)
            got = int8.conv_act(xt, kt, shifts, 0)
            want = int8.conv_act_reference(xt, kt, shifts, 0, compute_dtype="int32")
            torch.cuda.synchronize()
            assert torch.equal(got, want), shift
            if h % 2 == 0 and w % 2 == 0:
                got = int8.fused_conv_layer(xt, kt, shifts, 0)
                torch.cuda.synchronize()
                assert torch.equal(got, quant.maxpool2x2(want)), shift


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc,h,w", [(1, 35, 7, 12), (1, 13, 6, 10),
                                       (64, 5, 16, 16), (3, 128, 10, 10)])
def test_unpooled_kernel_with_packed_weights_on_card(cuda_device, ic, oc, h, w):
    x, k = _case(92, 37, ic, oc, h, w)
    xt = torch.from_numpy(x).to(cuda_device)
    kt = torch.from_numpy(k).to(cuda_device)
    shifts = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    want = int8.conv_act_reference(xt, kt, shifts, 0, compute_dtype="int32")
    got = int8.conv_act(xt, kt, shifts, 0, packed=mega.pack_layer(kt))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
