"""The port's device preprocess (``tpu_cnn_torch.ops.preprocess``) on the
CPU against ``tpu_cnn.ops.preprocess`` (run on JAX's CPU backend) and the
port's native and numpy twins, bit for bit: every input form (BGR and RGB,
4-channel, packed uint32 and int32 words, gray), the camera geometries on
both of the JAX function's nearest-sampling lowerings (its phase path and
its dense path), the exact area mean, upsampling, ``valid_w`` on a padded
pitch and its error."""

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.ops import preprocess as j_pre  # noqa: E402
from tpu_cnn.ops.luma import pack_bgrx as j_pack_bgrx  # noqa: E402
from tpu_cnn_torch.apps.realtime import preprocess as numpy_twin  # noqa: E402
from tpu_cnn_torch.native.preprocess import preprocess_frames_native  # noqa: E402
from tpu_cnn_torch.ops import preprocess as pre  # noqa: E402
from tpu_cnn_torch.ops.luma import pack_bgrx  # noqa: E402

# (W, H) camera geometries -> the JAX function's branch for 128^2 out
GEOMETRIES = {
    (640, 480): "dense (lane-aligned pitch)",
    (320, 240): "phase",
    (177, 131): "dense (q > 8)",
    (127, 127): "dense (q > 8)",
    (300, 200): "dense (q = 16)",
    (720, 560): "phase",
    (656, 480): "phase",
    (1280, 720): "dense (lane-aligned pitch)",
    (320, 256): "exact area mean",
    (96, 64): "upsample",
}


def _forms(rs, w, h, b=2):
    """(form, input, channel order, the numpy twin's answer) at batch b."""
    f4 = rs.randint(0, 256, (b, h, w, 4)).astype(np.uint8)
    f3 = np.ascontiguousarray(f4[..., :3])
    gray = rs.randint(0, 256, (b, h, w)).astype(np.uint8)
    bgr = np.stack([numpy_twin(f) for f in f3])
    rgb = np.stack([numpy_twin(f[..., ::-1]) for f in f3])
    words = pack_bgrx(f4)
    return [("bgr", f3, "bgr", bgr), ("rgb", f3, "rgb", rgb),
            ("bgrx", f4, "bgr", bgr), ("rgbx", f4, "rgb", rgb),
            ("packed uint32", words, "bgr", bgr),
            ("packed uint32 rgb", words, "rgb", rgb),
            ("packed int32", words.view(np.int32), "bgr", bgr),
            ("gray", gray, "bgr", np.stack([numpy_twin(f) for f in gray]))]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_preprocess_frames_equals_the_jax_function(geometry):
    w, h = geometry
    rs = np.random.RandomState(w * 1000 + h)
    for form, x, order, want in _forms(rs, w, h):
        got = pre.preprocess_frames(torch.from_numpy(x), 128, channel_order=order)
        assert got.dtype == torch.uint8 and got.shape == (2, 128, 128), form
        got = got.numpy()
        jx = x.view(np.uint32) if form == "packed int32" else x
        np.testing.assert_array_equal(
            got, np.asarray(j_pre.preprocess_frames(jx, 128, channel_order=order)),
            err_msg=f"{w}x{h} {form} ({GEOMETRIES[geometry]}) vs JAX")
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} {form} vs numpy")
        if form in ("bgr", "rgb", "gray"):
            np.testing.assert_array_equal(
                got, preprocess_frames_native(x, 128, channel_order=order),
                err_msg=f"{w}x{h} {form} vs native")


@pytest.mark.parametrize("w,h,pitch", [(640, 480, 648), (480, 640, 496),
                                       (320, 256, 336), (177, 131, 180)])
def test_preprocess_frames_valid_w(w, h, pitch):
    """Frames staged at a wider row pitch: bit-identical to the unpadded
    frame, the pad never read; equal to the JAX function's ``valid_w``."""
    rs = np.random.RandomState(pitch)
    f4 = rs.randint(0, 256, (2, h, w, 4)).astype(np.uint8)
    want = np.stack([numpy_twin(f[..., :3]) for f in f4])
    staged = np.full((2, h, pitch), 0xDEADBEEF, np.uint32)
    staged[:, :, :w] = pack_bgrx(f4)
    padded4 = np.full((2, h, pitch, 4), 0xEE, np.uint8)
    padded4[:, :, :w] = f4
    for x in (staged, padded4):
        got = pre.preprocess_frames(torch.from_numpy(x), 128, valid_w=w).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(j_pre.preprocess_frames(x, 128, valid_w=w)))
    # valid_w == the pitch is the default path
    np.testing.assert_array_equal(
        pre.preprocess_frames(torch.from_numpy(pack_bgrx(f4)), 128, valid_w=w).numpy(),
        want)


@pytest.mark.parametrize("valid_w", [9, 0, -1])
def test_preprocess_frames_refuses_valid_w_out_of_range(valid_w):
    x = np.zeros((1, 8, 8), np.uint32)
    for fn in (lambda: pre.preprocess_frames(torch.from_numpy(x), 4, valid_w=valid_w),
               lambda: j_pre.preprocess_frames(x, 4, valid_w=valid_w)):
        with pytest.raises(ValueError, match="out of range for staged width 8"):
            fn()


def test_preprocess_frames_channel_order_and_passthrough():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randint(0, 256, (2, 16, 16, 3)).astype(np.uint8))
    with pytest.raises(ValueError, match="channel_order"):
        pre.preprocess_frames(x, 8, channel_order="bgrx")
    gray = rs.randint(0, 256, (2, 128, 128)).astype(np.uint8)
    np.testing.assert_array_equal(
        pre.preprocess_frames(torch.from_numpy(gray)).numpy(), gray)


def test_luma_functions_equal_the_jax_ones():
    rs = np.random.RandomState(6)
    f4 = rs.randint(0, 256, (3, 5, 7, 4)).astype(np.uint8)
    f4[0, 0, :4] = ((255, 255, 255, 255), (0, 0, 0, 0), (255, 0, 0, 9),
                    (0, 0, 255, 200))
    words = j_pack_bgrx(f4)
    for order in ("bgr", "rgb"):
        want = np.asarray(j_pre.bt601_gray(f4[..., :3], order)).astype(np.int32)
        np.testing.assert_array_equal(
            pre.bt601_gray(torch.from_numpy(f4[..., :3]), order).numpy(), want)
        np.testing.assert_array_equal(
            pre.bt601_gray(torch.from_numpy(f4), order).numpy(), want)
        for w in (words, words.view(np.int32)):
            np.testing.assert_array_equal(
                pre.bt601_gray_packed(torch.from_numpy(w), order).numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(j_pre.bt601_gray_packed(words, order)).astype(np.int32), want)
    with pytest.raises(TypeError, match="uint32 or int32"):
        pre.bt601_gray_packed(torch.zeros(3, dtype=torch.int64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "-m cuda tests/test_torch_preprocess.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(640, 480), (320, 240), (1280, 720),
                                      (320, 256)])
def test_preprocess_frames_on_the_card(cuda_device, geometry):
    """The same torch ops on the card: bit-equal to the numpy twin, and
    the output stays on the card."""
    w, h = geometry
    for form, x, order, want in _forms(np.random.RandomState(w + h), w, h, b=5):
        got = pre.preprocess_frames(torch.from_numpy(x).to(cuda_device), 128,
                                    channel_order=order)
        assert got.device.type == "cuda", form
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=form)
