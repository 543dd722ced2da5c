"""The port's contract in plain torch (``tpu_cnn_torch.ops.quant``) against
the JAX contract (``tpu_cnn.ops.quant`` on the CPU) and the numpy oracle.

Tolerance: none. The contract is integer arithmetic, and both torch paths
(f32 below 2^24, int32) are exact, so every comparison is bit-equal."""

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.models.cnn import DEFAULT_SHIFTS  # noqa: E402
from tpu_cnn.models.registry import default_shifts, get_config  # noqa: E402
from tpu_cnn.ops import quant as jquant  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch.ops import quant  # noqa: E402


def _random_kernels(rs, layer_configs):
    """Full-range int8 kernels, (oc, ic, 3, 3) per layer."""
    return [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
            for ic, oc, _ in layer_configs]


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


@pytest.mark.parametrize("accum_wrap", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "int32"])
@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small"])
def test_cnn_forward_matches_jax_and_oracle(variant, compute_dtype, accum_wrap):
    rs = np.random.RandomState(11)
    cfg = get_config(variant)
    kernels = _random_kernels(rs, cfg.layer_configs)
    shifts = default_shifts(cfg)
    imgs = rs.randint(0, 256, (3, cfg.img_size, cfg.img_size)).astype(np.uint8)
    got = quant.cnn_forward(_t(imgs), [_t(k) for k in kernels],
                            _t(shifts, np.int32), accum_wrap=accum_wrap,
                            compute_dtype=compute_dtype).numpy()
    want_jax = np.asarray(jquant.cnn_forward(
        jnp.asarray(imgs), [jnp.asarray(k) for k in kernels],
        jnp.asarray(shifts, jnp.int32), accum_wrap=accum_wrap,
        compute_dtype=compute_dtype))
    want = np.stack([numpy_cnn_forward(im, kernels, shifts,
                                       accum_wrap=accum_wrap) for im in imgs])
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want)


def test_cnn_forward_lyr3_std_shipped_weights():
    """The flagship geometry with the shipped weights.bin, both paths."""
    kernels = art.load_bundle(default_artifacts()).kernels
    rs = np.random.RandomState(12)
    imgs = rs.randint(0, 256, (2, 128, 128)).astype(np.uint8)
    shifts = list(DEFAULT_SHIFTS)
    want = np.stack([numpy_cnn_forward(im, kernels, shifts) for im in imgs])
    want_jax = np.asarray(jquant.cnn_forward(
        jnp.asarray(imgs), [jnp.asarray(k) for k in kernels],
        jnp.asarray(shifts, jnp.int32)))
    np.testing.assert_array_equal(want_jax, want)
    for compute_dtype in ("float32", "int32"):
        got = quant.cnn_forward(_t(imgs), [_t(k) for k in kernels],
                                _t(shifts, np.int32),
                                compute_dtype=compute_dtype).numpy()
        np.testing.assert_array_equal(got, want, err_msg=compute_dtype)


@pytest.mark.parametrize("shift", [0, 1, 2, 4, 6, 8])
def test_float_floor_shift_equals_arithmetic_shift(shift):
    """Negative accumulators: floor division by 2^s in f32 must equal the
    arithmetic >> of int32 (and numpy's >>), below 2^24."""
    rs = np.random.RandomState(shift)
    acc = rs.randint(-(1 << 23), 1 << 23, size=4096).astype(np.int32)
    acc[:6] = [-1, -2, -3, -(1 << 23), (1 << 23) - 1, 0]
    want = np.clip(acc >> shift, 0, 255)
    sh = torch.tensor(shift, dtype=torch.int32)
    got_i = quant.shift_relu_clamp(_t(acc), sh).numpy()
    got_f = quant.shift_relu_clamp(_t(acc, np.float32), sh).numpy()
    np.testing.assert_array_equal(got_i, want)
    np.testing.assert_array_equal(got_f, want.astype(np.float32))
    # the unclamped shift itself, on the negative values
    neg = acc[acc < 0]
    np.testing.assert_array_equal(
        torch.bitwise_right_shift(_t(neg), sh).numpy(), neg >> shift)


def test_wrap_accum_matches_jax():
    m = 1 << 23
    x = np.array([0, 1, -1, m - 1, m, -m, -m - 1, 2 * m + 5, -3 * m + 7],
                 np.int32)
    want = np.asarray(jquant.wrap_accum(jnp.asarray(x)))
    np.testing.assert_array_equal(quant.wrap_accum(_t(x)).numpy(), want)
    # f32: the same floor-mod as jnp's (x + M rounds above 2^24 in both)
    xf = x.astype(np.float32)
    np.testing.assert_array_equal(
        quant.wrap_accum(_t(xf)).numpy(),
        np.asarray(jquant.wrap_accum(jnp.asarray(xf))))


@pytest.mark.parametrize("compute_dtype", ["float32", "int32"])
def test_conv3x3_same_matches_jax(compute_dtype):
    """The accumulator before the epilogue, NCHW here vs NHWC in JAX."""
    rs = np.random.RandomState(13)
    x = rs.randint(0, 256, (2, 16, 12, 12)).astype(np.uint8)
    k = rs.randint(-127, 128, (32, 16, 3, 3)).astype(np.int8)
    got = quant.conv3x3_same(_t(x), _t(k), compute_dtype).numpy()
    want = np.asarray(jquant.conv3x3_same(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(k), compute_dtype))
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


def test_maxpool2x2_matches_torch_pool():
    rs = np.random.RandomState(14)
    x = rs.randint(0, 256, (2, 3, 8, 8)).astype(np.uint8)
    want = torch.nn.functional.max_pool2d(_t(x, np.float32), 2).numpy()
    np.testing.assert_array_equal(quant.maxpool2x2(_t(x)).numpy(), want)


def test_accum_bound_certifies_f32_exactness():
    kernels = art.load_bundle(default_artifacts()).kernels
    bound = quant.theoretical_accum_bound([_t(k) for k in kernels])
    assert bound == jquant.theoretical_accum_bound(kernels)
    assert bound < 1 << 24


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        quant.conv3x3_same(torch.zeros((1, 1, 4, 4), dtype=torch.uint8),
                           torch.zeros((16, 1, 3, 3), dtype=torch.int8),
                           "bfloat16")
