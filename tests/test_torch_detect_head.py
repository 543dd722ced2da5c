"""The port's detection head (``tpu_cnn_torch.ops.detect_head``) against
``tpu_cnn.ops.detect_head`` on the CPU, on the same features and weights.

Tolerances: predictions and boxes equal; bin pooling bit-equal (exact
integer sums, the same two divisions). Probabilities within 1e-5: the
1024-term f32 logit dot is summed in another order by torch's and XLA's
CPU matmuls, which moves a logit by ~10 ulp (~5e-6 at |logit| ~ 6) and a
probability by ~1e-6; the bench's gate allows 1e-4."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.head.cam import cam_bbox_centroid, cam_bbox_fast  # noqa: E402
from tpu_cnn.ops import detect_head as jhead  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch.ops import detect_head as head  # noqa: E402

PROBS_ATOL = 1e-5


@pytest.fixture(scope="module")
def case():
    """Features of 6 shipped test images, 2 noise maps, an all-zero map
    (an all-zero CAM: the full-frame box) and a saturated one (every
    channel masked out of the CAM), with the shipped head."""
    d = default_artifacts()
    bundle = art.load_bundle(d)
    paths = sorted(glob.glob(os.path.join(d, "test_image_*.bin")))[:6]
    feats = [numpy_cnn_forward(np.fromfile(p, np.uint8), bundle.kernels)
             for p in paths]
    rs = np.random.RandomState(31)
    feats += [rs.randint(0, 256, (64, 256)).astype(np.uint8) for _ in range(2)]
    feats += [np.zeros((64, 256), np.uint8), np.full((64, 256), 255, np.uint8)]
    return np.stack(feats), bundle


def _np(out):
    return [np.asarray(o) if not isinstance(o, torch.Tensor) else o.numpy()
            for o in out]


def _assert_same(got, want):
    pred, conf, probs, bbox = _np(got)
    wpred, wconf, wprobs, wbbox = _np(want)
    assert pred.dtype == np.int32 and bbox.dtype == np.int32
    np.testing.assert_array_equal(pred, wpred)
    np.testing.assert_allclose(probs, wprobs, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(conf, wconf, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_array_equal(bbox, wbbox)


def test_bin_pool_matches_jax(case):
    feats, _ = case
    got = head.bin_pool(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhead.bin_pool(jnp.asarray(feats))))


@pytest.mark.parametrize("box_mode", ["ref", "centroid", "reg"])
def test_detect_with_pooled_matches_jax(case, box_mode):
    """The engine's fused path: pooled bins + the bf16 feature twin."""
    feats, b = case
    pooled = np.array(jhead.bin_pool(jnp.asarray(feats)))
    got = head.detect_with_pooled(
        None, torch.from_numpy(pooled), torch.from_numpy(b.fc_weight),
        torch.from_numpy(b.fc_bias), 128,
        features_twin=torch.from_numpy(feats).to(torch.bfloat16),
        box_mode=box_mode, bbox_weight=torch.from_numpy(b.bbox_weight))
    want = jhead.detect_with_pooled(
        None, jnp.asarray(pooled), jnp.asarray(b.fc_weight),
        jnp.asarray(b.fc_bias), 128,
        features_twin=jnp.asarray(feats).astype(jnp.bfloat16),
        box_mode=box_mode, bbox_weight=jnp.asarray(b.bbox_weight))
    _assert_same(got, want)


@pytest.mark.parametrize("head_mode", ["bins", "gap"])
@pytest.mark.parametrize("box_mode", ["ref", "centroid", "reg"])
def test_detect_matches_jax(case, box_mode, head_mode):
    feats, b = case
    fc_w, fc_b = b.fc_weight, b.fc_bias
    if head_mode == "gap":  # a seeded (6, 64) GAP head
        rs = np.random.RandomState(32)
        fc_w = (rs.randn(6, 64) * 0.05).astype(np.float32)
        fc_b = (rs.randn(6) * 0.1).astype(np.float32)
    got = head.detect(torch.from_numpy(feats), torch.from_numpy(fc_w),
                      torch.from_numpy(fc_b), head_mode, 128,
                      box_mode=box_mode,
                      bbox_weight=torch.from_numpy(b.bbox_weight))
    want = jhead.detect(jnp.asarray(feats), jnp.asarray(fc_w),
                        jnp.asarray(fc_b), head_mode, 128, box_mode=box_mode,
                        bbox_weight=jnp.asarray(b.bbox_weight))
    _assert_same(got, want)


@pytest.mark.parametrize("box_mode", ["ref", "centroid"])
def test_boxes_match_host_twins(case, box_mode):
    """The same boxes as the numpy head twins the gate and apps use."""
    feats, b = case
    pred = torch.from_numpy(np.array(
        jhead.classify(jnp.asarray(feats), jnp.asarray(b.fc_weight),
                       jnp.asarray(b.fc_bias))[0]))
    got = head.cam_bbox_f32(torch.from_numpy(feats), pred,
                            torch.from_numpy(b.fc_weight), 128,
                            box_mode=box_mode).numpy()
    twin = cam_bbox_fast if box_mode == "ref" else cam_bbox_centroid
    want = np.stack([twin(f, int(p), b.fc_weight) for f, p in zip(feats, pred)])
    np.testing.assert_array_equal(got, want)


def test_all_zero_cam_gives_the_full_frame(case):
    feats, b = case
    zero = torch.zeros((2, 64, 256), dtype=torch.float32)
    for mode in ("ref", "centroid"):
        got = head.cam_bbox_f32(zero, torch.tensor([0, 3]),
                                torch.from_numpy(b.fc_weight), 128,
                                box_mode=mode)
        np.testing.assert_array_equal(got.numpy(), [[0, 0, 127, 127]] * 2)


def test_flat_cam_ties_at_the_threshold():
    """Uniform weights over a constant map: every CAM value is 1.0, the
    threshold is 1.0 and ``cam > thr`` holds nowhere — the full frame, as
    in the JAX head."""
    feats = np.full((2, 64, 256), 7, np.uint8)
    w = np.ones((6, 1024), np.float32)
    cls = np.array([1, 4], np.int32)
    got = head.cam_bbox_f32(torch.from_numpy(feats), torch.from_numpy(cls),
                            torch.from_numpy(w), 128).numpy()
    want = np.asarray(jhead.cam_bbox(jnp.asarray(feats), jnp.asarray(cls),
                                     jnp.asarray(w), 128))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 0, 127, 127]] * 2)


@pytest.mark.parametrize("n", [256, 16, 7])
def test_percentile_topk_matches_jax(n):
    """Rows with many ties (quarter steps): the two order statistics and
    the host-f64 fraction give the JAX head's threshold bit for bit, and
    numpy's percentile to f32 rounding."""
    rs = np.random.RandomState(n)
    x = (rs.randint(0, 5, (40, n)) / 4).astype(np.float32)
    got = head._percentile_topk(torch.from_numpy(x), 70.0).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jhead._percentile_topk(jnp.asarray(x), 70.0)))
    np.testing.assert_allclose(got, np.percentile(x, 70, axis=1), rtol=1e-6)


def test_bbox_from_cam_extremal_rows_and_cols():
    """A hand-made CAM: the box spans the extreme rows/cols above the
    threshold, scaled by 128/16 and clipped to the image."""
    cam = torch.zeros((1, 16, 16))
    cam[0, 3, 5] = 1.0
    cam[0, 15, 9] = 0.9
    got = head._bbox_from_cam(cam, 128).numpy()
    np.testing.assert_array_equal(got, [[5 * 8, 3 * 8, 10 * 8, 127]])
