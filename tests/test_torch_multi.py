"""The port's multi-object and instance heads (``tpu_cnn_torch.ops.
detect_head``) and ``CUDAEngine.detect_multi_batch`` against the JAX
package (``tpu_cnn.ops.detect_head``, ``TPUEngine(backend="xla")``) and
the host twins (``tpu_cnn.head.cam``) on the CPU, on the same seeded
inputs; the engine module's JAX-free detection filters against the
originals in ``tpu_cnn.engine.tpu``.

None of these functions is a Pallas kernel in the JAX package; on the
card the same torch code runs on CUDA tensors (the test marked ``cuda``
holds it against the CPU engine there and skips elsewhere).

Tolerances: boxes, labels, pixel counts, ranking keys and predictions
equal. The per-class CAMs within 1e-6 (torch's and XLA's CPU matmuls sum
the 64-term CAM dot in different orders: ulps of a value at most 1).
Probabilities and presence scores within 1e-4, the JAX verify's bound
(the 1024-term logit dot in another order moves a score by ~1e-6)."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.apps.common import load_model  # noqa: E402
from tpu_cnn.engine import tpu as jeng  # noqa: E402
from tpu_cnn.engine.tpu import TPUEngine  # noqa: E402
from tpu_cnn.head import cam as host_cam  # noqa: E402
from tpu_cnn.head.classify import bin_pool_np, multi_scores_np  # noqa: E402
from tpu_cnn.models.cnn import FpgaCNN  # noqa: E402
from tpu_cnn.models.registry import default_shifts, get_config  # noqa: E402
from tpu_cnn.ops import detect_head as jhead  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch.apps.kernel_cases import MODULES  # noqa: E402
from tpu_cnn_torch.engine import cuda as peng  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.models.cnn import TorchFpgaCNN  # noqa: E402
from tpu_cnn_torch.ops import detect_head as head  # noqa: E402
from tpu_cnn_torch.head import cam as host_twins  # noqa: E402

SCORE_ATOL = 1e-4
CAM_ATOL = 1e-6
ART = default_artifacts()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 16  # the CAM side of lyr3-std and lyr2-small


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(out):
    return [o.numpy() for o in out]


@pytest.fixture(scope="module")
def feats():
    """Integer-valued features (6, 64, 256) in 0..199, channel 3 saturated
    (masked out of the CAM), one all-zero map, and a seeded (6, 1024)
    head; as u8."""
    rs = np.random.RandomState(61)
    f = rs.randint(0, 200, (6, 64, 256)).astype(np.uint8)
    f[:, 3] = 255
    f[5] = 0
    fc_w = rs.randn(6, 1024).astype(np.float32)
    return f, fc_w


# ── the heads against the JAX package and the host twins ─────────────


def test_multi_cam_stack_matches_jax(feats):
    f, w = feats
    got = head._multi_cam_stack(_t(f.astype(np.float32)), _t(w))
    want = np.asarray(jhead._multi_cam_stack(jnp.asarray(f, jnp.float32),
                                             jnp.asarray(w)))
    assert tuple(got.shape) == (36, S, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CAM_ATOL)
    # row b*K + k is class k's single-box CAM of image b
    single = head._normalized_cam_f32(_t(f.astype(np.float32)),
                                      torch.full((6,), 2, dtype=torch.int32), _t(w))
    assert torch.equal(got.reshape(6, 6, S * S)[:, 2], single)


@pytest.mark.parametrize("box_mode", ["ref", "centroid"])
def test_cam_bbox_multi_matches_jax_and_host(feats, box_mode):
    f, w = feats
    got = head.cam_bbox_multi_f32(_t(f.astype(np.float32)), _t(w), 128, box_mode)
    want = np.asarray(jhead.cam_bbox_multi_f32(jnp.asarray(f, jnp.float32),
                                               jnp.asarray(w), 128, box_mode))
    assert got.dtype == torch.int32 and tuple(got.shape) == (6, 6, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(len(f)):
        np.testing.assert_array_equal(
            got[b].numpy(), host_cam.cam_bbox_multi(f[b], w, 128, box_mode))


@pytest.mark.parametrize("instances", [1, 2, 3])
@pytest.mark.parametrize("box_mode", ["ref", "centroid"])
def test_multi_head_shared_matches_jax(feats, instances, box_mode):
    f, w = feats
    got = head._multi_head_shared(_t(f.astype(np.float32)), _t(w), 256,
                                  box_mode, instances)
    want = jhead._multi_head_shared(jnp.asarray(f, jnp.float32),
                                    jnp.asarray(w), 256, box_mode, instances)
    assert len(got) == len(want) == (1 if instances == 1 else 3)
    for g, wnt in zip(_np(got), want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("max_instances", [1, 2, 4])
def test_cam_instances_matches_jax_and_host(feats, max_instances):
    f, w = feats
    boxes, counts = head.cam_instances_f32(_t(f.astype(np.float32)), _t(w),
                                           128, max_instances)
    jb, jc = jhead.cam_instances_f32(jnp.asarray(f, jnp.float32),
                                     jnp.asarray(w), 128, max_instances)
    assert tuple(boxes.shape) == (6, 6, max_instances, 4)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    for b in range(len(f)):
        hb, hc = host_cam.cam_instances(f[b], w, 128, max_instances)
        np.testing.assert_array_equal(boxes[b].numpy(), hb)
        np.testing.assert_array_equal(counts[b].numpy(), hc)


def test_multi_scores_matches_jax_and_host(feats):
    f, _ = feats
    rs = np.random.RandomState(62)
    mw = (rs.randn(6, 1024) * 0.3).astype(np.float32)
    mb = rs.randn(6).astype(np.float32)
    pooled = bin_pool_np(f)
    got = head.multi_scores(_t(pooled), _t(mw), _t(mb)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhead.multi_scores(
        jnp.asarray(pooled), jnp.asarray(mw), jnp.asarray(mb))),
        rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got, multi_scores_np(pooled, mw, mb), rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("instances", [1, 2])
def test_detect_multi_with_pooled_matches_jax(feats, instances):
    f, w = feats
    rs = np.random.RandomState(63)
    b = rs.randn(6).astype(np.float32)
    mh = ((rs.randn(6, 1024) * 0.05).astype(np.float32), np.zeros(6, np.float32))
    pooled = bin_pool_np(f)
    twin = f.astype(np.float32)  # the kernel's twin, as exact bf16 values
    got = head.detect_multi_with_pooled(
        _t(pooled), _t(twin).to(torch.bfloat16), _t(w), _t(b), 128,
        instances=instances, multi_head=(_t(mh[0]), _t(mh[1])))
    want = jhead.detect_multi_with_pooled(
        jnp.asarray(pooled), jnp.asarray(twin, jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), 128, instances=instances,
        multi_head=tuple(jnp.asarray(a) for a in mh))
    _assert_multi_out(_np(got), [np.asarray(a) for a in want])


@pytest.mark.parametrize("head_mode", ["bins", "gap"])
@pytest.mark.parametrize("instances", [1, 2])
def test_detect_multi_matches_jax(feats, head_mode, instances):
    f, w = feats
    rs = np.random.RandomState(64)
    d = 1024 if head_mode == "bins" else 64
    fw = w if head_mode == "bins" else (rs.randn(6, 64) * 0.05).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    mh = ((rs.randn(6, d) * 0.05).astype(np.float32), np.zeros(6, np.float32))
    got = head.detect_multi(_t(f), _t(fw), _t(b), head_mode, 128,
                            instances=instances,
                            multi_head=(_t(mh[0]), _t(mh[1])))
    want = jhead.detect_multi(jnp.asarray(f), jnp.asarray(fw), jnp.asarray(b),
                              head_mode, 128, instances=instances,
                              multi_head=tuple(jnp.asarray(a) for a in mh))
    _assert_multi_out(_np(got), [np.asarray(a) for a in want])


def _assert_multi_out(got, want):
    """(pred, conf, probs, boxes[, inst_boxes, inst_counts], scores)."""
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    for i in (1, 2, -1):  # conf, probs, scores
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=SCORE_ATOL)
    for g, w in zip(got[3:-1], want[3:-1]):  # boxes, instances, counts
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# ── the label loops, on crafted masks ────────────────────────────────


def _labels_three_ways(masks: np.ndarray):
    """_connected_labels of the port and of the JAX package, and the host
    twin's, for (N, s, s) bool masks."""
    got = head._connected_labels(_t(masks)).numpy()
    want = np.asarray(jhead._connected_labels(jnp.asarray(masks)))
    host = np.stack([host_cam.connected_labels_np(m) for m in masks])
    return got, want, host


def _snake(s: int = S) -> np.ndarray:
    """A one-pixel serpentine through every other row: 136 pixels end to
    end on 16x16, far more label steps than one block."""
    m = np.zeros((s, s), bool)
    for r in range(0, s, 2):
        m[r] = True
        if r + 1 < s:
            m[r + 1, s - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _crafted_masks() -> np.ndarray:
    two = np.zeros((S, S), bool)
    two[1:4, 1:4] = True  # blob A, min index 17
    two[9:13, 8:12] = True  # blob B
    two[10, 2] = two[11, 3] = True  # a diagonal pair: not 4-connected
    return np.stack([two, np.zeros((S, S), bool), _snake(),
                     np.random.RandomState(65).rand(S, S) < 0.4])


def test_connected_labels_match_jax_and_host():
    got, want, host = _labels_three_ways(_crafted_masks())
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    two = got[0]
    assert two[1, 1] == two[3, 3] == 17 and two[10, 2] != two[11, 3]
    assert (got[1] == S * S).all()  # the empty mask: background only
    assert (got[2][_snake()] == 0).all()  # the snake: one component


def _counting_steps(monkeypatch):
    """Count the label loops' steps (one neighbour-min each) and their
    host syncs (one torch.equal each)."""
    counts = {"steps": 0, "syncs": 0}
    real_min, real_equal = head._neighbour_min, torch.equal

    def neighbour_min(*a):
        counts["steps"] += 1
        return real_min(*a)

    def equal(*a):
        counts["syncs"] += 1
        return real_equal(*a)

    monkeypatch.setattr(head, "_neighbour_min", neighbour_min)
    monkeypatch.setattr(head.torch, "equal", equal)
    return counts


def test_snake_takes_more_than_one_block_of_steps(monkeypatch):
    """The min label walks the snake one pixel a step: the loop must run
    several blocks of LABEL_BLOCK steps (one host sync each) and still
    stop at the JAX package's fixed point."""
    counts = _counting_steps(monkeypatch)
    got = head._connected_labels(_t(_snake()[None])).numpy()
    assert counts["syncs"] > 1
    assert counts["steps"] == counts["syncs"] * head.LABEL_BLOCK
    monkeypatch.undo()
    _, want, host = _labels_three_ways(_snake()[None])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    # growth from one end: a marker at the top-left grows the whole snake
    cores = np.zeros((S, S), bool)
    cores[0, 0] = True
    seeds = host_cam.connected_labels_np(cores)
    counts = _counting_steps(monkeypatch)
    grown = head._grow_labels(_t(seeds[None]), _t(_snake()[None])).numpy()
    assert counts["syncs"] > 1
    monkeypatch.undo()
    np.testing.assert_array_equal(grown[0], host_cam.grow_labels_np(seeds, _snake()))
    np.testing.assert_array_equal(grown, np.asarray(jhead._grow_labels(
        jnp.asarray(seeds[None]), jnp.asarray(_snake()[None]))))
    assert (grown[0][_snake()] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grow_labels_match_jax_and_host(seed):
    """Contested pixels (equidistant from two markers) take the smaller
    label in all three."""
    rs = np.random.RandomState(seed)
    mask = rs.rand(S, S) < 0.6
    cores = mask & (rs.rand(S, S) < 0.2)
    seeds = host_cam.connected_labels_np(cores)
    got = head._grow_labels(_t(seeds[None]), _t(mask[None])).numpy()[0]
    np.testing.assert_array_equal(got, host_cam.grow_labels_np(seeds, mask))
    np.testing.assert_array_equal(got, np.asarray(jhead._grow_labels(
        jnp.asarray(seeds[None]), jnp.asarray(mask[None])))[0])


@pytest.mark.parametrize("max_instances", [1, 2, 4])
def test_component_stats_matches_jax(max_instances):
    masks = np.random.RandomState(66).rand(6, S, S) < 0.3
    masks[4] = False  # background only
    masks[5] = False
    masks[5, 2:5, 3:7] = True  # exactly one component
    labels = np.stack([host_cam.connected_labels_np(m)
                       for m in masks]).reshape(6, S * S)
    lab, cnt = head._component_stats(_t(labels), max_instances)
    jlab, jcnt = jhead._component_stats(jnp.asarray(labels), max_instances)
    assert lab.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert lab[4].tolist() == [-1] * max_instances and cnt[4].sum() == 0
    assert cnt[5, 0] == 12 and lab[5, 0] == 2 * S + 3


def test_component_stats_refuses_more_than_1024_pixels():
    with pytest.raises(ValueError, match="at most 1024 pixels"):
        head._component_stats(torch.zeros((1, 33 * 33), dtype=torch.int32), 2)


def _instances_three_ways(f: np.ndarray, w: np.ndarray, max_instances=3):
    boxes, counts = head.cam_instances_f32(_t(f.astype(np.float32)), _t(w),
                                           128, max_instances)
    jb, jc = jhead.cam_instances_f32(jnp.asarray(f, jnp.float32),
                                     jnp.asarray(w), 128, max_instances)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    hb, hc = host_cam.cam_instances(f[0], w, 128, max_instances)
    np.testing.assert_array_equal(boxes[0].numpy(), hb)
    np.testing.assert_array_equal(counts[0].numpy(), hc)
    return boxes[0, 0].numpy(), counts[0, 0].numpy()


def _one_channel_features(fm: np.ndarray):
    """Features whose class-0 CAM is ``fm`` (channel 0, all 16 bins of fc
    row 0); the other classes look at the empty channel 1."""
    f = np.zeros((1, 64, S * S), np.uint8)
    f[0, 0] = fm.reshape(-1)
    w = np.zeros((6, 1024), np.float32)
    w[0, 0:16] = 1.0
    w[1:, 16:32] = 0.5
    return f, w


def test_two_blobs_are_two_instances():
    fm = np.zeros((S, S), np.uint8)
    fm[2:7, 2:7] = 200
    fm[9:14, 10:15] = 200
    boxes, counts = _instances_three_ways(*_one_channel_features(fm))
    assert counts.tolist() == [25, 25, 0]
    assert boxes[0].tolist() == [16, 16, 56, 56]  # scale 8: cols/rows 2-6
    assert boxes[1].tolist() == [80, 72, 120, 112]
    assert boxes[2].tolist() == [0, 0, 127, 127]  # absent: the full frame


def test_plateau_cam_without_a_core_uses_the_whole_mask():
    """A constant CAM over a quarter of the map: the percentile-88 core
    threshold is the maximum, so no pixel is a core, and the mask's own
    component is the instance."""
    fm = np.zeros((S, S), np.uint8)
    fm[4:12, 4:12] = 150  # 64 of 256 pixels
    boxes, counts = _instances_three_ways(*_one_channel_features(fm))
    assert counts.tolist() == [64, 0, 0]
    assert boxes[0].tolist() == [32, 32, 96, 96]


def test_empty_mask_gives_no_instance():
    boxes, counts = _instances_three_ways(
        *_one_channel_features(np.zeros((S, S), np.uint8)))
    assert counts.tolist() == [0, 0, 0]
    assert (boxes == [0, 0, 127, 127]).all()


@pytest.mark.parametrize("max_instances", [1, 2, 3])
def test_jax_free_instance_twin_equals_the_host_twin(feats, max_instances):
    assert (host_twins.CAM_CORE_PERCENTILE == jhead.CAM_CORE_PERCENTILE
            == head.CAM_CORE_PERCENTILE)
    f, w = feats
    fm = np.zeros((S, S), np.uint8)
    fm[4:12, 4:12] = 150  # a plateau: the fallback to the mask
    plateau, pw = _one_channel_features(fm)
    for x, fw in [(f[b], w) for b in range(len(f))] + [(plateau[0], pw)]:
        got = host_twins.cam_instances(x, fw, 128, max_instances)
        want = host_cam.cam_instances(x, fw, 128, max_instances)
        for g, wnt in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, wnt)


def test_host_instance_twin_imports_jax_and_the_ports_does_not():
    """The fault the port's copy works around: the host twin
    ``tpu_cnn.head.cam.cam_instances`` imports ``tpu_cnn.ops.detect_head``,
    and so jax, for one constant; ``tpu_cnn_torch.head.cam`` pins it."""
    code = (
        "import sys, numpy as np\n"
        "from tpu_cnn.head import cam\n"
        "from tpu_cnn_torch.head import cam as host_twins\n"
        "f = np.zeros((4, 256), np.uint8); w = np.ones((6, 64), np.float32)\n"
        "host_twins.cam_instances(f, w)\n"
        "print('jax' in sys.modules)\n"
        "cam.cam_instances(f, w)\n"
        "print('jax' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True"]


# ── the engine against TPUEngine(backend="xla") ──────────────────────


def _lyr2_model(seed=67, gap=False):
    cfg = get_config("lyr2-small")
    rs = np.random.RandomState(seed)
    kernels = [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
               for ic, oc, _ in cfg.layer_configs]
    d = cfg.layer_configs[-1][1] * (1 if gap else 16)
    fc_w = (rs.randn(6, d) * 0.05).astype(np.float32)
    fc_b = (rs.randn(6) * 0.1).astype(np.float32)
    mh = ((rs.randn(6, d) * 0.05).astype(np.float32),
          (rs.randn(6) * 0.1).astype(np.float32))
    return FpgaCNN(kernels, fc_w, fc_b, shifts=default_shifts(cfg), config=cfg,
                   multi_head=mh)


@pytest.fixture(scope="module")
def lyr2():
    """(model factory, images, the JAX engine's results by instances)."""
    rs = np.random.RandomState(68)
    imgs = rs.randint(0, 256, (5, 64, 64)).astype(np.uint8)
    ref = TPUEngine(_lyr2_model(), backend="xla")
    return imgs, {i: ref.detect_multi_batch(imgs, instances=i) for i in (1, 2)}


def _assert_result_equal(got, want, threshold):
    assert isinstance(got, peng.MultiDetectResult)
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_allclose(got.conf, want.conf, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=SCORE_ATOL)
    assert got.boxes.dtype == np.int32
    np.testing.assert_array_equal(got.boxes, want.boxes)
    if want.inst_boxes is None:
        assert got.inst_boxes is None and got.inst_counts is None
    else:
        assert got.inst_boxes.dtype == got.inst_counts.dtype == np.int32
        np.testing.assert_array_equal(got.inst_boxes, want.inst_boxes)
        np.testing.assert_array_equal(got.inst_counts, want.inst_counts)
    if want.scores is None:
        assert got.scores is None
    else:
        np.testing.assert_allclose(got.scores, want.scores, rtol=0,
                                   atol=SCORE_ATOL)
    for g, w in zip(got.detections(threshold), want.detections(threshold)):
        assert [(k, b) for k, _, b in g] == [(k, b) for k, _, b in w]
        np.testing.assert_allclose([p for _, p, _ in g], [p for _, p, _ in w],
                                   rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("instances", [1, 2])
@pytest.mark.parametrize("backend", ["mega", "pallas", "hybrid", "xla"])
def test_engine_matches_tpu_engine_lyr2_small(lyr2, backend, instances):
    imgs, want = lyr2
    before = {name: m.launches for name, m in MODULES.items()}
    port = CUDAEngine(_lyr2_model(), device="cpu", backend=backend)
    _assert_result_equal(port.detect_multi_batch(imgs, instances=instances),
                         want[instances], 0.3)
    # the CPU runs the plain versions: no wrapper counted a launch
    assert {name: m.launches for name, m in MODULES.items()} == before


@pytest.fixture(scope="module")
def lyr3_images():
    """4 shipped test images + 2 noise images."""
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:4]
    imgs = [np.fromfile(p, np.uint8).reshape(128, 128) for p in paths]
    rs = np.random.RandomState(69)
    imgs += [rs.randint(0, 256, (128, 128)).astype(np.uint8) for _ in range(2)]
    return np.stack(imgs)


@pytest.mark.parametrize("instances", [1, 2])
def test_engine_matches_tpu_engine_lyr3_std_shipped(lyr3_images, instances):
    """The shipped bundle: its presence head and per-class floors."""
    model = load_model(ART)
    assert model.multi_head is not None and model.multi_thresh is not None
    want = TPUEngine(load_model(ART), backend="xla").detect_multi_batch(
        lyr3_images, instances=instances)
    port = CUDAEngine(model, device="cpu")
    _assert_result_equal(port.detect_multi_batch(lyr3_images, instances=instances),
                         want, model.multi_thresh)
    staged = port.detect_multi_resolve(port.detect_multi_batch_async(
        port.stage_batch(lyr3_images), instances=instances))
    _assert_result_equal(staged, want, model.multi_thresh)


@pytest.mark.parametrize("backend", ["mega", "pallas", "xla"])
def test_engine_gap_head_matches_tpu_engine(lyr2, backend):
    """A seeded (6, 64) GAP head and presence head: every class shares the
    unweighted activation-map CAM."""
    imgs, _ = lyr2
    want = TPUEngine(_lyr2_model(70, gap=True), backend="xla").detect_multi_batch(
        imgs, instances=2)
    port = CUDAEngine(_lyr2_model(70, gap=True), device="cpu", backend=backend)
    assert port.model.head_mode == "gap"
    _assert_result_equal(port.detect_multi_batch(imgs, instances=2), want, 0.2)


def test_box_mode_reg_falls_back_to_the_cam_box(lyr3_images):
    model = load_model(ART)
    reg = CUDAEngine(model, device="cpu", box_mode="reg")
    ref = CUDAEngine(load_model(ART), device="cpu")
    got, want = (e.detect_multi_batch(lyr3_images[:3]) for e in (reg, ref))
    np.testing.assert_array_equal(got.boxes, want.boxes)


def test_compact_wire_round_trip(lyr3_images):
    """Boxes ride as u8 and counts as int16 on the device->host copy when
    the image is at most 256 pixels; the host gets int32, the values of
    the JAX engine's int32 results."""
    compact = CUDAEngine(load_model(ART), device="cpu")
    assert compact.compact_multi
    x, _ = compact._to_device(lyr3_images)
    wire = compact.detect_multi_device(x, 2)
    assert (wire[3].dtype, wire[4].dtype, wire[5].dtype) == (
        torch.uint8, torch.uint8, torch.int16)
    a = compact.detect_multi_batch(lyr3_images, instances=2)
    b = TPUEngine(load_model(ART), backend="xla").detect_multi_batch(
        lyr3_images, instances=2)
    for f in ("boxes", "inst_boxes", "inst_counts"):
        assert getattr(a, f).dtype == np.int32
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_warmup_runs_the_multi_program(monkeypatch):
    engine = CUDAEngine(load_model(ART), device="cpu")
    calls = []
    real = engine.detect_multi_batch
    monkeypatch.setattr(engine, "detect_multi_batch",
                        lambda imgs, instances=1: calls.append(
                            (imgs.shape, instances)) or real(imgs, instances))
    engine.warmup(batch=2, multi=True, instances=2)
    assert calls == [((2, 128, 128), 2)]
    with pytest.raises(ValueError, match="instances"):
        engine.detect_multi_batch(np.zeros((1, 128, 128), np.uint8), instances=0)


# ── the detection filters, the result type and the model ────────────


def _rows(seed, k=6, i=3):
    rs = np.random.RandomState(seed)
    probs = rs.rand(k).astype(np.float32)
    boxes = rs.randint(0, 128, (k, 4)).astype(np.int32)
    inst_boxes = rs.randint(0, 128, (k, i, 4)).astype(np.int32)
    inst_counts = rs.randint(0, 40, (k, i)).astype(np.int32)
    inst_counts[0] = (30, 0, 0)  # one instance: the class box instead
    inst_counts[1] = (30, 29, 3)  # two survive the floors
    return probs, boxes, inst_boxes, inst_counts


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.9,
                                       [0.1, 0.5, 0.2, 0.9, 0.0, 0.4]])
@pytest.mark.parametrize("seed", [71, 72, 73])
def test_detection_filters_match_the_originals(seed, threshold):
    probs, boxes, ib, ic = _rows(seed)
    assert (peng.detections_above(probs, boxes, threshold)
            == jeng.detections_above(probs, boxes, threshold))
    for kw in ({}, {"min_pixels": 1}, {"min_pixels": 20, "min_frac": 0.9}):
        assert (peng.instance_detections(probs, boxes, ib, ic, threshold, **kw)
                == jeng.instance_detections(probs, boxes, ib, ic, threshold,
                                            **kw))


def test_result_type_and_presence_scores_match_the_originals():
    import dataclasses

    assert ([f.name for f in dataclasses.fields(peng.MultiDetectResult)]
            == [f.name for f in dataclasses.fields(jeng.MultiDetectResult)])
    rows = [_rows(s) for s in (74, 75)]
    probs, boxes, ib, ic = (np.stack(a) for a in zip(*rows))
    pred = probs.argmax(1).astype(np.int32)
    conf = probs.max(1)
    scores = np.random.RandomState(76).rand(2, 6).astype(np.float32)
    for extra in ({}, {"inst_boxes": ib, "inst_counts": ic},
                  {"scores": scores},
                  {"inst_boxes": ib, "inst_counts": ic, "scores": scores}):
        p = peng.MultiDetectResult(pred, conf, probs, boxes, **extra)
        j = jeng.MultiDetectResult(pred, conf, probs, boxes, **extra)
        np.testing.assert_array_equal(peng.presence_scores(p),
                                      jeng.presence_scores(j))
        for thr in (0.15, [0.3] * 6):
            assert p.detections(thr) == j.detections(thr)
        assert p.detections() == j.detections()


def test_model_carries_the_multi_head():
    model = load_model(ART)
    net = TorchFpgaCNN.from_fpga_cnn(model, "cpu")
    mw, mb = net.multi_head
    assert mw.dtype == mb.dtype == torch.float32
    np.testing.assert_array_equal(mw.numpy(), model.multi_head[0])
    np.testing.assert_array_equal(mb.numpy(), model.multi_head[1])
    bare = FpgaCNN(model.kernels, model.fc_weight, model.fc_bias)
    assert bare.multi_head is None
    assert TorchFpgaCNN.from_fpga_cnn(bare, "cpu").multi_head is None


# ── on the card ──────────────────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the multi head runs on the "
                    "card's kernels (on the card: python -m pytest -m cuda "
                    "tests/test_torch_multi.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("instances", [1, 2])
@pytest.mark.parametrize("backend", ["mega", "pallas", "hybrid", "xla"])
def test_detect_multi_on_card_matches_cpu(cuda_device, lyr3_images, backend,
                                          instances):
    model = load_model(ART)
    got = CUDAEngine(load_model(ART), device="cuda", backend=backend
                     ).detect_multi_batch(lyr3_images, instances=instances)
    want = CUDAEngine(load_model(ART), device="cpu", backend=backend
                      ).detect_multi_batch(lyr3_images, instances=instances)
    _assert_result_equal(got, want, model.multi_thresh)
