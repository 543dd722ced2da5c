"""The single-box CAM head's kernel (``tpu_cnn_torch.ops.cam_head``,
``csrc/cam_head.cu``): its wrapper against ``detect_head.detect_with_pooled``
with ``box_mode="ref"``, its guards, the engine's routing to it, its span
and counter, and the benchmark's reader of that counter.

On CPU tensors the wrapper runs the plain version, which is
``detect_with_pooled`` itself: the CPU tests hold the wrapper's contract
(shapes, dtypes, the host-side percentile fraction, the routing). The CUDA
kernel has no CPU or interpret mode: the tests marked ``cuda`` hold it
against the plain version on the card and skip elsewhere (``python -m
pytest -m cuda tests/test_torch_cam_head.py`` on a machine with a GPU and
nvcc).

Tolerances on the card: predictions equal; probabilities within 1e-6 of
the float64 head's (the kernel sums the logits and takes the softmax in
f64) and within 2e-5 of the plain version's (whose f32 cuBLAS sums of
2,048 products differ from the exact sum by up to ~1e-5 on a
probability); boxes equal on the shipped test frames and the edge cases.
The CAM's channel sum runs in another order than the plain version's
``bmm``, which can decide a ``cam > thr`` tie on a frame of noise; there
the boxes are held to the float64 CAM's box instead
(``apps.kernel_cases.cam_head_f64``)."""

import glob
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.kernel_cases import MODULES, cam_head_f64  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.models.registry import REGISTRY  # noqa: E402
from tpu_cnn_torch.ops import cam_head, detect_head  # noqa: E402
from tpu_cnn_torch.utils import profiling  # noqa: E402
from tpu_cnn_torch.utils.paths import default_artifacts  # noqa: E402

PROBS_ATOL = 1e-6  # against the float64 head
PLAIN_PROBS_ATOL = 2e-5  # against the plain version's f32 sums
FAMILIES = ("lyr3-std", "lyr4-wide")


def _model(variant):
    return load_model(default_artifacts(variant), variant)


def _shipped_frames(variant, n=None):
    size = REGISTRY[variant].layer_configs[0][2]
    paths = sorted(glob.glob(os.path.join(default_artifacts(variant),
                                          "test_image_*.bin")))[:n]
    return np.stack([np.fromfile(p, np.uint8).reshape(size, size)
                     for p in paths])


def _bins_and_twin(engine, frames, dev):
    """The megakernel's (or its plain version's) bins and bf16 twin."""
    x = torch.from_numpy(frames).to(dev)
    pooled, twin = engine._mega(x, with_feats=False, with_bins=True,
                                with_twin=True)
    return pooled, twin


def _plain(pooled, twin, w, b, img):
    return detect_head.detect_with_pooled(None, pooled, w, b, img,
                                          features_twin=twin, box_mode="ref")


def _seeded(seed, b, c, p, k=6, dev="cpu"):
    """Integer-valued bf16 twin (some channels saturated), bins, weights."""
    rs = np.random.RandomState(seed)
    twin = rs.randint(0, 256, (b, c, p)).astype(np.float32)
    twin[:, ::7] = 255.0  # saturated: mean > 250, masked out of the CAM
    pooled = rs.rand(b, 16 * c).astype(np.float32)
    w = rs.randn(k, 16 * c).astype(np.float32) * 0.05
    bias = rs.randn(k).astype(np.float32) * 0.1
    t = [torch.from_numpy(a).to(dev) for a in (pooled, twin, w, bias)]
    t[1] = t[1].to(torch.bfloat16)
    return t


def _assert_same(got, want, exact, boxes=True):
    """``got`` against the plain version's ``want``; ``exact``: the float64
    head's probabilities."""
    pred, conf, probs, bbox = (a.cpu() for a in got)
    np.testing.assert_array_equal(pred.numpy(), want[0].cpu().numpy())
    assert pred.dtype == torch.int32 and bbox.dtype == torch.int32
    exact = exact.cpu().numpy()
    np.testing.assert_allclose(probs.numpy(), exact, atol=PROBS_ATOL, rtol=0)
    np.testing.assert_allclose(
        conf.numpy(), exact[np.arange(len(exact)), pred.numpy()],
        atol=PROBS_ATOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), want[2].cpu().numpy(),
                               atol=PLAIN_PROBS_ATOL, rtol=0)
    if boxes:
        np.testing.assert_array_equal(bbox.numpy(), want[3].cpu().numpy())


# ── on the CPU: the plain version ─────────────────────────────────────


@pytest.mark.parametrize("variant", FAMILIES)
def test_wrapper_equals_detect_with_pooled_on_shipped_frames(variant):
    model = _model(variant)
    engine = CUDAEngine(model, device="cpu")
    pooled, twin = _bins_and_twin(engine, _shipped_frames(variant, 8), "cpu")
    net, img = engine.net, model.config.img_size
    got = cam_head.detect_pooled_fused(pooled, twin, net.fc_weight,
                                       net.fc_bias, img)
    want = _plain(pooled, twin, net.fc_weight, net.fc_bias, img)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("c,p", [(64, 256), (32, 1024), (64, 16)])
def test_wrapper_equals_detect_with_pooled_on_seeded_shapes(c, p):
    pooled, twin, w, b = _seeded(c + p, 5, c, p)
    img = 8 * math.isqrt(p)
    got = cam_head.detect_pooled_fused(pooled, twin, w, b, img)
    want = _plain(pooled, twin, w, b, img)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


@pytest.mark.parametrize("p", [16, 64, 256, 1024, 4096])
def test_percentile_order_gives_the_plain_threshold(p):
    """The kernel's (lo, hi, frac), applied in f32 as the kernel applies
    them (no fused multiply-add), give ``_percentile_topk`` bit for bit,
    ties included."""
    rs = np.random.RandomState(p)
    x = (rs.randint(0, 9, (12, p)) / 8).astype(np.float32)
    lo, hi, frac = cam_head.percentile_order(p)
    assert hi == lo + 1 and 0 < frac < 1
    srt = np.sort(x, axis=1)
    a_lo, a_hi = srt[:, lo], srt[:, hi]
    got = a_lo + (a_hi - a_lo) * np.float32(frac)
    np.testing.assert_array_equal(
        got, detect_head._percentile_topk(torch.from_numpy(x), 70.0).numpy())


@pytest.mark.parametrize("c,p,k", [(64, 256, 40), (64, 256, 1), (32, 1024, 33),
                                   (64, 144, 6), (16, 4096, 6)])
def test_cpu_wrapper_is_the_plain_version_past_the_kernels_geometries(c, p, k):
    """On CPU tensors the wrapper checks no geometry: more classes than a
    warp or one class (which the kernel takes), a side that is no power of
    two, a CAM of 64 x 64 (which it refuses) run the plain version all the
    same."""
    pooled, twin, w, b = _seeded(c + p + k, 3, c, p, k)
    img = 8 * math.isqrt(p)
    got = cam_head.detect_pooled_fused(pooled, twin, w, b, img)
    want = _plain(pooled, twin, w, b, img)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def _bad_inputs():
    pooled, twin, w, b = _seeded(3, 2, 64, 256)
    yield "twin f32", (pooled, twin.float(), w, b)
    yield "pooled f64", (pooled.double(), twin, w, b)
    yield "weight bf16", (pooled, twin, w.to(torch.bfloat16), b)
    yield "pooled width", (pooled[:, :512], twin, w, b)
    yield "pooled batch", (pooled[:1], twin, w, b)
    yield "bias length", (pooled, twin, w, b[:5])
    yield "twin 2-D", (pooled, twin[0], w, b)
    yield "twin not contiguous", (
        pooled, twin.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    yield "pooled not contiguous", (
        pooled.t().contiguous().t(), twin, w, b)
    yield "mixed devices", (pooled, twin, w.to("meta"), b)


@pytest.mark.parametrize("case", [name for name, _ in _bad_inputs()])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    args = dict(_bad_inputs())[case]
    before = cam_head.launches
    with pytest.raises(ValueError):
        cam_head.detect_pooled_fused(*args, 128)
    assert cam_head.launches == before


# ── the engine's routing ──────────────────────────────────────────────


@pytest.fixture(scope="module")
def std_model():
    return _model("lyr3-std")


@pytest.mark.parametrize("box_mode,routed", [("ref", 1), ("centroid", 0),
                                             ("reg", 0)])
def test_engine_routes_the_ref_box_to_the_fused_head(std_model, box_mode,
                                                     routed, monkeypatch):
    """``detect_device`` on ``mega`` with the bins head calls the fused
    head for "ref" alone; its CPU answers are the plain head's."""
    calls = []
    real = cam_head.detect_pooled_fused

    def spy(*args):
        calls.append(args[1].shape[0])
        return real(*args)

    monkeypatch.setattr(cam_head, "detect_pooled_fused", spy)
    before = {name: m.launches for name, m in MODULES.items()}
    engine = CUDAEngine(std_model, device="cpu", box_mode=box_mode)
    frames = _shipped_frames("lyr3-std", 6)
    got = engine.detect_batch(frames)
    assert calls == [6] * routed
    # the CPU runs the plain versions: no wrapper counted a launch
    assert {name: m.launches for name, m in MODULES.items()} == before
    net = engine.net
    pooled, twin = _bins_and_twin(engine, frames, "cpu")
    want = detect_head.detect_with_pooled(
        None, pooled, net.fc_weight, net.fc_bias, 128, features_twin=twin,
        box_mode=box_mode, bbox_weight=net.bbox_weight)
    for g, w in zip((got.pred, got.conf, got.probs, got.bbox), want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_other_backends_keep_the_plain_head(std_model, backend, monkeypatch):
    monkeypatch.setattr(cam_head, "detect_pooled_fused",
                        lambda *a: pytest.fail("routed to the fused head"))
    engine = CUDAEngine(std_model, device="cpu", backend=backend)
    engine.detect_batch(_shipped_frames("lyr3-std", 2))


def test_multi_head_keeps_the_plain_head(std_model, monkeypatch):
    monkeypatch.setattr(cam_head, "detect_pooled_fused",
                        lambda *a: pytest.fail("routed to the fused head"))
    engine = CUDAEngine(std_model, device="cpu")
    engine.detect_multi_batch(_shipped_frames("lyr3-std", 2), instances=2)


# ── tracing ───────────────────────────────────────────────────────────


def test_the_plain_version_keeps_its_spans_and_counts_nothing():
    """On the CPU the wrapper is ``detect_with_pooled``: its three spans,
    and no ``head.fused.frames`` (the counter counts the kernel's frames)."""
    pooled, twin, w, b = _seeded(5, 3, 64, 256)
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cam_head.detect_pooled_fused(pooled, twin, w, b, 128)
    spans, counters = profiling.spans()
    assert {"head.classify", "head.cam", "head.box"} <= set(spans)
    assert "head.fused.frames" not in counters
    profiling.reset_spans()


def _fused_pct_reader():
    from benchmarks.lib import spec
    return spec.reader("head.fused_pct.camera")


@pytest.mark.parametrize("snap,frames,want", [
    (({"app.frame": (4, 0.01, 0.001)}, {"head.fused.frames": 4}), 4, 100.0),
    (({"app.frame": (4, 0.01, 0.001)}, {"head.fused.frames": 3}), 4, 75.0),
    (({"app.frame": (4, 0.01, 0.001)}, {}), 4, 0.0),
    (({"app.frame": (4, 0.01, 0.001)}, {"head.fused.frames": 4}), 0, None),
    (({}, {}), 4, None),
    (None, 4, None),
])
def test_fused_pct_reader(snap, frames, want, monkeypatch):
    from benchmarks.lib import spans
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    reader = _fused_pct_reader()
    assert reader.read({"trace_frames": frames}) == want
    assert reader.read({}) is None


def test_fused_pct_reader_on_a_program_without_the_fused_head(monkeypatch):
    """The parent program has no ``ops.cam_head``: the reader reads
    nothing there, and does not raise."""
    from benchmarks.lib import spans
    monkeypatch.setattr(spans, "snapshot", lambda: (
        {"app.frame": (4, 0.01, 0.001)}, {}))
    reader = _fused_pct_reader()
    monkeypatch.setattr(reader, "_has_fused_head", lambda: False)
    assert reader.read({"trace_frames": 4}) is None


# ── on the card: the kernel ───────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA CAM head has no "
                    "CPU or interpret mode (on the card: python -m pytest -m "
                    "cuda tests/test_torch_cam_head.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", FAMILIES)
@pytest.mark.parametrize("batch", [1, 7, 16384])
def test_kernel_matches_plain_version_on_card(cuda_device, variant, batch):
    """The shipped test frames (cycled to the batch) through the
    megakernel, then the kernel and the plain version on its bins and
    twin; one launch a call."""
    model = _model(variant)
    engine = CUDAEngine(model, device=cuda_device)
    shipped = _shipped_frames(variant)
    frames = shipped[np.arange(batch) % len(shipped)]
    pooled, twin = _bins_and_twin(engine, frames, cuda_device)
    net, img = engine.net, model.config.img_size
    before = cam_head.launches
    got = cam_head.detect_pooled_fused(pooled, twin, net.fc_weight,
                                       net.fc_bias, img)
    torch.cuda.synchronize()
    assert cam_head.launches == before + 1
    want = _plain(pooled, twin, net.fc_weight, net.fc_bias, img)
    _assert_same(got, want, cam_head_f64(pooled, twin, net.fc_weight,
                                         net.fc_bias, want[0], img)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("c,p,k", [(64, 256, 6), (128, 256, 6), (32, 1024, 6),
                                   (64, 16, 6), (16, 64, 6), (64, 256, 40),
                                   (64, 256, 1)])
def test_kernel_on_seeded_geometries(cuda_device, c, p, k):
    """Noise twins with saturated channels at every geometry the kernel's
    paths split on (bins 4 pixels wide or more, or narrower; the order
    statistics by a sort, or past 256 pixels by counting; more classes than
    a warp's lanes, or one): predictions as the plain version's,
    probabilities within 1e-6 of the float64 head's, boxes as the plain
    version's or the float64 CAM's."""
    pooled, twin, w, b = _seeded(c + p + k, 37, c, p, k, dev=cuda_device)
    img = 8 * math.isqrt(p)
    got = cam_head.detect_pooled_fused(pooled, twin, w, b, img)
    want = _plain(pooled, twin, w, b, img)
    probs64, f64 = cam_head_f64(pooled, twin, w, b, want[0], img)
    _assert_same(got, want, probs64, boxes=False)
    ok = (got[3] == want[3]).all(dim=1) | (got[3] == f64).all(dim=1)
    assert bool(ok.all()), torch.nonzero(~ok)[:, 0].tolist()


@pytest.mark.cuda
def test_all_zero_cam_is_the_full_frame(cuda_device):
    pooled, twin, w, b = _seeded(6, 5, 64, 256, dev=cuda_device)
    twin.zero_()
    got = cam_head.detect_pooled_fused(pooled, twin, w, b, 128)
    want = _plain(pooled, twin, w, b, 128)
    _assert_same(got, want, cam_head_f64(pooled, twin, w, b, want[0], 128)[0])
    assert (got[3].cpu() == torch.tensor([0, 0, 127, 127],
                                         dtype=torch.int32)).all()


@pytest.mark.cuda
def test_saturated_channels_are_masked(cuda_device):
    """Every channel but two saturated: the CAM is those two channels'."""
    pooled, twin, w, b = _seeded(7, 9, 64, 256, dev=cuda_device)
    twin[:, 2:] = 255.0
    twin[:, :2] = torch.randint(0, 200, (9, 2, 256), device=cuda_device).to(
        torch.bfloat16)
    want = _plain(pooled, twin, w, b, 128)
    _assert_same(cam_head.detect_pooled_fused(pooled, twin, w, b, 128), want,
                 cam_head_f64(pooled, twin, w, b, want[0], 128)[0])


@pytest.mark.cuda
def test_flat_cam_ties_at_the_threshold(cuda_device):
    """Uniform weights over a constant map: every CAM value is 1.0, the
    threshold is 1.0 and ``cam > thr`` holds nowhere: the full frame."""
    twin = torch.full((2, 64, 256), 7.0, device=cuda_device).to(torch.bfloat16)
    w = torch.ones((6, 1024), device=cuda_device)
    b = torch.zeros(6, device=cuda_device)
    pooled = torch.full((2, 1024), 7.0 / 255, device=cuda_device)
    got = cam_head.detect_pooled_fused(pooled, twin, w, b, 128)
    want = _plain(pooled, twin, w, b, 128)
    _assert_same(got, want, cam_head_f64(pooled, twin, w, b, want[0], 128)[0])
    assert got[3].cpu().tolist() == [[0, 0, 127, 127]] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(REGISTRY))
def test_every_registry_geometry_is_taken(cuda_device, variant):
    cfg = REGISTRY[variant].layer_configs
    c, side = cfg[-1][1], cfg[-1][2] // 2
    assert cam_head._lib().cam_head_smem_bytes(c, side * side, 6) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c,p,k,img", [(64, 144, 6, 96), (64, 8, 6, 128),
                                       (16, 4096, 6, 512), (1024, 1024, 6, 256),
                                       (64, 256, 0, 128), (64, 256, 6, 100)])
def test_kernel_refuses_what_it_does_not_take(cuda_device, c, p, k, img):
    """A side that is no power of two or out of 4..32, a twin past one
    CTA's shared memory, no class, an image size that is no multiple of
    the CAM's side: a ValueError, no launch, no plain head."""
    pooled = torch.zeros((1, 16 * c), device=cuda_device)
    twin = torch.zeros((1, c, p), dtype=torch.bfloat16, device=cuda_device)
    before = cam_head.launches
    with pytest.raises(ValueError):
        cam_head.detect_pooled_fused(
            pooled, twin, torch.zeros((k, 16 * c), device=cuda_device),
            torch.zeros(k, device=cuda_device), img)
    assert cam_head.launches == before


@pytest.mark.cuda
def test_kernel_launch_is_the_cam_span_and_counts_its_frames(cuda_device):
    """On the card the launch is the span ``head.cam`` (no
    ``head.classify`` or ``head.box``) and ``head.fused.frames`` adds each
    call's batch, only while a profile runs."""
    pooled, twin, w, b = _seeded(8, 5, 64, 256, dev=cuda_device)
    profiling.reset_spans()
    cam_head.detect_pooled_fused(pooled, twin, w, b, 128)
    assert profiling.spans() == ({}, {})
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        cam_head.detect_pooled_fused(pooled, twin, w, b, 128)
        cam_head.detect_pooled_fused(pooled[:2], twin[:2], w, b, 128)
    spans, counters = profiling.spans()
    assert set(spans) == {"head.cam"} and spans["head.cam"][0] == 2
    assert counters == {"head.fused.frames": 7}
    profiling.reset_spans()
