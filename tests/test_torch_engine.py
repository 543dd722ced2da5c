"""``CUDAEngine(device="cpu")`` against ``TPUEngine(backend="xla")`` on the
CPU, for lyr3-std and for lyr4-wide (the chained plan: one head layer, then
the megakernel's tail), the port's parity gate, and the engine's guards.

On the CPU the engine runs the kernels' plain versions; the kernels
themselves are held against those versions on the card (``chip_smoke.py``,
``python -m pytest -m cuda tests/test_torch_mega.py tests/test_torch_conv_pool.py``).

Tolerances: features, predictions and boxes equal. Pooled bins within
1e-6 (one-ulp order of the two divisions). Probabilities within 1e-5:
torch's and XLA's CPU matmuls sum the 1024-term logit dot in different
orders (~10 ulp on a logit, ~1e-6 on a probability)."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps.common import load_model  # noqa: E402
from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.engine.tpu import DetectResult as JaxDetectResult  # noqa: E402
from tpu_cnn.engine.tpu import TPUEngine  # noqa: E402
from tpu_cnn.head.classify import bin_pool_np  # noqa: E402
from tpu_cnn.models.cnn import CNNConfig, FpgaCNN  # noqa: E402
from tpu_cnn.models.registry import REGISTRY  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch import bench_gate  # noqa: E402
from tpu_cnn_torch.apps.kernel_cases import MODULES  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine, DetectResult  # noqa: E402
from tpu_cnn_torch.models.cnn import TorchFpgaCNN, params_from_numpy  # noqa: E402

PROBS_ATOL = 1e-5
ART = default_artifacts()
ART4 = default_artifacts("lyr4-wide")


def _launches() -> dict:
    """Every kernel wrapper's own count of its launches."""
    return {name: m.launches for name, m in MODULES.items()}


@pytest.fixture(scope="module")
def images():
    """4 shipped test images + 2 noise images."""
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:4]
    imgs = [np.fromfile(p, np.uint8).reshape(128, 128) for p in paths]
    rs = np.random.RandomState(41)
    imgs += [rs.randint(0, 256, (128, 128)).astype(np.uint8) for _ in range(2)]
    return np.stack(imgs)


@pytest.fixture(scope="module")
def engines():
    """(port, reference) on separate models: set_shifts mutates its model."""
    return (CUDAEngine(load_model(ART), device="cpu"),
            TPUEngine(load_model(ART), backend="xla"))


def _assert_detect_equal(got, want):
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.bbox, want.bbox)
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=PROBS_ATOL)
    np.testing.assert_allclose(got.conf, want.conf, rtol=0, atol=PROBS_ATOL)
    assert got.pred.dtype == np.int32 and got.bbox.dtype == np.int32


def test_detect_result_matches_the_jax_fields():
    import dataclasses

    assert ([f.name for f in dataclasses.fields(DetectResult)]
            == [f.name for f in dataclasses.fields(JaxDetectResult)])


@pytest.mark.parametrize("box_mode", ["ref", "centroid", "reg"])
def test_detect_batch_matches_tpu_engine(images, box_mode):
    port = CUDAEngine(load_model(ART), device="cpu", box_mode=box_mode)
    ref = TPUEngine(load_model(ART), backend="xla", box_mode=box_mode)
    _assert_detect_equal(port.detect_batch(images), ref.detect_batch(images))


def test_run_and_run_batch_match(images, engines):
    port, ref = engines
    feats, conv_ms, read_ms = port.run(images[0])
    want, _, _ = ref.run(images[0])
    np.testing.assert_array_equal(feats, want)
    assert feats.shape == (64, 256) and conv_ms >= 0 and read_ms >= 0
    np.testing.assert_array_equal(port.run_batch(images), ref.run_batch(images))


def test_run_batch_pooled_matches(images, engines):
    port, ref = engines
    np.testing.assert_allclose(port.run_batch_pooled(images),
                               ref.run_batch_pooled(images), rtol=0, atol=1e-6)


def test_async_handles_in_flight_and_staged(images, engines):
    port, ref = engines
    want = ref.detect_batch(images)
    handles = [port.detect_batch_async(images),
               port.detect_batch_async(port.stage_batch(images)),
               port.detect_batch_async(images[:3])]
    results = [port.detect_resolve(h) for h in handles]
    _assert_detect_equal(results[0], want)
    _assert_detect_equal(results[1], want)
    np.testing.assert_array_equal(results[2].pred, want.pred[:3])


def test_set_shifts_is_a_runtime_register(images):
    port = CUDAEngine(load_model(ART), device="cpu")
    ref = TPUEngine(load_model(ART), backend="xla")
    kernels = art.load_bundle(ART).kernels
    for eng in (port, ref):
        eng.set_shifts(1, 3, 5)
    got = port.run_batch(images)
    want = np.stack([numpy_cnn_forward(im, kernels, (1, 3, 5)) for im in images])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref.run_batch(images), want)
    _assert_detect_equal(port.detect_batch(images), ref.detect_batch(images))
    assert port.net.shifts.tolist() == [1, 3, 5]
    with pytest.raises(ValueError, match="one shift per layer"):
        port.set_shifts(1, 2)


def test_gap_head_matches_tpu_engine(images):
    bundle = art.load_bundle(ART)
    rs = np.random.RandomState(42)
    w = (rs.randn(6, 64) * 0.05).astype(np.float32)
    b = (rs.randn(6) * 0.1).astype(np.float32)
    port = CUDAEngine(FpgaCNN(bundle.kernels, w, b), device="cpu")
    ref = TPUEngine(FpgaCNN(bundle.kernels, w, b), backend="xla")
    _assert_detect_equal(port.detect_batch(images), ref.detect_batch(images))


def _gate_setup(images):
    return (CUDAEngine(load_model(ART), device="cpu"), art.load_bundle(ART),
            images)


def test_gate_passes_on_the_engine(images):
    engine, bundle, gate = _gate_setup(images)
    assert bench_gate.run_parity_gate(engine.detect_with_features, bundle,
                                      gate) is None


def _corrupt_feats(o):
    o[0][0, 0, 0] ^= 1  # one flipped bit


def _corrupt_bins(o):
    o[1][0, 0] += 1.0 / 4080.0  # one bin off by one feature count


def _corrupt_pred(o):
    o[2][:] = (o[2] + 1) % 6


def _corrupt_bbox(o):
    o[5][:] += 8


@pytest.mark.parametrize("corrupt,msg", [
    (_corrupt_feats, "features"), (_corrupt_bins, "bin pooling"),
    (_corrupt_pred, "predictions"), (_corrupt_bbox, "bbox")])
def test_gate_trips_on_corruption(images, corrupt, msg):
    engine, bundle, gate = _gate_setup(images)

    def corrupted(imgs):
        out = [np.array(a) for a in engine.detect_with_features(imgs)]
        corrupt(out)
        return out

    err = bench_gate.run_parity_gate(corrupted, bundle, gate)
    assert err is not None and msg in err


def test_gate_images_match_bench():
    imgs = bench_gate.load_gate_images(ART)
    assert imgs.shape == (32, 128, 128) and imgs.dtype == np.uint8
    first = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[0]
    np.testing.assert_array_equal(imgs[0].ravel(), np.fromfile(first, np.uint8))


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUDAEngine(load_model(ART), device="cuda")


def test_engine_guards(images):
    with pytest.raises(ValueError, match="device"):
        CUDAEngine(load_model(ART), device="meta")
    engine = CUDAEngine(load_model(ART), device="cpu", max_batch=4)
    with pytest.raises(ValueError, match="max_batch"):
        engine.detect_batch(images)
    big = CNNConfig(layer_configs=((1, 16, 512),))  # no tail fits a CTA
    rs = np.random.RandomState(43)
    k = rs.randint(-127, 128, (16, 1, 3, 3)).astype(np.int8)
    with pytest.raises(ValueError, match="fits the megakernel"):
        CUDAEngine(FpgaCNN([k], np.zeros((6, 256), np.float32),
                           np.zeros(6, np.float32), shifts=(2,), config=big),
                   device="cpu")


def _lyr4_bundle():
    return art.load_bundle(ART4,
                           layer_configs=REGISTRY["lyr4-wide"].layer_configs)


@pytest.fixture(scope="module")
def images4():
    """2 shipped lyr4-wide test images + 1 noise image, 256x256."""
    return bench_gate.load_gate_images(ART4, n_real=2, n_noise=1,
                                       img_size=256)


@pytest.mark.parametrize("box_mode", ["ref", "centroid", "reg"])
def test_lyr4_wide_detect_matches_tpu_engine(images4, box_mode):
    port = CUDAEngine(load_model(ART4, "lyr4-wide"), device="cpu",
                      box_mode=box_mode)
    ref = TPUEngine(load_model(ART4, "lyr4-wide"), backend="xla",
                    box_mode=box_mode)
    got = port.detect_batch(images4)
    _assert_detect_equal(got, ref.detect_batch(images4))
    assert got.probs.shape == (3, 6)


def test_lyr4_wide_run_batch_matches_tpu_engine(images4):
    before = _launches()
    port = CUDAEngine(load_model(ART4, "lyr4-wide"), device="cpu")
    ref = TPUEngine(load_model(ART4, "lyr4-wide"), backend="xla")
    feats = port.run_batch(images4)
    assert feats.shape == (3, 128, 256) and feats.dtype == np.uint8
    np.testing.assert_array_equal(feats, ref.run_batch(images4))
    one, _, _ = port.run(images4[0])
    np.testing.assert_array_equal(one, feats[0])
    np.testing.assert_allclose(port.run_batch_pooled(images4),
                               bin_pool_np(feats), rtol=0, atol=1e-6)
    assert port.backend == "reference-cpu" and _launches() == before


def test_lyr4_wide_set_shifts(images4):
    port = CUDAEngine(load_model(ART4, "lyr4-wide"), device="cpu")
    kernels = _lyr4_bundle().kernels
    port.set_shifts(2, 4, 6, 8)
    assert port.net.shifts.tolist() == [2, 4, 6, 8]
    want = np.stack([numpy_cnn_forward(im, kernels, (2, 4, 6, 8))
                     for im in images4[:2]])
    np.testing.assert_array_equal(port.run_batch(images4[:2]), want)
    with pytest.raises(ValueError, match="one shift per layer"):
        port.set_shifts(2, 4, 6)


def test_gate_takes_the_models_shifts_and_size(images4):
    """The gate repair: on lyr4-wide the old call (stock 2/4/6 shifts, a
    128 image size) reports a mismatch on a correct engine; with the
    model's shifts and image size it passes."""
    engine = CUDAEngine(load_model(ART4, "lyr4-wide"), device="cpu")
    bundle = _lyr4_bundle()
    shifts = engine.model.shifts
    assert list(shifts) == [3, 5, 5, 7]  # the bundle's shifts.json
    assert bench_gate.load_gate_images(ART4, 2, 1).shape == (3, 128, 128)
    err = bench_gate.run_parity_gate(engine.detect_with_features, bundle,
                                     images4)
    assert err is not None and "features" in err
    err = bench_gate.run_parity_gate(engine.detect_with_features, bundle,
                                     images4, shifts=shifts)
    assert err is not None and "bbox" in err  # boxes at 128-pixel scale
    assert bench_gate.run_parity_gate(engine.detect_with_features, bundle,
                                      images4, shifts=shifts,
                                      img_size=256) is None
    first = sorted(glob.glob(os.path.join(ART4, "test_image_*.bin")))[0]
    np.testing.assert_array_equal(images4[0].ravel(),
                                  np.fromfile(first, np.uint8))


def test_torch_model_carries_the_lyr4_wide_parameters():
    model = load_model(ART4, "lyr4-wide")
    net = TorchFpgaCNN.from_fpga_cnn(model, "cpu")
    assert [tuple(k.shape) for k in net.kernels] == [
        (16, 1, 3, 3), (32, 16, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3)]
    for k, want in zip(net.kernels, model.kernels):
        assert k.dtype == torch.int8
        np.testing.assert_array_equal(k.numpy(), want)
    assert net.shifts.dtype == torch.int32
    np.testing.assert_array_equal(net.shifts.numpy(), model.shifts)
    assert net.fc_weight.shape == (6, 2048)
    np.testing.assert_array_equal(net.fc_weight.numpy(), model.fc_weight)
    np.testing.assert_array_equal(net.fc_bias.numpy(), model.fc_bias)
    assert net.bbox_weight.shape == (2049, 4)
    np.testing.assert_array_equal(net.bbox_weight.numpy(), model.bbox_weight)


def test_torch_model_carries_the_parameters():
    model = load_model(ART)
    net = TorchFpgaCNN.from_fpga_cnn(model, "cpu")
    for k, want in zip(net.kernels, model.kernels):
        assert k.dtype == torch.int8
        np.testing.assert_array_equal(k.numpy(), want)
    assert net.shifts.dtype == torch.int32
    np.testing.assert_array_equal(net.shifts.numpy(), model.shifts)
    np.testing.assert_array_equal(net.fc_weight.numpy(), model.fc_weight)
    np.testing.assert_array_equal(net.bbox_weight.numpy(), model.bbox_weight)
    params = params_from_numpy(model.kernels[:2], model.fc_weight,
                               model.fc_bias, (2, 4), device="cpu")
    with pytest.raises(ValueError, match="kernel shapes"):
        TorchFpgaCNN(CNNConfig(), params)


def test_pooled_bins_equal_host_bin_pool(images, engines):
    port, _ = engines
    feats = port.run_batch(images)
    np.testing.assert_allclose(port.run_batch_pooled(images),
                               bin_pool_np(feats), rtol=0, atol=1e-6)


# ── the per-layer backends: pallas, hybrid, xla ──────────────────────


@pytest.mark.parametrize("backend,dtype", [
    ("pallas", "float32"), ("hybrid", "float32"), ("xla", "float32"),
    ("xla", "int32")])
def test_backend_matches_tpu_engine(images, backend, dtype):
    """CUDAEngine(backend=b) against TPUEngine(backend=b) (Pallas in
    interpret mode): detect_batch, run_batch and run_batch_pooled."""
    before = _launches()
    port = CUDAEngine(load_model(ART), device="cpu", backend=backend,
                      compute_dtype=dtype)
    ref = TPUEngine(load_model(ART), backend=backend, compute_dtype=dtype)
    assert port.backend == f"{backend}-reference-cpu"
    _assert_detect_equal(port.detect_batch(images), ref.detect_batch(images))
    feats = port.run_batch(images)
    np.testing.assert_array_equal(feats, ref.run_batch(images))
    np.testing.assert_allclose(port.run_batch_pooled(images),
                               ref.run_batch_pooled(images), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.run(images[0])[0], feats[0])
    assert _launches() == before  # the CPU runs the plain versions


@pytest.mark.parametrize("backend", ["pallas", "hybrid", "xla"])
def test_backend_gap_head_matches_tpu_engine(images, backend):
    bundle = art.load_bundle(ART)
    rs = np.random.RandomState(42)
    w = (rs.randn(6, 64) * 0.05).astype(np.float32)
    b = (rs.randn(6) * 0.1).astype(np.float32)
    port = CUDAEngine(FpgaCNN(bundle.kernels, w, b), device="cpu",
                      backend=backend)
    ref = TPUEngine(FpgaCNN(bundle.kernels, w, b), backend=backend)
    _assert_detect_equal(port.detect_batch(images), ref.detect_batch(images))


@pytest.mark.parametrize("backend", ["pallas", "hybrid"])
def test_backend_gate_and_set_shifts(images, backend):
    engine = CUDAEngine(load_model(ART), device="cpu", backend=backend)
    bundle = art.load_bundle(ART)
    assert bench_gate.run_parity_gate(engine.detect_with_features, bundle,
                                      images) is None
    engine.set_shifts(1, 3, 5)
    want = np.stack([numpy_cnn_forward(im, bundle.kernels, (1, 3, 5))
                     for im in images[:2]])
    np.testing.assert_array_equal(engine.run_batch(images[:2]), want)


def test_lyr4_wide_pallas_backend_matches_the_oracle(images4):
    """lyr4-wide on "pallas": every layer on the conv kernel's plain
    version, its L0 included (the JAX package reroutes that one to XLA)."""
    port = CUDAEngine(load_model(ART4, "lyr4-wide"), device="cpu",
                      backend="pallas")
    kernels = _lyr4_bundle().kernels
    want = np.stack([numpy_cnn_forward(im, kernels, (3, 5, 5, 7))
                     for im in images4[:2]])
    np.testing.assert_array_equal(port.run_batch(images4[:2]), want)


def test_backend_names_and_refusals():
    model = load_model(ART)
    for backend in ("mega", "pallas", "hybrid", "xla"):
        engine = CUDAEngine(model, device="cpu", backend=backend)
        assert engine.mode == backend
        assert engine.backend == ("reference-cpu" if backend == "mega"
                                  else f"{backend}-reference-cpu")
    assert CUDAEngine(model, device="cpu").backend == "reference-cpu"
    with pytest.raises(ValueError, match="unknown backend"):
        CUDAEngine(model, device="cpu", backend="auto")
    with pytest.raises(ValueError, match="compute_dtype"):
        CUDAEngine(model, device="cpu", backend="xla", compute_dtype="bf16")
