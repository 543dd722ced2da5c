"""The port's own copies of the JAX package's JAX-free modules, each held
equal to its ``tpu_cnn`` original on the same seeded numpy inputs: the
numpy oracle, the C++ oracle and its batched preprocess (and the frame
ring's and HTTP front's C++ sources, equal to theirs but for the header
comment), the host-oracle
engine, the host head twins and the tracker, the weights.bin and bundle
codecs, the registry and model holder, the CLI helpers, the luma
constants, the stage timers, the progress watchdog and the camera app's
host preprocess. Integer
results are compared exactly; float results bit for bit too, since both
sides run the same numpy code on the same arrays."""

import json
import time

import glob
import inspect
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import common as j_common  # noqa: E402
from tpu_cnn.apps import infer as j_infer  # noqa: E402
from tpu_cnn.apps import realtime as j_realtime  # noqa: E402
from tpu_cnn.apps import verify as j_verify  # noqa: E402
from tpu_cnn.engine import cpu_ref as j_cpu_ref  # noqa: E402
from tpu_cnn.head import bbox as j_bbox  # noqa: E402
from tpu_cnn.head import cam as j_cam  # noqa: E402
from tpu_cnn.head import classify as j_classify  # noqa: E402
from tpu_cnn.head import tracker as j_tracker  # noqa: E402
from tpu_cnn.models import cnn as j_cnn  # noqa: E402
from tpu_cnn.models import registry as j_registry  # noqa: E402
from tpu_cnn.native import oracle as j_oracle  # noqa: E402
from tpu_cnn.native import preprocess as j_native_pre  # noqa: E402
from tpu_cnn.ops import luma as j_luma  # noqa: E402
from tpu_cnn.utils import artifacts as j_art  # noqa: E402
from tpu_cnn.utils import paths as j_paths  # noqa: E402
from tpu_cnn.utils import weights as j_weights  # noqa: E402
from tpu_cnn_torch.apps import common, infer, realtime, serve, verify  # noqa: E402
from tpu_cnn_torch.engine import cpu_ref  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.head import bbox, cam, classify, tracker  # noqa: E402
from tpu_cnn_torch.models import cnn, registry  # noqa: E402
from tpu_cnn_torch.native import oracle  # noqa: E402
from tpu_cnn_torch.native import preprocess as native_pre  # noqa: E402
from tpu_cnn_torch.ops import detect_head, luma  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402
from tpu_cnn_torch.utils import paths, profiling, weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLES = {"lyr3-std": os.path.join(REPO, "artifacts", "pretrained"),
           "lyr4-wide": os.path.join(REPO, "artifacts", "pretrained-lyr4")}


def _kernels(rs, cfgs):
    return [rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
            for ic, oc, _ in cfgs]


def _same(a, b):
    """Equal values, dtypes and shapes, through tuples and lists."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


# ── the oracles ──────────────────────────────────────────────────────


@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small", "lyr3-std"])
def test_numpy_oracle_equals_the_original(variant):
    cfg = registry.get_config(variant)
    rs = np.random.RandomState(31)
    if variant == "lyr3-std":
        kernels = j_art.load_bundle(BUNDLES["lyr3-std"]).kernels
    else:
        kernels = _kernels(rs, cfg.layer_configs)
    shifts = registry.default_shifts(cfg)
    imgs = rs.randint(0, 256, (3, cfg.img_size, cfg.img_size)).astype(np.uint8)
    for im in imgs:
        for wrap in (False, True):
            _same(cpu_ref.numpy_cnn_forward(im, kernels, shifts, accum_wrap=wrap),
                  j_cpu_ref.numpy_cnn_forward(im, kernels, shifts, accum_wrap=wrap))
    x = rs.randint(-2**30, 2**30, (64,)).astype(np.int64)
    _same(cpu_ref.wrap_accum_np(x), j_cpu_ref.wrap_accum_np(x))


@pytest.mark.native
@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small"])
def test_native_oracle_equals_the_original(variant, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_CNN_BUILD_DIR", str(tmp_path))  # the original's
    cfg = registry.get_config(variant)
    rs = np.random.RandomState(32)
    kernels = _kernels(rs, cfg.layer_configs)
    shifts = registry.default_shifts(cfg)
    imgs = rs.randint(0, 256, (5, cfg.img_size, cfg.img_size)).astype(np.uint8)
    ours = oracle.NativeOracle()
    _same(ours.infer_batch(imgs, kernels, shifts),
          j_oracle.NativeOracle().infer_batch(imgs, kernels, shifts))
    _same(ours.infer(imgs[0], kernels, shifts),
          cpu_ref.numpy_cnn_forward(imgs[0], kernels, shifts))


# ── the host head twins ──────────────────────────────────────────────


@pytest.fixture(scope="module")
def head_case():
    """Shipped lyr3-std features of 6 test images plus a saturated map and
    an all-zero map (the CAM edge cases), the shipped bins head and
    presence head."""
    bundle = j_art.load_bundle(BUNDLES["lyr3-std"])
    paths_ = sorted(glob.glob(os.path.join(BUNDLES["lyr3-std"],
                                           "test_image_*.bin")))[:6]
    feats = [j_cpu_ref.numpy_cnn_forward(np.fromfile(p, np.uint8),
                                         bundle.kernels) for p in paths_]
    feats += [np.full((64, 256), 255, np.uint8), np.zeros((64, 256), np.uint8)]
    return np.stack(feats), bundle


TWINS = {
    "cam_bbox_fast": lambda m, f, b: [m.cam_bbox_fast(x, k, b.fc_weight)
                                      for x in f for k in range(6)],
    "cam_bbox_centroid": lambda m, f, b: [m.cam_bbox_centroid(x, k, b.fc_weight)
                                          for x in f for k in range(6)],
    "cam_bbox_hires": lambda m, f, b: [m.cam_bbox_hires(x, 1, b.fc_weight)
                                       for x in f],
    "cam_bbox_multi": lambda m, f, b: [m.cam_bbox_multi(x, b.fc_weight, 128, mode)
                                       for x in f for mode in ("ref", "centroid")],
    "cam_instances": lambda m, f, b: [m.cam_instances(x, b.fc_weight, 128, n)
                                      for x in f for n in (1, 2, 3)],
    "connected_labels_np": lambda m, f, b: [m.connected_labels_np(x[0].reshape(16, 16) > 90)
                                            for x in f],
    "grow_labels_np": lambda m, f, b: [
        m.grow_labels_np(m.connected_labels_np(x[1].reshape(16, 16) > 200),
                         x[1].reshape(16, 16) > 60) for x in f],
}
CLASSIFY = {
    "classify_np": lambda m, f, b: [m.classify_np(f, b.fc_weight, b.fc_bias),
                                    m.classify_np(f[0], b.fc_weight, b.fc_bias,
                                                  b.class_names)],
    "bin_pool_np": lambda m, f, b: m.bin_pool_np(f),
    "gap_pool_np": lambda m, f, b: m.gap_pool_np(f),
    "pool_for_head": lambda m, f, b: [m.pool_for_head(f, b.fc_weight),
                                      m.pool_for_head(f, b.fc_weight[:, :64])],
    "multi_scores_np": lambda m, f, b: m.multi_scores_np(
        m.pool_for_head(f, b.fc_weight), *b.multi_head),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_cam_twin_equals_the_original(name, head_case):
    feats, bundle = head_case
    _same(TWINS[name](cam, feats, bundle), TWINS[name](j_cam, feats, bundle))


@pytest.mark.parametrize("name", sorted(CLASSIFY))
def test_classify_twin_equals_the_original(name, head_case):
    feats, bundle = head_case
    _same(CLASSIFY[name](classify, feats, bundle),
          CLASSIFY[name](j_classify, feats, bundle))


def test_bbox_twins_equal_the_originals(head_case):
    feats, bundle = head_case
    pooled = j_classify.bin_pool_np(feats)
    _same(bbox.bbox_regress_np(pooled, bundle.bbox_weight),
          j_bbox.bbox_regress_np(pooled, bundle.bbox_weight))
    _same(bbox.bbox_regress_np(pooled[0], bundle.bbox_weight, 256),
          j_bbox.bbox_regress_np(pooled[0], bundle.bbox_weight, 256))
    _same([bbox.bbox_regress_features_np(f, bundle.bbox_weight) for f in feats],
          [j_bbox.bbox_regress_features_np(f, bundle.bbox_weight) for f in feats])


def test_head_constants_equal_the_originals():
    from tpu_cnn.ops import detect_head as j_detect_head

    assert cam.SATURATION_MEAN == j_cam.SATURATION_MEAN
    assert cam.CAM_CENTROID_K == j_cam.CAM_CENTROID_K
    assert (cam.CAM_CORE_PERCENTILE == j_detect_head.CAM_CORE_PERCENTILE
            == detect_head.CAM_CORE_PERCENTILE)


# ── codecs, registry, model ──────────────────────────────────────────


@pytest.mark.parametrize("variant", sorted(BUNDLES))
def test_bundle_loads_to_equal_arrays(variant):
    cfgs = registry.get_config(variant).layer_configs
    ours = art.load_bundle(BUNDLES[variant], layer_configs=cfgs)
    theirs = j_art.load_bundle(BUNDLES[variant], layer_configs=cfgs)
    for field in ("kernels", "fc_weight", "fc_bias", "class_names",
                  "bbox_weight", "shifts", "multi_thresh", "multi_head"):
        _same(getattr(ours, field), getattr(theirs, field))


@pytest.mark.parametrize("prefix", ["", "real_", "adam_"])
def test_bundle_head_prefixes_load_to_equal_arrays(prefix):
    ours = art.load_bundle(BUNDLES["lyr3-std"], prefix=prefix)
    theirs = j_art.load_bundle(BUNDLES["lyr3-std"], prefix=prefix)
    for field in ("fc_weight", "fc_bias", "multi_thresh", "multi_head"):
        _same(getattr(ours, field), getattr(theirs, field))


@pytest.mark.parametrize("variant", ["lyr3-std", "lyr3-tiny", "lyr2-small",
                                     "lyr4-wide"])
def test_weights_bin_round_trips(variant, tmp_path):
    cfgs = registry.get_config(variant).layer_configs
    kernels = _kernels(np.random.RandomState(33), cfgs)
    blob = weights.encode_weights(kernels)
    assert blob == j_weights.encode_weights(kernels)
    _same(weights.decode_weights(blob, cfgs), kernels)
    _same(weights.decode_weights(blob, cfgs), j_weights.decode_weights(blob, cfgs))
    path = tmp_path / "weights.bin"
    weights.save_weights_bin(path, kernels)
    _same(weights.load_weights_bin(path, cfgs), kernels)
    _same(j_weights.load_weights_bin(path, cfgs), kernels)
    with pytest.raises(ValueError, match="weight bytes"):
        weights.decode_weights(blob[:-1], cfgs)


@pytest.mark.parametrize("variant", ["lyr3-std", "lyr3-tiny", "lyr4-wide"])
@pytest.mark.parametrize("scale", [0.3, 1e-9])
def test_quantizers_equal_the_original(variant, scale):
    """quantize_global and quantize_per_layer (the trainer's export), on
    seeded float kernels and on kernels below the 1e-8 floor."""
    rs = np.random.RandomState(34)
    floats = [(rs.randn(oc, ic, 3, 3) * scale * (i + 1)).astype(np.float32)
              for i, (ic, oc, _) in enumerate(registry.get_config(variant).layer_configs)]
    for ours, theirs in ((weights.quantize_global, j_weights.quantize_global),
                         (weights.quantize_per_layer, j_weights.quantize_per_layer)):
        q, sc = ours(floats)
        jq, jsc = theirs(floats)
        _same(q, jq)
        assert sc == jsc
        assert all(k.dtype == np.int8 for k in q)
    q, _ = weights.quantize_per_layer(floats, quant_max=63)
    _same(q, j_weights.quantize_per_layer(floats, quant_max=63)[0])


def test_save_bundle_writes_the_originals_files(tmp_path):
    b = art.load_bundle(BUNDLES["lyr3-std"])
    b.shifts, b.multi_thresh = [1, 3, 5], [0.2] * 6
    b.multi_head = (np.ones((6, 1024), np.float32), np.zeros(6, np.float32))
    art.save_bundle(tmp_path / "ours", b, prefix="p_")
    j_art.save_bundle(tmp_path / "theirs", b, prefix="p_")
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    assert "p_multi_head.npz" in names and "p_shifts.json" in names
    for name in names:
        if not name.endswith(".npz"):
            assert ((tmp_path / "ours" / name).read_bytes()
                    == (tmp_path / "theirs" / name).read_bytes()), name
    back = j_art.load_bundle(tmp_path / "ours", prefix="p_")
    for field in ("kernels", "fc_weight", "fc_bias", "class_names", "bbox_weight",
                  "shifts", "multi_thresh", "multi_head"):
        _same(getattr(back, field), getattr(b, field))


def test_registry_equals_the_original():
    assert sorted(registry.REGISTRY) == sorted(j_registry.REGISTRY)
    for name, cfg in registry.REGISTRY.items():
        j = j_registry.get_config(name)
        assert (cfg.layer_configs, cfg.num_classes, cfg.accum_bits,
                cfg.accum_wrap) == (j.layer_configs, j.num_classes,
                                    j.accum_bits, j.accum_wrap)
        assert (cfg.img_size, cfg.out_channels, cfg.out_spatial,
                cfg.feature_dim_bins, cfg.weight_bytes()) == (
            j.img_size, j.out_channels, j.out_spatial, j.feature_dim_bins,
            j.weight_bytes())
        assert registry.default_shifts(cfg) == j_registry.default_shifts(j)
    with pytest.raises(KeyError, match="unknown model variant"):
        registry.get_config("lyr9")


def test_model_constants_equal_the_originals():
    for name in ("LAYER_CONFIGS", "DEFAULT_SHIFTS", "IMG_SIZE", "NUM_CLASSES",
                 "ACCUM_BITS", "QUANT_MAX", "CLASS_NAMES", "WEIGHT_BYTES"):
        assert getattr(cnn, name) == getattr(j_cnn, name), name


@pytest.mark.parametrize("variant", ["lyr3-std", "lyr4-wide"])
def test_load_model_equals_the_original(variant):
    ours = common.load_model(BUNDLES[variant], variant)
    theirs = j_common.load_model(BUNDLES[variant], variant)
    for field in ("kernels", "fc_weight", "fc_bias", "class_names", "shifts",
                  "bbox_weight", "multi_thresh", "multi_head"):
        _same(getattr(ours, field), getattr(theirs, field))
    assert ours.head_mode == theirs.head_mode
    assert ours.config.layer_configs == theirs.config.layer_configs


def test_fpga_cnn_refuses_what_the_original_refuses():
    cfg = registry.get_config("lyr3-tiny")
    ks = _kernels(np.random.RandomState(34), cfg.layer_configs)
    fcw, fcb = np.zeros((6, 1024), np.float32), np.zeros(6, np.float32)
    for mod, c in ((cnn, cfg), (j_cnn, j_registry.get_config("lyr3-tiny"))):
        with pytest.raises(ValueError, match="kernel shapes"):
            mod.FpgaCNN(ks[::-1], fcw, fcb, config=c)
        with pytest.raises(ValueError, match="one shift per layer"):
            mod.FpgaCNN(ks, fcw, fcb, shifts=(1, 2), config=c)
        with pytest.raises(ValueError, match="multi_head shapes"):
            mod.FpgaCNN(ks, fcw, fcb, config=c,
                        multi_head=(np.zeros((6, 64), np.float32), fcb))
        assert mod.FpgaCNN(ks, fcw[:, :64], fcb, config=c).head_mode == "gap"


def test_torch_model_takes_either_holder():
    """``TorchFpgaCNN.from_fpga_cnn`` duck-types the holder: the JAX
    package's model gives the same buffers as the port's."""
    ours = common.load_model(BUNDLES["lyr3-std"])
    theirs = j_common.load_model(BUNDLES["lyr3-std"])
    a = cnn.TorchFpgaCNN.from_fpga_cnn(ours, "cpu")
    b = cnn.TorchFpgaCNN.from_fpga_cnn(theirs, "cpu")
    assert isinstance(b.config, cnn.CNNConfig)
    assert a.config == b.config
    for (n, x), (m, y) in zip(a.named_buffers(), b.named_buffers()):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y)


def test_paths_and_labels_equal_the_originals(monkeypatch):
    monkeypatch.delenv("TPU_CNN_ARTIFACTS", raising=False)
    for variant in ("lyr3-std", "lyr4-wide", "lyr3-tiny"):
        assert paths.default_artifacts(variant) == j_paths.default_artifacts(variant)
    for name in ("x/test_image_3_class5.bin", "test_image_0.bin",
                 "a_classX.bin", "test_image_12_class0.png"):
        assert art.label_from_filename(name) == j_art.label_from_filename(name)
    monkeypatch.setenv("TPU_CNN_ARTIFACTS", "/somewhere")
    assert paths.default_artifacts() == "/somewhere"


def test_load_image_any_equals_the_original(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(35)
    png = tmp_path / "x.png"
    Image.fromarray(rs.randint(0, 256, (40, 60, 3)).astype(np.uint8)).save(png)
    raw = os.path.join(BUNDLES["lyr3-std"], "test_image_0_class3.bin")
    for p in (png, raw):
        _same(art.load_image_any(p), j_art.load_image_any(p))
    with pytest.raises(ValueError, match="expected"):
        art.load_image_any(raw, img_size=64)


# ── the CLI helpers and the camera app's host preprocess ─────────────


@pytest.mark.parametrize("shape", [(48, 64, 3), (64, 48, 3), (256, 256, 3),
                                   (100, 100, 3), (70, 90)])
def test_preprocess_equals_the_camera_twin(shape):
    frame = np.random.RandomState(36).randint(0, 256, shape).astype(np.uint8)
    for out in (16, 32):
        _same(realtime.preprocess(frame, out), j_realtime.preprocess(frame, out))
    if len(shape) == 3:
        for order in ("bgr", "rgb"):
            _same(luma.bt601_gray_np(frame, order),
                  j_luma.bt601_gray_np(frame, order))


def test_decode_image_equals_the_original():
    from PIL import Image
    from tpu_cnn.apps import serve as j_serve

    rs = np.random.RandomState(37)
    raw = rs.randint(0, 256, 128 * 128).astype(np.uint8).tobytes()
    buf = io.BytesIO()
    Image.fromarray(rs.randint(0, 256, (90, 120, 3)).astype(np.uint8)).save(
        buf, format="PNG")
    for body, size in ((raw, 128), (buf.getvalue(), 128), (buf.getvalue(), 32)):
        _same(serve.decode_image(body, size), j_serve.decode_image(body, size))


def test_stimuli_and_report_equal_the_originals(capsys):
    for n, d, size in ((2, None, 32), (1, BUNDLES["lyr3-std"], 128)):
        ours, theirs = verify.make_stimuli(n, d, size=size), \
            j_verify.make_stimuli(n, d, size=size)
        assert list(ours) == list(theirs)
        _same(list(ours.values()), list(theirs.values()))
    ref = np.random.RandomState(38).randint(0, 256, (2, 4, 9)).astype(np.uint8)
    bad = ref.copy()
    bad[1, 2, 3] ^= 1
    outputs = {"numpy": ref, "a": ref.copy(), "b": bad}
    for mod in (verify, j_verify):
        assert mod.compare("numpy", outputs, ["s0", "s1"]) is False
    ours, theirs = capsys.readouterr().out.split("  numpy vs a")[1:]
    assert ours == theirs


@pytest.mark.parametrize("box", ["ref", "centroid", "reg"])
def test_run_inference_prints_what_the_original_prints(box, tmp_path, capsys):
    """Both ``run_inference``s on one engine (the port's, on the CPU) and
    one image: the same answer and the same printed lines, the multi
    branch included; the annotated JPEGs are equal too."""
    model = common.load_model(BUNDLES["lyr3-std"])
    engine = CUDAEngine(model, device="cpu")
    src = os.path.join(BUNDLES["lyr3-std"], "test_image_4_class0.bin")
    path = tmp_path / "test_image_4_class0.bin"
    path.write_bytes(open(src, "rb").read())
    outs = []
    for mod in (infer, j_infer):
        for multi, inst in ((None, 1), (0.2, 1), (0.2, 2)):
            got = mod.run_inference(engine, model, str(path), box=box,
                                    multi_thresh=multi, instances=inst)
            text = capsys.readouterr().out
            jpg = (tmp_path / "test_image_4_class0_result.jpg").read_bytes()
            outs.append((got, [ln for ln in text.splitlines()
                               if "Engine:" not in ln], jpg))
    assert outs[:3] == outs[3:]


# ── the luma constants, the tracker, the stage timers ───────────────


def test_luma_equals_the_original():
    for name in ("LUMA_R", "LUMA_G", "LUMA_B", "LUMA_BIAS", "LUMA_SHIFT"):
        assert getattr(luma, name) == getattr(j_luma, name), name
    rs = np.random.RandomState(40)
    for shape in ((2, 5, 7, 3), (2, 5, 7, 4), (9, 3)):
        frames = rs.randint(0, 256, shape).astype(np.uint8)
        _same(luma.pack_bgrx(frames), j_luma.pack_bgrx(frames))
        if shape[-1] == 3:
            for order in ("bgr", "rgb"):
                _same(luma.bt601_gray_np(frames, order),
                      j_luma.bt601_gray_np(frames, order))
    for mod in (luma, j_luma):
        with pytest.raises(ValueError, match="3 or 4 channels"):
            mod.pack_bgrx(np.zeros((2, 2, 5), np.uint8))
        with pytest.raises(ValueError, match="channel_order"):
            mod.bt601_gray_np(np.zeros((2, 3), np.uint8), "bgrx")


def _detection_stream(seed: int, n_frames: int = 30):
    """A seeded 30-frame detection sequence: three objects of two classes
    drifting with jitter, one dropping out for a few frames, plus a
    one-frame flicker now and then."""
    rs = np.random.RandomState(seed)
    objs = [(1, np.array([10.0, 10, 40, 40]), np.array([2.0, 1, 2, 1])),
            (1, np.array([70.0, 60, 100, 95]), np.array([-1.0, 1, -1, 1])),
            (4, np.array([30.0, 80, 60, 120]), np.array([3.0, -2, 3, -2]))]
    frames = []
    for t in range(n_frames):
        dets = []
        for i, (cls, box, vel) in enumerate(objs):
            if i == 2 and 10 <= t < 14:
                continue  # occluded
            b = box + vel * t + rs.randint(-2, 3, 4)
            dets.append((cls, float(rs.uniform(0.3, 0.95)),
                         tuple(int(v) for v in np.clip(b, 0, 127))))
        if rs.rand() < 0.2:
            dets.append((int(rs.randint(0, 6)), float(rs.uniform(0.2, 0.5)),
                         tuple(int(v) for v in sorted(rs.randint(0, 128, 2)))
                         + tuple(int(v) for v in sorted(rs.randint(0, 128, 2)))))
        frames.append(dets)
    return frames


@pytest.mark.parametrize("velocity", [False, True])
def test_tracker_equals_the_original(velocity):
    ours = tracker.Tracker(velocity=velocity)
    theirs = j_tracker.Tracker(velocity=velocity)
    n_shown = 0
    for dets in _detection_stream(41):
        got, want = ours.update(dets), theirs.update(dets)
        assert [(t.id, t.cls, t.box, t.prob, t.hits, t.age, t.vel, t.ibox())
                for t in got] == [(t.id, t.cls, t.box, t.prob, t.hits, t.age,
                                   t.vel, t.ibox()) for t in want]
        n_shown += len(got)
    assert n_shown > 30  # the stream does confirm tracks
    assert [t.id for t in ours.tracks] == [t.id for t in theirs.tracks]
    assert ours.tracks[0].predicted(2) == theirs.tracks[0].predicted(2)
    for mod in (tracker, j_tracker):
        with pytest.raises(ValueError, match="smooth"):
            mod.Tracker(smooth=0.0)


def test_stage_timer_and_ema_fps():
    """``StageTimer`` and ``EmaFps`` as the JAX package's tests hold them
    (``tests/test_aux_subsystems.py``), and the JAX one's report format."""
    st = profiling.StageTimer()
    with st.stage("x"):
        time.sleep(0.01)
    assert st.mean_ms("x") >= 5
    assert "x:" in st.report() and st.report().endswith("ms(x1)")
    assert st.mean_ms("never") == 0.0
    ema = profiling.EmaFps()
    ema.tick()
    time.sleep(0.01)
    assert ema.tick() > 0
    from tpu_cnn.utils import profiling as j_profiling

    a, b = profiling.StageTimer(), j_profiling.StageTimer()
    for t in (a, b):
        t.totals["load"], t.counts["load"] = 0.0123, 3
    assert a.report() == b.report()
    assert profiling.EmaFps().alpha == j_profiling.EmaFps().alpha


def test_torch_trace_writes_a_trace(tmp_path):
    """``torch_trace`` (``jax_trace``'s counterpart): None or "" does
    nothing; a directory gets a Chrome trace of the block."""
    for off in (None, ""):
        with profiling.torch_trace(off):
            torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "trace"
    with profiling.torch_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = out / profiling.TRACE_FILE
    assert trace.exists() and "traceEvents" in trace.read_text()


# ── the native preprocess and the host-oracle engine ─────────────────


NATIVE_PRE_CASES = {  # tests/test_native_oracle.py's cases
    "color divisible": ((3, 256, 320, 3), 128, "bgr"),
    "rgb": ((2, 256, 256, 3), 128, "rgb"),
    "gray non-divisible": ((2, 200, 300), 128, "bgr"),
    "single colour frame": ((480, 640, 3), 128, "bgr"),
    "single gray frame": ((256, 256), 128, "bgr"),
    "tall": ((640, 256, 3), 128, "bgr"),
    "upsample": ((3, 240, 320, 3), 256, "bgr"),
}


@pytest.mark.native
@pytest.mark.parametrize("case", sorted(NATIVE_PRE_CASES))
def test_native_preprocess_equals_the_original(case, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_CNN_BUILD_DIR", str(tmp_path))  # the original's
    shape, out, order = NATIVE_PRE_CASES[case]
    frames = np.random.RandomState(42).randint(0, 256, shape).astype(np.uint8)
    got = native_pre.preprocess_frames_native(frames, out, channel_order=order)
    _same(got, j_native_pre.preprocess_frames_native(frames, out,
                                                     channel_order=order))
    if order == "bgr":  # the numpy twin reads BGR and gray
        want = (realtime.preprocess(frames, out) if len(shape) == 2
                or (len(shape) == 3 and shape[-1] == 3)
                else np.stack([realtime.preprocess(f, out) for f in frames]))
        _same(got, want)
    with pytest.raises(ValueError, match="channel_order"):
        native_pre.preprocess_frames_native(frames, out, channel_order="bgrx")


@pytest.mark.parametrize("use_native", [pytest.param(True, marks=pytest.mark.native),
                                        False])
def test_cpu_ref_engine_equals_the_original(use_native, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_CNN_BUILD_DIR", str(tmp_path))  # the original's
    bundle = j_art.load_bundle(BUNDLES["lyr3-std"])
    imgs = np.random.RandomState(43).randint(0, 256, (3, 128, 128)).astype(np.uint8)
    ours = cpu_ref.CPURefEngine(bundle.kernels, use_native=use_native)
    theirs = j_cpu_ref.CPURefEngine(bundle.kernels, use_native=use_native)
    assert ours.backend == theirs.backend == ("native-c++" if use_native
                                              else "numpy")
    for eng in (ours, theirs):
        eng.set_shifts(1, 3, 5)
    assert ours.shifts == theirs.shifts == [1, 3, 5]
    _same(ours.run_batch(imgs), theirs.run_batch(imgs))
    got, conv_ms, read_ms = ours.run(imgs[0])
    _same(got, theirs.run(imgs[0])[0])
    _same(got, cpu_ref.numpy_cnn_forward(imgs[0], bundle.kernels, (1, 3, 5)))
    assert conv_ms >= 0 and read_ms == 0.0


# ── the data generators, metrics and helpers of the offline apps ─────


VAL_BINS = os.path.join(REPO, "artifacts", "realphoto", "val_bins")


def _generator_case(data, name):
    """One generator's output through ``data`` (the port's module or the
    JAX package's) on fixed seeds and small sizes."""
    if name == "SyntheticShapes.arrays_with_boxes":
        return data.SyntheticShapes(n_per_class=2, seed=3).arrays_with_boxes()
    if name == "CompositeScenes":
        return [data.CompositeScenes(n_scenes=4, seed=3, same_class=sc).arrays()
                for sc in (False, True)]
    if name == "MovingScenes":
        return [data.MovingScenes(n_seqs=2, n_frames=5, seed=3,
                                  same_class=sc).arrays() for sc in (False, True)]
    if name == "RealComposites":
        return [data.RealComposites(n_scenes=4, seed=3, root=VAL_BINS,
                                    background=bg).arrays()
                for bg in ("noise", "real")] + [
            data.RealComposites(n_scenes=3, seed=4, same_class=True).arrays()]
    if name == "RealMovingScenes":
        return [data.RealMovingScenes(n_seqs=2, n_frames=5, seed=3,
                                      background=bg).arrays()
                for bg in ("noise", "real")]
    if name == "BinFolderDataset":
        ds = data.BinFolderDataset(VAL_BINS, max_per_class=3)
        return ds.arrays(), ds.class_names, len(ds)
    raise KeyError(name)


GENERATORS = ["SyntheticShapes.arrays_with_boxes", "CompositeScenes",
              "MovingScenes", "RealComposites", "RealMovingScenes",
              "BinFolderDataset"]


def _same_data(a, b):
    """``_same`` through dicts and tuples of numpy scalars and ints."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_data(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_data(x, y)
    elif isinstance(a, np.ndarray):
        _same(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


@pytest.mark.parametrize("name", GENERATORS)
def test_data_generator_equals_the_original(name):
    from tpu_cnn.train import data as j_data
    from tpu_cnn_torch.train import data

    _same_data(_generator_case(data, name), _generator_case(j_data, name))


def _write_pngs(root, rs):
    from PIL import Image

    for cls in ("bus", "cat"):
        os.makedirs(root / cls)
        for i in range(2):
            Image.fromarray(rs.randint(0, 256, (40 + 7 * i, 50, 3)).astype(
                np.uint8)).save(root / cls / f"im{i}.png")


def test_image_folder_dataset_equals_the_original(tmp_path):
    from tpu_cnn.train import data as j_data
    from tpu_cnn_torch.train import data

    _write_pngs(tmp_path, np.random.RandomState(44))
    for kw in ({}, {"max_per_class": 1, "img_size": 32},
               {"class_names": ["cat"]}):
        ours, theirs = (m.ImageFolderDataset(str(tmp_path), **kw)
                        for m in (data, j_data))
        assert ours.class_names == theirs.class_names
        assert ours.samples == theirs.samples
        _same_data(ours.arrays(), theirs.arrays())


def test_coco_classification_equals_the_original(tmp_path):
    """``CocoClassification`` on a small COCO JSON and images the test
    writes (COCO is not in the repository): the same samples and arrays,
    through the built-in JSON reader when pycocotools is absent."""
    import json

    from PIL import Image
    from tpu_cnn.train import data as j_data
    from tpu_cnn_torch.train import data

    rs = np.random.RandomState(45)
    cats = list(data.CocoClassification.COCO_CATS.values())
    images, anns = [], []
    for i in range(12):
        name = f"{i:04d}.png"
        Image.fromarray(rs.randint(0, 256, (30, 40, 3)).astype(np.uint8)).save(
            tmp_path / name)
        images.append({"id": 100 + i, "file_name": name})
        for c in rs.choice(cats, 1 + i % 2, replace=False):
            anns.append({"id": len(anns), "image_id": 100 + i,
                         "category_id": int(c)})
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns}))
    assert data.CocoClassification.COCO_CATS == j_data.CocoClassification.COCO_CATS
    for kw in ({}, {"max_per_class": 2, "img_size": 32, "seed": 3}):
        ours, theirs = (m.CocoClassification(str(tmp_path), str(ann), **kw)
                        for m in (data, j_data))
        assert ours.samples == theirs.samples and len(ours) == len(theirs) > 0
        assert ours.class_names == theirs.class_names
        _same_data(ours.arrays(), theirs.arrays())
    mini = data._MiniCoco(str(ann))
    j_mini = j_data._MiniCoco(str(ann))
    for c in cats:
        assert mini.getImgIds(catIds=[c]) == j_mini.getImgIds(catIds=[c])
    assert mini.loadImgs(103) == j_mini.loadImgs(103)


HELPERS = {
    "soft_composites": lambda d, imgs, labels: [
        d.soft_composites(imgs, labels, 5, seed=s) for s in (0, 2)],
    "batches": lambda d, imgs, labels: [
        list(d.batches(imgs, labels, 3, np.random.RandomState(5), drop_remainder=dr))
        for dr in (True, False)],
    "augment_batch": lambda d, imgs, labels: [
        d.augment_batch(imgs, np.random.RandomState(6), max_shift=ms)
        for ms in (4, 1)],
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_data_helper_equals_the_original(name):
    from tpu_cnn.train import data as j_data
    from tpu_cnn_torch.train import data

    imgs, labels = j_data.BinFolderDataset(VAL_BINS, max_per_class=3).arrays()
    _same_data(HELPERS[name](data, imgs, labels),
               HELPERS[name](j_data, imgs, labels))


def test_iou_equals_the_original():
    from tpu_cnn.apps.eval_detection import iou as j_iou
    from tpu_cnn_torch.apps.eval_detection import iou

    rs = np.random.RandomState(46)
    boxes = [tuple(int(v) for v in rs.randint(0, 128, 4)) for _ in range(40)]
    boxes += [(0, 0, 10, 10), (20, 20, 30, 30), (5, 5, 5, 5)]
    for a in boxes:
        for b in boxes[:12]:
            got, want = iou(a, b), j_iou(a, b)
            assert got == want and type(got) is type(want)


def test_metrics_equal_the_originals(tmp_path):
    from tpu_cnn.utils import metrics as j_metrics
    from tpu_cnn_torch.utils import metrics

    rs = np.random.RandomState(47)
    feats = rs.randint(0, 256, (5, 8, 16)).astype(np.uint8)
    feats[:, 2] = 0
    assert metrics.feature_stats(feats) == j_metrics.feature_stats(feats)
    labels = rs.randint(0, 4, 40)
    preds = np.where(rs.rand(40) < 0.7, labels, rs.randint(0, 4, 40))
    for names in (None, ["a", "b", "c", "d"]):
        assert (metrics.accuracy_report(preds, labels, names)
                == j_metrics.accuracy_report(preds, labels, names))
    recs = []
    for mod, name in ((metrics, "ours.jsonl"), (j_metrics, "theirs.jsonl")):
        sink = mod.JsonlMetrics(str(tmp_path / "sub" / name))
        sink.log("fps", 12.5, mode="mega")
        sink.log("acc", 0.75)
        mod.JsonlMetrics(None).log("ignored", 1)
        lines = (tmp_path / "sub" / name).read_text().splitlines()
        recs.append([{k: v for k, v in json.loads(ln).items() if k != "ts"}
                     for ln in lines])
    assert recs[0] == recs[1] == [{"metric": "fps", "value": 12.5, "mode": "mega"},
                                  {"metric": "acc", "value": 0.75}]


def test_fit_bbox_head_equals_the_original():
    rs = np.random.RandomState(48)
    pooled = rs.rand(50, 64).astype(np.float32)
    boxes = np.sort(rs.randint(0, 128, (50, 4)), axis=1)
    for img_size, lam in ((128, 1.0), (256, 0.3)):
        _same(bbox.fit_bbox_head(pooled, boxes, img_size, lam=lam),
              j_bbox.fit_bbox_head(pooled, boxes, img_size, lam=lam))


def test_feature_dump_codec_equals_the_original(tmp_path):
    rs = np.random.RandomState(49)
    feats = rs.randint(0, 256, (3, 64, 256)).astype(np.uint8)
    labels, names = np.array([3, 0, -1]), ["a.bin", "b.bin", "c.bin"]
    art.save_feature_dump(tmp_path / "ours.npz", feats, labels, names, (2, 4, 6))
    j_art.save_feature_dump(tmp_path / "theirs.npz", feats, labels, names, (2, 4, 6))
    for p in ("ours.npz", "theirs.npz"):
        for load in (art.load_feature_dump, j_art.load_feature_dump):
            _same(load(tmp_path / p)[:3], (feats, labels, names))
            _same(load(tmp_path / p)[3], np.asarray([2, 4, 6]))


def test_doctor_bundles_equal_the_original():
    from tpu_cnn.apps import doctor as j_doctor
    from tpu_cnn_torch.apps import doctor

    assert doctor._DEFAULT_BUNDLES == j_doctor._DEFAULT_BUNDLES


# ── the native ring and HTTP front sources ───────────────────────────


def _code_after_header(path: str) -> str:
    """A C++ source without its leading ``//`` comment block: the copies
    change only that header, which names the port."""
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines) and lines[i].startswith("//"):
        i += 1
    return "\n".join(lines[i:])


@pytest.mark.parametrize("name", ["frame_ring.cpp", "http_front.cpp"])
def test_native_runtime_sources_equal_the_originals(name):
    ours = os.path.join(REPO, "tpu_cnn_torch", "native", name)
    theirs = os.path.join(REPO, "tpu_cnn", "native", name)
    assert _code_after_header(ours) == _code_after_header(theirs)
    with open(ours) as f:
        assert "port" in f.read().split("\n\n")[0]


def test_host_library_links_the_three_sources():
    """One host library, as the JAX build links one shared object: the
    oracle, the ring (which calls the oracle's preprocess) and the front;
    the oracle, the preprocess, the ring and the front all load it."""
    from tpu_cnn.native import build as j_build
    from tpu_cnn_torch.ops import _build

    assert (tuple(os.path.basename(s) for s in j_build.SRCS)
            == _build.HOST_SOURCES)
    from tpu_cnn_torch.native import ring
    from tpu_cnn_torch.apps import serve_native

    for mod in (oracle, native_pre, ring, serve_native):
        with open(mod.__file__) as f:
            assert "_build.build_host()" in f.read()


def test_detection_filters_live_beside_the_engine():
    """``head.detections`` holds the engine module's filters (one copy):
    ``engine.cuda`` exports the same objects."""
    from tpu_cnn_torch.engine import cuda
    from tpu_cnn_torch.head import detections

    for name in ("presence_scores", "detections_above", "instance_detections",
                 "DEFAULT_MULTI_THRESH"):
        assert getattr(cuda, name) is getattr(detections, name)


# ── the progress watchdog ────────────────────────────────────────────


def test_watchdog_equals_the_original():
    """``utils.failguard.Watchdog`` is the JAX package's class, line for
    line (it is pure ``threading``)."""
    from tpu_cnn.utils import failguard as j_failguard
    from tpu_cnn_torch.utils import failguard

    assert (inspect.getsource(failguard.Watchdog)
            == inspect.getsource(j_failguard.Watchdog))


@pytest.mark.parametrize("case", ["fires_and_stops", "kick_defers"])
def test_watchdog_behaves_as_the_original(case):
    """``tests/test_aux_subsystems.py``'s two watchdog tests on the copy."""
    from tpu_cnn_torch.utils.failguard import Watchdog

    fired = []
    if case == "fires_and_stops":
        wd = Watchdog(stall_s=0.1, on_stall=lambda: fired.append(1))
        wd.kick()
        time.sleep(0.3)
        assert fired, "watchdog should fire after stall"
        wd.stop()
        n = len(fired)
        wd.kick()  # no-op after stop
        time.sleep(0.2)
        assert len(fired) == n
    else:
        wd = Watchdog(stall_s=0.25, on_stall=lambda: fired.append(1))
        for _ in range(4):
            wd.kick()
            time.sleep(0.1)  # keep kicking before the stall window closes
        assert not fired
        wd.stop()
