"""The port's deployable (``tpu_cnn_torch.apps.export_model``, loaded by
``tpu_cnn_torch.deploy.DeployedDetector``) against the JAX package's live
engine and deployable, on the CPU.

The ``xla`` program (the plain contract and head) exported for ``cpu``
from the shipped lyr3-std bundle (presence head, calibrated floors): the
round trip equals the JAX engine's fused detect, runtime shifts included;
bucket choice and chunking; the multi program with the instance head and
the presence scores last, ``detections()`` equal to the JAX deployable's;
a plain multi program; ``serve --deployable`` single, multi and
instances; the CLI; ``mega`` refused for ``cpu``; a JAX container refused.
The ``mega`` program's graph on CPU tensors (the custom ops' plain
versions), ``torch.library.opcheck`` on both ops, the exportable fixed
point against the eager one, and a child process that loads a deployable
without the code that builds the model. The kernel libraries a ``mega``
container carries for a host without nvcc (a dummy file in place of the
``.so`` here): the manifest key and the bytes round-trip into an empty
build cache, where ``ops._build`` finds them with ``_nvcc`` refusing; a
wrong digest or an old container without the key installs nothing. On the
card (``-m cuda``): the ``mega`` deployable equals ``CUDAEngine(mega)``.

Tolerances: predictions, boxes, instance boxes and counts, and detected
classes exact; probabilities, presence scores and detection scores within
1e-4 (f32 softmax and sigmoid of 1024-term dots, torch against XLA)."""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import export_model as j_export  # noqa: E402
from tpu_cnn.apps.common import load_model as j_load_model  # noqa: E402
from tpu_cnn.engine.tpu import TPUEngine  # noqa: E402
from tpu_cnn_torch.apps import export_model  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.export_model import (DeployedDetector,  # noqa: E402
                                             build_detect_fn, export_bundle)
from tpu_cnn_torch.apps.serve import build_service  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.models.cnn import FpgaCNN  # noqa: E402
from tpu_cnn_torch.ops import detect_head, library, mega  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
ART4 = os.path.join(REPO, "artifacts", "pretrained-lyr4")
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    default pool beside JAX turns seconds into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return load_model(ART), j_load_model(ART)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(5).randint(0, 256, (5, 128, 128)).astype(np.uint8)


@pytest.fixture(scope="module")
def blob(models):
    """The xla programs for cpu at buckets 2 and 4: single-box, and multi
    with the instance head and the shipped presence head."""
    return export_bundle(models[0], batch=(2, 4), backend="xla",
                         platforms=("cpu",), multi=True, instances=2)


@pytest.fixture(scope="module")
def det(blob):
    return DeployedDetector(blob, "cpu")


@pytest.fixture(scope="module")
def jax_engine(models):
    return TPUEngine(models[1], backend="xla")


def _plain(model):
    """The model without its presence head and floors."""
    return FpgaCNN(model.kernels, model.fc_weight, model.fc_bias,
                   model.class_names, shifts=model.shifts, config=model.config,
                   bbox_weight=model.bbox_weight)


def test_roundtrip_equals_the_jax_live_engine(det, jax_engine, images):
    m = det.manifest
    assert m["runtime"] == "torch.export" and m["platforms"] == ["cpu"]
    assert m["batches"] == [2, 4] and m["format"] == 2
    assert m["torch_version"] == torch.__version__ and "jax_version" not in m
    live = jax_engine.detect_batch(images)  # 5 images: chunk 4 + pad 1 to 2
    pred, conf, probs, bbox = det.detect(images)
    np.testing.assert_array_equal(pred, live.pred)
    np.testing.assert_array_equal(bbox, live.bbox)
    np.testing.assert_allclose(probs, live.probs, rtol=0, atol=TOL)
    np.testing.assert_allclose(conf, live.conf, rtol=0, atol=TOL)
    # the runtime register: other shifts through the same programs
    got = det.detect(images, shifts=[1, 2, 3])
    jax_engine.set_shifts(1, 2, 3)
    try:
        live2 = jax_engine.detect_batch(images)
    finally:
        jax_engine.set_shifts(*[int(s) for s in m["default_shifts"]])
    np.testing.assert_array_equal(got[0], live2.pred)
    np.testing.assert_array_equal(got[3], live2.bbox)
    with pytest.raises(ValueError, match="outside 0..31"):
        det.detect(images, shifts=[2, 4, 32])


@pytest.mark.parametrize("n,calls", [(1, [2]), (2, [2]), (3, [4]),
                                     (5, [4, 2]), (9, [4, 4, 2])])
def test_bucket_choice_and_chunking(det, images, n, calls):
    """The smallest bucket that fits the remainder, the largest to chunk;
    padded rows change no real row's answer."""
    seen = []
    real = dict(det._calls)
    det._calls = {b: (lambda x, s, b=b: (seen.append(b), real[b](x, s))[1])
                  for b in real}
    try:
        batch = np.concatenate([images, images])[:n]
        out = det.detect(batch)
    finally:
        det._calls = real
    assert seen == calls
    assert all(len(o) == n for o in out)
    one = [det.detect(batch[i:i + 1]) for i in range(n)]
    for k in (0, 3):
        np.testing.assert_array_equal(out[k], np.concatenate([o[k] for o in one]))


def test_multi_program_equals_the_jax_engine_and_deployable(det, models,
                                                            jax_engine, images):
    """The multi program with instances 2 and the presence head: seven
    outputs, scores last, equal to the JAX engine; ``detections()`` equal
    to the JAX deployable's on the same manifest policy."""
    out = det.detect_multi(images)
    assert len(out) == 7 and det.manifest["multi_head"] is True
    want = jax_engine.detect_multi_batch(images, instances=2)
    for got, w in zip(out, (want.pred, None, None, want.boxes, want.inst_boxes,
                            want.inst_counts)):
        if w is not None:
            np.testing.assert_array_equal(got, w)
    np.testing.assert_allclose(out[2], want.probs, rtol=0, atol=TOL)
    np.testing.assert_allclose(out[-1], want.scores, rtol=0, atol=TOL)
    j_det = j_export.DeployedDetector(j_export.export_bundle(
        models[1], batch=(2, 4), backend="xla", platforms=("cpu",),
        multi=True, instances=2))
    got, theirs = det.detections(images), j_det.detections(images)
    assert det.manifest["multi_thresh"] == j_det.manifest["multi_thresh"]
    assert [[(k, b) for k, _, b in d] for d in got] == \
        [[(k, b) for k, _, b in d] for d in theirs]
    assert sum(len(d) for d in got) >= len(images)
    for g, t in zip(got, theirs):
        np.testing.assert_allclose([p for _, p, _ in g], [p for _, p, _ in t],
                                   rtol=0, atol=TOL)


def test_plain_multi_program_and_refusals(models, images):
    """--multi without instances or a presence head: four outputs, equal to
    the JAX engine; a container without the multi program refuses
    detect_multi."""
    plain = _plain(models[0])
    det = DeployedDetector(export_bundle(plain, batch=(2,), backend="xla",
                                         platforms=("cpu",), multi=True), "cpu")
    assert det.manifest["instances"] == 1 and det.manifest["multi_head"] is False
    out = det.detect_multi(images[:3])
    assert len(out) == 4
    want = TPUEngine(_plain(models[1]), backend="xla").detect_multi_batch(images[:3])
    np.testing.assert_array_equal(out[0], want.pred)
    np.testing.assert_array_equal(out[3], want.boxes)
    np.testing.assert_allclose(out[2], want.probs, rtol=0, atol=TOL)
    single = DeployedDetector(export_bundle(plain, batch=2, backend="xla",
                                            platforms=("cpu",)), "cpu")
    with pytest.raises(ValueError, match="--multi"):
        single.detect_multi(images)


def test_serve_from_the_deployable(tmp_path, blob, models, jax_engine, images):
    """serve --deployable: the batcher runs the container's programs, no
    bundle and no model construction: single-box, multi (detections on
    the presence scores and the manifest's floors) and instances."""
    path = tmp_path / "m.tcnnx"
    path.write_bytes(blob)
    live = jax_engine.detect_batch(images[:2])
    live_multi = jax_engine.detect_multi_batch(images[:2], instances=2)
    thr = models[0].multi_thresh
    for multi, instances in ((False, 1), (True, 1), (True, 2)):
        batcher, backend = build_service(None, device="cpu", max_batch=2,
                                         max_wait_ms=1.0, deployable=str(path),
                                         multi=multi, instances=instances)
        try:
            assert backend == "deployable:xla@cpu"
            for i in range(2):
                res = batcher.submit(images[i])
                assert res["pred"] == int(live.pred[i])
                assert res["name"] == models[0].class_names[res["pred"]]
                if not multi:
                    assert res["bbox"] == [int(v) for v in live.bbox[i]]
                    continue
                want = (live_multi if instances > 1 else
                        jax_engine.detect_multi_batch(images[:2]))
                dets = want.detections(thr)[i]
                assert [(d["pred"], tuple(d["bbox"])) for d in res["detections"]] \
                    == [(k, b) for k, _, b in dets]
        finally:
            batcher.stop()
    single = tmp_path / "s.tcnnx"
    single.write_bytes(export_bundle(_plain(models[0]), batch=2, backend="xla",
                                     platforms=("cpu",)))
    with pytest.raises(ValueError, match="re-export"):
        build_service(None, device="cpu", deployable=str(single), multi=True)


def test_export_cli_roundtrip(tmp_path, capsys):
    out = str(tmp_path / "model.tcnnx")
    assert export_model.main(["--artifacts", ART, "--output", out, "--backend",
                              "xla", "--platforms", "cpu", "--batch", "2"]) == 0
    img = os.path.join(ART, "test_image_0_class3.bin")
    assert export_model.main(["--load", out, "--device", "cpu", "--image",
                              img]) == 0
    txt = capsys.readouterr().out
    assert "backend xla" in txt and "(torch.export)" in txt and "box [" in txt
    eng = CUDAEngine(load_model(ART), "cpu", backend="xla")
    res = eng.detect_batch(np.fromfile(img, np.uint8).reshape(1, 128, 128))
    assert f"box {res.bbox[0].tolist()}" in txt
    with pytest.raises(SystemExit):
        export_model.main(["--artifacts", ART, "--output", out, "--instances",
                           "2"])


def test_refusals(models, blob):
    with pytest.raises(ValueError, match="CUDA only"):
        export_bundle(models[0], batch=2, backend="mega", platforms=("cpu",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_bundle(models[0], batch=2, backend="xla", platforms=("cuda",))
    # a container of the JAX package: StableHLO, no runtime key
    jblob = j_export.export_bundle(models[1], batch=2, backend="xla",
                                   platforms=("cpu",))
    with pytest.raises(ValueError, match="StableHLO"):
        DeployedDetector(jblob, "cpu")
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not cuda"):
        DeployedDetector(blob, "cuda")
    # a cuda container where torch finds no card: refused, not mapped to cpu
    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as src, \
            zipfile.ZipFile(buf, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "manifest.json":
                m = json.loads(data)
                m["platforms"] = ["cuda"]
                data = json.dumps(m)
            dst.writestr(name, data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeployedDetector(buf.getvalue(), "cuda")


def _with_manifest(blob: bytes, edit) -> bytes:
    """The container with ``edit(manifest)`` applied."""
    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as src, \
            zipfile.ZipFile(buf, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "manifest.json":
                m = json.loads(data)
                edit(m)
                data = json.dumps(m)
            dst.writestr(name, data)
    return buf.getvalue()


def test_kernel_libraries_round_trip_into_the_cache(tmp_path, models,
                                                    monkeypatch):
    from tpu_cnn_torch.ops import _build

    assert export_model.kernel_names(models[0], "mega") == ["mega_cnn"]
    assert export_model.kernel_names(load_model(
        os.path.join(REPO, "artifacts", "pretrained-lyr4"), "lyr4-wide"),
        "mega") == ["conv_pool_layer", "mega_cnn"]
    assert export_model.kernel_names(models[0], "xla") == []
    # the exporting host's cache: a dummy file where the library would be
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "export_cache"))
    os.makedirs(_build.BUILD_DIR)
    dummy = b"\x7fELF a stand-in for the sm_90a library"
    with open(_build.kernel_library("mega_cnn"), "wb") as f:
        f.write(dummy)
    _build.build.cache_clear()
    monkeypatch.setattr(export_model, "kernel_names",
                        lambda model, backend: ["mega_cnn"])
    try:
        blob = export_bundle(models[0], batch=1, backend="xla",
                             platforms=("cpu",))
        digest = _build.kernel_digest("mega_cnn")
        member = f"kernels/sm_90a/libmega_cnn_{digest[:16]}.so"
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            entries = json.loads(z.read("manifest.json"))["kernel_libraries"]
            assert z.read(member) == dummy
        assert entries == [{"name": "mega_cnn", "digest": digest,
                            "arch": "sm_90a", "file": member}]

        # the serving host: an empty cache and no CUDA toolkit
        def no_nvcc():
            raise _build.KernelBuildError("nvcc not found")

        monkeypatch.setattr(_build, "_nvcc", no_nvcc)
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "serve_cache"))
        _build.build.cache_clear()
        assert DeployedDetector(blob, "cpu").installed == ["mega_cnn"]
        lib, log, seconds = _build.build("mega_cnn")
        assert (lib, log, seconds) == (_build.kernel_library("mega_cnn"), "", 0.0)
        with open(lib, "rb") as f:
            assert f.read() == dummy
        assert DeployedDetector(blob, "cpu").installed == []  # cached now

        # a digest that is not this csrc/'s, or no key: nothing installed
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "other_cache"))
        _build.build.cache_clear()
        wrong = _with_manifest(blob, lambda m: m["kernel_libraries"][0].update(
            digest="0" * 64))
        old = _with_manifest(blob, lambda m: m.pop("kernel_libraries"))
        for b in (wrong, old):
            det = DeployedDetector(b, "cpu")
            assert det.installed == []
            assert det.detect(np.zeros((1, 128, 128), np.uint8))[0].shape == (1,)
        assert not os.path.exists(_build.BUILD_DIR)
        with pytest.raises(_build.KernelBuildError, match="nvcc"):
            _build.build("mega_cnn")
    finally:
        _build.build.cache_clear()


def test_kernel_library_names_hold_nothing_of_the_host(monkeypatch):
    """A library's name is its sources and ``NVCC_FLAGS`` (the arch among
    them): the same on a host with the toolkit elsewhere, or none."""
    from tpu_cnn_torch.ops import _build

    names = {k: _build.kernel_library(k) for k in
             ("mega_cnn", "conv_pool_layer", "conv_act", "bitcast")}
    monkeypatch.setenv("CUDA_HOME", "/elsewhere/cuda")
    monkeypatch.setenv("PATH", "/elsewhere/bin")
    for k, path in names.items():
        assert _build.kernel_library(k) == path
        digest = _build.source_digest(os.path.join(_build.CSRC_DIR, k + ".cu"),
                                      repr(_build.NVCC_FLAGS).encode())
        assert os.path.basename(path) == f"lib{k}_{digest[:16]}.so"
    assert "code=sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("variant,ops", [
    ("lyr3-std", ["tcnn.mega_cnn.default"]),
    ("lyr4-wide", ["tcnn.conv_pool_layer.default", "tcnn.mega_cnn.default"])])
def test_mega_program_goes_through_the_custom_ops(variant, ops):
    """The mega program's graph calls the kernels' ops (the chained plan's
    head layer, then the tail), the packed weights its constants; run on
    CPU tensors (the ops' plain versions) it equals the engine."""
    model = load_model(ART if variant == "lyr3-std" else ART4, variant)
    prog = build_detect_fn(model, "mega", "ref", "cpu")
    s = model.config.img_size
    ep = torch.export.export(prog, (torch.zeros((1, s, s), dtype=torch.uint8),
                                    torch.zeros(len(model.kernels),
                                                dtype=torch.int32)),
                             strict=False)
    assert [str(n.target) for n in ep.graph.nodes if "tcnn" in str(n.target)] == ops
    assert any(k.startswith("packed") for k in ep.state_dict)
    img = np.random.RandomState(6).randint(0, 256, (1, s, s)).astype(np.uint8)
    out = ep.module()(torch.from_numpy(img), torch.from_numpy(model.shifts))
    want = CUDAEngine(model, "cpu", backend="mega").detect_batch(img)
    for got, w in zip(out, (want.pred, want.conf, want.probs, want.bbox)):
        np.testing.assert_array_equal(got.numpy(), w)


def test_a_mega_program_with_the_old_packing_is_refused(monkeypatch, models):
    """A ``mega`` program exported before the megakernel took its wgmma
    layout holds old-layout packed constants (mma.sync fragments for every
    layer, 4-D). Saved and loaded, it fails loudly on its first call, with
    the ValueError of ``mega._check_packed``, and computes nothing: every
    new packed shape differs from the old one, so the shapes alone tell
    them apart and the manifest needs no packing number."""
    model = models[0]
    ks = [torch.from_numpy(k) for k in model.kernels]
    assert all(tuple(mega.pack_fragments(k).shape) != mega.packed_shape(k) for k in ks)
    monkeypatch.setattr(mega, "pack_plan",
                        lambda kernels, size: [mega.pack_fragments(k) for k in kernels])
    prog = build_detect_fn(model, "mega", "ref", "cpu")
    ep = torch.export.export(prog, (torch.zeros((1, 128, 128), dtype=torch.uint8),
                                    torch.zeros(len(ks), dtype=torch.int32)), strict=False)
    monkeypatch.undo()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    loaded = torch.export.load(buf)
    img = np.random.RandomState(7).randint(0, 256, (1, 128, 128)).astype(np.uint8)
    before = mega.launches
    with pytest.raises(ValueError, match="pack_plan"):
        loaded.module()(torch.from_numpy(img), torch.from_numpy(model.shifts))
    assert mega.launches == before


def test_opcheck_the_custom_ops():
    """torch.library.opcheck: the CPU implementations and the fake ones
    agree on shapes and dtypes, and both ops survive tracing."""
    rs = np.random.RandomState(4)
    ks = [torch.from_numpy(rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8))
          for ic, oc in ((1, 4), (4, 8))]
    x = torch.from_numpy(rs.randint(0, 256, (2, 16, 16)).astype(np.uint8))
    sh = torch.tensor([2, 3], dtype=torch.int32)
    torch.library.opcheck(torch.ops.tcnn.mega_cnn.default,
                          (x, ks, [mega.pack_weights(k) for k in ks], sh,
                           True, True, True))
    torch.library.opcheck(torch.ops.tcnn.conv_pool_layer.default,
                          (x[:, None], ks[0], mega.pack_layer(ks[0]), sh, 0))


class _Labels(torch.nn.Module):
    def forward(self, cores, mask):
        return detect_head._grow_labels(detect_head._connected_labels(cores),
                                        mask)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exported_fixed_point_equals_the_eager_one(seed):
    """Exported, the label loops are ``while_loop``s to the fixed point;
    they give the eager loops' labels (blocks of LABEL_BLOCK steps with a
    host test) on seeded masks, through a save and load."""
    rs = np.random.RandomState(seed)
    mask = torch.from_numpy(rs.rand(3, 16, 16) > 0.45)
    cores = mask & torch.from_numpy(rs.rand(3, 16, 16) > 0.6)
    ep = torch.export.export(_Labels(), (cores, mask), strict=False)
    assert any("while_loop" in str(n.target) for n in ep.graph.nodes)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    buf.seek(0)
    got = torch.export.load(buf).module()(cores, mask)
    want = _Labels()(cores, mask)
    assert torch.equal(got, want)
    assert (want < 256).sum() > 0  # some labelled pixels


_CHILD = r"""
import json, sys
import numpy as np
from tpu_cnn_torch.deploy import DeployedDetector
det = DeployedDetector.load(sys.argv[1], "cpu")
imgs = np.random.RandomState(5).randint(0, 256, (3, 128, 128)).astype(np.uint8)
pred = det.detect(imgs)[0].tolist()
dets = det.detections(imgs)
print(json.dumps({"pred": pred, "n_dets": sum(len(d) for d in dets),
                  "loaded": sorted(m for m in sys.modules if m.startswith(
                      ("tpu_cnn_torch.models", "tpu_cnn_torch.engine",
                       "tpu_cnn_torch.apps", "tpu_cnn.", "jax")))}))
"""


def test_a_child_loads_the_deployable_without_the_model_code(tmp_path, blob,
                                                             det, images):
    path = tmp_path / "m.tcnnx"
    path.write_bytes(blob)
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(path)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["loaded"] == []
    assert res["pred"] == det.detect(images[:3])[0].tolist()
    assert res["n_dets"] == sum(len(d) for d in det.detections(images[:3]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the mega deployable calls "
                    "the CUDA kernels (python -m pytest -m cuda "
                    "tests/test_torch_export.py on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lyr3-std", "lyr4-wide"])
def test_mega_deployable_equals_the_engine_on_the_card(cuda_device, variant):
    model = load_model(ART if variant == "lyr3-std" else ART4, variant)
    det = DeployedDetector(export_bundle(model, batch=(8, 64), backend="mega",
                                         platforms=("cuda",)), cuda_device)
    s = model.config.img_size
    imgs = np.random.RandomState(3).randint(0, 256, (77, s, s)).astype(np.uint8)
    before = mega.launches
    got = det.detect(imgs)
    assert mega.launches > before
    want = CUDAEngine(model, cuda_device, backend="mega").detect_batch(imgs)
    np.testing.assert_array_equal(got[0], want.pred)
    np.testing.assert_array_equal(got[3], want.bbox)
    np.testing.assert_allclose(got[2], want.probs, rtol=0, atol=TOL)
