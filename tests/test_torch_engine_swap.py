"""The port's engine swap on the CPU: ``make_engine`` for every ``--mode``,
the host-oracle engine behind the infer CLI's ``--mode cpu`` (the same
lines, accuracy and Detections blocks as the JAX CLI's ``--mode cpu``),
``--dump-features`` (the JAX CLI's array), ``--mode auto`` and the serve
CLI's ``--mode cpu`` as a process answering HTTP.

Tolerances: features, predictions, boxes and printed lines are exact."""

import glob
import http.client
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import infer as j_infer  # noqa: E402
from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn_torch.apps import infer, serve  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.engine.cpu_ref import CPURefEngine  # noqa: E402
from tpu_cnn_torch.engine.cuda import BACKENDS, CUDAEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
ART4 = os.path.join(REPO, "artifacts", "pretrained-lyr4")


@pytest.fixture(scope="module")
def model():
    return load_model(ART)


def test_make_engine_cpu_is_the_host_oracle(model):
    eng = infer.make_engine(model, "cpu", device="cuda")  # device ignored
    assert isinstance(eng, CPURefEngine) and eng.backend == "native-c++"
    assert not hasattr(eng, "detect_batch")
    img = np.fromfile(os.path.join(ART, "test_image_0_class3.bin"), np.uint8)
    np.testing.assert_array_equal(eng.run(img)[0],
                                  numpy_cnn_forward(img, model.kernels, model.shifts))


@pytest.mark.parametrize("mode", BACKENDS)
def test_make_engine_device_backends(model, mode):
    eng = infer.make_engine(model, mode, device="cpu", box_mode="centroid")
    assert isinstance(eng, CUDAEngine)
    assert eng.mode == mode and eng.box_mode == "centroid"
    assert eng.device.type == "cpu"


@pytest.mark.parametrize("variant,art", [("lyr3-std", ART), ("lyr4-wide", ART4)])
def test_make_engine_auto_resolves_to_mega(variant, art):
    m = load_model(art, variant)
    assert infer.auto_backend(m) == "mega"
    eng = infer.make_engine(m, "auto", device="cpu")
    assert isinstance(eng, CUDAEngine) and eng.mode == "mega"


def test_auto_falls_back_to_hybrid_without_a_plan(model, monkeypatch):
    """The rule ``TPUEngine`` applies on a chip: no megakernel plan for
    the geometry -> hybrid."""
    monkeypatch.setattr(infer.mega, "mega_plan", lambda cfgs: None)
    assert infer.auto_backend(model) == "hybrid"
    assert infer.make_engine(model, "auto", device="cpu").mode == "hybrid"


def test_make_engine_refuses_mesh_and_unknown_modes(model, capsys):
    """``--mode mesh`` runs since the mesh was ported: ``make_engine`` gives
    a ``MeshEngine`` over the CPU (one position; the kernels' plain
    versions), whose features are the oracle's, and infer and serve take
    it, infer scoring what ``--mode cpu`` scores; unknown modes are still
    refused."""
    from tpu_cnn_torch.parallel.mesh import MeshEngine

    eng = infer.make_engine(model, "mesh", device="cpu")
    assert isinstance(eng, MeshEngine) and eng.backend == "mesh[(1, 1)]:mega"
    img = np.fromfile(os.path.join(ART, "test_image_0_class3.bin"), np.uint8)
    np.testing.assert_array_equal(eng.run(img)[0],
                                  numpy_cnn_forward(img, model.kernels, model.shifts))
    with pytest.raises(ValueError, match="unknown mode"):
        infer.make_engine(model, "tpu", device="cpu")
    infer.main(["--mode", "mesh", "--device", "cpu", "--no-save"])
    mesh_out = capsys.readouterr().out
    infer.main(["--mode", "cpu", "--no-save"])
    cpu_out = capsys.readouterr().out
    assert "MeshEngine (mesh[(1, 1)]:mega)" in mesh_out
    assert _accuracy(mesh_out) == _accuracy(cpu_out)
    batcher, backend = serve.build_service(device="cpu", mode="mesh",
                                           max_batch=2)
    batcher.stop()
    assert backend == "mesh[(1, 1)]:mega"


def _accuracy(text: str) -> str:
    return next(ln for ln in text.splitlines() if "Accuracy:" in ln)


def _lines(text: str) -> list[str]:
    """The CLI lines both CLIs print alike (the engine's own line and the
    ms/image timing left out)."""
    keep = ("  Image:", "  Prediction:", "  Confidence:", "  BBox:",
            "  Accuracy:", "    1.", "    2.", "    3.")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("argv", [[], ["--box", "centroid"], ["--box", "reg"]])
def test_infer_mode_cpu_prints_what_the_jax_cli_prints(argv, tmp_path, capsys):
    for p in sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:12]:
        shutil.copy(p, tmp_path)
    common = ["--artifacts", ART, "--image-dir", str(tmp_path), "--mode", "cpu",
              "--no-save"] + argv
    infer.main(common)
    ours = capsys.readouterr().out
    j_infer.main(common)
    theirs = capsys.readouterr().out
    assert "Engine: CPURefEngine (native-c++)" in ours
    assert _lines(ours) == _lines(theirs) and len(_lines(ours)) == 12 * 7 + 1


def test_infer_mode_cpu_whole_bundle_accuracy(capsys):
    """The acceptance command: ``infer --mode cpu --no-save`` on the
    shipped bundle scores what the JAX CLI scores."""
    infer.main(["--mode", "cpu", "--no-save"])
    ours = [ln for ln in capsys.readouterr().out.splitlines() if "Accuracy:" in ln]
    j_infer.main(["--mode", "cpu", "--no-save"])
    theirs = [ln for ln in capsys.readouterr().out.splitlines() if "Accuracy:" in ln]
    assert ours == theirs and len(ours) == 1


@pytest.mark.parametrize("argv", [["--multi"], ["--multi", "--instances", "2"],
                                  ["--multi", "--multi-thresh", "0.05"]])
def test_infer_mode_cpu_multi_blocks_equal_the_jax_cli(argv, tmp_path, capsys):
    """``--mode cpu --multi``: the host twins in ``run_inference`` (the
    engine has no multi detect), the same Detections blocks as the JAX
    CLI's, and the annotated multi JPEGs equal."""
    for p in sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:4]:
        shutil.copy(p, tmp_path)
    common = ["--artifacts", ART, "--image-dir", str(tmp_path), "--mode", "cpu"]
    infer.main(common + argv)
    got = capsys.readouterr().out
    jpgs = {f: open(os.path.join(tmp_path, f), "rb").read()
            for f in os.listdir(tmp_path) if f.endswith("_result.jpg")}
    j_infer.main(common + argv)
    want = capsys.readouterr().out
    assert infer.parse_detection_blocks(got) == infer.parse_detection_blocks(want)
    assert len(infer.parse_detection_blocks(got)) == 4 and len(jpgs) == 4
    for f, data in jpgs.items():
        assert open(os.path.join(tmp_path, f), "rb").read() == data


@pytest.mark.parametrize("mode", ["cpu", "auto", "mega"])
def test_dump_features_equals_the_jax_cli(mode, tmp_path, capsys):
    src = os.path.join(ART, "test_image_5_class0.bin")
    if not os.path.exists(src):
        src = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[5]
    img = tmp_path / os.path.basename(src)
    shutil.copy(src, img)
    out = os.path.splitext(str(img))[0] + "_features.npy"
    infer.main(["--image", str(img), "--mode", mode, "--device", "cpu",
                "--no-save", "--dump-features"])
    assert f"Features saved: {out}" in capsys.readouterr().out
    ours = np.load(out)
    os.remove(out)
    j_infer.main(["--image", str(img), "--mode", "cpu", "--no-save",
                  "--dump-features"])
    theirs = np.load(out)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_infer_mode_auto_runs_mega(capsys):
    p = os.path.join(ART, "test_image_0_class3.bin")
    infer.main(["--image", p, "--mode", "auto", "--device", "cpu", "--no-save"])
    assert "Engine: CUDAEngine (reference-cpu)" in capsys.readouterr().out


def test_serve_cli_mode_cpu_answers_http():
    """``python -m tpu_cnn_torch.apps.serve --mode cpu --port 0``: a
    process that prints its port and answers a POST like the host oracle."""
    body = open(os.path.join(ART, "test_image_0_class3.bin"), "rb").read()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_cnn_torch.apps.serve", "--mode", "cpu",
         "--port", "0", "--max-batch", "2"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on 127.0.0.1:"), line + proc.stderr.read()
        assert "backend host:native-c++" in line
        port = int(line.split(":")[1].split()[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/detect", body=body)
        resp = conn.getresponse()
        ans = json.loads(resp.read())
        conn.close()
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    from tpu_cnn.head.cam import cam_bbox_fast
    from tpu_cnn.head.classify import classify_np

    m = load_model(ART)
    feats = numpy_cnn_forward(np.frombuffer(body, np.uint8), m.kernels, m.shifts)
    idx = int(classify_np(feats[None], m.fc_weight, m.fc_bias)[0][0])
    assert resp.status == 200
    assert ans["pred"] == idx
    assert ans["bbox"] == list(cam_bbox_fast(feats, idx, m.fc_weight))
