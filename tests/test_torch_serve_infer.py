"""The port's apps on the CPU: the HTTP service and the inference CLI
against the host oracle, for lyr3-std and lyr4-wide (``--variant``), their
multi-object modes (``--multi``, ``--instances``) against the host twins,
and the package's import hygiene (no JAX).

Tolerances: predictions and boxes equal; probabilities within 1e-4 (the
bench gate's bound: the service computes them in torch, the oracle in
numpy, with different summation orders)."""

import contextlib
import glob
import http.client
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps.serve import ServiceHTTPServer, make_handler  # noqa: E402
from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.head.cam import cam_bbox_fast  # noqa: E402
from tpu_cnn.head.classify import classify_np  # noqa: E402
from tpu_cnn.models.registry import REGISTRY  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch.apps import infer, serve  # noqa: E402

ART = default_artifacts()
ART4 = default_artifacts("lyr4-wide")
LYR4_SHIFTS = (3, 5, 5, 7)  # the lyr4-wide bundle's shifts.json
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle(body: bytes, bundle, shifts=(2, 4, 6), img_size=128):
    feats = numpy_cnn_forward(np.frombuffer(body, np.uint8), bundle.kernels,
                              shifts)
    idx, conf, probs = classify_np(feats[None], bundle.fc_weight, bundle.fc_bias)
    return int(idx[0]), probs[0], list(cam_bbox_fast(
        feats, int(idx[0]), bundle.fc_weight, img_size=img_size))


def _lyr4_bundle():
    return art.load_bundle(ART4,
                           layer_configs=REGISTRY["lyr4-wide"].layer_configs)


@contextlib.contextmanager
def _service(**kwargs):
    """A CPU service on an ephemeral loopback port; yields request()."""
    batcher, backend = serve.build_service(device="cpu", max_wait_ms=2.0,
                                           **kwargs)
    srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(batcher, backend))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=60)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        yield request
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        th.join(timeout=10)
    assert not th.is_alive()


def test_service_answers_like_the_host_oracle():
    bundle = art.load_bundle(ART)
    with _service(artifacts_dir=ART, max_batch=4) as request:
        for p in sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:3]:
            body = open(p, "rb").read()
            status, ans = request("POST", "/detect", body)
            idx, probs, box = _oracle(body, bundle)
            assert status == 200, ans
            assert ans["pred"] == idx and ans["bbox"] == box
            assert ans["name"] == bundle.class_names[idx]
            np.testing.assert_allclose(ans["probs"], probs, rtol=0, atol=1e-4)
        assert request("GET", "/healthz") == (
            200, {"ok": True, "backend": "reference-cpu"})
        assert request("POST", "/detect", b"\x00" * 100)[0] == 400


def test_service_lyr4_wide_answers_like_the_host_oracle():
    """--variant lyr4-wide: a POST body is 256 x 256 = 65,536 bytes; a
    128 x 128 body is refused."""
    bundle = _lyr4_bundle()
    body = open(sorted(glob.glob(os.path.join(ART4, "test_image_*.bin")))[0],
                "rb").read()
    assert len(body) == 65536
    with _service(variant="lyr4-wide", max_batch=2) as request:
        status, ans = request("POST", "/detect", body)
        idx, probs, box = _oracle(body, bundle, LYR4_SHIFTS, 256)
        assert status == 200, ans
        assert ans["pred"] == idx and ans["bbox"] == box
        np.testing.assert_allclose(ans["probs"], probs, rtol=0, atol=1e-4)
        assert request("POST", "/detect", b"\x00" * 16384)[0] == 400


def test_infer_cli_scores_a_directory(tmp_path, capsys):
    bundle = art.load_bundle(ART)
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:2]
    for p in paths:
        shutil.copy(p, tmp_path)
    infer.main(["--artifacts", ART, "--image-dir", str(tmp_path),
                "--device", "cpu", "--no-save"])
    out = capsys.readouterr().out
    want = sum(_oracle(open(p, "rb").read(), bundle)[0]
               == art.label_from_filename(p) for p in paths)
    assert f"Accuracy: {want}/2 " in out
    assert "CUDAEngine (reference-cpu)" in out


def test_infer_cli_lyr4_wide(tmp_path, capsys):
    """--variant lyr4-wide resolves artifacts/pretrained-lyr4 and its
    shifts; the accuracy equals the numpy oracle's on the same images."""
    bundle = _lyr4_bundle()
    paths = sorted(glob.glob(os.path.join(ART4, "test_image_*.bin")))[:2]
    for p in paths:
        shutil.copy(p, tmp_path)
    infer.main(["--variant", "lyr4-wide", "--image-dir", str(tmp_path),
                "--device", "cpu", "--no-save"])
    out = capsys.readouterr().out
    want = sum(_oracle(open(p, "rb").read(), bundle, LYR4_SHIFTS, 256)[0]
               == art.label_from_filename(p) for p in paths)
    assert f"Accuracy: {want}/2 " in out
    assert "CUDAEngine (reference-cpu)" in out


def test_infer_cli_single_image(capsys):
    p = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[0]
    infer.main(["--image", p, "--device", "cpu", "--no-save"])
    idx = _oracle(open(p, "rb").read(), art.load_bundle(ART))[0]
    assert f"(class {idx})" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--multi"], ["--multi", "--instances", "2"]])
def test_infer_unported_modes_exit(tmp_path, capsys, argv):
    """--multi and --multi --instances 2 on the port (the detections of the
    engine's multi detect) print the same "Detections" blocks as the JAX
    CLI on its numpy oracle and host twins (``--mode cpu``): names and
    boxes equal, probabilities within the printed 0.1%."""
    from tpu_cnn.apps import infer as jax_infer

    for p in sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:3]:
        shutil.copy(p, tmp_path)
    common = ["--artifacts", ART, "--image-dir", str(tmp_path), "--no-save"]
    infer.main(common + argv + ["--device", "cpu"])
    got = infer.parse_detection_blocks(capsys.readouterr().out)
    jax_infer.main(common + argv + ["--mode", "cpu"])
    want = infer.parse_detection_blocks(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    for (gh, gd), (wh, wd) in zip(got, want):
        assert gh == wh == "  Detections (prob >= per-class calibrated floors):"
        assert [(n, b) for n, _, b in gd] == [(n, b) for n, _, b in wd]
        np.testing.assert_allclose([p for _, p, _ in gd], [p for _, p, _ in wd],
                                   rtol=0, atol=0.1 + 1e-9)


def test_infer_multi_flags_as_in_the_jax_cli(tmp_path, capsys):
    """--instances without --multi is ignored; --multi-thresh sets a
    uniform floor; --multi on a GAP-head bundle is refused."""
    p = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[0]
    infer.main(["--image", p, "--device", "cpu", "--no-save", "--instances", "2"])
    assert "Detections" not in capsys.readouterr().out
    infer.main(["--image", p, "--device", "cpu", "--no-save", "--multi",
                "--multi-thresh", "0.05", "--mode", "pallas"])
    assert "  Detections (prob >= 5%):" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        infer.main(["--variant", "lyr4-wide", "--head-prefix", "gap_",
                    "--multi", "--device", "cpu", "--no-save"])
    with pytest.raises(ValueError, match="spatial-bin head"):
        serve.build_service(ART4, device="cpu", max_batch=1,
                            variant="lyr4-wide", head_prefix="gap_", multi=True)


@pytest.mark.parametrize("argv", [["--deployable", "x.tcnnx"],
                                  ["--deployable", "x.tcnnx", "--multi"]])
def test_serve_unported_modes_exit(argv):
    with pytest.raises(SystemExit):
        serve.main(argv + ["--device", "cpu"])


_MULTI_SERVICE = """
import http.client, json, sys, threading
from tpu_cnn.apps.serve import ServiceHTTPServer, make_handler
from tpu_cnn_torch.apps import serve
paths, urls = json.loads(sys.argv[1]), json.loads(sys.argv[2])
batcher, backend = serve.build_service(device="cpu", max_batch=4,
                                       max_wait_ms=2.0, multi=True,
                                       instances=2)
srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(batcher, backend))
th = threading.Thread(target=srv.serve_forever, daemon=True)
th.start()
answers = []
for path, url in zip(paths, urls):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    conn.request("POST", url, body=open(path, "rb").read())
    resp = conn.getresponse()
    answers.append((resp.status, json.loads(resp.read())))
    conn.close()
srv.shutdown()
srv.server_close()
batcher.stop()
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
print(json.dumps(answers))
"""


def test_service_multi_instances_answers_like_the_host_twins():
    """--multi --instances 2 on the port's service, in a process that
    never imports JAX: each answer's detections equal the host twins'
    (numpy oracle features, cam_bbox_multi, cam_instances, the shipped
    presence head and floors, the JAX engine's instance filter); one
    request sets its own floor with ?thresh=."""
    from tpu_cnn.engine.tpu import instance_detections
    from tpu_cnn.head.cam import cam_bbox_multi, cam_instances
    from tpu_cnn.head.classify import multi_scores_np, pool_for_head

    bundle = art.load_bundle(ART)
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[4:8]
    urls = ["/detect?thresh=0.3", "/detect", "/detect", "/detect"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _MULTI_SERVICE, json.dumps(paths),
         json.dumps(urls)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    answers = json.loads(proc.stdout.splitlines()[-1])
    for path, url, (status, ans) in zip(paths, urls, answers):
        body = open(path, "rb").read()
        idx, probs, _ = _oracle(body, bundle)
        feats = numpy_cnn_forward(np.frombuffer(body, np.uint8), bundle.kernels)
        boxes = cam_bbox_multi(feats, bundle.fc_weight)
        ib, ic = cam_instances(feats, bundle.fc_weight, max_instances=2)
        sc = multi_scores_np(pool_for_head(feats[None], bundle.fc_weight),
                             *bundle.multi_head)[0]
        thr = 0.3 if "thresh" in url else bundle.multi_thresh
        want = instance_detections(sc, boxes, ib, ic, thr)
        assert status == 200, ans
        assert ans["pred"] == idx and ans["bbox"] == [int(v) for v in boxes[idx]]
        np.testing.assert_allclose(ans["probs"], probs, rtol=0, atol=1e-4)
        got = ans["detections"]
        assert [(d["pred"], d["bbox"]) for d in got] == [
            (k, list(b)) for k, _, b in want]
        assert [d["name"] for d in got] == [bundle.class_names[k]
                                            for k, _, _ in want]
        np.testing.assert_allclose([d["conf"] for d in got],
                                   [p for _, p, _ in want], rtol=0, atol=1e-4)


def test_package_imports_without_jax():
    """Every module of the port imports without pulling in JAX (the card's
    machine need not have it)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_cnn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "tpu_cnn_torch.__path__, 'tpu_cnn_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 14, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_infer_cli_mode_pallas(tmp_path, capsys):
    """--mode pallas: the conv kernel's plain version on every layer; the
    accuracy equals the numpy oracle's."""
    bundle = art.load_bundle(ART)
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[2:4]
    for p in paths:
        shutil.copy(p, tmp_path)
    infer.main(["--artifacts", ART, "--image-dir", str(tmp_path),
                "--device", "cpu", "--mode", "pallas", "--no-save"])
    out = capsys.readouterr().out
    want = sum(_oracle(open(p, "rb").read(), bundle)[0]
               == art.label_from_filename(p) for p in paths)
    assert f"Accuracy: {want}/2 " in out
    assert "CUDAEngine (pallas-reference-cpu)" in out


def test_service_mode_hybrid_answers_like_the_host_oracle():
    bundle = art.load_bundle(ART)
    with _service(artifacts_dir=ART, max_batch=2, mode="hybrid") as request:
        assert request("GET", "/healthz") == (
            200, {"ok": True, "backend": "hybrid-reference-cpu"})
        for p in sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[3:5]:
            body = open(p, "rb").read()
            status, ans = request("POST", "/detect", body)
            idx, probs, box = _oracle(body, bundle)
            assert status == 200, ans
            assert ans["pred"] == idx and ans["bbox"] == box
            np.testing.assert_allclose(ans["probs"], probs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("argv,exc", [
    (["--mode", "auto"], SystemExit),  # no backend picks itself
    (["--shifts", "2,4,-1"], ValueError),
    (["--shifts", "2,32,6"], ValueError)])
def test_infer_refuses_bad_mode_and_shifts(argv, exc):
    with pytest.raises(exc):
        infer.main(argv + ["--device", "cpu", "--no-save"])
