"""The port's service on the host oracle (``build_service(mode="cpu")``:
``CPURefEngine`` behind ``_HostDetectAdapter``) and its ``DynamicBatcher``,
held to the JAX service's batcher tests (``tests/test_serve_and_
preprocess.py``): coalescing, HTTP end to end, 413, 503 shedding, the
multi-object service with its per-request ``thresh``, its refusal on a
non-multi server and the bundle's default floors, the async pipeline on a
device engine, an engine without ``detect_batch``, and ``--instances``
refused on the host adapter. The adapter itself equals the JAX one.

Tolerances: predictions, boxes and detections exact (both sides run the
same numpy twins on bit-equal features); probabilities within 1e-4 where
one side is torch."""

import http.client
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import serve as j_serve  # noqa: E402
from tpu_cnn.engine.cpu_ref import CPURefEngine as JCPURefEngine  # noqa: E402
from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.head import cam as j_cam  # noqa: E402
from tpu_cnn.head.classify import classify_np  # noqa: E402
from tpu_cnn_torch.apps import serve  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.serve import (MAX_BODY_BYTES, DynamicBatcher,  # noqa: E402
                                      Overloaded, ServiceHTTPServer,
                                      _HostDetectAdapter, _Pending, build_service,
                                      make_handler)
from tpu_cnn_torch.engine.cpu_ref import CPURefEngine  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine, DetectResult  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")


@pytest.fixture(scope="module")
def model():
    return load_model(ART)


def _http(batcher, backend):
    srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(batcher, backend))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _images(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (128, 128)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("box", ["ref", "centroid", "reg"])
def test_host_adapter_equals_the_jax_adapter(model, box):
    imgs = np.stack(_images(5, 1))
    ours = _HostDetectAdapter(CPURefEngine(model.kernels, model.shifts), model, box=box)
    theirs = j_serve._HostDetectAdapter(JCPURefEngine(model.kernels, model.shifts),
                                        model, box=box)
    assert ours.backend == theirs.backend == "host:native-c++"
    a, b = ours.detect_batch(imgs), theirs.detect_batch(imgs)
    for f in ("pred", "conf", "probs", "bbox"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)
    a, b = ours.detect_multi_batch(imgs), theirs.detect_multi_batch(imgs)
    for f in ("pred", "conf", "probs", "boxes"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.inst_boxes is None and a.scores is None
    assert a.detections(1 / 6) == b.detections(1 / 6)


def test_dynamic_batcher_coalesces():
    batcher, backend = build_service(ART, mode="cpu", max_batch=8,
                                     max_wait_ms=30.0)
    assert backend == "host:native-c++"
    imgs = _images(12)
    results = [None] * 12

    def call(i):
        results[i] = batcher.submit(imgs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None and "pred" in r for r in results)
    assert batcher.stats["requests"] == 12
    assert batcher.stats["batches"] < 12, "requests must coalesce into batches"
    batcher.stop()


def test_http_service_end_to_end(model):
    batcher, backend = build_service(ART, mode="cpu", max_batch=4,
                                     max_wait_ms=5.0)
    srv, port = _http(batcher, backend)
    try:
        img = _images(1)[0]
        out = _post(port, "/detect", img.tobytes())
        feats = numpy_cnn_forward(img, model.kernels, model.shifts)
        idx = int(classify_np(feats[None], model.fc_weight, model.fc_bias)[0][0])
        assert out["pred"] == idx and out["name"] == model.class_names[idx]
        assert out["bbox"] == list(j_cam.cam_bbox_fast(feats, idx, model.fc_weight))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True, "backend": "host:native-c++"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            assert json.loads(r.read())["requests"] >= 1
    finally:
        srv.shutdown()
        batcher.stop()


def test_http_service_rejects_oversized_body():
    batcher, backend = build_service(ART, mode="cpu", max_batch=2,
                                     max_wait_ms=1.0)
    srv, port = _http(batcher, backend)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.putrequest("POST", "/detect")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert "too large" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        srv.shutdown()
        batcher.stop()


def test_http_service_sheds_overload_with_503(model):
    """A full admission queue answers a clean 503 with a Retry-After hint,
    never a dropped connection; the direct API raises ``Overloaded``."""

    class _SlowEngine:
        backend = "slow"

        def detect_batch(self, images):
            time.sleep(0.25)  # keep the worker busy so the queue fills
            n = len(images)
            return DetectResult(
                np.zeros(n, np.int32), np.ones(n, np.float32),
                np.full((n, 6), 1 / 6, np.float32), np.zeros((n, 4), np.int32))

    batcher = DynamicBatcher(_SlowEngine(), model.class_names, max_batch=1,
                             max_wait_ms=1.0, max_queue=2)
    srv, port = _http(batcher, "slow")
    body = _images(1)[0].tobytes()
    statuses, retry_after, conn_errors = [], [], []

    def call():
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/detect", body=body)
            r = c.getresponse()
            payload = json.loads(r.read())
            statuses.append(r.status)
            if r.status == 503:
                retry_after.append(r.getheader("Retry-After"))
                assert payload["error"] == "overloaded"
            c.close()
        except Exception as e:  # pragma: no cover - the failure under test
            conn_errors.append(e)

    try:
        threads = [threading.Thread(target=call) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not conn_errors, f"connections dropped: {conn_errors}"
        assert len(statuses) == 12 and set(statuses) <= {200, 503}
        assert 200 in statuses and 503 in statuses
        assert all(ra and int(ra) >= 1 for ra in retry_after)
        assert batcher.snapshot()["shed"] == statuses.count(503)
        batcher.stop()
        time.sleep(0.8)  # the worker finishes its in-flight batch and exits
        while True:
            try:
                batcher.q.put_nowait(_Pending(np.zeros((128, 128), np.uint8)))
            except Exception:
                break
        with pytest.raises(Overloaded) as ei:
            batcher.submit(np.zeros((128, 128), np.uint8), timeout_s=0.1)
        assert ei.value.retry_after_s >= 1
    finally:
        srv.shutdown()
        batcher.stop()


def test_async_pipelined_batcher(model):
    """A device engine (``CUDAEngine`` on the CPU, ``xla``) rides the
    batcher's async pipeline; the answers agree with the host head."""
    engine = CUDAEngine(model, device="cpu", backend="xla")
    assert hasattr(engine, "detect_batch_async")
    batcher = DynamicBatcher(engine, model.class_names, max_batch=4,
                             max_wait_ms=10.0)
    imgs = _images(10)
    results = [None] * 10

    def call(i):
        results[i] = batcher.submit(imgs[i], timeout_s=120)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(10)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=180)
    assert all(r is not None and "pred" in r for r in results), results
    assert batcher.snapshot()["batches"] < 10
    feats = engine.run_batch(np.stack(imgs))
    idx = classify_np(feats, model.fc_weight, model.fc_bias)[0]
    assert [r["pred"] for r in results] == [int(i) for i in idx]
    batcher.stop()


def test_serve_multi_on_the_host_adapter(model):
    """--multi on the host adapter: a 'detections' list of per-class CAM
    boxes above the floor, the argmax entry leading, equal to the host
    twins; the compatibility bbox is the argmax class's CAM box."""
    batcher, _ = build_service(ART, mode="cpu", max_batch=4, max_wait_ms=5.0,
                               multi=True, multi_thresh=1 / 6)
    img = np.random.RandomState(5).randint(0, 256, (128, 128)).astype(np.uint8)
    res = batcher.submit(img)
    feats = numpy_cnn_forward(img, model.kernels, model.shifts)
    idx, _, probs = classify_np(feats[None], model.fc_weight, model.fc_bias)
    boxes = j_cam.cam_bbox_multi(feats, model.fc_weight)
    assert res["detections"] and res["detections"][0]["pred"] == res["pred"]
    for d in res["detections"]:
        assert probs[0, d["pred"]] >= 1 / 6
        np.testing.assert_array_equal(np.asarray(d["bbox"]), boxes[d["pred"]])
    np.testing.assert_array_equal(np.asarray(res["bbox"]), boxes[int(idx[0])])
    batcher.stop()


def test_serve_multi_http_with_per_request_thresh():
    batcher, backend = build_service(ART, mode="cpu", max_batch=4,
                                     max_wait_ms=5.0, multi=True,
                                     multi_thresh=0.0)
    srv, port = _http(batcher, backend)
    try:
        body = _images(1)[0].tobytes()
        all_dets = _post(port, "/detect", body)  # floor 0.0 -> every class
        assert len(all_dets["detections"]) == 6
        some = _post(port, "/detect?thresh=0.166", body)
        assert 1 <= len(some["detections"]) <= 6
        none = _post(port, "/detect?thresh=0.999", body)
        assert none["detections"] == []
        assert none["pred"] == all_dets["pred"]
        for bad in ("1.1", "nan", "-0.1", "x"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, f"/detect?thresh={bad}", body)
            assert e.value.code == 400
    finally:
        srv.shutdown()
        batcher.stop()


def test_serve_thresh_rejected_on_non_multi_server():
    batcher, backend = build_service(ART, mode="cpu", max_batch=2,
                                     max_wait_ms=1.0)
    srv, port = _http(batcher, backend)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/detect?thresh=0.3", np.zeros(128 * 128, np.uint8).tobytes())
        assert e.value.code == 400 and "multi" in e.value.read().decode()
    finally:
        srv.shutdown()
        batcher.stop()


def test_serve_defaults_to_bundle_multi_thresh(tmp_path):
    """A bundle's multi_thresh.json sets the --multi floors per class."""
    art = tmp_path / "bundle"
    shutil.copytree(ART, art, ignore=shutil.ignore_patterns("test_image_*"))
    with open(art / "multi_thresh.json", "w") as f:
        json.dump([0.99, 0.0, 0.99, 0.0, 0.99, 0.0], f)
    os.remove(art / "multi_head.npz")  # floors on the softmax probabilities
    batcher, _ = build_service(str(art), mode="cpu", max_batch=2,
                               max_wait_ms=2.0, multi=True)
    res = batcher.submit(_images(1)[0])
    preds = {d["pred"] for d in res["detections"]}
    assert {1, 3, 5} <= preds
    for d in res["detections"]:
        if d["pred"] in (0, 2, 4):
            assert d["conf"] >= 0.99
    batcher.stop()


def test_serve_multi_rejects_unsupported_engine(model):
    class NoMulti:
        def detect_batch(self, images):
            raise AssertionError("unused")

    with pytest.raises(ValueError, match="multi"):
        DynamicBatcher(NoMulti(), model.class_names, multi=True)


def test_serve_instances_refused_on_the_host_adapter(model):
    adapter = _HostDetectAdapter(CPURefEngine(model.kernels), model)
    with pytest.raises(ValueError, match="instances"):
        DynamicBatcher(adapter, model.class_names, multi=True, instances=2)
    with pytest.raises(ValueError, match="instances"):
        build_service(ART, mode="cpu", max_batch=2, multi=True, instances=2)


def test_batcher_engine_without_detect_batch_fails_per_request(model):
    class NoDetect:
        pass

    batcher = DynamicBatcher(NoDetect(), model.class_names, max_batch=2,
                             max_wait_ms=1.0)
    res = batcher.submit(np.zeros((128, 128), np.uint8), timeout_s=30)
    assert "error" in res and "detect_batch" in res["error"]
    res2 = batcher.submit(np.zeros((128, 128), np.uint8), timeout_s=30)
    assert "error" in res2
    batcher.stop()


def test_decode_image_runs_the_camera_preprocess(model):
    """A PNG body goes through ``realtime.preprocess`` (BGR), not PIL's
    own luma and resize."""
    import io

    from PIL import Image

    from tpu_cnn_torch.apps.realtime import preprocess

    rgb = np.random.RandomState(9).randint(0, 256, (90, 120, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    np.testing.assert_array_equal(serve.decode_image(buf.getvalue(), 64),
                                  preprocess(rgb[..., ::-1], 64))
