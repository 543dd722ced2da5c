"""The port's native host runtime against the JAX package's: the frame
ring (``tpu_cnn_torch.native.ring`` on ``native/frame_ring.cpp``) and the
C++ HTTP front (``tpu_cnn_torch.apps.serve_native`` on
``native/http_front.cpp``), both in the port's host library ``tcnn_host``.

The ring: push/pop on the same seeded frames equal to
``tpu_cnn.native.ring.NativeFrameRing``'s, drop-oldest overflow, threaded
producers with ``wait``. The front, over real sockets: concurrent raw-frame
POSTs to the port's front and to the JAX ``NativeFrontEnd`` on the same
frames, single-box and ``--multi`` on the host oracle (``--mode cpu``),
``--instances 2`` on the plain versions of the port's engine against the
JAX engine's ``xla`` backend; /healthz, 400 and 413, 503 push-back, and
the CLI in a child process.

Tolerances: predictions, names, boxes and detected classes exact;
probabilities and detection scores within 1e-4 (f32 softmax and sigmoid of
1024-term dots in torch against numpy/XLA)."""

import functools
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import infer as j_infer  # noqa: E402
from tpu_cnn.apps import serve as j_serve  # noqa: E402
from tpu_cnn.apps import serve_native as j_serve_native  # noqa: E402
from tpu_cnn.apps.common import load_model as j_load_model  # noqa: E402
from tpu_cnn.engine.tpu import TPUEngine  # noqa: E402
from tpu_cnn.native import ring as j_ring  # noqa: E402
from tpu_cnn_torch.apps import serve_native  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.serve_native import NativeFrontEnd, build_worker  # noqa: E402
from tpu_cnn_torch.native.preprocess import preprocess_frames_native  # noqa: E402
from tpu_cnn_torch.native.ring import NativeFrameRing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _isolated_jax_build(tmp_path_factory):
    """The JAX package's host library builds into a directory of this
    module (its build writes the library in place, so parallel workers
    must not share one), and torch runs one intra-op thread here."""
    old, n = os.environ.get("TPU_CNN_BUILD_DIR"), torch.get_num_threads()
    os.environ["TPU_CNN_BUILD_DIR"] = str(tmp_path_factory.mktemp("jax_build"))
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop("TPU_CNN_BUILD_DIR")
    else:
        os.environ["TPU_CNN_BUILD_DIR"] = old


# ── the frame ring ───────────────────────────────────────────────────


@pytest.mark.parametrize("shape,out,order", [((5, 480, 640, 3), 128, "bgr"),
                                             ((5, 96, 72, 3), 32, "rgb"),
                                             ((3, 64, 64), 32, "bgr")])
def test_ring_push_pop_equals_the_jax_ring(shape, out, order):
    """Frames pushed raw come out preprocessed, oldest first, equal to the
    JAX ring's and to the batched native preprocess."""
    frames = np.random.RandomState(7).randint(0, 256, shape).astype(np.uint8)
    ours = NativeFrameRing(capacity=8, out_size=out, channel_order=order)
    theirs = j_ring.NativeFrameRing(capacity=8, out_size=out,
                                    channel_order=order)
    try:
        assert [ours.push(f) for f in frames] == [theirs.push(f) for f in frames]
        got = ours.pop_batch(8)
        np.testing.assert_array_equal(got, theirs.pop_batch(8))
        np.testing.assert_array_equal(
            got, preprocess_frames_native(frames, out, channel_order=order))
        assert ours.pop_batch(4).shape == (0, out, out)
        assert ours.dropped == theirs.dropped == 0
    finally:
        ours.close()
        theirs.close()


def test_ring_overflow_drops_oldest_as_the_jax_ring():
    frames = np.random.RandomState(8).randint(0, 256, (6, 64, 64)).astype(np.uint8)
    ours = NativeFrameRing(capacity=4, out_size=32)
    theirs = j_ring.NativeFrameRing(capacity=4, out_size=32)
    try:
        for f in frames:
            ours.push(f)
            theirs.push(f)
        assert ours.dropped == theirs.dropped == 2
        got = ours.pop_batch(10)
        np.testing.assert_array_equal(got, theirs.pop_batch(10))
        np.testing.assert_array_equal(got, preprocess_frames_native(frames[2:], 32))
    finally:
        ours.close()
        theirs.close()


def test_ring_threaded_producers_and_wait():
    """Four producer threads push at once (the preprocess runs off the
    GIL); the consumer's wait sees the frames; popped + dropped ==
    pushed; the age signal is fresh."""
    ring = NativeFrameRing(capacity=64, out_size=32)
    frames = np.random.RandomState(9).randint(
        0, 256, (4, 25, 96, 96, 3)).astype(np.uint8)
    try:
        threads = [threading.Thread(target=lambda fs=fs: [ring.push(f) for f in fs])
                   for fs in frames]
        for t in threads:
            t.start()
        assert ring.wait(min_frames=1, timeout_s=5.0) >= 1
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert ring.wait(min_frames=64, timeout_s=5.0) == 64
        total = 0
        while len(got := ring.pop_batch(16)):
            total += len(got)
        assert total == 64 and total + ring.dropped == 100
        assert 0.0 <= ring.age_s() < 60.0
        with pytest.raises(ValueError):
            ring.push(np.zeros((4, 4, 2), np.uint8))
    finally:
        ring.close()


# ── the native front ─────────────────────────────────────────────────


@pytest.fixture(scope="module")
def models():
    return load_model(ART), j_load_model(ART)


@pytest.fixture(scope="module")
def frames():
    """Six seeded frames and two shipped test images (objects to detect)."""
    rs = np.random.RandomState(10)
    shipped = [np.fromfile(os.path.join(ART, f), np.uint8).reshape(128, 128)
               for f in sorted(os.listdir(ART)) if f.startswith("test_image_")][:2]
    return np.stack([*rs.randint(0, 256, (6, 128, 128)).astype(np.uint8),
                     *shipped])


def _post(port, body, path="/detect", method="POST"):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, json.loads(r.read())
    finally:
        c.close()


def _serve(front, detect_fn, class_names, multi_thresh, frames):
    """Serve ``frames`` as concurrent POSTs through ``front`` with one
    worker thread on ``detect_fn``; returns the answers in frame order."""
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            front.serve_once(detect_fn, class_names, timeout_s=0.05,
                             multi_thresh=multi_thresh)

    wt = threading.Thread(target=worker)
    wt.start()
    answers = [None] * len(frames)

    def post(i):
        answers[i] = _post(front.port, frames[i].tobytes())

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert front.served >= len(frames)
    finally:
        stop.set()
        wt.join(timeout=30)
        front.stop()
    return answers


def _same_answer(got, want):
    gs, g = got
    ws, w = want
    assert gs == ws == 200
    assert (g["pred"], g["name"], g["bbox"]) == (w["pred"], w["name"], w["bbox"])
    np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=TOL)
    assert abs(g["conf"] - w["conf"]) <= TOL
    assert ("detections" in g) == ("detections" in w)
    gd, wd = g.get("detections", []), w.get("detections", [])
    assert [(d["pred"], d["name"], d["bbox"]) for d in gd] == \
        [(d["pred"], d["name"], d["bbox"]) for d in wd]
    np.testing.assert_allclose([d["conf"] for d in gd], [d["conf"] for d in wd],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["single", "multi", "instances", "mesh"])
def test_native_front_equals_the_jax_front(case, models, frames):
    ours_m, theirs_m = models
    multi = case not in ("single", "mesh")
    if case == "mesh":  # MeshEngine on the CPU against the JAX host oracle
        detect_fn, thr, backend = build_worker(ours_m, "mesh", "cpu",
                                               max_batch=8)
        j_fn = j_serve._HostDetectAdapter(j_infer.make_engine(theirs_m, "cpu"),
                                          theirs_m).detect_batch
    elif case == "instances":
        detect_fn, thr, backend = build_worker(ours_m, "mega", "cpu",
                                               max_batch=8, multi=True,
                                               instances=2)
        j_fn = functools.partial(TPUEngine(theirs_m, backend="xla")
                                 .detect_multi_batch, instances=2)
    else:
        detect_fn, thr, backend = build_worker(ours_m, "cpu", max_batch=8,
                                               multi=multi)
        j_eng = j_serve._HostDetectAdapter(j_infer.make_engine(theirs_m, "cpu"),
                                           theirs_m)
        j_fn = j_eng.detect_multi_batch if multi else j_eng.detect_batch
    assert (thr is None) == (not multi)
    got = _serve(NativeFrontEnd("127.0.0.1", 0, 128, max_batch=8), detect_fn,
                 ours_m.class_names, thr, frames)
    want = _serve(j_serve_native.NativeFrontEnd("127.0.0.1", 0, 128,
                                                max_batch=8),
                  j_fn, theirs_m.class_names, thr, frames)
    for g, w in zip(got, want):
        _same_answer(g, w)
    if multi:
        assert sum(len(a["detections"]) for _, a in got) >= len(frames)
    assert backend == {"instances": "reference-cpu",
                       "mesh": "mesh[(1, 1)]:mega"}.get(case, "host:native-c++")


def test_native_front_health_and_malformed_bodies(models):
    model = models[0]
    detect_fn, _, _ = build_worker(model, "cpu", max_batch=4)
    front = NativeFrontEnd("127.0.0.1", 0, 128, max_batch=4)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            front.serve_once(detect_fn, model.class_names, timeout_s=0.05)

    wt = threading.Thread(target=worker)
    wt.start()
    try:
        status, health = _post(front.port, None, "/healthz", "GET")
        assert status == 200 and health["status"] == "ok"
        assert _post(front.port, b"tiny")[0] == 400
        assert _post(front.port, b"x" * 50000)[0] == 413
        assert _post(front.port, None, "/nope", "GET")[0] == 404
        status, ans = _post(front.port, bytes(128 * 128))
        assert status == 200 and set(ans) == {"pred", "name", "conf",
                                              "probs", "bbox"}
        status, st = _post(front.port, None, "/stats", "GET")
        assert status == 200 and st["served"] >= 1 and st["p99_ms"] >= 0
    finally:
        stop.set()
        wt.join(timeout=30)
        front.stop()


def test_native_front_pushes_back_with_503(models):
    """With the worker stalled, posts beyond the queue (4 x max_batch) get
    503 at once; once the worker drains, the queued ones answer 200."""
    model = models[0]
    detect_fn, _, _ = build_worker(model, "cpu", max_batch=2)
    front = NativeFrontEnd("127.0.0.1", 0, 128, max_batch=2)
    cap, n_posts = 8, 12
    statuses = [None] * n_posts
    body = np.random.RandomState(1).randint(0, 256, (128, 128)).astype(np.uint8)

    def post(i):
        statuses[i] = _post(front.port, body.tobytes())[0]

    threads = [threading.Thread(target=post, args=(i,)) for i in range(n_posts)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while time.time() < deadline and statuses.count(503) < n_posts - cap:
            time.sleep(0.05)
        for _ in range(cap):
            front.serve_once(detect_fn, model.class_names, timeout_s=0.5)
        for t in threads:
            t.join(timeout=30)
        assert statuses.count(503) == n_posts - cap, statuses
        assert statuses.count(200) == cap, statuses
    finally:
        front.stop()


@pytest.mark.parametrize("argv,msg", [
    (["--mode", "mesh", "--instances", "2"], "--instances needs --multi"),
    (["--mode", "cpu", "--instances", "2"], "--instances needs --multi"),
    (["--variant", "lyr4-wide", "--head-prefix", "gap_", "--multi",
      "--mode", "cpu"], "spatial-bin head")])
def test_serve_native_cli_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        serve_native.main(argv + ["--device", "cpu", "--port", "0"])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_serve_native_cli_answers_in_a_child_process():
    """``python -m tpu_cnn_torch.apps.serve_native --mode cpu --port 0``:
    warms, binds, prints its port, answers a POST as the host oracle, and
    stops on SIGINT."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_cnn_torch.apps.serve_native", "--mode",
         "cpu", "--port", "0", "--max-batch", "4"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("native front end on 127.0.0.1:"), (
            line + proc.stderr.read() if proc.poll() is not None else line)
        port = int(line.split(":")[1].split()[0])
        img = np.fromfile(os.path.join(ART, "test_image_0_class3.bin"), np.uint8)
        status, ans = _post(port, img.tobytes())
        want = build_worker(load_model(ART), "cpu", max_batch=1)[0](
            img.reshape(1, 128, 128))
        assert status == 200 and ans["pred"] == int(want.pred[0])
        assert ans["bbox"] == [int(v) for v in want.bbox[0]]
    finally:
        proc.send_signal(2)
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
            proc.stderr.close()
    assert proc.returncode == 0
