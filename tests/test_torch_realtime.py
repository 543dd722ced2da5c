"""The port's realtime app on the CPU, against ``tpu_cnn.apps.realtime``:
the synthetic source and the overlay pixel for pixel, the loop's answer
frame by frame on ``--mode cpu`` (the host oracle and the host twins,
score EMA and tracker included) through ``main`` and through
``detect_frame``, the fused device head (``--device cpu``: the kernels'
plain versions) against the host oracle, the smoke runs and argument
errors of the JAX app's tests, and the MJPEG endpoints.

Tolerances: images, boxes, predictions, detections and tracks exact;
probabilities and presence scores within 1e-4 where one side is torch."""

import http.client
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import realtime as j_realtime  # noqa: E402
from tpu_cnn_torch.apps import realtime  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.infer import make_engine  # noqa: E402
from tpu_cnn_torch.head.tracker import Tracker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
ART4 = os.path.join(REPO, "artifacts", "pretrained-lyr4")
TOL = 1e-4
BASE = ["--source", "synthetic", "--no-serve"]


@pytest.fixture(scope="module")
def model():
    return load_model(ART)


@pytest.mark.parametrize("size", [(640, 480), (320, 240), (200, 300)])
def test_synthetic_source_equals_the_original(size):
    ours, theirs = realtime.SyntheticSource(*size), j_realtime.SyntheticSource(*size)
    for _ in range(4):
        a, b = ours.read(), theirs.read()
        assert a.dtype == b.dtype == np.uint8 and a.shape == (size[1], size[0], 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["single", "detections", "tall"])
def test_draw_overlay_equals_the_original(case):
    rs = np.random.RandomState(3)
    shape = (640, 480, 3) if case == "tall" else (480, 640, 3)
    frame = rs.randint(0, 256, shape).astype(np.uint8)
    probs = np.asarray([0.55, 0.2, 0.1, 0.05, 0.05, 0.05], np.float32)
    names = ["airplane", "cat", "zebra", "bus", "bicycle", "donut"]
    dets = None
    if case == "detections":
        dets = [(0, 0.55, (10, 12, 60, 70)), (3, 0.31, (70, 20, 120, 100), "bus #4")]
    outs = []
    for mod in (realtime, j_realtime):
        f = frame.copy()
        ret = mod.draw_overlay(f, 0, "airplane", 0.55, probs, (20, 30, 90, 100),
                               41.5, 2.25, 0.5, "CUDAEngine:mega-cuda:fused",
                               names, detections=dets)
        assert ret is f
        outs.append(f)
    np.testing.assert_array_equal(*outs)
    assert (outs[0] != frame).any()


def test_overlay_burns_text_into_pixels():
    frame = np.full((480, 640, 3), 90, np.uint8)
    probs = np.asarray([0.7, 0.1, 0.05, 0.05, 0.05, 0.05], np.float32)
    names = ["airplane", "cat", "zebra", "bus", "bicycle", "donut"]
    realtime.draw_overlay(frame, 0, "airplane", 0.7, probs, (30, 40, 90, 100),
                          123.4, 1.23, 0.45, "CUDAEngine:mega-cuda", names)
    assert (frame[4:50, 8:260] != 90).any(axis=2).sum() > 200
    assert (frame[8:96, 640 - 176:640 - 120] != 90).any(axis=2).sum() > 100


def _capture(monkeypatch, mod):
    """Record every frame's answer as the app's loop hands it to
    ``draw_overlay``."""
    frames = []
    real = mod.draw_overlay

    def record(frame, idx, name, conf, probs, bbox, fps, conv_ms, read_ms,
               mode, names, img_size=128, detections=None):
        frames.append((idx, name, conf, np.asarray(probs).copy(),
                       tuple(int(v) for v in bbox),
                       None if detections is None else list(detections)))
        return real(frame, idx, name, conf, probs, bbox, fps, conv_ms, read_ms,
                    mode, names, img_size, detections=detections)

    monkeypatch.setattr(mod, "draw_overlay", record)
    return frames


LOOPS = {
    "host": [],
    "centroid": ["--box", "centroid"],
    "reg": ["--box", "reg"],
    "multi": ["--multi"],
    "multi ema": ["--multi", "--score-ema", "0.3"],
    "instances track ema": ["--multi", "--instances", "2", "--track",
                            "--score-ema", "0.3"],
    "track velocity": ["--multi", "--track", "--track-velocity",
                       "--multi-thresh", "0.1"],
}


def _same_answers(got, want, tol=0.0):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0] and g[1] == w[1] and g[4] == w[4], i
        assert abs(g[2] - w[2]) <= tol, i
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=tol, err_msg=str(i))
        if w[5] is None:
            assert g[5] is None
            continue
        assert [(d[0], tuple(d[2]), d[3:]) for d in g[5]] == \
            [(d[0], tuple(d[2]), d[3:]) for d in w[5]], i
        np.testing.assert_allclose([d[1] for d in g[5]], [d[1] for d in w[5]],
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_mode_cpu_loop_equals_the_jax_app(loop, model, monkeypatch, capsys):
    """``--mode cpu`` over 10 synthetic frames: the port's ``main`` and
    ``detect_frame`` give the JAX app's loop's answer on every frame."""
    argv = ["--mode", "cpu", "--frames", "10", *BASE, *LOOPS[loop]]
    theirs = _capture(monkeypatch, j_realtime)
    j_realtime.main(argv)
    ours = _capture(monkeypatch, realtime)
    stats = realtime.main(argv)
    out = capsys.readouterr().out
    assert "Done. 10 frames." in out and "Engine: CPURefEngine:native-c++" in out
    assert stats["frames"] == 10 and stats["conv_ms"] >= 0
    assert len(theirs) == 10
    _same_answers(ours, theirs)
    # detect_frame on the same frames, with its own EMA and tracker
    flags = LOOPS[loop]
    opt = lambda f, d: flags[flags.index(f) + 1] if f in flags else d  # noqa: E731
    engine = make_engine(model, "cpu")
    ema = realtime.ScoreEma(float(opt("--score-ema", 1.0)))
    tracker = (Tracker(velocity="--track-velocity" in flags)
               if "--track" in flags else None)
    thresh = float(opt("--multi-thresh", 0)) or model.multi_thresh
    src = realtime.SyntheticSource()
    direct = []
    for _ in range(10):
        r = realtime.detect_frame(
            engine, model, realtime.preprocess(src.read()), multi="--multi" in flags,
            instances=int(opt("--instances", 1)), box=opt("--box", "ref"),
            multi_thresh=thresh, score_ema=ema, tracker=tracker)
        direct.append((r.idx, r.name, r.conf, r.probs, tuple(r.bbox), r.detections))
    _same_answers(direct, theirs)


@pytest.mark.parametrize("flags", [[], ["--multi"],
                                   ["--multi", "--instances", "2", "--track"]])
@pytest.mark.parametrize("mode", ["mega", "pallas", "mesh"])
def test_fused_device_head_equals_the_host_oracle(flags, mode, model, monkeypatch,
                                                  capsys):
    """``--device cpu --mode mega|pallas|mesh --fused``: the engine's fused
    detect (the kernels' plain versions) against the host oracle's loop,
    10 frames: the same classes, boxes and detections, probabilities
    within 1e-4."""
    base = ["--frames", "10", *BASE, *flags]
    frames = _capture(monkeypatch, realtime)
    realtime.main(["--mode", "cpu", *base])
    want = frames[:]
    frames.clear()
    realtime.main(["--mode", mode, "--device", "cpu", "--fused", *base])
    got = frames[:]
    out = capsys.readouterr().out
    assert ":fused" in out and "Done. 10 frames." in out
    _same_answers(got, want, TOL)


def test_realtime_synthetic_smoke(capsys):
    stats = realtime.main(["--device", "cpu", "--frames", "25", *BASE])
    out = capsys.readouterr().out
    assert "Done. 25 frames." in out
    assert "FPS" in out  # the status line at frame 20
    assert "Engine: CUDAEngine:reference-cpu" in out  # auto -> mega
    assert stats["frames"] == 25 and stats["fps"] > 0


def test_realtime_fused_head_smoke(capsys):
    realtime.main(["--mode", "xla", "--device", "cpu", "--frames", "3",
                   "--fused", *BASE])
    out = capsys.readouterr().out
    assert ":fused" in out and "Done. 3 frames." in out


def test_realtime_fused_falls_back_on_host_engine(capsys):
    realtime.main(["--mode", "cpu", "--frames", "2", "--fused", *BASE])
    out = capsys.readouterr().out
    assert "no fused detect" in out and "Done. 2 frames." in out


@pytest.mark.parametrize("extra", [[], ["--score-ema", "0.3"],
                                   ["--fused", "--mode", "xla"],
                                   ["--fused", "--mode", "xla", "--score-ema", "0.3"]])
def test_realtime_multi_smoke(extra, capsys):
    realtime.main(["--mode", "cpu", "--device", "cpu", "--frames", "3", *BASE,
                   "--multi", *extra])
    assert "Done. 3 frames." in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--track"], ["--track", "--track-velocity"]])
def test_realtime_track_smoke(extra, capsys):
    realtime.main(["--mode", "cpu", "--frames", "6", *BASE, "--multi", *extra])
    assert "Done. 6 frames." in capsys.readouterr().out


def test_realtime_lyr4_wide(capsys):
    realtime.main(["--variant", "lyr4-wide", "--mode", "cpu", "--frames", "2",
                   *BASE])
    assert "Done. 2 frames." in capsys.readouterr().out


def _bundle_without_bbox(tmp_path):
    d = tmp_path / "nobbox"
    shutil.copytree(ART, d, ignore=shutil.ignore_patterns("test_image_*",
                                                          "bbox_weight.npy"))
    return str(d)


@pytest.mark.parametrize("argv", [
    ["--track"],                                   # --track needs --multi
    ["--multi", "--track-velocity"],               # needs --track
    ["--multi", "--score-ema", "0"],               # out of (0, 1]
    ["--multi", "--score-ema", "1.5"],
    ["--score-ema", "0.5"],                        # needs --multi
    ["--variant", "lyr4-wide", "--head-prefix", "gap_", "--multi"],  # GAP head
    ["--box", "reg", "--artifacts", "NOBBOX"],     # no bbox_weight.npy
    ["--mode", "mesh", "--box", "reg", "--artifacts", "NOBBOX"],  # no bbox head
])
def test_realtime_argument_errors(argv, tmp_path):
    argv = [_bundle_without_bbox(tmp_path) if a == "NOBBOX" else a for a in argv]
    with pytest.raises(SystemExit) as e:
        realtime.main(["--mode", "cpu", "--frames", "2", *BASE, *argv]
                      if "--mode" not in argv else ["--frames", "2", *BASE, *argv])
    assert e.value.code == 2


def test_realtime_video_file_source(tmp_path, capsys):
    """``--source <path>`` loops the clip at EOF."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rs = np.random.RandomState(0)
    for _ in range(5):
        w.write(rs.randint(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()
    realtime.main(["--mode", "cpu", "--source", path, "--frames", "8", "--no-serve"])
    assert "Done. 8 frames." in capsys.readouterr().out


def test_realtime_camera_falls_back_to_synthetic(monkeypatch, capsys):
    """No camera (or no OpenCV): the synthetic source takes its place."""

    class NoCamera:
        def __init__(self, *a, **k):
            raise RuntimeError("camera 0 failed to open")

    monkeypatch.setattr(realtime, "CameraThread", NoCamera)
    realtime.main(["--mode", "cpu", "--frames", "2", "--no-serve"])
    out = capsys.readouterr().out
    assert "falling back to synthetic source" in out and "Done. 2 frames." in out


def test_camera_thread_recovery_ladder(monkeypatch):
    """The stall watchdog's three rungs, in order, each only after the
    previous one failed to bring frames back; a healthy read resets it."""

    class Cap:
        def __init__(self, frames):
            self.frames = frames

        def isOpened(self):
            return True

        def set(self, *a):
            pass

        def read(self):
            return (True, self.frames.pop(0)) if self.frames else (False, None)

        def release(self):
            pass

    free_device, usb_reset = realtime._free_video_device, realtime._usb_reset_video_device
    rungs = []
    cam = realtime.CameraThread.__new__(realtime.CameraThread)
    cam._idx, cam._stall_strikes = 0, 0
    cam._open = lambda: Cap([])
    cam.cap = Cap([])
    monkeypatch.setattr(realtime, "_free_video_device", lambda i: rungs.append("free"))
    monkeypatch.setattr(realtime, "_usb_reset_video_device",
                        lambda i: rungs.append("usb") or False)
    for _ in range(4):
        cam._recover()
    assert rungs == ["free", "usb", "usb"] and cam._stall_strikes == 4
    assert realtime.CameraThread.RECOVERY == ("reopen", "free-device", "usb-reset")
    assert free_device(999) is False  # no /dev/video999
    assert usb_reset(999) is False


def test_realtime_preprocess():
    frame = np.random.RandomState(0).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    small = realtime.preprocess(frame)
    assert small.shape == (128, 128) and small.dtype == np.uint8
    fn, name = realtime.resolve_preprocess()
    assert name == "native-c++"
    np.testing.assert_array_equal(fn(frame, 128), small)


def test_realtime_mjpeg_stream_endpoints():
    """The index page (it names the GPU) and one multipart JPEG frame
    through a real socket (the publisher/subscriber wake-up path)."""
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), realtime.Stream)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("GET", "/")
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200 and b"/stream" in body
        assert b"GPU" in body and b"TPU" not in body
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn.close()

        frame = np.zeros((32, 32, 3), np.uint8)

        def feed():
            for _ in range(50):
                realtime.PUBLISHER.publish(frame)
                time.sleep(0.01)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        assert resp.status == 200
        assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
        chunk = resp.fp.read(2048)
        assert b"cnnframe" in chunk and b"image/jpeg" in chunk
        assert b"\xff\xd8" in chunk  # JPEG SOI marker
        conn.close()
        t.join()
    finally:
        srv.shutdown()
