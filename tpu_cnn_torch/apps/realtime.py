"""Real-time detection app on the port's engines — the ``realtime_detect.py``
surface: the port of ``tpu_cnn.apps.realtime``.

Frame source (webcam via OpenCV when present, a video file, or the
synthetic generator) -> center-crop/gray/resize host preprocess (native
C++ when it builds, numpy otherwise) -> engine (``make_engine``: a
``CUDAEngine`` backend on ``--device``, or the host oracle with
``--mode cpu``, the reference's FPGA/ARM switch,
``software/realtime_detect.py:556``) -> classify + CAM box (the host twins
on the engine's features, or with ``--fused`` the engine's fused detect)
-> overlay -> MJPEG HTTP stream on ``--port``.

Carries over the reference's reliability machinery: a background capture
thread holding only the latest frame, a stall watchdog with a three-rung
recovery ladder (``realtime_detect.py:205-231``), EMA FPS, per-stage ms
overlay, and the periodic console status line. One frame's detection is
``detect_frame``; ``main`` loops it over the source.

Usage:
  python -m tpu_cnn_torch.apps.realtime --device cuda --port 5000
  python -m tpu_cnn_torch.apps.realtime --device cuda --source synthetic --frames 200 --no-serve
  python -m tpu_cnn_torch.apps.realtime --device cuda --fused --multi --instances 2 --track --source synthetic --frames 200 --no-serve
  python -m tpu_cnn_torch.apps.realtime --mode cpu --source synthetic --frames 25 --no-serve
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpu_cnn_torch.apps.common import add_variant_arg, load_model
from tpu_cnn_torch.apps.infer import MODES, make_engine
from tpu_cnn_torch.engine.cuda import (DEFAULT_MULTI_THRESH, detections_above,
                                       instance_detections, presence_scores)
from tpu_cnn_torch.head import cam as cam_host
from tpu_cnn_torch.head import classify as classify_host
from tpu_cnn_torch.head.bbox import bbox_regress_features_np
from tpu_cnn_torch.head.tracker import Tracker
from tpu_cnn_torch.models.cnn import IMG_SIZE
from tpu_cnn_torch.ops.luma import bt601_gray_np
from tpu_cnn_torch.utils.paths import default_artifacts
from tpu_cnn_torch.utils.profiling import EmaFps

COLORS = [
    (255, 80, 80), (80, 220, 80), (255, 255, 80),
    (80, 120, 255), (220, 80, 255), (80, 230, 230),
]


# ── Frame sources ────────────────────────────────────────────────────


class SyntheticSource:
    """Deterministic moving-blob frames for hardware-free operation — the
    analogue of the reference's pynq-less SIMULATION MODE
    (``pynq_inference.py:157-162``)."""

    def __init__(self, width=640, height=480):
        self.w, self.h = width, height
        self._t = 0

    def read(self):
        t = self._t
        self._t += 1
        yy, xx = np.mgrid[0 : self.h, 0 : self.w].astype(np.float32)
        cx = self.w / 2 + (self.w / 3) * np.sin(t / 20.0)
        cy = self.h / 2 + (self.h / 3) * np.cos(t / 31.0)
        blob = 220.0 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 60.0**2)))
        noise = ((xx * 13 + yy * 7 + t) % 23).astype(np.float32)
        frame = np.clip(blob + noise + 20, 0, 255).astype(np.uint8)
        return np.stack([frame] * 3, axis=2)  # HWC "BGR"

    def release(self):
        pass


def _free_video_device(idx: int) -> bool:
    """Recovery rung 2: terminate OTHER processes holding /dev/videoN (the
    usual cause of a capture that reopens but never delivers frames).
    Lists holders with ``fuser`` and signals each PID individually, never
    this process — a blanket ``fuser -k`` would SIGKILL us too whenever our
    own release() failed and we still hold the device."""
    import signal
    import subprocess

    dev = f"/dev/video{idx}"
    if not os.path.exists(dev):
        return False
    try:
        r = subprocess.run(["fuser", dev], capture_output=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return False
    me = os.getpid()
    killed = False
    for tok in r.stdout.split():
        try:
            pid = int(tok)
        except ValueError:
            continue
        if pid == me:
            continue
        try:
            os.kill(pid, signal.SIGKILL)
            killed = True
        except OSError:
            pass
    return killed


def _usb_reset_video_device(idx: int) -> bool:
    """Recovery rung 3: port-level USB reset of the camera. Resolves the
    V4L device's USB bus/device numbers through sysfs and issues
    USBDEVFS_RESET on the /dev/bus/usb node — the software equivalent of
    replugging the cable."""
    import fcntl

    USBDEVFS_RESET = ord("U") << 8 | 20
    sys_dev = f"/sys/class/video4linux/video{idx}/device"
    try:
        usb_dir = os.path.realpath(sys_dev)
        # walk up to the USB device level (the dir that has busnum/devnum)
        while usb_dir and usb_dir != "/":
            if os.path.exists(os.path.join(usb_dir, "busnum")):
                break
            usb_dir = os.path.dirname(usb_dir)
        with open(os.path.join(usb_dir, "busnum")) as f:
            bus = int(f.read())
        with open(os.path.join(usb_dir, "devnum")) as f:
            dev = int(f.read())
        node = f"/dev/bus/usb/{bus:03d}/{dev:03d}"
        fd = os.open(node, os.O_WRONLY)
        try:
            fcntl.ioctl(fd, USBDEVFS_RESET, 0)
        finally:
            os.close(fd)
        return True
    except (OSError, ValueError):
        return False


class VideoFileSource:
    """Frame source over a video file (beyond-reference: the reference's
    realtime loop only reads webcams). Same ``read``/``release`` protocol
    as the camera; loops at EOF so ``--frames 0`` keeps streaming."""

    def __init__(self, path: str, loop: bool = True):
        import cv2

        self._cv2 = cv2
        self._path = path
        self._loop = loop
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open video file {path!r}")

    def read(self):
        ret, frame = self.cap.read()
        if not ret and self._loop:
            self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
            ret, frame = self.cap.read()
        return frame if ret else None

    def release(self):
        try:
            self.cap.release()
        except Exception:
            pass


class CameraThread:
    """Background capture holding the latest frame, with a stall watchdog
    driving an escalating recovery ladder (reference
    ``realtime_detect.py:148-240``): (1) release + reopen; (2) free the
    device from other holders; (3) USB port reset; each rung only after the
    previous one failed to restore frames."""

    RECOVERY = ("reopen", "free-device", "usb-reset")

    def __init__(self, cam_idx=0, width=640, height=480, stall_timeout=2.0):
        import cv2

        self._cv2 = cv2
        self._idx, self._w, self._h = cam_idx, width, height
        self._stall = stall_timeout
        self.frame = None
        self.lock = threading.Lock()
        self.running = True
        self._last_ok = time.time()
        self._stall_strikes = 0  # consecutive stalls -> ladder rung
        self.cap = self._open()
        if self.cap is None:
            raise RuntimeError(f"camera {cam_idx} failed to open")
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _open(self):
        cv2 = self._cv2
        cap = cv2.VideoCapture(self._idx)
        if not cap.isOpened():
            cap.release()
            return None
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, self._w)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self._h)
        return cap

    def _recover(self):
        rung = self.RECOVERY[min(self._stall_strikes, len(self.RECOVERY) - 1)]
        print(f"camera stalled — recovery rung {self._stall_strikes + 1}: "
              f"{rung}", flush=True)
        try:
            self.cap.release()
        except Exception:
            pass
        if rung == "free-device":
            _free_video_device(self._idx)
        elif rung == "usb-reset":
            if _usb_reset_video_device(self._idx):
                time.sleep(1.0)  # device re-enumerates
        cap = self._open()
        if cap is not None:
            self.cap = cap
        self._stall_strikes += 1
        self._last_ok = time.time()

    def _reader(self):
        while self.running:
            try:
                ret, f = self.cap.read()
                if ret and f is not None:
                    with self.lock:
                        self.frame = f
                    self._last_ok = time.time()
                    self._stall_strikes = 0  # healthy again
                    continue
                if time.time() - self._last_ok > self._stall:
                    self._recover()
                else:
                    time.sleep(0.01)
            except Exception as e:
                print(f"camera error: {e}", flush=True)
                time.sleep(0.5)

    def read(self):
        with self.lock:
            return None if self.frame is None else self.frame.copy()

    def release(self):
        self.running = False
        try:
            self.cap.release()
        except Exception:
            pass


# ── Preprocess + overlay (numpy, no cv2 dependency) ─────────────────


def resolve_preprocess():
    """Pick the fastest available host preprocess: the native C++ batched
    one (OpenMP, bit-identical — tests/test_torch_preprocess.py) when it
    builds, this module's numpy twin otherwise."""
    try:
        from tpu_cnn_torch.native.preprocess import preprocess_frames_native

        probe = np.zeros((8, 8, 3), np.uint8)
        preprocess_frames_native(probe, 4)
        return preprocess_frames_native, "native-c++"
    except Exception:
        return preprocess, "numpy"


def preprocess(frame: np.ndarray, out_size: int = IMG_SIZE) -> np.ndarray:
    """Center-crop to square, BT.601 grayscale (cv2.COLOR_BGR2GRAY-exact),
    area-resize to the model input size (``realtime_detect.py:584-591``)."""
    h, w = frame.shape[:2]
    if w > h:
        x0 = (w - h) // 2
        crop = frame[:, x0 : x0 + h]
    elif h > w:
        y0 = (h - w) // 2
        crop = frame[y0 : y0 + w]
    else:
        crop = frame
    if crop.ndim == 3:  # BGR, OpenCV's fixed-point BT.601 luma
        gray = bt601_gray_np(crop).astype(np.uint32)
    else:
        gray = crop
    s = gray.shape[0]
    f = s // out_size
    if f >= 1 and s % out_size == 0:
        small = gray.reshape(out_size, f, out_size, f).mean(axis=(1, 3))
    else:
        idx = (np.arange(out_size) * s // out_size).clip(0, s - 1)
        small = gray[np.ix_(idx, idx)]
    return small.astype(np.uint8)


def _burn_texts(frame: np.ndarray, texts) -> None:
    """Burn text into the frame with PIL's bitmap font — one PIL round-trip
    for all strings, no cv2 dependency. ``texts``: [(x, y, str, color)].
    Channel order is preserved (colors are given in the frame's own order)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame)
    d = ImageDraw.Draw(img)
    for x, y, s, color in texts:
        d.text((x + 1, y + 1), s, fill=(0, 0, 0))  # drop shadow
        d.text((x, y), s, fill=tuple(int(v) for v in color))
    frame[:] = np.asarray(img)


def _frame_box(frame, bbox, color, xo, yo, s, th=2):
    """Draw one image-space bbox (model coords) as a rectangle on the
    camera frame; returns the frame-space top-left for label placement."""
    x1, y1 = int(xo + bbox[0] * s), int(yo + bbox[1] * s)
    x2, y2 = int(xo + bbox[2] * s), int(yo + bbox[3] * s)
    frame[max(y1, 0) : y1 + th, max(x1, 0) : x2] = color
    frame[y2 - th : y2, max(x1, 0) : x2] = color
    frame[max(y1, 0) : y2, max(x1, 0) : x1 + th] = color
    frame[max(y1, 0) : y2, x2 - th : x2] = color
    return x1, y1


def draw_overlay(frame, idx, name, conf, probs, bbox, fps, conv_ms, read_ms,
                 mode, names, img_size: int = IMG_SIZE, detections=None):
    """In-place overlay: bbox rectangle + header text + probability bars.

    The text surface matches the reference's viewer: class name, confidence,
    FPS, and per-stage ms are rendered into the pixels
    (``software/realtime_detect.py:490-514``), not just the console line.
    ``detections`` (multi-object mode): [(class_idx, prob, bbox), ...] — one
    labelled rectangle per detection replaces the single argmax box. A
    4th element, if present, overrides the rendered label (the tracker
    passes "name #id" here)."""
    h, w = frame.shape[:2]
    # undo the center-crop: offsets mirror preprocess() for both landscape
    # (horizontal crop) and portrait (vertical crop) frames
    xo = (w - h) // 2 if w > h else 0
    yo = (h - w) // 2 if h > w else 0
    s = min(w, h) / float(img_size)
    box_texts = []
    if detections is None:
        x1, y1 = _frame_box(frame, bbox, COLORS[idx % len(COLORS)], xo, yo, s)
        box_texts.append((x1, y1, f"{name} {conf * 100:.0f}%",
                          COLORS[idx % len(COLORS)]))
    else:
        for det in detections:
            k, p, bb = det[:3]
            ck = COLORS[k % len(COLORS)]
            bx1, by1 = _frame_box(frame, bb, ck, xo, yo, s)
            label = det[3] if len(det) > 3 else names[k]
            box_texts.append((bx1, by1,
                              f"{label} {p * 100:.0f}%", ck))
    c = COLORS[idx % len(COLORS)]
    # probability bars, top-right
    bw, bh = 110, 10
    for i, p in enumerate(np.asarray(probs)):
        y = 10 + i * (bh + 4)
        frame[y : y + bh, w - bw - 10 : w - 10] = (40, 40, 40)
        fill = int(p * bw)
        if fill > 0:
            frame[y : y + bh, w - bw - 10 : w - bw - 10 + fill] = COLORS[i % len(COLORS)]
    # burned-in text: label+conf at the box, FPS / stage-ms / engine header,
    # class names beside their bars (realtime_detect.py:490-514 parity)
    texts = [
        (10, 6, f"{name} {conf * 100:.0f}%", c),
        (10, 22, f"{fps:5.1f} FPS  conv {conv_ms:.2f} ms  "
                 f"read {read_ms:.2f} ms", (255, 255, 255)),
        (10, 38, str(mode), (180, 180, 180)),
    ]
    for bx, by, label, color in box_texts:
        texts.append((min(max(bx, 0) + 4, w - 60), min(max(by, 0) + 4, h - 14),
                      label, color))
    for i, nm in enumerate(names):
        y = 10 + i * (bh + 4)
        texts.append((w - bw - 66, y, f"{str(nm)[:9]}",
                      COLORS[i % len(COLORS)]))
    _burn_texts(frame, texts)
    return frame


# ── MJPEG server ─────────────────────────────────────────────────────
#
# Publisher/subscriber design: the inference loop publishes each annotated
# frame ONCE (already JPEG-encoded, off the request threads); stream clients
# block on a condition variable and are woken per frame — no polling sleeps,
# no duplicate encodes when several viewers are attached, and a slow client
# simply skips to the newest frame (sequence-numbered) instead of queueing.


class FramePublisher:
    def __init__(self):
        self._cond = threading.Condition()
        self._jpeg: bytes | None = None
        self._seq = 0
        self._nsubs = 0

    def subscribe(self):
        with self._cond:
            self._nsubs += 1

    def unsubscribe(self):
        with self._cond:
            self._nsubs -= 1

    def publish(self, frame: np.ndarray) -> None:
        with self._cond:
            if self._nsubs == 0:
                return  # nobody watching: skip the JPEG encode entirely
        data = encode_jpeg(frame)
        with self._cond:
            self._jpeg = data
            self._seq += 1
            self._cond.notify_all()

    def next_frame(self, last_seq: int, timeout: float = 1.0):
        """Block until a frame newer than ``last_seq`` exists (or timeout).
        Returns (jpeg | None, seq)."""
        with self._cond:
            self._cond.wait_for(lambda: self._seq > last_seq, timeout=timeout)
            return self._jpeg, self._seq


PUBLISHER = FramePublisher()

_INDEX_HTML = b"""\
<!doctype html>
<meta charset="utf-8">
<title>tpu_cnn_torch :: live</title>
<style>
  html { color-scheme: dark; }
  body { margin: 0; min-height: 100vh; display: grid; place-items: center;
         background: #16181d; color: #c9d1d9; font: 15px/1.4 monospace; }
  main { text-align: center; }
  main img { display: block; margin: 1rem auto; max-width: 92vw;
             outline: 1px solid #3a3f4b; }
  .tag { color: #7ee787; letter-spacing: .2em; }
</style>
<main>
  <p class="tag">[ tpu_cnn_torch &middot; realtime detector ]</p>
  <img src="/stream" alt="live detection feed">
  <p>int8 CNN + CAM head on the GPU &mdash; MJPEG relay</p>
</main>
"""

_BOUNDARY = b"cnnframe"


class Stream(BaseHTTPRequestHandler):
    def do_GET(self):
        if self.path == "/":
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(_INDEX_HTML)))
            self.end_headers()
            self.wfile.write(_INDEX_HTML)
            return
        if self.path != "/stream":
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header(
            "Content-Type",
            "multipart/x-mixed-replace; boundary=" + _BOUNDARY.decode(),
        )
        self.end_headers()
        seq = 0
        PUBLISHER.subscribe()
        try:
            while True:
                jpeg, seq = PUBLISHER.next_frame(seq)
                if jpeg is None:
                    continue
                part = b"".join([
                    b"--", _BOUNDARY, b"\r\n",
                    b"Content-Type: image/jpeg\r\n",
                    b"Content-Length: ", str(len(jpeg)).encode(), b"\r\n\r\n",
                    jpeg, b"\r\n",
                ])
                self.wfile.write(part)
        except (BrokenPipeError, ConnectionResetError, OSError):
            return  # client went away
        finally:
            PUBLISHER.unsubscribe()

    def log_message(self, *_):
        pass


def encode_jpeg(frame: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame[..., ::-1] if frame.ndim == 3 else frame).save(
        buf, format="JPEG", quality=70
    )
    return buf.getvalue()


def encode_jpeg(frame: np.ndarray) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame[..., ::-1] if frame.ndim == 3 else frame).save(
        buf, format="JPEG", quality=70
    )
    return buf.getvalue()


# ── One frame ────────────────────────────────────────────────────────


Frame = collections.namedtuple(
    "Frame", "idx name conf probs bbox detections conv_ms read_ms")
Frame.__doc__ = """One frame's answer: the argmax class (index, name,
confidence), the class probabilities, its box, the multi-object
detections ([(class_idx, prob, bbox[, label]), ...], None without
--multi), and the engine's compute and readout ms."""


class ScoreEma:
    """``--score-ema``: presence scores smoothed across frames,
    ``sm = a * new + (1 - a) * sm``; ``alpha`` 1.0 passes them through."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha
        self.state = None  # per-class (K,)

    def __call__(self, sc):
        if self.alpha >= 1.0:
            return sc
        sc = np.asarray(sc, np.float32)
        self.state = (sc if self.state is None
                      else self.alpha * sc + (1 - self.alpha) * self.state)
        return self.state


def detect_frame(engine, model, small: np.ndarray, *, fused: bool = False,
                 multi: bool = False, instances: int = 1, box: str = "ref",
                 multi_thresh=DEFAULT_MULTI_THRESH,
                 score_ema: ScoreEma | None = None,
                 tracker: Tracker | None = None) -> Frame:
    """One preprocessed (S, S) u8 frame through ``engine``: the loop body
    of ``main`` (the reference's per-frame detect).

    ``fused``: the engine's fused detect (``detect_batch``, or with
    ``multi`` ``detect_multi_batch``): only the head's outputs cross back.
    Otherwise the reference protocol: ``engine.run`` features, then the
    host twins (classifier, the ``box`` CAM box or the regression box,
    and with ``multi`` the per-class boxes, presence scores and watershed
    instances). ``score_ema`` smooths the multi presence scores across
    frames; ``tracker`` turns the detections into tracks labelled
    "name #id"."""
    score_ema = score_ema if score_ema is not None else ScoreEma()
    names, img_size = model.class_names, model.config.img_size
    detections = None
    if fused and multi:
        t0 = time.perf_counter()
        res = engine.detect_multi_batch(small[None], instances=instances)
        conv_ms = (time.perf_counter() - t0) * 1e3
        read_ms = 0.0
        idx = int(res.pred[0])
        name = names[idx]
        conf = float(res.conf[0])
        probs = res.probs[0]
        if score_ema.alpha < 1.0:
            sc = score_ema(presence_scores(res)[0])
            if getattr(res, "inst_boxes", None) is not None:
                detections = instance_detections(
                    sc, res.boxes[0], res.inst_boxes[0],
                    res.inst_counts[0], multi_thresh)
            else:
                detections = detections_above(sc, res.boxes[0], multi_thresh)
        else:
            detections = res.detections(multi_thresh)[0]
        bbox = tuple(int(v) for v in res.boxes[0, idx])
    elif fused:
        # the engine's fused detect honours the box mode it was built
        # with; only the few result bytes cross back
        t0 = time.perf_counter()
        res = engine.detect_batch(small[None])
        conv_ms = (time.perf_counter() - t0) * 1e3
        read_ms = 0.0
        idx = int(res.pred[0])
        name = names[idx]
        conf = float(res.conf[0])
        probs = res.probs[0]
        bbox = tuple(int(v) for v in res.bbox[0])
    else:
        feat, conv_ms, read_ms = engine.run(small)
        idx, name, conf, probs = classify_host.classify_np(
            feat, model.fc_weight, model.fc_bias, names
        )
        if box == "reg":
            bbox = bbox_regress_features_np(feat, model.bbox_weight, img_size)
        elif model.head_mode == "bins":
            box_fn = (cam_host.cam_bbox_centroid if box == "centroid"
                      else cam_host.cam_bbox_fast)
            bbox = box_fn(feat, idx, model.fc_weight, img_size)
        else:
            bbox = (0, 0, img_size - 1, img_size - 1)
        if multi:
            sc = probs
            if model.multi_head is not None:
                sc = classify_host.multi_scores_np(
                    classify_host.pool_for_head(feat, model.fc_weight),
                    *model.multi_head)
            sc = score_ema(sc)
            boxes_all = cam_host.cam_bbox_multi(
                feat, model.fc_weight, img_size=img_size,
                box_mode="centroid" if box == "centroid" else "ref")
            if instances > 1:
                ib, ic = cam_host.cam_instances(
                    feat, model.fc_weight, img_size=img_size,
                    max_instances=instances)
                detections = instance_detections(sc, boxes_all, ib, ic,
                                                 multi_thresh)
            else:
                detections = detections_above(sc, boxes_all, multi_thresh)
    if tracker is not None and detections is not None:
        detections = [(t.cls, t.prob, t.ibox(), f"{names[t.cls]} #{t.id}")
                      for t in tracker.update(detections)]
    return Frame(idx, name, conf, probs, bbox, detections, conv_ms, read_ms)


# ── Main loop ────────────────────────────────────────────────────────


def main(argv=None):
    """Run the app; returns {"frames", "fps" (the final EMA FPS),
    "conv_ms" (the median of the last 4096 frames' engine ms)}."""
    ap = argparse.ArgumentParser(description="Real-time detection on the "
                                             "CUDA port")
    ap.add_argument("--mode", choices=MODES, default="auto",
                    help="engine (see tpu_cnn_torch.apps.infer): auto (mega "
                         "where it fits, else hybrid), mega, pallas, hybrid, "
                         "xla, or cpu (the host oracle; --device ignored)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
    ap.add_argument("--artifacts", default=None)
    ap.add_argument("--head-prefix", default="")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="MJPEG bind address. The stream has no auth — "
                         "expose beyond localhost deliberately (0.0.0.0).")
    ap.add_argument("--source", default="camera",
                    help="'camera', 'synthetic', or a video-file path "
                         "(loops at EOF)")
    ap.add_argument("--camera", type=int, default=0)
    ap.add_argument("--res", type=str, default="640x480")
    ap.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = forever)")
    ap.add_argument("--no-serve", action="store_true", help="skip the MJPEG server")
    ap.add_argument("--box", default="ref", choices=["ref", "centroid", "reg"],
                    help="box head: reference CAM, tuned centroid, or learned "
                         "regression (needs bbox_weight.npy)")
    ap.add_argument("--multi", action="store_true",
                    help="multi-object mode: one labelled box per class "
                         "above --multi-thresh (bins head only)")
    ap.add_argument("--multi-thresh", type=float, default=None,
                    help="uniform probability floor for --multi detections "
                         "(default: the bundle's calibrated "
                         "multi_thresh.json if present, else 0.15)")
    ap.add_argument("--instances", type=int, default=1,
                    help="with --multi: up to N watershed component boxes "
                         "per class, so two objects of the SAME class get "
                         "separate boxes (default 1)")
    ap.add_argument("--track", action="store_true",
                    help="with --multi: frame-to-frame object tracking — "
                         "stable '#id' labels, smoothed boxes, flicker "
                         "suppression (head.tracker, SORT-style greedy "
                         "IoU association)")
    ap.add_argument("--track-velocity", action="store_true",
                    help="with --track: constant-velocity association gate "
                         "(opt in for small fast objects)")
    ap.add_argument("--score-ema", type=float, default=1.0,
                    help="with --multi: smooth presence scores across "
                         "frames (sm = a*new + (1-a)*sm) before the "
                         "floors; 1.0 = off")
    ap.add_argument("--fused", action="store_true",
                    help="run the whole head in the engine's fused detect "
                         "(only pred/conf/probs/box cross back, not the "
                         "feature map). Default is the reference protocol: "
                         "engine.run() features + host classify/CAM twins.")
    add_variant_arg(ap)
    args = ap.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    cam_w, cam_h = (int(v) for v in args.res.split("x"))

    print("=" * 60)
    print("  REAL-TIME OBJECT DETECTION — CNN (PyTorch/CUDA port)")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant, args.head_prefix)
    if args.box == "reg" and model.bbox_weight is None:
        ap.error("--box reg needs bbox_weight.npy in the bundle")
    if args.multi and model.head_mode != "bins":
        ap.error("--multi needs the spatial-bin head (per-class CAM)")
    if args.track and not args.multi:
        ap.error("--track rides the multi-object detections; add --multi")
    if args.track_velocity and not args.track:
        ap.error("--track-velocity is a --track option")
    if not 0.0 < args.score_ema <= 1.0:
        ap.error("--score-ema must be in (0, 1]")
    if args.score_ema < 1.0 and not args.multi:
        ap.error("--score-ema smooths the multi-object presence scores; "
                 "add --multi")
    tracker = Tracker(velocity=args.track_velocity) if args.track else None
    multi_thresh = (args.multi_thresh if args.multi_thresh is not None
                    else (model.multi_thresh
                          if model.multi_thresh is not None
                          else DEFAULT_MULTI_THRESH))
    img_size = model.config.img_size
    names = model.class_names
    print(f"Classes: {names}")

    engine = make_engine(model, args.mode, args.device, box_mode=args.box)
    use_fused = args.fused and hasattr(engine, "detect_batch")
    if args.fused and not use_fused:
        print(f"note: {type(engine).__name__} has no fused detect; "
              "using the host-head protocol")
    mode_lbl = (f"{type(engine).__name__}:{getattr(engine, 'backend', '?')}"
                + (":fused" if use_fused else ""))
    print(f"Engine: {mode_lbl}")
    preprocess_fn, pp_name = resolve_preprocess()
    print(f"Host preprocess: {pp_name}")
    if hasattr(engine, "warmup"):
        engine.warmup(multi=args.multi and use_fused,
                      instances=args.instances)

    if args.source == "synthetic":
        cam = SyntheticSource(cam_w, cam_h)
    elif args.source != "camera":
        cam = VideoFileSource(args.source)
    else:
        try:
            cam = CameraThread(args.camera, cam_w, cam_h)
        except Exception as e:
            print(f"camera unavailable ({e}); falling back to synthetic source")
            cam = SyntheticSource(cam_w, cam_h)

    srv = None
    if not args.no_serve:
        import socket

        # Threading server: each /stream viewer holds its connection open
        # for the session, so a per-request thread is required for the
        # publisher's multi-subscriber design (and for / to answer while a
        # stream is live). daemon_threads=True is the class default.
        srv = ThreadingHTTPServer((args.host, args.port), Stream)
        srv.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        print(f"Stream: http://{args.host}:{srv.server_address[1]}")
    print("Ctrl+C to stop.\n")

    ema = EmaFps()
    score_ema = ScoreEma(args.score_ema)
    conv_hist: collections.deque[float] = collections.deque(maxlen=4096)
    n = 0
    try:
        while True:
            frame = cam.read()
            if frame is None:
                time.sleep(0.005)
                continue
            small = preprocess_fn(frame, img_size)
            r = detect_frame(engine, model, small, fused=use_fused,
                             multi=args.multi, instances=args.instances,
                             box=args.box, multi_thresh=multi_thresh,
                             score_ema=score_ema, tracker=tracker)
            conv_hist.append(r.conv_ms)
            fps = ema.tick()
            out = frame if frame.ndim == 3 else np.stack([frame] * 3, axis=2)
            draw_overlay(out, r.idx, r.name, r.conf, r.probs, r.bbox, fps,
                         r.conv_ms, r.read_ms, mode_lbl, names, img_size,
                         detections=r.detections)
            PUBLISHER.publish(out)

            n += 1
            if n % 20 == 0:
                top = np.argsort(r.probs)[::-1][:3]
                stat = " | ".join(f"{names[i]}:{r.probs[i] * 100:.0f}%" for i in top)
                print(f"\r  Frame {n} | {fps:.1f} FPS | conv:{r.conv_ms:.2f}ms "
                      f"read:{r.read_ms:.2f}ms | {stat}   ", end="", flush=True)
            if args.frames and n >= args.frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        print(f"\n\nDone. {n} frames.")
        cam.release()
        if srv:
            srv.shutdown()
            srv.server_close()
    return {"frames": n, "fps": ema.value,
            "conv_ms": statistics.median(conv_hist) if conv_hist else None}


if __name__ == "__main__":
    main()
