"""Detection service on the port's engine — dynamic-batching HTTP server.

The port of ``tpu_cnn.apps.serve``, with its engine from the port's engine
swap (``apps.infer.make_engine``): ``CUDAEngine`` on a device backend, or
with ``--mode cpu`` the host oracle behind ``_HostDetectAdapter`` (the host
head twins on its features). The serving layer (``DynamicBatcher``,
``ServiceHTTPServer``, ``make_handler``, ``decode_image``) is the port's
copy of the JAX service's: the batcher coalesces single requests into
device batches and drives the engine's async detect pipeline; the
multi-object answers come from the engine module's detection filters.
``decode_image`` runs an encoded image through the camera pipeline's host
preprocess (``apps.realtime.preprocess``).

Endpoints:
  POST /detect   body: S x S raw uint8 bytes at the variant's image size
                 (16,384 for lyr3-std's 128x128, 65,536 for lyr4-wide's
                 256x256) or any PIL-decodable image (center-crop, BT.601
                 luma, area resize); returns JSON {pred, name, conf, probs,
                 bbox}, and with --multi also "detections": [{pred, name,
                 conf, bbox}, ...] (per-request floor: POST /detect?thresh=0.3)
  GET  /healthz  liveness + engine backend
  GET  /stats    request/batch counters and latency percentiles

Usage:
  python -m tpu_cnn_torch.apps.serve --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --variant lyr4-wide --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --mode hybrid --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --multi --instances 2 --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --mode cpu --port 8000
  python -m tpu_cnn_torch.apps.serve --deployable model.tcnnx --device cuda

``--mode`` picks the engine, as in ``apps.infer`` (``MODES``);
``--deployable`` serves an exported ``.tcnnx`` (``apps.export_model``)
through ``_DeployableAdapter`` instead.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from tpu_cnn_torch.apps.common import load_model
from tpu_cnn_torch.apps.infer import MODES, make_engine
from tpu_cnn_torch.deploy import DeployedDetector
from tpu_cnn_torch.engine.cuda import (DEFAULT_MULTI_THRESH, DetectResult,
                                       MultiDetectResult, detections_above,
                                       instance_detections, presence_scores)
from tpu_cnn_torch.head import cam as cam_host
from tpu_cnn_torch.head.bbox import bbox_regress_np
from tpu_cnn_torch.head.classify import bin_pool_np, classify_np
from tpu_cnn_torch.models.cnn import IMG_SIZE
from tpu_cnn_torch.utils.paths import default_artifacts

class Overloaded(Exception):
    """The batcher's admission queue is full. Carries a Retry-After hint
    (seconds) derived from the backlog the client would otherwise join.
    The reference signals the same condition at the protocol level —
    ``tready = !busy``
    (its AXI slave's ``tready``): backpressure is an explicit signal, never a dropped transaction."""

    def __init__(self, retry_after_s: int):
        super().__init__(f"server overloaded, retry after {retry_after_s}s")
        self.retry_after_s = retry_after_s


class ServiceHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a deep accept backlog. The default
    ``request_queue_size=5`` RESETS the 6th simultaneous connect while the
    GIL-bound accept loop is busy — measured as 354 silent client errors
    at 64 concurrent clients (docs/OPERATIONS.md). Overload must surface
    as a 503, which requires accepting the connection first."""

    request_queue_size = 128
    daemon_threads = True


class _Pending:
    __slots__ = ("image", "event", "result", "thresh", "t0")

    def __init__(self, image: np.ndarray, thresh: float | None = None):
        self.image = image
        self.event = threading.Event()
        self.result: dict | None = None
        self.thresh = thresh  # per-request multi threshold (multi mode)
        self.t0 = time.perf_counter()  # submit time -> /stats percentiles


class DynamicBatcher:
    """Coalesces single requests into device batches.

    A worker thread drains the queue; a batch launches when ``max_batch``
    requests are waiting or the oldest has waited ``max_wait_ms``.
    """

    def __init__(self, engine, class_names, max_batch: int = 256,
                 max_wait_ms: float = 5.0, img_size: int = IMG_SIZE,
                 multi: bool = False, multi_thresh: float = 0.15,
                 instances: int = 1, max_queue: int | None = None):
        if multi and not hasattr(engine, "detect_multi_batch"):
            raise ValueError(
                f"--multi is not supported by this engine "
                f"({type(engine).__name__}) — it has no detect_multi_batch")
        if instances > 1:
            import inspect

            sig = inspect.signature(engine.detect_multi_batch)
            if "instances" not in sig.parameters:
                raise ValueError(
                    f"--instances is not supported by this engine "
                    f"({type(engine).__name__})")
        self.instances = instances
        self.engine = engine
        self.class_names = class_names
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.img_size = img_size
        self.multi = multi
        self.multi_thresh = multi_thresh
        # Bounded admission queue: beyond ~4 full device batches of backlog
        # the client is better served by an immediate 503 + Retry-After than
        # by joining a queue whose wait already exceeds any sane deadline.
        self.max_queue = max_queue if max_queue is not None else 4 * max_batch
        self.q: queue.Queue[_Pending] = queue.Queue(maxsize=self.max_queue)
        self.stats = {"requests": 0, "batches": 0, "batch_ms_ema": 0.0,
                      "mean_batch_size": 0.0, "errors": 0, "shed": 0}
        # per-request submit->result latencies (ms), last 4096 — /stats
        # reports p50/p99 from this window (serving SLO measurement,
        # docs/OPERATIONS.md load harness)
        from collections import deque

        self._lat: deque[float] = deque(maxlen=4096)
        self._lock = threading.Lock()
        self.running = True
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray, timeout_s: float = 30.0,
               thresh: float | None = None) -> dict:
        p = _Pending(image, thresh)
        try:
            self.q.put_nowait(p)
        except queue.Full:
            with self._lock:
                self.stats["shed"] += 1
                ema = self.stats["batch_ms_ema"]
            # hint: the time to drain the backlog ahead of this client
            # (queue depth / batch size, at the EMA batch latency)
            backlog_batches = self.max_queue / max(1, self.max_batch)
            retry = max(1, int(round(backlog_batches * max(ema, 50.0) / 1e3)))
            raise Overloaded(min(retry, 30))
        if not p.event.wait(timeout_s):
            raise TimeoutError("inference timed out")
        assert p.result is not None
        return p.result

    def _collect(self) -> list[_Pending]:
        try:
            first = self.q.get(timeout=0.25)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _fan_out(self, batch, res):
        for i, p in enumerate(batch):
            idx = int(res.pred[i])
            p.result = {
                "pred": idx,
                "name": self.class_names[idx],
                "conf": float(res.conf[i]),
                "probs": [float(v) for v in res.probs[i]],
                "bbox": [int(v) for v in (res.boxes[i, idx] if self.multi
                                          else res.bbox[i])],
            }
            if self.multi:
                thr = p.thresh if p.thresh is not None else self.multi_thresh
                sc = presence_scores(res)
                if getattr(res, "inst_boxes", None) is not None:
                    dets = instance_detections(
                        sc[i], res.boxes[i], res.inst_boxes[i],
                        res.inst_counts[i], thr)
                else:
                    dets = detections_above(sc[i], res.boxes[i], thr)
                p.result["detections"] = [
                    {"pred": k, "name": self.class_names[k], "conf": prob,
                     "bbox": list(bbox)}
                    for k, prob, bbox in dets
                ]
            p.event.set()
        now = time.perf_counter()
        lats = [(now - p.t0) * 1e3 for p in batch]
        with self._lock:
            self._lat.extend(lats)

    def _fail(self, batch, e):
        for p in batch:
            p.result = {"error": f"{type(e).__name__}: {e}"}
            p.event.set()
        with self._lock:
            self.stats["errors"] += len(batch)

    def _record(self, n, t0):
        dt = (time.perf_counter() - t0) * 1e3
        with self._lock:
            s = self.stats
            s["requests"] += n
            s["batches"] += 1
            s["batch_ms_ema"] = 0.8 * s["batch_ms_ema"] + 0.2 * dt
            s["mean_batch_size"] = s["requests"] / s["batches"]

    def _worker(self):
        """Dispatch loop. With an async-capable engine, batches are
        dispatched without blocking and resolved by the collector thread —
        several batches overlap on device (the bench.py pipeline pattern).
        Host engines fall back to synchronous dispatch."""
        dispatch_async = getattr(
            self.engine,
            "detect_multi_batch_async" if self.multi else "detect_batch_async",
            None)
        if self.multi and self.instances > 1 and dispatch_async is not None:
            import functools

            dispatch_async = functools.partial(dispatch_async,
                                               instances=self.instances)
        # resolved lazily inside the per-batch try so an engine without the
        # method fails each request loudly instead of killing the worker
        self._dispatch_sync = getattr(
            self.engine,
            "detect_multi_batch" if self.multi else "detect_batch",
            None)
        if (self.multi and self.instances > 1
                and self._dispatch_sync is not None):
            import functools

            self._dispatch_sync = functools.partial(
                self._dispatch_sync, instances=self.instances)
        self._resolve = getattr(
            self.engine,
            "detect_multi_resolve" if self.multi else "detect_resolve",
            None)
        is_async = dispatch_async is not None
        if is_async:
            self._inflight: queue.Queue = queue.Queue(maxsize=4)
            self._collector = threading.Thread(target=self._collect_loop,
                                               daemon=True)
            self._collector.start()
        while self.running:
            batch = self._collect()
            if not batch:
                continue
            t0 = time.perf_counter()
            # Pad every device batch to the fixed max_batch shape: one
            # compiled executable instead of one per power-of-two bucket
            # (bucket churn stalls serving for minutes per new size).
            images = np.zeros((self.max_batch, *batch[0].image.shape), np.uint8)
            for i, p in enumerate(batch):
                images[i] = p.image
            try:
                if is_async:
                    handle = dispatch_async(images)
                    self._inflight.put((batch, handle, t0))
                else:
                    if self._dispatch_sync is None:
                        raise AttributeError(
                            f"{type(self.engine).__name__} has no "
                            "detect_batch")
                    res = self._dispatch_sync(images)
                    self._fan_out(batch, res)
                    self._record(len(batch), t0)
            except Exception as e:  # fan the failure out, keep serving
                self._fail(batch, e)

    def _collect_loop(self):
        while self.running:
            try:
                batch, handle, t0 = self._inflight.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                res = self._resolve(handle)
                self._fan_out(batch, res)
                self._record(len(batch), t0)
            except Exception as e:
                self._fail(batch, e)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            lats = sorted(self._lat)
        out["queue_depth"] = self.q.qsize()
        inflight = getattr(self, "_inflight", None)
        out["batches_in_flight"] = inflight.qsize() if inflight else 0
        if lats:
            out["p50_ms"] = round(lats[len(lats) // 2], 3)
            out["p99_ms"] = round(lats[min(len(lats) - 1,
                                           int(len(lats) * 0.99))], 3)
        return out

    def stop(self, timeout_s: float = 5.0):
        """Stop the dispatch threads and wait for them (each wakes within
        0.25 s): a daemon thread left running into interpreter shutdown
        can abort the process on its way out."""
        self.running = False
        if self._thread is not threading.current_thread():
            self._thread.join(timeout_s)
        collector = getattr(self, "_collector", None)
        if collector is not None:
            collector.join(timeout_s)


def decode_image(body: bytes, img_size: int = IMG_SIZE) -> np.ndarray:
    if len(body) == img_size * img_size:
        return np.frombuffer(body, np.uint8).reshape(img_size, img_size).copy()
    from PIL import Image

    from tpu_cnn_torch.apps.realtime import preprocess as host_preprocess

    # Decode, then run the SAME preprocess as every other ingest path
    # (center-crop, cv2-exact BT.601 luma, area/nearest resize) — PIL's
    # convert("L")+resize uses different luma rounding and interpolation,
    # which would make the service classify differently from the camera
    # pipeline on identical pixels.
    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), np.uint8)
    return host_preprocess(img[..., ::-1], img_size)  # twin expects BGR


# Reject request bodies above this size before reading them: the server
# otherwise buffers attacker-controlled Content-Length bytes in RAM.
MAX_BODY_BYTES = 8 * 1024 * 1024


def make_handler(batcher: DynamicBatcher, backend: str):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj: dict, extra_headers=()):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "backend": backend})
            elif self.path == "/stats":
                self._json(200, batcher.snapshot())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            if url.path != "/detect":
                self._json(404, {"error": "not found"})
                return
            qs = parse_qs(url.query)
            thresh = None
            if "thresh" in qs:
                if not batcher.multi:
                    self._json(400, {"error": "thresh= needs a --multi "
                                              "server"})
                    return
                try:
                    thresh = float(qs["thresh"][0])
                except ValueError:
                    thresh = float("nan")
                if not (0.0 <= thresh <= 1.0):  # also rejects NaN
                    self._json(400, {"error": "bad thresh (need 0..1)"})
                    return
            n = int(self.headers.get("Content-Length", 0))
            if n > MAX_BODY_BYTES:
                self._json(413, {"error": f"body too large ({n} bytes; "
                                          f"max {MAX_BODY_BYTES})"})
                return
            body = self.rfile.read(n)
            try:
                image = decode_image(body, batcher.img_size)
                result = batcher.submit(image, thresh=thresh)
            except Overloaded as e:
                # graceful shed: a protocol-level backpressure signal (the
                # reference's tready=!busy), never a dropped connection
                self._json(503, {"error": "overloaded",
                                 "retry_after_s": e.retry_after_s},
                           extra_headers=[("Retry-After",
                                           str(e.retry_after_s))])
                return
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            code = 500 if "error" in result else 200
            self._json(code, result)

        def log_message(self, *_):
            pass

    return Handler


def build_service(artifacts_dir: str | None = None, device: str = "cuda",
                  max_batch: int = 256, max_wait_ms: float = 5.0,
                  variant: str = "lyr3-std", box: str = "ref",
                  head_prefix: str = "", mode: str = "mega",
                  multi: bool = False, multi_thresh=None, instances: int = 1,
                  deployable: str | None = None):
    """Load the bundle, build the engine for ``mode`` through
    ``make_engine`` (a ``CUDAEngine`` on ``device``, warmed at
    ``max_batch`` since the batcher pads every batch to it, the multi
    program too with ``multi``; or with ``mode="cpu"`` the host oracle
    behind ``_HostDetectAdapter``), and put a ``DynamicBatcher`` in front.
    ``multi_thresh`` None: the bundle's ``multi_thresh.json``, else 0.15.
    With ``deployable`` (a ``.tcnnx`` of ``apps.export_model``) it serves
    that container's programs on ``device`` instead, with no bundle and no
    model construction (``mode``, ``box`` and the bundle arguments are
    unused); ``multi_thresh`` None then reads the manifest's floors.
    Returns (batcher, backend name)."""
    if deployable:
        det = DeployedDetector.load(deployable, device)
        m = det.manifest
        if multi and not m.get("multi"):
            raise ValueError(
                "--multi needs a multi-object program in the .tcnnx — "
                "re-export with apps.export_model --multi")
        adapter = (_DeployableMultiAdapter if m.get("multi")
                   else _DeployableAdapter)(det)
        if multi_thresh is None:
            multi_thresh = m.get("multi_thresh") or DEFAULT_MULTI_THRESH
        zeros = np.zeros((1, m["img_size"], m["img_size"]), np.uint8)
        adapter.detect_batch(zeros)  # warm the serving program
        if multi:
            adapter.detect_multi_batch(zeros)
        batcher = DynamicBatcher(adapter, m["classes"], max_batch=max_batch,
                                 max_wait_ms=max_wait_ms,
                                 img_size=m["img_size"], multi=multi,
                                 multi_thresh=multi_thresh,
                                 instances=instances)
        return batcher, adapter.backend
    model = load_model(artifacts_dir or default_artifacts(variant), variant,
                       head_prefix)
    if box == "reg" and model.bbox_weight is None:
        raise ValueError("--box reg needs bbox_weight.npy in the bundle")
    if multi and model.head_mode != "bins":
        raise ValueError("--multi needs the spatial-bin head (per-class CAM)")
    if multi_thresh is None:
        multi_thresh = (model.multi_thresh if model.multi_thresh is not None
                        else DEFAULT_MULTI_THRESH)
    engine = make_engine(model, mode, device, box_mode=box)
    if hasattr(engine, "warmup"):
        engine.max_batch = max_batch
        engine.warmup(batch=max_batch, multi=multi, instances=instances)
    if not hasattr(engine, "detect_batch"):
        # the host oracle engine: the host head twins on its features
        engine = _HostDetectAdapter(engine, model, box=box)
    batcher = DynamicBatcher(engine, model.class_names, max_batch=max_batch,
                             max_wait_ms=max_wait_ms,
                             img_size=model.config.img_size, multi=multi,
                             multi_thresh=multi_thresh, instances=instances)
    return batcher, engine.backend


class _DeployableAdapter:
    """The detect_batch protocol over a loaded ``.tcnnx`` deployable."""

    def __init__(self, det: DeployedDetector):
        self.det = det
        self.backend = (f"deployable:{det.manifest['backend']}"
                        f"@{det.device.type}")

    def detect_batch(self, images):
        return DetectResult(*self.det.detect(images))


class _DeployableMultiAdapter(_DeployableAdapter):
    """Adds detect_multi_batch only when the container carries the
    multi-object program (a subclass, so that DynamicBatcher's
    hasattr-based capability check stays honest)."""

    def detect_multi_batch(self, images, instances: int = 1):
        out = self.det.detect_multi(images)
        scores = None
        if self.det.manifest.get("multi_head"):  # scores ride LAST
            scores, out = out[-1], out[:-1]
        if instances > 1 and int(self.det.manifest.get("instances", 1)) < 2:
            raise ValueError(
                "this .tcnnx has no instance program — re-export with "
                "apps.export_model --multi --instances N")
        # the container bakes ONE instance count; instances=1 requests
        # strip the extra outputs (plain multi semantics)
        inst = out[4:6] if instances > 1 and len(out) > 4 else (None, None)
        return MultiDetectResult(*out[:4], *inst, scores=scores)


class _HostDetectAdapter:
    """Gives the host oracle engine (``CPURefEngine``) the detect_batch
    interface: the port's copy of the JAX service's, the host head twins
    on the engine's features. Its ``detect_multi_batch`` takes no
    ``instances``, so a batcher asked for instances refuses it."""

    def __init__(self, engine, model, box: str = "ref"):
        self.engine = engine
        self.model = model
        self.box = box
        self.backend = f"host:{engine.backend}"

    def detect_batch(self, images):
        feats = self.engine.run_batch(images)
        idx, conf, probs = classify_np(feats, self.model.fc_weight, self.model.fc_bias)
        s = self.model.config.img_size
        if self.box == "reg":
            boxes = bbox_regress_np(bin_pool_np(feats),
                                    self.model.bbox_weight, s)
            return DetectResult(idx.astype(np.int32), conf.astype(np.float32),
                                probs.astype(np.float32),
                                np.asarray(boxes, np.int32))
        box_fn = (cam_host.cam_bbox_centroid if self.box == "centroid"
                  else cam_host.cam_bbox_fast)
        boxes = []
        for i in range(len(images)):
            if self.model.head_mode == "bins":
                boxes.append(box_fn(feats[i], int(idx[i]),
                                    self.model.fc_weight, s))
            else:
                boxes.append((0, 0, s - 1, s - 1))
        return DetectResult(idx.astype(np.int32), conf.astype(np.float32),
                            probs.astype(np.float32),
                            np.asarray(boxes, np.int32))

    def detect_multi_batch(self, images):
        feats = self.engine.run_batch(images)
        idx, conf, probs = classify_np(feats, self.model.fc_weight,
                                       self.model.fc_bias)
        s = self.model.config.img_size
        box_mode = "centroid" if self.box == "centroid" else "ref"
        boxes = np.stack([
            cam_host.cam_bbox_multi(feats[i], self.model.fc_weight,
                                    img_size=s, box_mode=box_mode)
            for i in range(len(images))
        ])
        return MultiDetectResult(idx.astype(np.int32),
                                 conf.astype(np.float32),
                                 probs.astype(np.float32),
                                 boxes.astype(np.int32))


def main(argv=None):
    p = argparse.ArgumentParser(description="CNN detection service on the "
                                            "CUDA port")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mode", default="mega", choices=MODES,
                   help="engine (see tpu_cnn_torch.apps.infer); cpu serves "
                        "the host oracle and ignores --device")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; the service has no "
                        "auth — expose beyond localhost deliberately)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--head-prefix", default="")
    p.add_argument("--variant", default="lyr3-std")
    p.add_argument("--box", default="ref", choices=["ref", "centroid", "reg"])
    p.add_argument("--multi", action="store_true",
                   help="multi-object responses: every class above the "
                        "threshold gets its own CAM box in 'detections' "
                        "(per-request override: POST /detect?thresh=0.3)")
    p.add_argument("--multi-thresh", type=float, default=None,
                   help="uniform floor for --multi detections (default: the "
                        "bundle's calibrated multi_thresh.json if present, "
                        "else 0.15)")
    p.add_argument("--instances", type=int, default=1,
                   help="with --multi: up to N watershed component boxes "
                        "per class in 'detections' (default 1)")
    p.add_argument("--deployable", default=None,
                   help="serve a .tcnnx from tpu_cnn_torch.apps.export_model "
                        "on --device (no bundle, no model construction)")
    args = p.parse_args(argv)
    if args.deployable and not os.path.isfile(args.deployable):
        p.error(f"--deployable {args.deployable}: no such file")
    batcher, backend = build_service(
        args.artifacts, args.device, args.max_batch, args.max_wait_ms,
        variant=args.variant, box=args.box, head_prefix=args.head_prefix,
        mode=args.mode, multi=args.multi, multi_thresh=args.multi_thresh,
        instances=args.instances, deployable=args.deployable)
    srv = ServiceHTTPServer((args.host, args.port),
                            make_handler(batcher, backend))
    print(f"serving on {args.host}:{srv.server_address[1]} (backend {backend}, "
          f"max_batch {args.max_batch}, max_wait {args.max_wait_ms}ms)",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.stop()
        srv.server_close()


if __name__ == "__main__":
    main()
