"""Native-front-end detection service on the port's engine.

The port of ``tpu_cnn.apps.serve_native``. The HTTP layer runs in C++
(``native/http_front.cpp``, the port's copy, in the host library
``tcnn_host``): accept, parse, body read, per-ticket response rendezvous
and push-back all happen off the GIL. Python does only what it must —
this worker loop drains request batches through one ctypes call, runs
the engine's fused detect, and posts JSON results back. The engine comes
from the port's engine swap (``apps.infer.make_engine``): ``CUDAEngine``
on ``--device``, or with ``--mode cpu`` the host oracle behind
``apps.serve._HostDetectAdapter``. The Python front end (``apps.serve``)
answers with the same schema.

Protocol: ``POST /detect`` with EXACTLY img_size^2 raw uint8 bytes (the
reference's test_image_*.bin format; 400 when shorter, 413 when longer)
-> JSON {pred, name, conf, probs, bbox}, and with ``--multi`` also
"detections": [{pred, name, conf, bbox}, ...]; a full queue (4 x
``--max-batch`` pending) -> 503; ``GET /healthz`` -> {status, pending,
served}; ``GET /stats`` -> {pending, served, live_conns, p50_ms, p99_ms}.

Usage:
  python -m tpu_cnn_torch.apps.serve_native --device cuda [--port 8000]
  python -m tpu_cnn_torch.apps.serve_native --variant lyr4-wide --device cuda
  python -m tpu_cnn_torch.apps.serve_native --multi --instances 2 --device cuda
  python -m tpu_cnn_torch.apps.serve_native --mode cpu
  curl --data-binary @artifacts/pretrained/test_image_0_class3.bin \\
       http://127.0.0.1:8000/detect
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import inspect
import json

import numpy as np

from tpu_cnn_torch.apps.common import add_variant_arg, load_model
from tpu_cnn_torch.apps.infer import MODES, make_engine
from tpu_cnn_torch.apps.serve import _HostDetectAdapter
from tpu_cnn_torch.head.detections import (DEFAULT_MULTI_THRESH,
                                           detections_above,
                                           instance_detections,
                                           presence_scores)
from tpu_cnn_torch.ops import _build
from tpu_cnn_torch.utils.paths import default_artifacts


def _get_lib():
    lib = ctypes.CDLL(_build.build_host())
    lib.tcnn_http_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.tcnn_http_start.restype = ctypes.c_void_p
    lib.tcnn_http_stop.argtypes = [ctypes.c_void_p]
    lib.tcnn_http_port.argtypes = [ctypes.c_void_p]
    lib.tcnn_http_port.restype = ctypes.c_int
    lib.tcnn_http_take.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_double,
    ]
    lib.tcnn_http_take.restype = ctypes.c_int
    lib.tcnn_http_respond.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.tcnn_http_served.argtypes = [ctypes.c_void_p]
    lib.tcnn_http_served.restype = ctypes.c_uint64
    return lib


class NativeFrontEnd:
    """The C++ HTTP front end + this process's engine worker loop."""

    def __init__(self, host: str, port: int, img_size: int,
                 max_batch: int = 256):
        self._lib = _get_lib()
        self.img_size = img_size
        self.max_batch = max_batch
        self._h = self._lib.tcnn_http_start(
            host.encode(), port, img_size * img_size, 4 * max_batch
        )
        if not self._h:
            raise RuntimeError(f"native front end failed to bind {host}:{port}")
        self.port = self._lib.tcnn_http_port(self._h)

    def serve_once(self, detect_fn, class_names, timeout_s: float = 0.2,
                   multi_thresh: float | None = None) -> int:
        """Drain one batch (blocking up to timeout_s), run ``detect_fn``
        ((B, S, S) u8 -> DetectResult-like), post responses. Returns the
        number of requests served. With ``multi_thresh``, ``detect_fn``
        must return a MultiDetectResult and every response carries a
        'detections' list (the raw-bytes C++ protocol has no query
        string, so the threshold is server-level here)."""
        s = self.img_size
        imgs = np.empty((self.max_batch, s, s), np.uint8)
        tickets = np.empty(self.max_batch, np.uint64)
        n = self._lib.tcnn_http_take(
            self._h, imgs.ctypes.data_as(ctypes.c_void_p),
            tickets.ctypes.data_as(ctypes.c_void_p), self.max_batch,
            ctypes.c_double(timeout_s),
        )
        if n <= 0:
            return 0
        res = detect_fn(imgs[:n])
        for i in range(n):
            idx = int(res.pred[i])
            obj = {
                "pred": idx,
                "name": class_names[idx],
                "conf": float(res.conf[i]),
                "probs": [float(v) for v in res.probs[i]],
                "bbox": [int(v) for v in (res.boxes[i, idx]
                                          if multi_thresh is not None
                                          else res.bbox[i])],
            }
            if multi_thresh is not None:
                sc = presence_scores(res)
                if getattr(res, "inst_boxes", None) is not None:
                    dets = instance_detections(
                        sc[i], res.boxes[i], res.inst_boxes[i],
                        res.inst_counts[i], multi_thresh)
                else:
                    dets = detections_above(sc[i], res.boxes[i],
                                            multi_thresh)
                obj["detections"] = [
                    {"pred": k, "name": class_names[k], "conf": prob,
                     "bbox": list(bbox)}
                    for k, prob, bbox in dets
                ]
            payload = json.dumps(obj).encode()
            self._lib.tcnn_http_respond(
                self._h, ctypes.c_uint64(int(tickets[i])), payload,
                len(payload),
            )
        return n

    @property
    def served(self) -> int:
        return int(self._lib.tcnn_http_served(self._h))

    def stop(self) -> None:
        if self._h:
            self._lib.tcnn_http_stop(self._h)
            self._h = None


def build_worker(model, mode: str, device: str = "cuda", box: str = "ref",
                 max_batch: int = 256, multi: bool = False,
                 multi_thresh=None, instances: int = 1):
    """The engine behind the front: ``make_engine`` for ``mode`` on
    ``device``, warmed at ``max_batch`` (the multi program too with
    ``multi``) before any port is bound, the host oracle behind
    ``_HostDetectAdapter``. Returns (detect_fn, multi_thresh or None,
    backend name); ``ValueError`` names what the engine cannot serve."""
    if multi and model.head_mode != "bins":
        raise ValueError("--multi needs the spatial-bin head (per-class CAM)")
    engine = make_engine(model, mode, device, box_mode=box)
    if instances > 1 and (
            not multi or not hasattr(engine, "detect_multi_batch")
            or "instances" not in inspect.signature(
                engine.detect_multi_batch).parameters):
        raise ValueError("--instances needs --multi and an engine with "
                         "instance support")
    if hasattr(engine, "warmup"):
        engine.max_batch = max_batch
        engine.warmup(batch=max_batch, multi=multi, instances=instances)
    if not hasattr(engine, "detect_batch"):
        engine = _HostDetectAdapter(engine, model, box=box)
    if multi and instances > 1:
        detect_fn = functools.partial(engine.detect_multi_batch,
                                      instances=instances)
    elif multi:
        detect_fn = engine.detect_multi_batch
    else:
        detect_fn = engine.detect_batch
    if multi and multi_thresh is None:
        multi_thresh = (model.multi_thresh if model.multi_thresh is not None
                        else DEFAULT_MULTI_THRESH)
    return detect_fn, (multi_thresh if multi else None), engine.backend


def main(argv=None):
    p = argparse.ArgumentParser(description="Native-front-end detect service "
                                            "on the CUDA port")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mode", default="auto", choices=MODES,
                   help="engine (see tpu_cnn_torch.apps.infer); cpu serves "
                        "the host oracle and ignores --device")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (no auth — expose deliberately)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--box", default="ref", choices=["ref", "centroid", "reg"])
    p.add_argument("--multi", action="store_true",
                   help="multi-object responses (one CAM box per class "
                        "above --multi-thresh; server-level threshold — "
                        "the raw-bytes protocol has no per-request params)")
    p.add_argument("--multi-thresh", type=float, default=None,
                   help="uniform floor (default: the bundle's calibrated "
                        "multi_thresh.json if present, else 0.15)")
    p.add_argument("--instances", type=int, default=1,
                   help="with --multi: up to N watershed component boxes "
                        "per class in 'detections' (default 1)")
    p.add_argument("--head-prefix", default="")
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    model = load_model(args.artifacts, args.variant, args.head_prefix)
    try:
        detect_fn, multi_thresh, backend = build_worker(
            model, args.mode, args.device, args.box, args.max_batch,
            args.multi, args.multi_thresh, args.instances)
    except ValueError as e:
        p.error(str(e))
    front = NativeFrontEnd(args.host, args.port, model.config.img_size,
                           args.max_batch)
    print(f"native front end on {args.host}:{front.port} "
          f"(backend {backend}, max_batch {args.max_batch}) — POST raw "
          f"{model.config.img_size}^2 bytes to /detect", flush=True)
    try:
        while True:
            front.serve_once(detect_fn, model.class_names,
                             multi_thresh=multi_thresh)
    except KeyboardInterrupt:
        pass
    finally:
        front.stop()


if __name__ == "__main__":
    main()
