"""Detection service on the port's engine — dynamic-batching HTTP server.

The ``tpu_cnn.apps.serve`` service with ``CUDAEngine`` underneath. The
serving layer itself (``DynamicBatcher``, ``ServiceHTTPServer``,
``make_handler``) is reused: the batcher coalesces single requests into
device batches and drives the engine's async detect pipeline. Only the
multi-object answer is built here (``PortBatcher``), from the engine
module's JAX-free twins of the detection filters, with the same JSON.

Endpoints:
  POST /detect   body: S x S raw uint8 bytes at the variant's image size
                 (16,384 for lyr3-std's 128x128, 65,536 for lyr4-wide's
                 256x256); returns JSON {pred, name, conf, probs, bbox},
                 and with --multi also "detections": [{pred, name, conf,
                 bbox}, ...] (per-request floor: POST /detect?thresh=0.3)
  GET  /healthz  liveness + engine backend
  GET  /stats    request/batch counters and latency percentiles

Usage:
  python -m tpu_cnn_torch.apps.serve --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --variant lyr4-wide --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --mode hybrid --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --multi --instances 2 --device cuda --port 8000

``--mode`` picks the engine's backend, as in ``apps.infer``.
"""

from __future__ import annotations

import argparse
import time

from tpu_cnn.apps.common import load_model
from tpu_cnn.apps.serve import DynamicBatcher, ServiceHTTPServer, make_handler
from tpu_cnn.utils.paths import default_artifacts
from tpu_cnn_torch.engine.cuda import (BACKENDS, DEFAULT_MULTI_THRESH,
                                       CUDAEngine, detections_above,
                                       instance_detections, presence_scores)


class PortBatcher(DynamicBatcher):
    """``DynamicBatcher`` whose multi-object answers come from the port's
    detection filters (the base class imports the JAX engine module for
    them)."""

    def _fan_out(self, batch, res):
        if not self.multi:
            super()._fan_out(batch, res)
            return
        sc = presence_scores(res)
        for i, p in enumerate(batch):
            idx = int(res.pred[i])
            thr = p.thresh if p.thresh is not None else self.multi_thresh
            if res.inst_boxes is not None:
                dets = instance_detections(sc[i], res.boxes[i],
                                           res.inst_boxes[i],
                                           res.inst_counts[i], thr)
            else:
                dets = detections_above(sc[i], res.boxes[i], thr)
            p.result = {
                "pred": idx,
                "name": self.class_names[idx],
                "conf": float(res.conf[i]),
                "probs": [float(v) for v in res.probs[i]],
                "bbox": [int(v) for v in res.boxes[i, idx]],
                "detections": [{"pred": k, "name": self.class_names[k],
                                "conf": prob, "bbox": list(bbox)}
                               for k, prob, bbox in dets],
            }
            p.event.set()
        now = time.perf_counter()
        with self._lock:
            self._lat.extend((now - p.t0) * 1e3 for p in batch)


def build_service(artifacts_dir: str | None = None, device: str = "cuda",
                  max_batch: int = 256, max_wait_ms: float = 5.0,
                  variant: str = "lyr3-std", box: str = "ref",
                  head_prefix: str = "", mode: str = "mega",
                  multi: bool = False, multi_thresh=None, instances: int = 1):
    """Load the bundle, build and warm a ``CUDAEngine`` on backend ``mode``
    at ``max_batch`` (the batcher pads every batch to it), the multi
    program too with ``multi``, and put a ``PortBatcher`` in front.
    ``multi_thresh`` None: the bundle's ``multi_thresh.json``, else 0.15.
    Returns (batcher, backend name)."""
    model = load_model(artifacts_dir or default_artifacts(variant), variant,
                       head_prefix)
    if multi and model.head_mode != "bins":
        raise ValueError("--multi needs the spatial-bin head (per-class CAM)")
    if multi_thresh is None:
        multi_thresh = (model.multi_thresh if model.multi_thresh is not None
                        else DEFAULT_MULTI_THRESH)
    engine = CUDAEngine(model, device=device, backend=mode,
                        max_batch=max_batch, box_mode=box)
    engine.warmup(batch=max_batch, multi=multi, instances=instances)
    batcher = PortBatcher(engine, model.class_names, max_batch=max_batch,
                          max_wait_ms=max_wait_ms,
                          img_size=model.config.img_size, multi=multi,
                          multi_thresh=multi_thresh, instances=instances)
    return batcher, engine.backend


def main(argv=None):
    p = argparse.ArgumentParser(description="CNN detection service on the "
                                            "CUDA port")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mode", default="mega", choices=BACKENDS,
                   help="engine backend (see tpu_cnn_torch.apps.infer)")
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
                   help="not yet ported (ROADMAP A.12, export)")
    args = p.parse_args(argv)
    if args.deployable:
        p.error("--deployable: not yet ported (ROADMAP A.12, export)")
    batcher, backend = build_service(
        args.artifacts, args.device, args.max_batch, args.max_wait_ms,
        variant=args.variant, box=args.box, head_prefix=args.head_prefix,
        mode=args.mode, multi=args.multi, multi_thresh=args.multi_thresh,
        instances=args.instances)
    srv = ServiceHTTPServer((args.host, args.port),
                            make_handler(batcher, backend))
    print(f"serving on {args.host}:{args.port} (backend {backend}, "
          f"max_batch {args.max_batch}, max_wait {args.max_wait_ms}ms)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.stop()
        srv.server_close()


if __name__ == "__main__":
    main()
