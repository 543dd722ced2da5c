"""Detection service on the port's engine — dynamic-batching HTTP server.

The ``tpu_cnn.apps.serve`` service with ``CUDAEngine`` underneath. The
serving layer itself (``DynamicBatcher``, ``ServiceHTTPServer``,
``make_handler``) is reused unchanged: the batcher coalesces single
requests into device batches and drives the engine's
``detect_batch_async`` / ``detect_resolve`` pipeline.

Endpoints:
  POST /detect   body: S x S raw uint8 bytes at the variant's image size
                 (16,384 for lyr3-std's 128x128, 65,536 for lyr4-wide's
                 256x256); returns JSON {pred, name, conf, probs, bbox}
  GET  /healthz  liveness + engine backend
  GET  /stats    request/batch counters and latency percentiles

Usage:
  python -m tpu_cnn_torch.apps.serve --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --variant lyr4-wide --device cuda --port 8000
  python -m tpu_cnn_torch.apps.serve --mode hybrid --device cuda --port 8000

``--mode`` picks the engine's backend, as in ``apps.infer``.
"""

from __future__ import annotations

import argparse

from tpu_cnn.apps.common import load_model
from tpu_cnn.apps.serve import DynamicBatcher, ServiceHTTPServer, make_handler
from tpu_cnn.utils.paths import default_artifacts
from tpu_cnn_torch.engine.cuda import BACKENDS, CUDAEngine


def build_service(artifacts_dir: str | None = None, device: str = "cuda",
                  max_batch: int = 256, max_wait_ms: float = 5.0,
                  variant: str = "lyr3-std", box: str = "ref",
                  head_prefix: str = "", mode: str = "mega"):
    """Load the bundle, build and warm a ``CUDAEngine`` on backend ``mode``
    at ``max_batch`` (the batcher pads every batch to it), and put a
    ``DynamicBatcher`` in front. Returns (batcher, backend name)."""
    model = load_model(artifacts_dir or default_artifacts(variant), variant,
                       head_prefix)
    engine = CUDAEngine(model, device=device, backend=mode,
                        max_batch=max_batch, box_mode=box)
    engine.warmup(batch=max_batch)
    batcher = DynamicBatcher(engine, model.class_names, max_batch=max_batch,
                             max_wait_ms=max_wait_ms,
                             img_size=model.config.img_size)
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
    p.add_argument("--deployable", default=None,
                   help="not yet ported (ROADMAP A.12, export)")
    p.add_argument("--multi", action="store_true",
                   help="not yet ported (ROADMAP A.7)")
    args = p.parse_args(argv)
    if args.deployable:
        p.error("--deployable: not yet ported (ROADMAP A.12, export)")
    if args.multi:
        p.error("--multi: not yet ported (ROADMAP A.7)")
    batcher, backend = build_service(args.artifacts, args.device,
                                     args.max_batch, args.max_wait_ms,
                                     variant=args.variant, box=args.box,
                                     head_prefix=args.head_prefix,
                                     mode=args.mode)
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
