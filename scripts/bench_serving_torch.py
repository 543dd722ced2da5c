"""Serving-layer load benchmark on the port: the Python front
(``tpu_cnn_torch.apps.serve``) against the native C++ front
(``tpu_cnn_torch.apps.serve_native``) on the SAME warm engine.

The port of ``scripts/bench_serving.py``: one ``CUDAEngine`` (through
``apps.infer.make_engine``), both fronts up on ephemeral localhost ports,
and for each concurrency N a sustained closed-loop load (N client threads,
one request in flight each, a fresh TCP connection per request — both
fronts speak Connection: close), the two fronts interleaved per
concurrency. Reports requests/s, client-side p50/p99 latency, connection
errors, 503 sheds and other non-200 answers, and each front's own /stats
(queue depth and server-side percentiles).

Run on the card:
  python scripts/bench_serving_torch.py [--duration 60] [--conc 4,16,64]
      [--mode auto] [--max-batch 256] [--variant lyr3-std] [--device cuda]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.infer import make_engine  # noqa: E402
from tpu_cnn_torch.apps.serve import (DynamicBatcher, ServiceHTTPServer,  # noqa: E402
                                      make_handler)
from tpu_cnn_torch.apps.serve_native import NativeFrontEnd  # noqa: E402
from tpu_cnn_torch.utils.paths import default_artifacts  # noqa: E402


def load(port: int, frame: bytes, duration: float, conc: int):
    """Closed-loop load: conc threads, one in-flight request each.
    Returns (req/s, p50_ms, p99_ms, errors, shed503, other_non200).
    ``errors`` counts connection-level failures (resets, refusals,
    timeouts); a clean 503 shed is counted apart and honoured (a brief
    backoff, Retry-After capped at 0.5 s)."""
    stop = time.perf_counter() + duration
    lats, errs, shed, bad = [], [0], [0], [0]
    lock = threading.Lock()

    def client():
        my_lats = []
        while time.perf_counter() < stop:
            t0 = time.perf_counter()
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=35)
            try:
                c.request("POST", "/detect", body=frame)
                r = c.getresponse()
                r.read()
                if r.status == 503:
                    with lock:
                        shed[0] += 1
                    ra = r.getheader("Retry-After")
                    time.sleep(min(float(ra) if ra else 0.2, 0.5))
                    continue
                if r.status != 200:
                    with lock:
                        bad[0] += 1
                    continue
            except (OSError, http.client.HTTPException):
                with lock:
                    errs[0] += 1
                continue
            finally:
                c.close()
            my_lats.append((time.perf_counter() - t0) * 1e3)
        with lock:
            lats.extend(my_lats)

    threads = [threading.Thread(target=client) for _ in range(conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    lats.sort()
    if not lats:
        return 0.0, 0.0, 0.0, errs[0], shed[0], bad[0]
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    return len(lats) / dt, p50, p99, errs[0], shed[0], bad[0]


def stats(port: int) -> dict:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        c.request("GET", "/stats")
        return json.loads(c.getresponse().read())
    finally:
        c.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--conc", default="4,16,64")
    ap.add_argument("--mode", default="auto")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--variant", default="lyr3-std")
    ap.add_argument("--artifacts", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    concs = [int(c) for c in args.conc.split(",")]

    model = load_model(args.artifacts or default_artifacts(args.variant),
                       args.variant)
    engine = make_engine(model, args.mode, args.device)
    print(f"warming engine ({engine.backend}, max_batch {args.max_batch})...",
          flush=True)
    engine.max_batch = args.max_batch
    engine.warmup(batch=args.max_batch)

    s = model.config.img_size
    frame = np.random.RandomState(0).randint(
        0, 256, (s, s), dtype=np.uint8).tobytes()

    # the Python front
    batcher = DynamicBatcher(engine, model.class_names,
                             max_batch=args.max_batch, img_size=s)
    httpd = ServiceHTTPServer(("127.0.0.1", 0),
                              make_handler(batcher, engine.backend))
    py_port = httpd.server_address[1]
    py_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    py_thread.start()

    # the native front and its engine worker loop
    front = NativeFrontEnd("127.0.0.1", 0, s, max_batch=args.max_batch)
    native_running = threading.Event()
    native_running.set()

    def native_worker():
        while native_running.is_set():
            front.serve_once(engine.detect_batch, model.class_names,
                             timeout_s=0.05)

    native_thread = threading.Thread(target=native_worker, daemon=True)
    native_thread.start()

    print(f"python front :{py_port}  native front :{front.port}  "
          f"duration {args.duration:.0f}s per cell", flush=True)
    rows = []
    try:
        for conc in concs:
            for name, port in (("python", py_port), ("native", front.port)):
                rps, p50, p99, errs, shed, bad = load(port, frame,
                                                      args.duration, conc)
                rows.append({"front": name, "conc": conc, "req_s": rps,
                             "p50_ms": p50, "p99_ms": p99, "conn_errors": errs,
                             "shed_503": shed, "non200": bad})
                print(f"  {name:7s} conc={conc:<4d} {rps!r} req/s   "
                      f"p50 {p50!r} ms   p99 {p99!r} ms   "
                      f"conn-errors {errs}  shed-503 {shed}  non200 {bad}",
                      flush=True)
        server_stats = {"python": batcher.snapshot(),
                        "native": stats(front.port)}
    finally:
        native_running.clear()
        native_thread.join(timeout=10)
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
        front.stop()
    print("\n  server-side /stats after load:")
    for name, st in server_stats.items():
        print(f"    {name}: {json.dumps(st)}")
    return {"backend": engine.backend, "rows": rows, "stats": server_stats}


if __name__ == "__main__":
    main()
