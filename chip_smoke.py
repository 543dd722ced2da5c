#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_cnn_torch``) end to end on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (CUDA toolkit) and the repository around
this file; it fails with a non-zero exit code otherwise. Phases, one line
each, in order; any failure raises:

  1. header   — the card (nvidia-smi name and power limit), torch, CUDA
  2. build    — nvcc builds csrc/mega_cnn.cu for sm_90a
  3. kernel   — the megakernel against its plain PyTorch version on the
                card: lyr3-std (shipped and seeded random weights, shifts
                2/4/6 and 1/3/5, B=37, every with_feats/bins/twin
                combination), lyr3-tiny and lyr2-small. Features and twin
                bit-equal, bins within 1e-6.
  4. engine   — CUDAEngine(device="cuda") through the bench's parity gate
                on 28 shipped test images + 4 noise images
  5. cli      — tpu_cnn_torch.apps.infer over the shipped test images;
                accuracy equal to the numpy oracle's
  6. server   — tpu_cnn_torch.apps.serve behind HTTP on 127.0.0.1: 8 raw
                image POSTs, each answer equal to the host oracle's
  7. times    — at batch 1536: the kernel and its plain version (CUDA
                events, median), and the async-pipelined engine detect FPS

Phases 4-6 are the main path: every kernel launch counter is set to 0
before them and read after, and each kernel must have launched there. The
line before the last is a JSON object with each kernel's launches, error
and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import http.client
import io
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from tpu_cnn.apps.common import load_model  # noqa: E402
from tpu_cnn.apps.serve import ServiceHTTPServer, make_handler  # noqa: E402
from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.head.cam import cam_bbox_fast  # noqa: E402
from tpu_cnn.head.classify import classify_np  # noqa: E402
from tpu_cnn.models.registry import default_shifts, get_config  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.artifacts import label_from_filename  # noqa: E402
from tpu_cnn_torch import bench_gate  # noqa: E402
from tpu_cnn_torch.apps import infer, serve  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.ops import _build, mega  # noqa: E402

ART = os.path.join(ROOT, "artifacts", "pretrained")
KERNEL_SOURCE = "tpu_cnn_torch/csrc/mega_cnn.cu"
REPLACES = "tpu_cnn/ops/pallas_poly.py:687"  # cnn_forward_polyphase_pallas
BINS_TOL = 1e-6  # the kernel's bins vs the plain version's (1-ulp / order)
BENCH_BATCH = 1536  # bench.py's batch
MACS_PER_IMAGE = sum(oc * ic * 9 * s * s
                     for ic, oc, s in get_config("lyr3-std").layer_configs)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def header() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch finds no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmul is on; the plain version and the head need f32")
    phase("1 header", f"torch {torch.__version__} CUDA {torch.version.cuda} "
                      f"device {torch.cuda.get_device_name(0)} "
                      f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def build() -> None:
    _lib, log, secs = _build.build("mega_cnn")
    mega._lib()  # load it and bind its entry points
    ptxas = " ".join(line.split("info    : ", 1)[-1] for line in log.splitlines()
                     if "registers" in line or "stack frame" in line)
    phase("2 build", f"nvcc sm_90a {KERNEL_SOURCE}: {secs:.2f} s; {ptxas}")


def kernel_vs_plain(dev: torch.device) -> float:
    """Every case: the kernel's outputs against mega_reference on the same
    card tensors. Returns the largest absolute difference seen."""
    bundle = art.load_bundle(ART)
    gate = bench_gate.load_gate_images(ART, n_real=28, n_noise=9)  # B = 37
    rs = np.random.RandomState(7)
    setups = [(f"lyr3-std/{w}/{sh}", gate, ks, sh)
              for w, ks in (("shipped", bundle.kernels),
                            ("seed7", _random_kernels(rs, "lyr3-std")))
              for sh in ((2, 4, 6), (1, 3, 5))]
    for name in ("lyr3-tiny", "lyr2-small"):
        s = get_config(name).img_size
        setups.append((name, rs.randint(0, 256, (37, s, s)).astype(np.uint8),
                       _random_kernels(rs, name),
                       tuple(default_shifts(get_config(name)))))
    max_err, n_cases = 0.0, 0
    combos = [c for c in itertools.product((True, False), repeat=3) if any(c)]
    for name, imgs_np, ks_np, sh in setups:
        imgs = torch.from_numpy(imgs_np).to(dev)
        ks = [torch.from_numpy(k).to(dev) for k in ks_np]
        shifts = torch.tensor(sh, dtype=torch.int32, device=dev)
        ref_feats, ref_bins, ref_twin = mega.mega_reference(imgs, ks, shifts)
        int_feats = mega.mega_reference(imgs, ks, shifts, compute_dtype="int32")[0]
        torch.cuda.synchronize()
        check(torch.equal(ref_feats, int_feats),
              f"{name}: plain f32 and int32 paths disagree on the card")
        oracle = np.stack([numpy_cnn_forward(im, ks_np, sh) for im in imgs_np[:4]])
        check(np.array_equal(ref_feats[:4].cpu().numpy(), oracle),
              f"{name}: plain version disagrees with the numpy oracle")
        for wf, wb, wt in combos:
            out = mega.cnn_forward_mega(imgs, ks, shifts, with_feats=wf,
                                        with_bins=wb, with_twin=wt)
            torch.cuda.synchronize()
            out = list(out) if isinstance(out, tuple) else [out]
            tag = f"{name} feats={wf} bins={wb} twin={wt}"
            if wf:
                f = out.pop(0)
                check(torch.equal(f, ref_feats), f"{tag}: features differ")
                max_err = max(max_err, (f.int() - ref_feats.int()).abs().max().item())
            if wb:
                b = out.pop(0)
                err = (b - ref_bins).abs().max().item()
                check(err <= BINS_TOL, f"{tag}: bins off by {err}")
                max_err = max(max_err, err)
            if wt:
                t = out.pop(0)
                check(t.dtype == torch.bfloat16 and torch.equal(t, ref_twin)
                      and torch.equal(t.float(), ref_feats.float()),
                      f"{tag}: twin differs from the features")
            n_cases += 1
    phase("3 kernel", f"{n_cases} cases (B=37) bit-equal feats/twin, bins "
                      f"within {BINS_TOL}; max_abs_err={max_err!r}")
    return max_err


def _random_kernels(rs, variant):
    return [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
            for ic, oc, _ in get_config(variant).layer_configs]


def engine_gate() -> None:
    bundle = art.load_bundle(ART)
    engine = CUDAEngine(load_model(ART), device="cuda")
    gate = bench_gate.load_gate_images(ART)
    err = bench_gate.run_parity_gate(engine.detect_with_features, bundle, gate)
    check(err is None, f"engine parity gate: {err}")
    res = engine.detect_batch(gate)  # the detect path proper: no u8 store
    _, _, pred, _, _, bbox = engine.detect_with_features(gate)
    check(np.array_equal(res.pred, pred) and np.array_equal(res.bbox, bbox),
          "detect_batch disagrees with the gated path")
    engine.set_shifts(1, 3, 5)
    feats = engine.run_batch(gate[:4])
    want = np.stack([numpy_cnn_forward(im, bundle.kernels, (1, 3, 5))
                     for im in gate[:4]])
    check(np.array_equal(feats, want), "set_shifts(1, 3, 5) features differ")
    engine.set_shifts(2, 4, 6)
    check(engine.launches > 0, "the engine launched no kernel")
    phase("4 engine", f"parity gate passed on {len(gate)} images; "
                      f"set_shifts checked; engine launches={engine.launches}")


def cli() -> None:
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))
    bundle = art.load_bundle(ART)
    feats = np.stack([numpy_cnn_forward(np.fromfile(p, np.uint8), bundle.kernels)
                      for p in paths])
    pred = classify_np(feats, bundle.fc_weight, bundle.fc_bias)[0]
    want = sum(int(p == label_from_filename(f)) for p, f in zip(pred, paths))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(["--image-dir", ART, "--device", "cuda", "--no-save"])
    line = next(ln.strip() for ln in out.getvalue().splitlines()
                if "Accuracy:" in ln)
    check(line.startswith(f"Accuracy: {want}/{len(paths)} "),
          f"CLI '{line}' != the oracle's {want}/{len(paths)}")
    phase("5 cli", f"tpu_cnn_torch.apps.infer: {line} (numpy oracle: "
                   f"{want}/{len(paths)})")


def server() -> None:
    bundle = art.load_bundle(ART)
    paths = sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:8]
    batcher, backend = serve.build_service(ART, device="cuda", max_batch=8)
    srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(batcher, backend))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]

    def request(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        bodies = [open(p, "rb").read() for p in paths]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda b: request("POST", "/detect", b), bodies))
        for p, body, (status, ans) in zip(paths, bodies, answers):
            f = numpy_cnn_forward(np.frombuffer(body, np.uint8), bundle.kernels)
            idx = int(classify_np(f[None], bundle.fc_weight, bundle.fc_bias)[0][0])
            box = list(cam_bbox_fast(f, idx, bundle.fc_weight))
            check(status == 200 and ans["pred"] == idx and ans["bbox"] == box,
                  f"{os.path.basename(p)}: server {status} {ans} != oracle "
                  f"pred {idx} bbox {box}")
        status, health = request("GET", "/healthz")
        check(status == 200 and health.get("ok") is True, f"/healthz: {health}")
        stats = batcher.snapshot()
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        th.join(timeout=10)
    phase("6 server", f"{len(paths)} POST /detect equal to the host oracle; "
                      f"/healthz {health}; batches={stats['batches']} "
                      f"requests={stats['requests']}")


def _event_ms(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def times(dev: torch.device, card: str) -> tuple[float, float]:
    bundle = art.load_bundle(ART)
    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 128, 128)).astype(np.uint8)).to(dev)
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    shifts = torch.tensor((2, 4, 6), dtype=torch.int32, device=dev)

    def kernel():
        mega.cnn_forward_mega(imgs, ks, shifts, with_feats=False,
                              with_bins=True, with_twin=True)

    def plain():
        mega.mega_reference(imgs, ks, shifts)

    for fn in (kernel, plain):  # warm-up
        fn()
    torch.cuda.synchronize()
    # plain, kernel, kernel, plain: both see the same card state
    p_ms = _event_ms(plain, 5)
    k_ms = _event_ms(kernel, 20) + _event_ms(kernel, 20)
    p_ms += _event_ms(plain, 5)
    kernel_ms, plain_ms = statistics.median(k_ms), statistics.median(p_ms)
    tops = MACS_PER_IMAGE * BENCH_BATCH / (kernel_ms * 1e-3) / 1e12
    phase("7 times", f"batch {BENCH_BATCH} detect outputs on {card}: kernel "
                     f"median {kernel_ms!r} ms (n={len(k_ms)}, "
                     f"{tops:.2f} int TMAC/s), plain median {plain_ms!r} ms "
                     f"(n={len(p_ms)})")

    engine = CUDAEngine(load_model(ART), device="cuda")
    pools = [engine.stage_batch(rs.randint(0, 256, (BENCH_BATCH, 128, 128))
                                .astype(np.uint8)) for _ in range(4)]
    engine.detect_resolve(engine.detect_batch_async(pools[0]))
    rounds = 52  # bench.py's async pipeline: 52 rounds over 4 staged pools

    def measure():
        t0 = time.perf_counter()
        handles = [engine.detect_batch_async(pools[i % 4]) for i in range(rounds)]
        results = [engine.detect_resolve(h) for h in handles]
        dt = time.perf_counter() - t0
        check(len(results) == rounds and results[0].pred.shape == (BENCH_BATCH,),
              "pipelined detect returned the wrong shapes")
        return rounds * BENCH_BATCH / dt

    fps = [measure() for _ in range(3)]
    phase("7 times", f"engine detect async-pipelined batch {BENCH_BATCH} on "
                     f"{card}: best {max(fps)!r} FPS of {fps!r}")
    return kernel_ms, plain_ms


def main() -> None:
    card = header()
    dev = torch.device("cuda", 0)
    build()
    max_err = kernel_vs_plain(dev)

    mega.launches = 0  # the main path starts here
    engine_gate()
    cli()
    server()
    launches = mega.launches
    check(launches > 0, "the main path never launched the megakernel")

    kernel_ms, plain_ms = times(dev, card)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "mega_cnn", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
