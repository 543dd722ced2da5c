"""Throughput/latency benchmark — the ``arm_benchmark.py`` role: the port's
``tpu_cnn.apps.benchmark``.

Reports per-layer MAC counts, end-to-end batched FPS per backend, and the
speedup vs the reference FPGA's published numbers (22 FPS end-to-end,
6.8 ms conv latency — BASELINE.md). Every measurement of the JAX app runs
here on the port's engine and kernels:

  - the default: each ``--modes`` entry's ``apps.infer.make_engine``
    engine, its fused detect async-pipelined on frames staged on the
    device (``--multi [--instances N]``: the multi detect; ``--features``:
    ``run_batch``, the u8 feature map copied back);
  - ``--latency``: synchronous round trips per batch size, median and p99,
    beside the pipelined rate;
  - ``--per-layer``: each layer alone on the inputs the preceding layers
    staged on the device: the pooled conv kernel
    (``int8.fused_conv_layer``, weights packed once) on every layer for
    ``pallas`` and on L0 for ``hybrid``/``auto``, the plain contract layer
    (the ``xla`` backend) elsewhere, then the head
    (``detect_head.detect``); ``mega`` reports the chained plan's fused
    whole-net time beside the ``xla`` table;
  - ``--roofline``: MACs and HBM bytes per image, their bounds on the card
    (``utils.roofline``) and the measured fused detect's share;
  - ``--camera-pipeline``: the device preprocess
    (``ops.preprocess.preprocess_frames``) then the engine's detect, on
    frames resident on the card.

  - ``--train``: the trainer's phase-1 float step
    (``train.train_cnn.make_train_step``: forward, backward, Adam) at
    ``--batch`` and ``--train-dtype``, ``--runs`` dependent steps per
    chain; ms/step, img/s and the MFU against the card's float peak for
    the dtype (``utils.roofline``).

Timing: every window ends with a device synchronise or a CUDA event (a
result copied to the host through a recorded event counts), so no window
times launches that nothing waited on. A mode that fails prints ``FAILED``
as the JAX app does, and the run then exits 1.

  - ``--host-ingest``: the native frame ring (``native.ring``):
    ``--ingest-threads`` producers push raw ``--cam-res`` BGR frames
    through the C++ preprocess, one consumer drains ``--batch`` batches;
    frames/s and the frames the ring dropped. Host work only: no device,
    no kernel.

Usage:
  python -m tpu_cnn_torch.apps.benchmark --batch 1024 --runs 30
  python -m tpu_cnn_torch.apps.benchmark --modes auto,mega,pallas,hybrid,xla,cpu
  python -m tpu_cnn_torch.apps.benchmark --per-layer --modes pallas
  python -m tpu_cnn_torch.apps.benchmark --device cpu --batch 4 --runs 1 --modes mega
"""

from __future__ import annotations

import argparse
import itertools
import sys
import threading
import time

import numpy as np
import torch

from tpu_cnn_torch.models.cnn import FpgaCNN, TorchFpgaCNN
from tpu_cnn_torch.native.ring import NativeFrameRing
from tpu_cnn_torch.train.train_cnn import resolve_device as _device
from tpu_cnn_torch.utils.roofline import (PEAK_BF16_MACS, PEAK_F32_MACS,
                                          PEAK_HBM_BYTES, PEAK_INT8_MACS,
                                          detect_out_bytes, layers_bound,
                                          macs_per_image)

FPGA_FPS = 22.0  # reference README.md:11
FPGA_CONV_MS = 6.8  # reference README.md:12
# the card's float peak the train step's MFU is read against, per dtype
TRAIN_PEAK_MACS = {"float32": PEAK_F32_MACS, "bfloat16": PEAK_BF16_MACS}


def _seconds_per_call(fn, runs: int, dev: torch.device) -> float:
    """Seconds per call of ``fn`` over ``runs`` calls back to back, after
    one warm-up call (which builds and loads a kernel on its first CUDA
    call). On the card the window is two CUDA events on the stream around
    the calls, waited on; on the CPU the calls are synchronous."""
    fn()
    runs = max(1, runs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) / runs


def bench_per_layer(model: FpgaCNN, mode: str, batch: int, runs: int,
                    device: str = "cuda"):
    """Per-layer device timings + MFU — the ``arm_benchmark.py:227-242``
    table, on the card. Each layer is timed alone (``runs`` calls back to
    back in one event window) on inputs staged on the device by running
    the preceding layers once. The layers are NCHW throughout."""
    from tpu_cnn_torch.ops import detect_head, int8, mega, quant

    dev = _device(device)
    net = TorchFpgaCNN.from_fpga_cnn(model, dev)
    rng = np.random.RandomState(0)
    cfgs = model.config.layer_configs
    x = torch.from_numpy(rng.randint(
        0, 256, (batch, 1, cfgs[0][2], cfgs[0][2]), dtype=np.uint8)).to(dev)

    def layer_fn(i):
        k, shifts = net.kernels[i], net.shifts
        use_pallas = mode == "pallas" or (mode in ("hybrid", "auto") and i == 0)
        if use_pallas:
            packed = mega.pack_layer(k)  # once, as CUDAEngine packs them
            return (lambda a: int8.fused_conv_layer(a, k, shifts, i,
                                                    packed=packed)), "pallas"
        return (lambda a: quant.fixed_point_conv_layer(a, k, shifts[i])), "xla"

    rows = []
    for i, (ic, oc, size) in enumerate(cfgs):
        fn, kind = layer_fn(i)
        y = fn(x)  # stage the next layer's input
        dt = _seconds_per_call(lambda: fn(x), runs, dev)
        macs = size * size * oc * ic * 9 * batch
        rows.append({
            "layer": i, "ic": ic, "oc": oc, "size": size, "kind": kind,
            "ms": dt * 1e3, "us_per_img": dt / batch * 1e6,
            "tmacs": macs / dt / 1e12, "mfu": macs / dt / PEAK_INT8_MACS,
        })
        x = y

    # head: fused classify + CAM on the final features
    feats = x.reshape(batch, x.shape[1], -1)
    dt = _seconds_per_call(lambda: detect_head.detect(
        feats, net.fc_weight, net.fc_bias, model.head_mode,
        model.config.img_size), runs, dev)
    rows.append({
        "layer": "head", "ic": x.shape[1], "oc": len(model.fc_bias),
        "size": x.shape[2], "kind": "xla", "ms": dt * 1e3,
        "us_per_img": dt / batch * 1e6, "tmacs": 0.0, "mfu": 0.0,
    })
    return rows


def bench_mega_fused(model: FpgaCNN, batch: int, runs: int,
                     device: str = "cuda") -> float | None:
    """Whole-net seconds per batch of the ``mega`` backend's kernels on the
    engine's plan (``mega.cnn_forward_mega`` with ``pack_plan``'s weights;
    on lyr4-wide the layer kernel, then the megakernel), emitting what the
    engine's fused detect reads: the bins and the bf16 twin. One fused
    program has no per-layer split. Returns None when ``mega_plan`` has no
    plan for the geometry."""
    from tpu_cnn_torch.ops import mega

    cfgs = model.config.layer_configs
    if mega.mega_plan(cfgs) is None:
        return None
    dev = _device(device)
    net = TorchFpgaCNN.from_fpga_cnn(model, dev)
    packed = mega.pack_plan(net.kernels, model.config.img_size)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(
        0, 256, (batch, cfgs[0][2], cfgs[0][2]), dtype=np.uint8)).to(dev)
    return _seconds_per_call(lambda: mega.cnn_forward_mega(
        x, net.kernels, net.shifts, with_feats=False, with_bins=True,
        with_twin=True, packed=packed), runs, dev)


def print_roofline(model: FpgaCNN, batch: int, runs: int,
                   device: str = "cuda"):
    """The fused detect's roofline on the card: MACs per image and their
    int8 tensor-core bound, the HBM bytes per image (the input read once,
    the detect outputs written once) and their bound, and the measured
    fused time (``bench_mega_fused``) with its share of the larger bound.
    Returns the numbers as a dict."""
    from tpu_cnn_torch.ops import mega

    cfgs = model.config.layer_configs
    macs = macs_per_image(cfgs)
    ic, _, s = cfgs[0]
    out_bytes = detect_out_bytes(cfgs)
    in_bytes = ic * s * s
    hbm = in_bytes + out_bytes
    mac_us, hbm_us = macs / PEAK_INT8_MACS * 1e6, hbm / PEAK_HBM_BYTES * 1e6
    print("\n  ROOFLINE — fused detect (the mega backend's plan)")
    print(f"  MACs/img {macs / 1e6:.1f}M")
    print(f"    int8 tensor-core bound ({PEAK_INT8_MACS / 1e12:.1f} T MAC/s, "
          f"H100 SXM dense peak): {mac_us:8.3f} us/img")
    print(f"  HBM bytes/img {hbm:,} (input {in_bytes:,} read once; detect "
          f"outputs {out_bytes:,} written once: bf16 twin + f32 bins)")
    print(f"    HBM bound ({PEAK_HBM_BYTES / 1e12:.2f} TB/s, H100 SXM HBM3 "
          f"peak): {hbm_us:8.3f} us/img")
    out = {"macs_per_img": macs, "bytes_per_img": hbm,
           "mac_bound_us": mac_us, "hbm_bound_us": hbm_us}
    n_head = mega.mega_plan(cfgs)
    if n_head is None:
        print("  (no megakernel plan for this geometry — hybrid runs it)")
        return out
    if n_head:
        print(f"  plan: {n_head} head layer(s) on the layer kernel, then the "
              f"megakernel on the tail")
    dt = bench_mega_fused(model, batch, runs, device)
    us = dt / batch * 1e6
    b_ms, b_by = layers_bound(cfgs, batch, out_bytes)
    b_us = b_ms * 1e3 / batch
    print(f"  measured fused detect outputs: {us:.3f} us/img "
          f"({1e6 / us:,.0f} FPS), batch {batch}")
    print(f"  bound {b_us:.3f} us/img by {b_by} (weights included): "
          f"{b_us / us:.1%} of it  |  MFU {macs / (us * 1e-6) / PEAK_INT8_MACS:.1%}"
          f"  |  HBM {hbm / (us * 1e-6) / 1e9:.1f} GB/s")
    out.update({"us_per_img": us, "bound_us": b_us, "bound_by": b_by,
                "share": b_us / us})
    return out


def bench_host_ingest(batch: int, runs: int, cam_w: int, cam_h: int,
                      n_threads: int = 4, out_size: int = 128):
    """Native frame-ring ingest throughput: ``n_threads`` producers push
    raw BGR camera frames (the C++ preprocess runs off the GIL inside
    push), one consumer drains engine-sized batches. Measures the host
    side of the camera pipeline — the ceiling the native data-loader puts
    on feeding the device (``native/frame_ring.cpp``). Returns (frames/s,
    frames dropped); consumed + dropped = the frames pushed."""
    rng = np.random.RandomState(0)
    per_thread = batch * runs // n_threads
    total = per_thread * n_threads
    frame_pool = [rng.randint(0, 256, (cam_h, cam_w, 3), dtype=np.uint8)
                  for _ in range(8)]
    ring = NativeFrameRing(capacity=4 * batch, out_size=out_size)
    try:
        def producer(tid):
            for i in range(per_thread):
                ring.push(frame_pool[(tid + i) % len(frame_pool)])

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        consumed = 0
        while consumed + ring.dropped < total:
            ring.wait(min_frames=min(batch, total - consumed), timeout_s=0.2)
            consumed += len(ring.pop_batch(batch))
        dt = time.perf_counter() - t0
        for t in threads:
            t.join()
        return total / dt, ring.dropped
    finally:
        ring.close()


def bench_train(model: FpgaCNN, batch: int, runs: int, compute_dtype: str,
                passes: int = 3, device: str = "cuda"):
    """Phase-1 float train step throughput (forward + backward + Adam).

    Chains ``runs`` dependent steps on one batch staged on the device and
    synchronises once per chain; best of ``passes`` chains after a warm-up
    chain. Returns (ms_per_step, img_per_s, mfu_pct): the MFU counts 3x the
    forward MACs per image (forward, gradient of the input, gradient of the
    weights) against the card's peak for ``compute_dtype`` (f32 outside the
    tensor cores, bf16 on them)."""
    from tpu_cnn_torch.train.train_cnn import (AdamCosine, TrainConfig,
                                               init_params, make_train_step)

    dev = _device(device)
    runs = max(1, runs)
    cfg = TrainConfig(layer_configs=model.config.layer_configs,
                      batch_size=batch)
    net = init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
    # the trainer's optimiser (its cosine spans the whole timed run): the
    # JAX app's plain optax.adam does the same work per step
    opt = AdamCosine(1e-3, runs * (max(1, passes) + 1))
    state = opt.init(net.params())
    step = make_train_step(cfg, opt, compute_dtype=compute_dtype)
    rs = np.random.RandomState(0)
    s = model.config.img_size
    imgs = torch.as_tensor(rs.rand(batch, s, s).astype(np.float32), device=dev)
    labels = torch.as_tensor(rs.randint(0, cfg.num_classes, batch), device=dev)

    def chain():
        for _ in range(runs):
            step(net, state, imgs, labels)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    chain()  # build and warm
    best = float("inf")
    for _ in range(max(1, passes)):
        t0 = time.perf_counter()
        chain()
        best = min(best, (time.perf_counter() - t0) / runs)
    train_macs = 3 * macs_per_image(model.config.layer_configs)
    mfu = batch * train_macs / best / TRAIN_PEAK_MACS[compute_dtype] * 100.0
    return best * 1e3, batch / best, mfu


def bench_engine(engine, images: np.ndarray, runs: int, use_detect: bool,
                 multi: bool = False, instances: int = 1):
    """Async-pipelined when the engine supports it (detect_batch_async):
    every batch dispatched on frames staged on the device, then each
    resolved (its results copied to the host through pinned buffers and a
    recorded event, waited on). ``multi`` times the multi-object pipeline
    (per-class boxes) instead; ``instances`` additionally times the
    watershed instance head. Other engines (the host oracle) and
    ``use_detect=False`` (``run_batch``: the features copied back) run
    synchronously. Returns seconds per batch."""
    if multi and not hasattr(engine, "detect_multi_batch"):
        raise ValueError(
            f"--multi needs an engine with detect_multi_batch; "
            f"{type(engine).__name__} has none")
    dispatch_name = "detect_multi_batch_async" if multi else "detect_batch_async"
    if use_detect and hasattr(engine, dispatch_name):
        dispatch = getattr(engine, dispatch_name)
        if multi and instances > 1:
            import functools

            dispatch = functools.partial(dispatch, instances=instances)
        resolve = (engine.detect_multi_resolve if multi
                   else engine.detect_resolve)
        # Stage the frames on the device first, then measure pure
        # dispatch+compute (bench.py's measurement discipline)
        pools = [engine.stage_batch(images) for _ in range(2)]
        resolve(dispatch(pools[0]))  # warmup
        t0 = time.perf_counter()
        handles = [dispatch(pools[i % 2]) for i in range(runs)]
        for h in handles:
            resolve(h)
        return (time.perf_counter() - t0) / runs
    sync_name = "detect_multi_batch" if multi else "detect_batch"
    fn = (getattr(engine, sync_name)
          if use_detect and hasattr(engine, sync_name) else engine.run_batch)
    fn(images)  # warmup / kernel build
    t0 = time.perf_counter()
    for _ in range(runs):
        fn(images)
    return (time.perf_counter() - t0) / runs


def bench_latency(model: FpgaCNN, mode: str, runs: int,
                  batches=(1, 8, 64, 256, 1024), device: str = "cuda"):
    """Dispatch-to-result latency of the fused detect pipeline.

    What a SYNCHRONOUS caller waits per request (one camera frame, one
    RPC): median/p99 of ``runs`` blocking round trips on device-staged
    inputs, per batch size, beside the async-pipelined amortised rate the
    throughput numbers are quoted at. The reference's analogue is its
    45 ms/frame end-to-end (22 FPS, ``README.md:11``). A round trip here is
    the launches, the device time, and the results' copy to pinned host
    buffers over PCIe with an event waited on. Returns a list of per-batch
    row dicts."""
    from tpu_cnn_torch.apps.infer import make_engine

    engine = make_engine(model, mode, device)
    if not hasattr(engine, "detect_batch_async"):
        raise ValueError(f"--latency measures a CUDAEngine backend, not "
                         f"{type(engine).__name__}")
    rng = np.random.RandomState(0)
    s = model.config.img_size
    rows = []
    for b in batches:
        imgs = rng.randint(0, 256, (b, s, s)).astype(np.uint8)
        staged = engine.stage_batch(imgs)
        engine.detect_resolve(engine.detect_batch_async(staged))  # warm-up
        lats = []
        for _ in range(runs):
            t0 = time.perf_counter()
            engine.detect_resolve(engine.detect_batch_async(staged))
            lats.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        handles = [engine.detect_batch_async(staged) for _ in range(runs)]
        for h in handles:
            engine.detect_resolve(h)
        amort = (time.perf_counter() - t0) / runs
        rows.append({
            "batch": b,
            "median_ms": float(np.median(lats)) * 1e3,
            "p99_ms": float(np.percentile(lats, 99)) * 1e3,
            "amortized_ms": amort * 1e3,
            "amortized_us_per_img": amort / b * 1e6,
        })
    return rows


def bench_camera_pipeline(model: FpgaCNN, mode: str, batch: int, runs: int,
                          cam_w: int, cam_h: int, channels: int = 4,
                          pitch: int | None = None, device: str = "cuda"):
    """Raw camera frames -> boxes, everything on the device: the device
    preprocess (``preprocess_frames``: center crop, BT.601 luma, area
    resize) then the engine's fused detect (``CUDAEngine.detect_device``,
    the kernels of its backend and the head), chained on device-resident
    tensors. Frames staged on the device, two pools in turns.
    ``channels`` 4 is the packed-BGRX ingest (one u32 word per pixel, the
    production layout; ``ops.luma.pack_bgrx``), 3 the plain
    (B, H, W, 3) u8 layout. ``pitch``: rows staged at a wider word pitch
    (V4L2 bytesperline-style padding), read up to ``cam_w``. Returns
    seconds per batch."""
    from tpu_cnn_torch.apps.infer import make_engine
    from tpu_cnn_torch.ops.preprocess import preprocess_frames

    engine = make_engine(model, mode, device)
    if not hasattr(engine, "detect_device"):
        raise ValueError(f"--camera-pipeline runs on a CUDAEngine backend, "
                         f"not {type(engine).__name__}")
    dev = engine.device

    def pipeline(frames):
        small = preprocess_frames(frames, model.config.img_size,
                                  valid_w=cam_w)
        _, _, pred, conf, _, bbox = engine.detect_device(small)
        return pred, conf, bbox

    rng = np.random.RandomState(0)
    pitch = cam_w if pitch is None else pitch
    if channels == 4:  # packed BGRX words (random bytes incl. pad), as int32
        pools = [rng.randint(0, 2**32, (batch, cam_h, pitch),
                             dtype=np.uint32).view(np.int32) for _ in range(2)]
    else:
        pools = [rng.randint(0, 256, (batch, cam_h, pitch, 3), dtype=np.uint8)
                 for _ in range(2)]
    pools = [torch.from_numpy(f).to(dev) for f in pools]
    calls = itertools.count()
    return _seconds_per_call(lambda: pipeline(pools[next(calls) % 2]), runs,
                             dev)


def main(argv=None):
    """The JAX CLI's flags plus ``--device``; returns the results dict, and
    exits 1 after the summary when a ``--modes`` entry failed."""
    from tpu_cnn_torch.apps.common import add_variant_arg, load_model
    from tpu_cnn_torch.apps.infer import make_engine
    from tpu_cnn_torch.utils.paths import default_artifacts
    from tpu_cnn_torch.utils.profiling import torch_trace

    p = argparse.ArgumentParser(description="CNN benchmark (PyTorch/CUDA port)")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions (the cpu mode ignores it)")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--modes", default="auto",
                   help="comma list of: auto, mega, hybrid, pallas, xla, "
                        "mesh, cpu (auto = production backend)")
    p.add_argument("--detect", dest="detect", action="store_true",
                   default=True,
                   help="benchmark the fused detect pipeline (the default: "
                        "only pred/conf/probs/boxes cross back to host)")
    p.add_argument("--features", dest="detect", action="store_false",
                   help="benchmark raw feature extraction instead: copies "
                        "the full (B, C, S'*S') feature map to the host, so "
                        "it measures the PCIe copy as well")
    p.add_argument("--per-layer", action="store_true",
                   help="per-layer device timings + MFU (arm_benchmark's "
                        "per-layer table, on the card)")
    p.add_argument("--camera-pipeline", action="store_true",
                   help="benchmark the FULL camera pipeline: on-device "
                        "preprocess (crop/gray/resize) chained with detect "
                        "— raw frames to boxes")
    p.add_argument("--cam-res", default="640x480")
    p.add_argument("--cam-channels", type=int, default=4, choices=(3, 4),
                   help="camera pixel format: 4 = BGRX packed words, "
                        "3 = plain BGR")
    p.add_argument("--cam-pitch", type=int, default=None,
                   help="stage camera rows at this word pitch (>= width; "
                        "V4L2 bytesperline-style), read up to the width")
    p.add_argument("--trace-dir", default=None,
                   help="with --camera-pipeline: capture a torch.profiler "
                        "trace of the measured loop (trace.json)")
    p.add_argument("--host-ingest", action="store_true",
                   help="benchmark the NATIVE host ingest: threaded "
                        "producers push raw camera frames through the C++ "
                        "frame ring (off-GIL preprocess), one consumer "
                        "drains engine batches")
    p.add_argument("--ingest-threads", type=int, default=4)
    p.add_argument("--train", action="store_true",
                   help="benchmark the phase-1 TRAIN step (fwd+bwd+Adam) "
                        "instead of inference: ms/step, img/s, train MFU")
    p.add_argument("--train-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="--train compute dtype (train_cnn --bf16 twin)")
    p.add_argument("--multi", action="store_true",
                   help="time the multi-object detect pipeline (one CAM box "
                        "per class) instead of the single-box head")
    p.add_argument("--instances", type=int, default=1,
                   help="with --multi: time the watershed instance head "
                        "(up to N component boxes per class)")
    p.add_argument("--latency", action="store_true",
                   help="synchronous dispatch-to-result latency per batch "
                        "size (median/p99) beside the async-pipelined "
                        "amortised rate — what one blocking caller waits "
                        "vs what the serving pipeline delivers")
    p.add_argument("--latency-batches", default="1,8,64,256,1024",
                   help="comma list of batch sizes for --latency")
    p.add_argument("--roofline", action="store_true",
                   help="print the fused detect's roofline: MAC and HBM "
                        "bounds per image on the card, the measured fused "
                        "time and its share of the bound")
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)

    print("=" * 64)
    print(f"  CNN BENCHMARK [{args.variant}] (PyTorch/CUDA port, "
          f"--device {args.device})")
    print("=" * 64)
    # shared loader: honours the bundle's persisted shifts.json — the
    # correctness side of this benchmark must classify with the shifts
    # the shipped head was trained at
    model = load_model(args.artifacts, args.variant)

    cfgs = model.config.layer_configs
    total_macs = macs_per_image(cfgs)
    for i, (ic, oc, size) in enumerate(cfgs):
        m = size * size * oc * ic * 9
        print(f"  Layer {i} ({ic:2d}->{oc:2d}ch {size}x{size}): {m / 1e6:6.1f}M MACs")
    print(f"  Total: {total_macs / 1e6:.1f}M MACs/image")

    rng = np.random.RandomState(0)
    s = model.config.img_size
    images = rng.randint(0, 256, size=(args.batch, s, s)).astype(np.uint8)

    if args.host_ingest:
        cam_w, cam_h = (int(v) for v in args.cam_res.split("x"))
        fps, dropped = bench_host_ingest(args.batch, args.runs, cam_w, cam_h,
                                         args.ingest_threads, out_size=s)
        print(f"\n  host ingest ({cam_w}x{cam_h}x3 -> {s}^2 gray, "
              f"{args.ingest_threads} producer threads, native ring): "
              f"{fps:12,.0f} frames/s  ({dropped} dropped)")
        return {"host_ingest": fps, "dropped": dropped}

    if args.train:
        ms, ips, mfu = bench_train(model, args.batch, args.runs,
                                   args.train_dtype, device=args.device)
        peak = "f32" if args.train_dtype == "float32" else "bf16 tensor-core"
        print(f"\n  train step ({args.train_dtype}, batch {args.batch}, "
              f"{args.runs}-step chain, {args.device}): {ms:8.2f} ms/step  "
              f"{ips:10,.0f} img/s  MFU {mfu:.1f}% (of the card's {peak} "
              f"peak)")
        return {"train_img_per_s": ips}

    if args.multi and not args.detect:
        p.error("--multi times the multi-object DETECT pipeline; it cannot "
                "combine with --features")
    if args.multi and (args.latency or args.per_layer
                       or args.camera_pipeline or args.roofline):
        p.error("--multi applies to the default throughput measurement "
                "only")
    if args.latency:
        mode = args.modes.split(",")[0].strip()
        if mode not in ("auto", "mega", "hybrid", "pallas", "xla"):
            p.error(f"--latency measures a CUDAEngine backend "
                    f"(auto/mega/hybrid/pallas/xla), not '{mode}'")
        batches = tuple(int(v) for v in args.latency_batches.split(","))
        rows = bench_latency(model, mode, args.runs, batches, args.device)
        link = ("the launches, the device time and the results' copy to "
                "pinned host buffers over PCIe, waited on"
                if args.device == "cuda" else "the plain versions on the host")
        print(f"\n  LATENCY — fused detect, backend '{mode}' on "
              f"{args.device} (a sync round trip is {link})")
        print(f"  {'batch':>6} {'sync med':>10} {'sync p99':>10} "
              f"{'pipelined':>10} {'us/img':>9}")
        for r in rows:
            print(f"  {r['batch']:>6} {r['median_ms']:>8.2f}ms "
                  f"{r['p99_ms']:>8.2f}ms {r['amortized_ms']:>8.2f}ms "
                  f"{r['amortized_us_per_img']:>9.2f}")
        return {"latency": rows}

    if args.roofline:
        return {"roofline": print_roofline(model, args.batch, args.runs,
                                           args.device)}

    if args.per_layer:
        mode = args.modes.split(",")[0].strip()
        mega_dt = None
        if mode in ("mega", "auto"):
            # The mega backend is one fused program per plan stage: a
            # per-layer split of it does not exist. Report the fused
            # whole-net number and time the decomposable xla path for the
            # layer table.
            mega_dt = bench_mega_fused(model, args.batch, args.runs,
                                       args.device)
            if mode == "mega" and mega_dt is None:
                print("\n  note: no megakernel plan for this geometry; "
                      "per-layer table uses the xla path")
            elif mode == "mega":
                print("\n  note: the mega backend is ONE fused kernel (or "
                      "the chained plan's two) — not layer-decomposable. "
                      "Fused whole-net time below; the per-layer table "
                      "times the xla path.")
            mode = "xla" if mode == "mega" else mode
        rows = bench_per_layer(model, mode, args.batch, args.runs, args.device)
        print(f"\n  per-layer timings ({mode}, batch {args.batch}, "
              f"{args.runs} runs, one event window each):")
        print(f"  {'layer':>6} {'geometry':>16} {'path':>7} {'ms/batch':>9} "
              f"{'us/img':>7} {'TMAC/s':>7} {'MFU%':>6}")
        total_us = 0.0
        for r in rows:
            geo = f"{r['ic']}->{r['oc']} @{r['size']}"
            print(f"  {str(r['layer']):>6} {geo:>16} {r['kind']:>7} "
                  f"{r['ms']:9.3f} {r['us_per_img']:7.2f} "
                  f"{r['tmacs']:7.2f} {r['mfu'] * 100:6.2f}")
            total_us += r["us_per_img"]
        fps = 1e6 / total_us
        print(f"  {'sum':>6} {'':>16} {'':>7} {'':>9} {total_us:7.2f}  "
              f"-> {fps:,.0f} FPS layer-sum bound "
              f"({fps / FPGA_FPS:,.0f}x reference)")
        mega_us = None
        if mega_dt is not None:
            mega_us = mega_dt / args.batch * 1e6
            macs = macs_per_image(model.config.layer_configs)
            mfu = macs / (mega_dt / args.batch) / PEAK_INT8_MACS
            print(f"  {'mega':>6} {'(whole net, fused)':>16} {'mega':>7} "
                  f"{mega_dt * 1e3:9.3f} {mega_us:7.2f} "
                  f"{macs / (mega_dt / args.batch) / 1e12:7.2f} "
                  f"{mfu * 100:6.2f}"
                  f"  -> {1e6 / mega_us:,.0f} FPS (no per-layer split "
                  f"exists)")
        return {"per_layer": rows, "mega_fused_us": mega_us}

    if args.camera_pipeline:
        cam_w, cam_h = (int(v) for v in args.cam_res.split("x"))
        mode = args.modes.split(",")[0].strip()
        if mode not in ("auto", "mega", "hybrid", "pallas", "xla"):
            p.error(f"--camera-pipeline runs on a CUDAEngine backend "
                    f"(auto/mega/hybrid/pallas/xla), not {mode!r}")
        if args.cam_pitch is not None and args.cam_pitch < cam_w:
            p.error(f"--cam-pitch {args.cam_pitch} < camera width {cam_w}")
        with torch_trace(args.trace_dir):
            dt = bench_camera_pipeline(model, mode, args.batch, args.runs,
                                       cam_w, cam_h, args.cam_channels,
                                       args.cam_pitch, args.device)
        fps = args.batch / dt
        pitch_s = f"@{args.cam_pitch}" if args.cam_pitch else ""
        print(f"\n  camera pipeline ({cam_w}x{cam_h}x{args.cam_channels}"
              f"{pitch_s} -> boxes, {mode}): "
              f"{dt * 1e3:9.3f} ms/batch{args.batch}  {fps:12,.0f} FPS  "
              f"({fps / FPGA_FPS:,.0f}x reference)")
        return {"camera_pipeline": fps}

    results, failed = {}, []
    for mode in args.modes.split(","):
        mode = mode.strip()
        try:
            engine = make_engine(model, mode, args.device)
            dt = bench_engine(engine, images, args.runs, args.detect,
                              multi=args.multi, instances=args.instances)
        except Exception as e:
            print(f"\n  {mode}: FAILED ({e})")
            failed.append(mode)
            continue
        fps = args.batch / dt
        results[mode] = fps
        print(f"\n  {mode:8s}: {dt * 1e3:9.3f} ms/batch{args.batch}  "
              f"{fps:12,.0f} FPS  {fps * total_macs / 1e12:8.2f} TMAC/s")
        print(f"  {'':8s}  vs FPGA 22 FPS end-to-end: {fps / FPGA_FPS:10,.0f}x")

    if results:
        best = max(results, key=results.get)
        print("\n" + "=" * 64)
        print(f"  BEST: {best} at {results[best]:,.0f} FPS "
              f"({results[best] / FPGA_FPS:,.0f}x the reference FPGA)")
        print("=" * 64)
    if failed:
        print(f"  {len(failed)} mode(s) FAILED: {', '.join(failed)}")
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
