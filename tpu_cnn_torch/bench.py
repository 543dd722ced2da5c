"""The headline bench without JAX: the port of ``bench.py``'s measurement
(``bench.py:94-186``; its gate, ``bench.py:38-91``, is ``bench_gate``).

    python -m tpu_cnn_torch.bench    # on the card: ONE JSON line on stdout

End-to-end batched fused-detect throughput on one card: the megakernel
(``csrc/mega_cnn.cu``: the whole lyr3-std net, its fused 4x4 bins and bf16
feature twin) and the CAM head's kernel (``csrc/cam_head.cu``, through
``ops.cam_head``: the classifier on the bins, the CAM box from the twin, in
one launch) over (1536, 128, 128) u8 frames, on ``CUDAEngine(backend="mega")``'s own device path
(``detect_device``) with the shipped bundle (``artifacts/pretrained``,
shifts 2/4/6): what users run, its weights packed once by the engine. As
``bench.py`` does it:

  1. the parity gate first, on the exact function timed with its u8
     features kept (28 shipped test images + 4 noise; ``bench_gate``): a
     mismatch prints the error line and exits 1. K1's launch shape depends
     on the geometry, not on the batch, so the 32-image gate runs the
     kernel code the 1536 batch runs;
  2. four (1536, 128, 128) pools drawn in turn from the ``RandomState(0)``
     made before the gate, staged on the card, and one synchronised call
     (the first call builds the kernel; that stays outside the window);
  3. 52 rounds over the pools, all dispatched first: each round's pred,
     conf and bbox start a device->host copy into pinned buffers, then an
     event is recorded; the window ends when every event has been waited
     on (bounded) and every result is numpy. Best of 3 passes;
  4. every timed round's results held equal to one synchronous call of
     the same path on its pool: a copy read before its event lands would
     look like a fast, correct run.

stdout carries one JSON line with ``bench.py``'s keys: ``metric``
``"end_to_end_fps"``, ``value``, ``unit`` ``"frames/sec"`` and
``vs_baseline`` against ``BASELINE_FPS``, the reference FPGA system's 22
FPS end-to-end rate (``BASELINE.md``). stderr carries the card's name and
power limit (``nvidia-smi``), the build and gate seconds, each pass's FPS
and, last, those details as one JSON object with the two kernels'
launches.

Nothing falls back: with no CUDA device ``main`` prints the error line and
exits 1, and a kernel that fails to build or launch raises. The work sits
in :func:`run`, whose device and sizes are parameters (the tests run it on
the CPU at a small size, on the kernels' plain versions); ``main`` runs
it at ``bench.py``'s sizes on the card.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from typing import Callable, Sequence

import numpy as np
import torch

from tpu_cnn_torch import bench_gate
from tpu_cnn_torch.apps.common import load_model
from tpu_cnn_torch.engine.cuda import CUDAEngine
from tpu_cnn_torch.ops import _build, cam_head, mega
from tpu_cnn_torch.utils.failguard import wait_event
from tpu_cnn_torch.utils.paths import default_artifacts

BASELINE_FPS = 22.0
# bench.py's sizes
BATCH = 1536
N_POOLS = 4
ROUNDS = 52
PASSES = 3
TIMEOUT_S = 300.0  # bound on each wait for a round's copies
SENTINEL = -1  # what a host buffer holds until its copy lands


def production_path(engine: CUDAEngine) -> Callable:
    """The gated function: (B, S, S) u8 images on the engine's device ->
    (feats, pooled, pred, conf, probs, bbox) on the device, through the
    engine's fused detect with the u8 features written too."""
    return functools.partial(engine.detect_device, with_feats=True)


def timed_path(engine: CUDAEngine) -> Callable:
    """The measured function (``bench.py``'s ``detect``): the production
    path, the same kernel outputs requested, with feats, pooled and probs
    dropped after it -> (pred, conf, bbox)."""
    path = production_path(engine)

    def detect(images: torch.Tensor):
        _, _, pred, conf, _, bbox = path(images)
        return pred, conf, bbox

    return detect


def draw_pools(rs: np.random.RandomState, batch: int = BATCH,
               n_pools: int = N_POOLS, img_size: int = 128) -> list[np.ndarray]:
    """``bench.py``'s frame pools: ``n_pools`` (batch, S, S) u8 draws from
    ``rs``, in turn."""
    return [rs.randint(0, 256, size=(batch, img_size, img_size)).astype(np.uint8)
            for _ in range(n_pools)]


def host_buffers(like: Sequence[torch.Tensor], rounds: int) -> list[tuple]:
    """Per round, one host buffer for each tensor of ``like``, filled with
    ``SENTINEL``: pinned when ``like`` lies on the card (a non_blocking
    copy into pageable memory is synchronous and would serialise the
    pipeline). Made before a timed window: a server amortises the pinned
    allocation."""
    pin = like[0].is_cuda
    return [tuple(torch.full(t.shape, SENTINEL, dtype=t.dtype, pin_memory=pin)
                  for t in like) for _ in range(rounds)]


def copy_async(host: Sequence[torch.Tensor], tensors: Sequence[torch.Tensor]):
    """Start the copies of ``tensors`` into ``host``; returns the handle
    :func:`wait_copies` completes. On the card: non_blocking copies into
    the pinned buffers, then an event recorded on the current stream (the
    pattern of ``CUDAEngine._to_host_async``). On the CPU, which has no
    copy engine, the wait makes the copies: there too a buffer holds its
    result only once its handle has been waited on."""
    if not tensors[0].is_cuda:
        return host, tuple(tensors)
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return host, event


def wait_copies(handle) -> tuple[np.ndarray, ...]:
    """Complete a :func:`copy_async` handle (a bounded wait on the card)
    -> the results as numpy (views of the host buffers)."""
    host, pending = handle
    if isinstance(pending, torch.cuda.Event):
        wait_event(pending, TIMEOUT_S, diagnostics=lambda: "bench round's copies")
    else:
        for h, t in zip(host, pending):
            h.copy_(t)
    return tuple(h.numpy() for h in host)


def pipelined(detect: Callable, like: Sequence[torch.Tensor], rounds: int) -> Callable:
    """A dispatch for one pass of :func:`measure`: ``detect`` on a pool,
    its results' copies started into the next of ``rounds`` sets of host
    buffers, made here, before the window."""
    buffers = iter(host_buffers(like, rounds))
    return lambda pool: copy_async(next(buffers), detect(pool))


def measure(dispatch: Callable, resolve: Callable, pools: Sequence, batch: int,
            rounds: int = ROUNDS) -> tuple[float, list]:
    """One pass of ``bench.py``'s async pipeline: ``rounds`` dispatches over
    ``pools`` in turn, all queued before the first is resolved; the window
    ends when every handle is resolved. Returns (frames/s, the resolved
    results in round order)."""
    t0 = time.perf_counter()
    handles = [dispatch(pools[i % len(pools)]) for i in range(rounds)]
    results = [resolve(h) for h in handles]
    dt = time.perf_counter() - t0
    return rounds * batch / dt, results


def error_line(err: str) -> dict:
    """``bench.py``'s line on a failure."""
    return {"metric": "end_to_end_fps", "value": 0.0, "unit": "frames/sec",
            "vs_baseline": 0.0, "error": err}


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(device: torch.device | str, art_dir: str | None = None,
        batch: int = BATCH, n_pools: int = N_POOLS, rounds: int = ROUNDS,
        passes: int = PASSES, n_real: int = 28, n_noise: int = 4) -> dict:
    """The bench on ``device`` (module docstring): returns the stdout line
    as a dict, with ``error`` on a gate or timed-results mismatch. On the
    CPU the engine runs the kernels' plain versions, for the tests."""
    device = torch.device(device)
    details: dict = {"device": str(device)}
    if device.type == "cuda":
        details["card"] = card()
        _log(details["card"])
        t0 = time.perf_counter()
        details["build_s"] = sum(_build.build(name)[2]
                                 for name in ("mega_cnn", "cam_head"))
        _log(f"build: mega_cnn and cam_head {details['build_s']!r} s of nvcc "
             f"(0 when cached), {time.perf_counter() - t0!r} s in all")
    art_dir = art_dir or default_artifacts()
    rs = np.random.RandomState(0)
    engine = CUDAEngine(load_model(art_dir), device, backend="mega")
    model, size = engine.model, engine.model.config.img_size
    path = production_path(engine)
    launches0 = {"mega_cnn": mega.launches, "cam_head": cam_head.launches}

    t0 = time.perf_counter()
    gate = bench_gate.load_gate_images(art_dir, n_real, n_noise, img_size=size)
    err = bench_gate.run_parity_gate(
        lambda g: path(torch.from_numpy(g).to(device)), model, gate,
        shifts=tuple(int(s) for s in model.shifts), img_size=size)
    if err is not None:
        return error_line(err)
    details["gate_s"] = time.perf_counter() - t0
    _log(f"gate: passed on {len(gate)} images in {details['gate_s']!r} s")

    detect = timed_path(engine)
    pools = [torch.from_numpy(a).to(device)
             for a in draw_pools(rs, batch, n_pools, size)]
    # the warm-up: one synchronous call per pool, each pool's answer for
    # the timed results (read by .cpu(), not through the timed copies)
    outs = [detect(p) for p in pools]
    want = [tuple(t.cpu().numpy() for t in o) for o in outs]

    fps, passes_results = [], []
    for i in range(passes):
        dispatch = pipelined(detect, outs[0], rounds)
        f, results = measure(dispatch, wait_copies, pools, batch, rounds)
        fps.append(f)
        passes_results.append(results)
        _log(f"pass {i + 1}: {f!r} FPS")
    for p, results in enumerate(passes_results):
        if len(results) != rounds:
            return error_line(f"pass {p + 1} resolved {len(results)} of "
                              f"{rounds} rounds")
        for r, got in enumerate(results):
            if not all(np.array_equal(g, w)
                       for g, w in zip(got, want[r % n_pools])):
                return error_line(
                    f"timed results differ from the synchronous call: pass "
                    f"{p + 1}, round {r} (pred, conf, bbox of pool "
                    f"{r % n_pools})")
    details.update(passes_fps=fps, launches={
        "mega_cnn": mega.launches - launches0["mega_cnn"],
        "cam_head": cam_head.launches - launches0["cam_head"]})
    _log(json.dumps(details))
    best = max(fps)
    return {"metric": "end_to_end_fps", "value": round(best, 1),
            "unit": "frames/sec", "vs_baseline": round(best / BASELINE_FPS, 1)}


def main() -> int:
    """``bench.py``'s ``main`` on the card: the stdout line; 0 on success,
    1 on a mismatch or with no CUDA device."""
    if torch.cuda.is_available():
        result = run(torch.device("cuda", 0))
    else:
        result = error_line("no CUDA device: the bench measures the card only")
    print(json.dumps(result), flush=True)
    return 1 if "error" in result else 0


if __name__ == "__main__":
    sys.exit(main())
