#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_cnn_torch``) end to end on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-out multi_profile.txt  # + profiler tables

Needs one CUDA device, ``nvcc`` (CUDA toolkit), ``g++`` (the native
oracle of the verify phase) and the repository around this file; it fails
with a non-zero exit code otherwise. Two model families run: lyr3-std
(128x128) and lyr4-wide (256x256), on four single-box main paths: each
family on the default ``mega`` backend (lyr3-std: the whole net in the
megakernel; lyr4-wide: the chained plan, the layer kernel for L0, then the
megakernel for L1-L3), lyr4-wide on ``pallas`` (every layer on the conv
kernel) and lyr3-std on ``hybrid`` (L0 on the conv kernel, L1-L2 plain);
then the bitcast probe's path, and two multi-object paths with the shipped
presence heads: lyr3-std on ``mega`` with ``--multi --instances 2`` (the
kernel's bins and twin, the instance head) and lyr4-wide on ``pallas``
with ``--multi`` (the features branch, the 256-pixel box scale). Phases,
one line each, in order; any failure raises:

  1. header   — the card (nvidia-smi name and power limit), torch, CUDA
  2. build    — nvcc builds csrc/mega_cnn.cu, csrc/conv_pool_layer.cu,
                csrc/conv_act.cu (the last two: the layer kernel of
                csrc/conv_layer.cuh, both on csrc/int8_mma.cuh like the
                megakernel) and csrc/bitcast.cu for sm_90a, in parallel
  3. kernel   — each kernel against its plain PyTorch version on the card,
                B=37. The megakernel: lyr3-std (shipped and seeded random
                weights, shifts 2/4/6 and 1/3/5, every with_feats/bins/twin
                combination), lyr3-tiny, lyr2-small, and lyr4-wide's L1-L3
                tail from a (B, 16, 128, 128) input; then the edges of its
                tensor-core path: all-255 images on all +127 and all -128
                weights and 0/255 images on ±127/-128 weights at shifts 0
                and 31, 3 input channels, a 128-channel middle layer, 35
                then 13 output channels, a 12-wide layer (no bins there),
                a one-channel middle layer and one-layer nets on both
                input paths. The layer kernel (conv_pool_layer):
                lyr4-wide's L0 (shipped and seeded weights, shifts 3 and
                0), 16->32 at 128^2 and two small odd geometries. The conv
                kernel, unpooled and (even maps) pooled: every layer of
                lyr3-std and lyr4-wide (shipped weights on the plain
                chain's activations at the model's shift, seeded weights
                at shifts 0 and 31), the rectangles 6x10 and 7x12 and
                20->35 across the channel chunks; then its pooled output
                against conv_pool_layer on lyr4-wide's L0. Then the
                tensor-core edges of all three entries: all-255 inputs on
                all +127 and all -128 weights and 0/255 inputs on
                +127/-128 weights at shifts 0 and 31, input channels
                1/3/20/64 against output channels 5/13/35/128 at 7x12,
                6x10 and 38x38, lyr4-wide's L3 (64->128 at 32^2). Every
                layer-kernel case runs with the weights packed per call
                and packed once. Then the lyr4-wide chain against the
                numpy oracle on 4 images. Features and twin bit-equal, bins within 1e-6; the
                plain f32 and int32 versions bit-equal to each other. The
                bitcast kernel's narrow, widen and roll (shifts 3, 0, -1,
                L+2) bit-equal at (8, 256), (5, 37), (1024, 4096) and
                (4096, 4096) on full-range words, and widen(narrow(x)) == x;
                narrow and widen on views misaligned for the vector path.
  4. engine   — CUDAEngine(device="cuda", backend=...) through the bench's
                parity gate on 28 shipped test images + 4 noise images,
                per path, and set_shifts against the oracle; on a multi
                path detect_multi_batch (direct and staged) on the same 32
                images against the host twins: boxes, instances and counts
                equal, probabilities and presence scores within 1e-4, the
                same detections
  5. cli      — tpu_cnn_torch.apps.infer --mode ... over the shipped test
                images, per path; accuracy equal to the numpy oracle's; on
                a multi path each image's "Detections" lines equal the
                host twins' (names and boxes; probabilities to the printed
                0.1%)
  6. server   — tpu_cnn_torch.apps.serve --mode ... behind HTTP on
                127.0.0.1, per path: 8 raw image POSTs, each answer equal
                to the host oracle's; on a multi path the "detections" too,
                one POST with ?thresh=0.3
  probe       — tpu_cnn_torch.apps.probe_bitcast --device cuda: exit 0,
                MATCH on the r*4+b layouts of Q1 and Q2 and on Q3
  verify      — tpu_cnn_torch.apps.verify --device cuda for lyr3-std
                (shipped weights) and lyr4-wide (seeded weights): all seven
                backends bit-exact and every engine head, multi boxes,
                instances and presence scores included, equal to the host
                twins; exit 0 and the verdict line
  7. times    — at batch 1536, CUDA events, median: lyr3-std's megakernel
                and its plain version, and the megakernel on lyr3-std's
                first layer alone; lyr4-wide's layer kernel, tail and
                chain and their plain versions, each with its bound (the
                card's int8 tensor-core and HBM peaks) and its share of
                it; the conv kernel on each
                lyr3-std layer and lyr4-wide's L0, unpooled and pooled,
                each with its bound, and its plain version; a
                torch.profiler list of the device kernels of the lyr3-std
                pallas pass (the conv kernel per layer, no torch pool);
                the async-pipelined engine detect FPS of each family on
                mega and of lyr3-std on pallas and hybrid; on lyr3-std/mega
                the multi detect FPS at instances 1 and 2 beside the
                single-box FPS, and a torch.profiler split of the instance
                head; the bitcast kernel and its plain version (one
                PyTorch call each, so also its library time) at
                (4096, 4096), past the L2, device time per call with the
                calls queued

Phases 4-6 and the probe are the main paths, once per path: every kernel
launch counter is set to 0 before a path's phases and read after them,
and each kernel of that path must have launched there and no other
kernel (lyr3-std/mega: the megakernel; lyr4-wide/mega: the megakernel and
the layer kernel; lyr4-wide/pallas and lyr3-std/hybrid: the conv kernel;
the probe: the bitcast kernel; the multi paths: the megakernel, then the
conv kernel). The line before the last is a JSON object with each
kernel's launches (summed over the paths), error, times and bound (and
the conv kernel's pooled time and bound on lyr3-std); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import glob
import hashlib
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

from tpu_cnn_torch import bench_gate  # noqa: E402
from tpu_cnn_torch.apps import infer, probe_bitcast, serve, verify  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.serve import ServiceHTTPServer, make_handler  # noqa: E402
from tpu_cnn_torch.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn_torch.engine.cuda import (DEFAULT_MULTI_THRESH, CUDAEngine,  # noqa: E402
                                       MultiDetectResult)
from tpu_cnn_torch.head.cam import cam_bbox_fast, cam_bbox_multi, cam_instances  # noqa: E402
from tpu_cnn_torch.head.classify import classify_np, multi_scores_np, pool_for_head  # noqa: E402
from tpu_cnn_torch.models.registry import default_shifts, get_config  # noqa: E402
from tpu_cnn_torch.ops import _build, bitcast, conv_pool, detect_head, int8, mega, quant  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402
from tpu_cnn_torch.utils.artifacts import label_from_filename  # noqa: E402

ARTIFACTS = {"lyr3-std": os.path.join(ROOT, "artifacts", "pretrained"),
             "lyr4-wide": os.path.join(ROOT, "artifacts", "pretrained-lyr4")}
KERNELS = {  # name -> (source, the TPU kernel(s) it replaces)
    "mega_cnn": ("tpu_cnn_torch/csrc/mega_cnn.cu",
                 "tpu_cnn/ops/pallas_poly.py:687"),  # cnn_forward_polyphase_pallas
    "conv_pool_layer": ("tpu_cnn_torch/csrc/conv_pool_layer.cu",
                        # conv_pool_layer_poly, conv_pool_layer_phase
                        "tpu_cnn/ops/pallas_poly.py:957,1160"),
    "conv_act": ("tpu_cnn_torch/csrc/conv_act.cu",
                 "tpu_cnn/ops/pallas_int8.py:150"),  # _conv_mxu
    "bitcast": ("tpu_cnn_torch/csrc/bitcast.cu",
                "scripts/probe_bitcast.py:35"),  # run (narrow, widen, roll)
}
# the main paths: (family, engine backend, the shifts set_shifts tries, the
# kernels the path must launch; it must launch no other)
PATHS = [("lyr3-std", "mega", (1, 3, 5), ("mega_cnn",)),
         ("lyr4-wide", "mega", (2, 4, 6, 8), ("mega_cnn", "conv_pool_layer")),
         ("lyr4-wide", "pallas", (2, 4, 6, 8), ("conv_act",)),
         ("lyr3-std", "hybrid", (1, 3, 5), ("conv_act",))]
# the multi-object paths: (family, backend, instances, kernels)
MULTI_PATHS = [("lyr3-std", "mega", 2, ("mega_cnn",)),
               ("lyr4-wide", "pallas", 1, ("conv_act",))]
MODULES = {"mega_cnn": mega, "conv_pool_layer": conv_pool, "conv_act": int8,
           "bitcast": bitcast}
SCORE_TOL = 1e-4  # probabilities and presence scores: 1024-term f32 dots
# the probe's; ragged; 16 MiB; 64 MiB of words, past the 50 MB L2 (timed)
BITCAST_SHAPES = ((8, 256), (5, 37), (1024, 4096), (4096, 4096))
VERDICT = "VERDICT: DESIGN IS BIT-ACCURATE across all backends"
BINS_TOL = 1e-6  # the kernel's bins vs the plain version's (1-ulp / order)
BENCH_BATCH = 1536  # bench.py's batch
KERNEL_BATCH = 37  # the kernel cases' batch: not a multiple of any tile
COMBOS = [c for c in itertools.product((True, False), repeat=3) if any(c)]
# the card's published dense peaks (NVIDIA H100 SXM data sheet, at 700 W):
# int8 tensor cores 1,979 T op/s (a MAC is two), HBM3 3.35 TB/s
PEAK_INT8_MACS = 1979e12 / 2
PEAK_HBM_BYTES = 3.35e12


def macs_per_image(layer_configs) -> int:
    return sum(oc * ic * 9 * s * s for ic, oc, s in layer_configs)


def bound(macs: float, nbytes: float) -> tuple[float, str]:
    """The least ms the card could take for ``macs`` int8 multiply-adds on
    inputs and outputs of ``nbytes`` (each read or written once), and the
    limit that sets it: "operations" or "bytes"."""
    ops_ms = macs / PEAK_INT8_MACS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def layers_bound(layer_configs, batch: int, out_bytes: int,
                 calls: str = "net") -> tuple[float, str]:
    """``bound`` of a stack of contract layers at ``batch``. ``calls``:
    "net", one call for the stack (the megakernel, the layer kernel): the
    first layer's u8 input, the weights and ``out_bytes`` per image of
    output; "unpooled" or "pooled", each layer its own call of the conv
    kernel (its input read, its output written: ``oc * s^2`` unpooled,
    ``oc * (s/2)^2`` pooled), and the bounds add up."""
    weights = sum(oc * ic * 9 for ic, oc, _ in layer_configs)
    if calls == "net":
        ic, _, s = layer_configs[0]
        return bound(macs_per_image(layer_configs) * batch,
                     ic * s * s * batch + weights + out_bytes * batch)
    div = 4 if calls == "pooled" else 1
    parts = [bound(oc * ic * 9 * s * s * batch,
                   (ic * s * s + oc * s * s // div) * batch + oc * ic * 9)
             for ic, oc, s in layer_configs]
    kinds = {k for _, k in parts}
    return sum(t for t, _ in parts), kinds.pop() if len(kinds) == 1 else "mixed"


def detect_out_bytes(layer_configs) -> int:
    """Per image, the megakernel's detect outputs: the bf16 twin and the
    f32 bins of the final map."""
    _, oc, s = layer_configs[-1]
    return oc * (s // 2) ** 2 * 2 + oc * 16 * 4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bundle_of(variant: str):
    return art.load_bundle(ARTIFACTS[variant],
                           layer_configs=get_config(variant).layer_configs)


def shipped_images(variant: str) -> list[str]:
    return sorted(glob.glob(os.path.join(ARTIFACTS[variant], "test_image_*.bin")))


_ORACLE: dict[bytes, np.ndarray] = {}


def oracle_feats(images, kernels, shifts) -> np.ndarray:
    """numpy_cnn_forward per image, (N, oc, P*P) u8. Runs on a pool of
    threads (numpy's tensordot leaves the GIL) and remembers each result by
    image, kernels and shifts: the lyr4-wide oracle takes ~1.5 s an image."""
    shifts = tuple(int(s) for s in shifts)
    wkey = b"".join(np.ascontiguousarray(k).tobytes() for k in kernels)
    keys = [hashlib.sha256(np.ascontiguousarray(im).tobytes() + wkey
                           + repr(shifts).encode()).digest() for im in images]
    todo = {k: im for k, im in zip(keys, images) if k not in _ORACLE}
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for k, f in zip(todo, pool.map(
                lambda im: numpy_cnn_forward(im, kernels, shifts), todo.values())):
            _ORACLE[k] = f
    return np.stack([_ORACLE[k] for k in keys])


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
    """One nvcc per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for module in MODULES.values():  # load each library, bind its entry points
        module._lib()
    for name, (_lib, log, secs) in built.items():
        ptxas = " ".join(line.split("info    : ", 1)[-1]
                         for line in log.splitlines()
                         if "registers" in line or "stack frame" in line)
        phase("2 build", f"nvcc sm_90a {KERNELS[name][0]}: {secs:.2f} s; {ptxas}")


def _random_kernels(rs, layer_configs):
    return [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
            for ic, oc, _ in layer_configs]


def _check_mega_outputs(tag, got, ref, flags) -> float:
    """The wrapper's return for ``flags`` against (feats, bins, twin) of the
    plain version. Returns the largest absolute difference."""
    ref_feats, ref_bins, ref_twin = ref
    got = list(got) if isinstance(got, tuple) else [got]
    wf, wb, wt = flags
    err = 0.0
    if wf:
        f = got.pop(0)
        check(torch.equal(f, ref_feats), f"{tag}: features differ")
        err = max(err, (f.int() - ref_feats.int()).abs().max().item())
    if wb:
        b = got.pop(0)
        e = (b - ref_bins).abs().max().item()
        check(e <= BINS_TOL, f"{tag}: bins off by {e}")
        err = max(err, e)
    if wt:
        t = got.pop(0)
        check(t.dtype == torch.bfloat16 and torch.equal(t, ref_twin)
              and torch.equal(t.float(), ref_feats.float()),
              f"{tag}: twin differs from the features")
    return err


def _mma_edge_setups(rs) -> list:
    """Megakernel cases at the edges of its tensor-core path: saturating
    and most negative sums (all-255 images against all +127 and all -128
    weights, and random 0/255 images against random ±127/-128 weights) at
    shifts 0 and 31; an input of 3 channels (padded to 16 in K), the
    runtime-chunk path (a 128-channel middle layer), an output of 35 then
    13 channels (padded N tiles), column groups cut by the map's edge (a
    12-wide layer), a one-channel middle layer (one byte a pixel in
    shared memory) and one-layer nets on both input paths (one byte a
    pixel, staged by words or, 30 wide, by bytes; and 16 channels in
    bands)."""
    cfg3 = get_config("lyr3-std").layer_configs
    b, setups = KERNEL_BATCH, []
    sat = np.full((b, 128, 128), 255, np.uint8)
    for fill in (127, -128):
        ks = [np.full((oc, ic, 3, 3), fill, np.int8) for ic, oc, _ in cfg3]
        for sh in ((0, 0, 0), (31, 31, 31)):
            setups.append((f"all-255 x {fill}/{sh}", sat, ks, sh))
    imgs = (rs.randint(0, 2, (b, 128, 128)) * 255).astype(np.uint8)
    ks = [np.where(rs.randint(0, 2, (oc, ic, 3, 3)) == 1, 127, -128).astype(np.int8)
          for ic, oc, _ in cfg3]
    for sh in ((0, 0, 0), (31, 31, 31), (9, 11, 13)):
        setups.append((f"0/255 x 127/-128/{sh}", imgs, ks, sh))
    for name, ic0, s, chans, sh in (
            ("ic0=3 3->24->8@32", 3, 32, (24, 8), (3, 5)),
            ("wide middle 16->128->16@16", 16, 16, (128, 16), (4, 9)),
            ("padded N 1->35->13@32", 1, 32, (35, 13), (2, 6)),
            ("ragged 1->16->24@24", 1, 24, (16, 24), (2, 5)),
            ("one-channel middle 1->1->16@32", 1, 32, (1, 16), (1, 3)),
            ("one layer 1->16@64", 1, 64, (16,), (3,)),
            ("one layer 1->16@30", 1, 30, (16,), (2,)),
            ("one layer 16->32@32", 16, 32, (32,), (6,))):
        shape = (b, s, s) if ic0 == 1 else (b, ic0, s, s)
        ics = (ic0,) + chans[:-1]
        ks = [rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
              for ic, oc in zip(ics, chans)]
        setups.append((name, rs.randint(0, 256, shape).astype(np.uint8), ks, sh))
    return setups


def mega_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The megakernel against mega_reference on the same card tensors:
    whole nets, and lyr4-wide's L1-L3 tail on a 4-D input. Returns (largest
    absolute difference, cases)."""
    art3 = ARTIFACTS["lyr3-std"]
    bundle = art.load_bundle(art3)
    gate = bench_gate.load_gate_images(art3, n_real=28, n_noise=9)  # B = 37
    rs = np.random.RandomState(7)
    setups = [(f"lyr3-std/{w}/{sh}", gate, ks, sh)
              for w, ks in (("shipped", bundle.kernels),
                            ("seed7", _random_kernels(
                                rs, get_config("lyr3-std").layer_configs)))
              for sh in ((2, 4, 6), (1, 3, 5))]
    for name in ("lyr3-tiny", "lyr2-small"):
        s = get_config(name).img_size
        setups.append((name, rs.randint(0, 256, (KERNEL_BATCH, s, s)).astype(np.uint8),
                       _random_kernels(rs, get_config(name).layer_configs),
                       tuple(default_shifts(get_config(name)))))
    tail_cfgs = get_config("lyr4-wide").layer_configs[1:]
    x16 = rs.randint(0, 256, (KERNEL_BATCH, 16, 128, 128)).astype(np.uint8)
    for w, ks in (("shipped", bundle_of("lyr4-wide").kernels[1:]),
                  ("seed7", _random_kernels(rs, tail_cfgs))):
        setups.append((f"lyr4-wide-tail/{w}", x16, ks, (5, 5, 7)))
    setups += _mma_edge_setups(rs)
    max_err, n_cases = 0.0, 0
    for name, imgs_np, ks_np, sh in setups:
        imgs = torch.from_numpy(imgs_np).to(dev)
        ks = [torch.from_numpy(k).to(dev) for k in ks_np]
        shifts = torch.tensor(sh, dtype=torch.int32, device=dev)
        ref = mega.mega_reference(imgs, ks, shifts)
        int_feats = mega.mega_reference(imgs, ks, shifts, compute_dtype="int32")[0]
        torch.cuda.synchronize()
        check(torch.equal(ref[0], int_feats),
              f"{name}: plain f32 and int32 paths disagree on the card")
        if imgs_np.ndim == 3:
            oracle = oracle_feats(imgs_np[:4], ks_np, sh)
            check(np.array_equal(ref[0][:4].cpu().numpy(), oracle),
                  f"{name}: plain version disagrees with the numpy oracle")
        final = imgs_np.shape[-1] >> len(ks_np)
        for flags in COMBOS:
            if flags[1] and final % 4:
                continue  # bins need a final map divisible by 4
            out = mega.cnn_forward_mega(imgs, ks, shifts, with_feats=flags[0],
                                        with_bins=flags[1], with_twin=flags[2])
            torch.cuda.synchronize()
            tag = f"{name} feats={flags[0]} bins={flags[1]} twin={flags[2]}"
            max_err = max(max_err, _check_mega_outputs(tag, out, ref, flags))
            n_cases += 1
    return max_err, n_cases


def layer_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The layer kernel against conv_pool_reference on the same card
    tensors. Returns (largest absolute difference, cases)."""
    rs = np.random.RandomState(8)
    gate = bench_gate.load_gate_images(ARTIFACTS["lyr4-wide"], n_real=28,
                                       n_noise=9, img_size=256)[:, None]
    k0 = bundle_of("lyr4-wide").kernels[0]
    setups = [(f"lyr4-wide-L0/{w}/{sh}", gate, k, sh)
              for w, k in (("shipped", k0),
                           ("seed8", rs.randint(-127, 128, k0.shape).astype(np.int8)))
              for sh in (3, 0)]
    for ic, oc, s, sh in ((16, 32, 128, 5), (20, 35, 38, 4), (3, 5, 10, 2)):
        setups.append((f"{ic}->{oc}@{s}/{sh}",
                       rs.randint(0, 256, (KERNEL_BATCH, ic, s, s)).astype(np.uint8),
                       rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8), sh))
    max_err, n_cases = 0.0, 0
    for name, x_np, k_np, sh in setups:
        x = torch.from_numpy(x_np).to(dev)
        k = torch.from_numpy(k_np).to(dev)
        shifts = torch.tensor([7, sh], dtype=torch.int32, device=dev)  # layer 1
        ref = conv_pool.conv_pool_reference(x, k, shifts, 1)
        ref_int = conv_pool.conv_pool_reference(x, k, shifts, 1,
                                                compute_dtype="int32")
        torch.cuda.synchronize()
        check(torch.equal(ref, ref_int),
              f"{name}: plain f32 and int32 paths disagree on the card")
        for packed in (None, mega.pack_layer(k)):
            got = conv_pool.conv_pool_layer(x, k, shifts, 1, packed=packed)
            torch.cuda.synchronize()
            check(got.dtype == torch.uint8 and torch.equal(got, ref),
                  f"{name} packed={packed is not None}: layer kernel differs "
                  f"from its plain version")
            max_err = max(max_err, (got.int() - ref.int()).abs().max().item())
            n_cases += 1
    return max_err, n_cases


def act_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The conv kernel against conv_act_reference on the same card tensors:
    every layer of lyr3-std and lyr4-wide, with the shipped weights on the
    plain chain's activations of the gate images at the model's shift and
    with seeded weights on noise at shifts 0 and 31; two rectangles and
    20->35 across the channel chunks. Then its pooled output against the
    layer kernel on lyr4-wide's L0. Returns (largest absolute difference,
    cases)."""
    rs = np.random.RandomState(9)
    setups = []  # (name, x on the card, kernel (numpy), shift)
    for variant in ARTIFACTS:
        model = load_model(ARTIFACTS[variant], variant)
        x = torch.from_numpy(bench_gate.load_gate_images(
            ARTIFACTS[variant], n_real=28, n_noise=9,
            img_size=model.config.img_size)[:, None]).to(dev)  # B = 37
        shifts = torch.from_numpy(model.shifts).to(dev)
        for li, (ic, oc, s) in enumerate(model.config.layer_configs):
            setups.append((f"{variant}-L{li}/shipped/{model.shifts[li]}", x,
                           model.kernels[li], int(model.shifts[li])))
            noise = torch.from_numpy(rs.randint(
                0, 256, (KERNEL_BATCH, ic, s, s)).astype(np.uint8)).to(dev)
            k = rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
            setups += [(f"{variant}-L{li}/seed9/{sh}", noise, k, sh)
                       for sh in (0, 31)]
            x = conv_pool.conv_pool_reference(
                x, torch.from_numpy(model.kernels[li]).to(dev), shifts, li,
                compute_dtype="int32")
    for ic, oc, h, w in ((3, 5, 6, 10), (4, 7, 7, 12), (20, 35, 38, 38)):
        setups.append((f"{ic}->{oc}@{h}x{w}/3", torch.from_numpy(rs.randint(
            0, 256, (KERNEL_BATCH, ic, h, w)).astype(np.uint8)).to(dev),
            rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8), 3))
    max_err, n_cases = 0.0, 0
    for name, x, k_np, sh in setups:
        k = torch.from_numpy(k_np).to(dev)
        shifts = torch.tensor([7, sh], dtype=torch.int32, device=dev)  # layer 1
        ref = int8.conv_act_reference(x, k, shifts, 1)
        ref_int = int8.conv_act_reference(x, k, shifts, 1, compute_dtype="int32")
        torch.cuda.synchronize()
        check(torch.equal(ref, ref_int),
              f"{name}: plain f32 and int32 paths disagree on the card")
        err, n = _conv_entries(name, x, k, shifts, 1, ref)
        max_err, n_cases = max(max_err, err), n_cases + n

    # two hand-written kernels on one function: conv + pool, lyr4-wide L0
    model = load_model(ARTIFACTS["lyr4-wide"], "lyr4-wide")
    x = torch.from_numpy(bench_gate.load_gate_images(
        ARTIFACTS["lyr4-wide"], n_real=28, n_noise=9, img_size=256)[:, None]).to(dev)
    k = torch.from_numpy(model.kernels[0]).to(dev)
    shifts = torch.from_numpy(model.shifts).to(dev)
    pooled = int8.fused_conv_layer(x, k, shifts, 0)
    layer = conv_pool.conv_pool_layer(x, k, shifts, 0)
    torch.cuda.synchronize()
    check(torch.equal(pooled, layer), "lyr4-wide L0: pooled conv kernel "
                                      "differs from the layer kernel")
    return max_err, n_cases


def _conv_entries(name, x, k, shifts, layer, ref) -> tuple[float, int]:
    """The conv kernel's unpooled entry and, for an even H and W, its
    pooled entry (``fused_conv_layer``), each with the weights packed per
    call and packed once, against ``ref`` (the plain unpooled conv) and
    its 2x2 max. Returns (largest absolute difference, cases)."""
    h, w = x.shape[-2:]
    want = {"unpooled": ref}
    if h % 2 == 0 and w % 2 == 0:
        want["pooled"] = quant.maxpool2x2(ref)
    max_err, n = 0.0, 0
    for packed in (None, mega.pack_layer(k)):
        for entry, ref_out in want.items():
            fn = int8.conv_act if entry == "unpooled" else int8.fused_conv_layer
            got = fn(x, k, shifts, layer, packed=packed)
            torch.cuda.synchronize()
            check(got.dtype == torch.uint8 and torch.equal(got, ref_out),
                  f"{name} {entry} packed={packed is not None}: conv kernel "
                  f"differs from its plain version")
            max_err = max(max_err, (got.int() - ref_out.int()).abs().max().item())
            n += 1
    return max_err, n


def layer_edges(dev: torch.device) -> tuple[float, int, float, int]:
    """The layer kernel's tensor-core edges, B=37, through all three of
    its entries (the conv kernel unpooled and pooled, and conv_pool_layer
    for a square map), each with the weights packed per call and once:
    all-255 inputs on all +127 and on all -128 weights and 0/255 inputs
    on random +127/-128 weights, at shifts 0 and 31, on one-channel,
    16-channel and 64-channel layers; then input channels 1, 3, 20 and 64
    (K padded) against output channels 5, 13, 35 and 128 (N tiles padded)
    on the rectangles 7x12 (unpooled) and 6x10 and on 38x38, and
    lyr4-wide's L3 (64 -> 128 at 32^2). Returns (the conv kernel's largest
    absolute difference, its cases, the layer kernel's, its cases)."""
    rs = np.random.RandomState(11)
    b, setups = KERNEL_BATCH, []
    for ic, oc in ((1, 16), (16, 32), (64, 128)):
        sat = np.full((b, ic, 32, 32), 255, np.uint8)
        bits = (rs.randint(0, 2, (b, ic, 32, 32)) * 255).astype(np.uint8)
        for fill in (127, -128):
            setups.append((f"all-255 x {fill} {ic}->{oc}", sat,
                           np.full((oc, ic, 3, 3), fill, np.int8), (0, 31)))
        setups.append((f"0/255 x 127/-128 {ic}->{oc}", bits, np.where(
            rs.randint(0, 2, (oc, ic, 3, 3)) == 1, 127, -128).astype(np.int8),
            (0, 31)))
    for ic, oc, h, w in ((1, 5, 7, 12), (3, 13, 7, 12), (20, 35, 7, 12),
                         (64, 128, 7, 12), (1, 35, 6, 10), (3, 128, 6, 10),
                         (20, 5, 6, 10), (64, 13, 6, 10), (1, 128, 38, 38),
                         (3, 35, 38, 38), (20, 13, 38, 38), (64, 5, 38, 38),
                         (64, 128, 32, 32)):
        setups.append((f"{ic}->{oc}@{h}x{w}",
                       rs.randint(0, 256, (b, ic, h, w)).astype(np.uint8),
                       rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8), (3,)))
    act_err = layer_err = 0.0
    act_n = layer_n = 0
    for name, x_np, k_np, shift_set in setups:
        x = torch.from_numpy(x_np).to(dev)
        k = torch.from_numpy(k_np).to(dev)
        h, w = x_np.shape[-2:]
        for sh in shift_set:
            shifts = torch.tensor([sh], dtype=torch.int32, device=dev)
            ref = int8.conv_act_reference(x, k, shifts, 0, compute_dtype="int32")
            err, n = _conv_entries(f"{name}/{sh}", x, k, shifts, 0, ref)
            act_err, act_n = max(act_err, err), act_n + n
            if h == w and h % 2 == 0:
                want = quant.maxpool2x2(ref)
                for packed in (None, mega.pack_layer(k)):
                    got = conv_pool.conv_pool_layer(x, k, shifts, 0, packed=packed)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"{name}/{sh} packed="
                          f"{packed is not None}: layer kernel differs")
                    layer_err = max(layer_err, (got.int() - want.int()).abs().max().item())
                    layer_n += 1
    return act_err, act_n, layer_err, layer_n


def chain_vs_oracle(dev: torch.device) -> None:
    """The lyr4-wide chain (layer kernel, then the tail) on 4 shipped test
    images against the numpy oracle and the plain chain."""
    bundle = bundle_of("lyr4-wide")
    sh = load_model(ARTIFACTS["lyr4-wide"], "lyr4-wide").shifts
    imgs_np = np.stack([np.fromfile(p, np.uint8).reshape(256, 256)
                        for p in shipped_images("lyr4-wide")[:4]])
    imgs = torch.from_numpy(imgs_np).to(dev)
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    shifts = torch.from_numpy(np.asarray(sh, np.int32)).to(dev)
    ref = mega.mega_reference(imgs, ks, shifts)
    out = mega.cnn_forward_mega(imgs, ks, shifts, with_feats=True,
                                with_bins=True, with_twin=True)
    torch.cuda.synchronize()
    _check_mega_outputs("lyr4-wide chain", out, ref, (True, True, True))
    check(np.array_equal(out[0].cpu().numpy(),
                         oracle_feats(imgs_np, bundle.kernels, sh)),
          "lyr4-wide chain disagrees with the numpy oracle")


def bitcast_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The bitcast kernel's three functions against their plain versions
    on the same card tensors, bit for bit. Returns (largest absolute
    difference, cases)."""
    rs = np.random.RandomState(10)
    max_err, n_cases = 0, 0

    def same(tag, got, want):
        nonlocal max_err, n_cases
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(got, want), f"bitcast {tag}: differs")
        max_err = max(max_err, (got.long() - want.long()).abs().max().item())
        n_cases += 1

    for r, l in BITCAST_SHAPES:
        words = rs.randint(-2**31, 2**31, (r, l), dtype=np.int64).astype(np.int32)
        words.reshape(-1)[:4] = (-2**31, 2**31 - 1, 0, -1)  # the extremes
        x = torch.from_numpy(words).to(dev)
        x8 = torch.from_numpy(rs.randint(0, 256, (4 * r, l)).astype(np.uint8)).to(dev)
        narrow = bitcast.narrow_i32_to_i8(x)
        same(f"narrow {r}x{l}", narrow, bitcast.narrow_i32_to_i8_reference(x))
        same(f"widen {r}x{l}", bitcast.widen_u8_to_i32(x8),
             bitcast.widen_u8_to_i32_reference(x8))
        same(f"widen(narrow(x)) {r}x{l}", bitcast.widen_u8_to_i32(narrow), x)
        for k in (3, 0, -1, l + 2):
            same(f"roll {k} {r}x{l}", bitcast.packed_roll(x, k),
                 bitcast.packed_roll_reference(x, k))
    # views one element into their storage, at a width that is a multiple
    # of 4: misaligned for the vector path, so the one-word path runs
    flat = torch.from_numpy(rs.randint(-2**31, 2**31, 8 * 64 + 1, dtype=np.int64)
                            .astype(np.int32)).to(dev)
    x = flat[1:].view(8, 64)
    x8 = flat.view(torch.uint8)[1:4 * 8 * 64 + 1].view(32, 64)
    same("narrow offset view", bitcast.narrow_i32_to_i8(x),
         bitcast.narrow_i32_to_i8_reference(x))
    same("widen offset view", bitcast.widen_u8_to_i32(x8),
         bitcast.widen_u8_to_i32_reference(x8))
    return float(max_err), n_cases


def kernel_vs_plain(dev: torch.device) -> dict[str, float]:
    mega_err, mega_cases = mega_vs_plain(dev)
    phase("3 kernel", f"mega_cnn: {mega_cases} cases (B={KERNEL_BATCH}) "
                      f"bit-equal feats/twin, bins within {BINS_TOL}; "
                      f"max_abs_err={mega_err!r}")
    layer_err, layer_cases = layer_vs_plain(dev)
    phase("3 kernel", f"conv_pool_layer: {layer_cases} cases (B={KERNEL_BATCH}; "
                      f"weights packed per call and once) bit-equal; "
                      f"max_abs_err={layer_err!r}")
    act_err, act_cases = act_vs_plain(dev)
    phase("3 kernel", f"conv_act: {act_cases} cases (B={KERNEL_BATCH}; the "
                      f"unpooled and, for an even map, the pooled entry, "
                      f"weights packed per call and once) bit-equal; "
                      f"max_abs_err={act_err!r}; pooled, bit-equal to "
                      f"conv_pool_layer on lyr4-wide's L0")
    edge_act_err, edge_act, edge_layer_err, edge_layer = layer_edges(dev)
    phase("3 kernel", f"layer kernel edges (all-255 x +127/-128 and 0/255 x "
                      f"+127/-128 at shifts 0 and 31; ic 1/3/20/64 x oc "
                      f"5/13/35/128 at 7x12, 6x10 and 38x38; 64->128 at 32^2): "
                      f"conv_act {edge_act} and conv_pool_layer {edge_layer} "
                      f"cases bit-equal; max_abs_err={max(edge_act_err, edge_layer_err)!r}")
    act_err = max(act_err, edge_act_err)
    layer_err = max(layer_err, edge_layer_err)
    chain_vs_oracle(dev)
    phase("3 kernel", "lyr4-wide chain on 4 shipped images: bit-equal to the "
                      "numpy oracle and the plain chain")
    bit_err, bit_cases = bitcast_vs_plain(dev)
    phase("3 kernel", f"bitcast: {bit_cases} cases (narrow, widen, "
                      f"widen(narrow), roll 3/0/-1/L+2 at {BITCAST_SHAPES}; "
                      f"narrow and widen on offset views) bit-equal; "
                      f"max_abs_err={bit_err!r}")
    return {"mega_cnn": mega_err, "conv_pool_layer": layer_err,
            "conv_act": act_err, "bitcast": bit_err}


def engine_gate(variant: str, backend: str,
                alt_shifts: tuple[int, ...]) -> None:
    art_dir = ARTIFACTS[variant]
    bundle = bundle_of(variant)
    model = load_model(art_dir, variant)
    shifts, size = tuple(int(s) for s in model.shifts), model.config.img_size
    engine = CUDAEngine(model, device="cuda", backend=backend)
    gate = bench_gate.load_gate_images(art_dir, img_size=size)
    err = bench_gate.run_parity_gate(engine.detect_with_features, bundle, gate,
                                     shifts=shifts, img_size=size)
    check(err is None, f"{variant} engine parity gate: {err}")
    res = engine.detect_batch(gate)  # the detect path proper: no u8 store
    _, _, pred, _, _, bbox = engine.detect_with_features(gate)
    check(np.array_equal(res.pred, pred) and np.array_equal(res.bbox, bbox),
          f"{variant}: detect_batch disagrees with the gated path")
    engine.set_shifts(*alt_shifts)
    feats = engine.run_batch(gate[:4])
    want = oracle_feats(gate[:4], bundle.kernels, alt_shifts)
    check(np.array_equal(feats, want), f"{variant}: set_shifts{alt_shifts} "
                                       f"features differ")
    engine.set_shifts(*shifts)
    check(engine.launches > 0, f"{variant}: the engine launched no kernel")
    phase("4 engine", f"{variant} ({engine.backend}, shifts {shifts}): parity "
                      f"gate passed on {len(gate)} images; set_shifts"
                      f"{alt_shifts} checked; engine launches={engine.launches}")


def cli(variant: str, mode: str) -> None:
    art_dir = ARTIFACTS[variant]
    paths = shipped_images(variant)
    bundle = bundle_of(variant)
    shifts = load_model(art_dir, variant).shifts
    feats = oracle_feats([np.fromfile(p, np.uint8) for p in paths],
                         bundle.kernels, shifts)
    pred = classify_np(feats, bundle.fc_weight, bundle.fc_bias)[0]
    want = sum(int(p == label_from_filename(f)) for p, f in zip(pred, paths))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(["--variant", variant, "--image-dir", art_dir,
                    "--device", "cuda", "--mode", mode, "--no-save"])
    line = next(ln.strip() for ln in out.getvalue().splitlines()
                if "Accuracy:" in ln)
    check(line.startswith(f"Accuracy: {want}/{len(paths)} "),
          f"{variant} --mode {mode} CLI '{line}' != the oracle's "
          f"{want}/{len(paths)}")
    phase("5 cli", f"tpu_cnn_torch.apps.infer --variant {variant} --mode "
                   f"{mode}: {line} (numpy oracle: {want}/{len(paths)})")


@contextlib.contextmanager
def http_service(batcher, backend):
    """The batcher behind HTTP on an ephemeral loopback port; yields
    request(method, path, body) -> (status, JSON). Stops both after."""
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
        yield request
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        th.join(timeout=10)


def server(variant: str, mode: str) -> None:
    bundle = bundle_of(variant)
    model = load_model(ARTIFACTS[variant], variant)
    size = model.config.img_size
    paths = shipped_images(variant)[:8]
    batcher, backend = serve.build_service(ARTIFACTS[variant], device="cuda",
                                           max_batch=8, variant=variant,
                                           mode=mode)
    with http_service(batcher, backend) as request:
        bodies = [open(p, "rb").read() for p in paths]
        check(all(len(b) == size * size for b in bodies),
              f"{variant}: test images are not {size}x{size}")
        feats = oracle_feats([np.frombuffer(b, np.uint8) for b in bodies],
                             bundle.kernels, model.shifts)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda b: request("POST", "/detect", b), bodies))
        for p, f, (status, ans) in zip(paths, feats, answers):
            idx = int(classify_np(f[None], bundle.fc_weight, bundle.fc_bias)[0][0])
            box = list(cam_bbox_fast(f, idx, bundle.fc_weight, img_size=size))
            check(status == 200 and ans["pred"] == idx and ans["bbox"] == box,
                  f"{variant} {os.path.basename(p)}: server {status} {ans} != "
                  f"oracle pred {idx} bbox {box}")
        status, health = request("GET", "/healthz")
        check(status == 200 and health.get("ok") is True, f"/healthz: {health}")
        stats = batcher.snapshot()
    phase("6 server", f"{variant} ({backend}): {len(paths)} POST /detect of "
                      f"{size * size} "
                      f"bytes equal to the host oracle; /healthz {health}; "
                      f"batches={stats['batches']} requests={stats['requests']}")


# ── the multi-object paths ───────────────────────────────────────────


def host_multi(feats: np.ndarray, model, instances: int) -> MultiDetectResult:
    """The host twins' multi-object result for (N, C, P) u8 features: the
    numpy classifier and presence head, cam_bbox_multi, cam_instances."""
    fcw, size = model.fc_weight, model.config.img_size
    pred, conf, probs = classify_np(feats, fcw, model.fc_bias)
    scores = (multi_scores_np(pool_for_head(feats, fcw), *model.multi_head)
              if model.multi_head is not None else None)
    boxes = np.stack([cam_bbox_multi(f, fcw, img_size=size) for f in feats])
    inst = (None, None)
    if instances > 1:
        got = [cam_instances(f, fcw, img_size=size, max_instances=instances)
               for f in feats]
        inst = (np.stack([g[0] for g in got]), np.stack([g[1] for g in got]))
    return MultiDetectResult(pred.astype(np.int32), conf, probs, boxes, *inst,
                             scores=scores)


def same_detections(got, want, tol: float) -> bool:
    """Two lists of (class, prob, box): classes and boxes equal, probs
    within ``tol``."""
    return len(got) == len(want) and all(
        gk == wk and tuple(gb) == tuple(wb) and abs(gp - wp) <= tol
        for (gk, gp, gb), (wk, wp, wb) in zip(got, want))


def multi_thresh_of(model):
    return (model.multi_thresh if model.multi_thresh is not None
            else DEFAULT_MULTI_THRESH)


def multi_engine(variant: str, backend: str, instances: int) -> None:
    art_dir = ARTIFACTS[variant]
    model = load_model(art_dir, variant)
    check(model.multi_head is not None, f"{variant}: no shipped multi_head.npz")
    engine = CUDAEngine(model, device="cuda", backend=backend)
    gate = bench_gate.load_gate_images(art_dir, img_size=model.config.img_size)
    want = host_multi(oracle_feats(gate, model.kernels, model.shifts), model,
                      instances)
    thr = multi_thresh_of(model)
    runs = {"direct": engine.detect_multi_batch(gate, instances=instances),
            "staged": engine.detect_multi_resolve(engine.detect_multi_batch_async(
                engine.stage_batch(gate), instances=instances))}
    for how, res in runs.items():
        tag = f"{variant}/{backend} --instances {instances} {how}"
        check(np.array_equal(res.pred, want.pred), f"{tag}: predictions")
        check(np.allclose(res.probs, want.probs, rtol=0, atol=SCORE_TOL),
              f"{tag}: probabilities")
        check(res.boxes.dtype == np.int32 and np.array_equal(res.boxes, want.boxes),
              f"{tag}: per-class boxes")
        check(np.allclose(res.scores, want.scores, rtol=0, atol=SCORE_TOL),
              f"{tag}: presence scores")
        if instances > 1:
            check(np.array_equal(res.inst_boxes, want.inst_boxes)
                  and np.array_equal(res.inst_counts, want.inst_counts),
                  f"{tag}: instance boxes or counts")
        else:
            check(res.inst_boxes is None, f"{tag}: instance outputs")
        got_d, want_d = res.detections(thr), want.detections(thr)
        check(all(same_detections(g, w, SCORE_TOL) for g, w in zip(got_d, want_d)),
              f"{tag}: detections differ")
    n_dets = sum(len(d) for d in want_d)
    phase("4 engine", f"{variant} ({engine.backend}) detect_multi_batch "
                      f"--instances {instances}, direct and staged, on "
                      f"{len(gate)} images: boxes"
                      f"{', instances and counts' if instances > 1 else ''} "
                      f"equal to the host twins, probabilities and presence "
                      f"scores within {SCORE_TOL}, the same {n_dets} "
                      f"detections; wire boxes u8: {engine.compact_multi}")


def multi_cli(variant: str, mode: str, instances: int) -> None:
    art_dir = ARTIFACTS[variant]
    paths = shipped_images(variant)
    model = load_model(art_dir, variant)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        infer.main(["--variant", variant, "--image-dir", art_dir, "--device",
                    "cuda", "--mode", mode, "--multi", "--instances",
                    str(instances), "--no-save"])
    got = infer.parse_detection_blocks(out.getvalue())
    feats = oracle_feats([np.fromfile(p, np.uint8) for p in paths],
                         model.kernels, model.shifts)
    thr = multi_thresh_of(model)
    dets = host_multi(feats, model, instances).detections(thr)
    # the host twins' detections in the JAX CLI's format
    # (tpu_cnn/apps/infer.py), not through the port's formatter
    header = "  Detections (prob >= " + (
        f"{thr:.0%}" if np.ndim(thr) == 0 else "per-class calibrated floors") + "):"
    want = [(header, [(model.class_names[k], 100.0 * prob,
                       f"({x1}, {y1}) -> ({x2}, {y2})")
                      for k, prob, (x1, y1, x2, y2) in d]) for d in dets]
    check(len(got) == len(want) == len(paths),
          f"{variant} --multi CLI printed {len(got)} detection blocks for "
          f"{len(paths)} images")
    for p, (gh, gd), (wh, wd) in zip(paths, got, want):
        # the printed 0.1% rounds the probability: allow one step of it
        check(gh == wh and len(gd) == len(wd) and all(
            gn == wn and gb == wb and abs(gp - wp) <= 0.1 + 1e-9
            for (gn, gp, gb), (wn, wp, wb) in zip(gd, wd)),
            f"{variant} --multi CLI on {os.path.basename(p)}: {gh} {gd} != "
            f"the host twins' {wh} {wd}")
    phase("5 cli", f"tpu_cnn_torch.apps.infer --variant {variant} --mode {mode} "
                   f"--multi --instances {instances}: the Detections lines of "
                   f"{len(paths)} images equal the host twins' "
                   f"({sum(len(d) for _, d in got)} detections)")


def multi_server(variant: str, mode: str, instances: int) -> None:
    model = load_model(ARTIFACTS[variant], variant)
    size = model.config.img_size
    paths = shipped_images(variant)[:8]
    batcher, backend = serve.build_service(ARTIFACTS[variant], device="cuda",
                                           max_batch=8, variant=variant,
                                           mode=mode, multi=True,
                                           instances=instances)
    bodies = [open(p, "rb").read() for p in paths]
    feats = oracle_feats([np.frombuffer(b, np.uint8) for b in bodies],
                         model.kernels, model.shifts)
    want = host_multi(feats, model, instances)
    want_dets = {"/detect": want.detections(multi_thresh_of(model)),
                 "/detect?thresh=0.3": want.detections(0.3)}
    urls = ["/detect?thresh=0.3"] + ["/detect"] * (len(bodies) - 1)
    with http_service(batcher, backend) as request:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(lambda a: request("POST", *a),
                                    zip(urls, bodies)))
        stats = batcher.snapshot()
    for i, (p, url, (status, ans)) in enumerate(zip(paths, urls, answers)):
        idx = int(want.pred[i])
        dets = want_dets[url][i]
        got = [(d["pred"], d["conf"], d["bbox"]) for d in ans.get("detections", [])]
        check(status == 200 and ans["pred"] == idx
              and ans["bbox"] == [int(v) for v in want.boxes[i, idx]]
              and all(d["name"] == model.class_names[d["pred"]]
                      for d in ans["detections"])
              and same_detections(got, dets, SCORE_TOL),
              f"{variant} {os.path.basename(p)} {url}: server {status} {ans} "
              f"!= host pred {idx} detections {dets}")
    phase("6 server", f"{variant} ({backend}) --multi --instances {instances}: "
                      f"{len(paths)} POSTs (one with ?thresh=0.3), each "
                      f"answer's detections equal to the host twins'; "
                      f"batches={stats['batches']} requests={stats['requests']}")


def probe_path() -> None:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = probe_bitcast.main(["--device", "cuda"])
    lines = [ln.strip() for ln in out.getvalue().splitlines()]
    want = ("layout r*4+b (word-major rows): MATCH", "layout r*4+b: MATCH",
            "Q3 packed i32 roll: MATCH")
    if rc != 0 or not all(w in lines for w in want):
        print(out.getvalue(), flush=True)
    check(rc == 0 and all(w in lines for w in want),
          f"tpu_cnn_torch.apps.probe_bitcast --device cuda: exit {rc}")
    phase("probe", f"tpu_cnn_torch.apps.probe_bitcast --device cuda: exit 0; "
                   f"{'; '.join(want)}")


def verify_cli(variant: str) -> None:
    """The port's golden-model verifier on the card: all seven backends,
    the engines' heads, exit 0 and the verdict."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = verify.main(["--device", "cuda", "--variant", variant,
                          "--image-dir", ARTIFACTS[variant]])
    text = out.getvalue()
    exact = sum("BIT-EXACT" in ln for ln in text.splitlines())
    heads = sum(": OK" in ln for ln in text.splitlines())
    multi_ok = all(
        sum(f"host twin {name:13s}: OK" in ln for ln in text.splitlines())
        == len(verify.ENGINE_BACKENDS)
        for name in ("multi boxes", "instances", "multi scores"))
    if rc != 0 or VERDICT not in text or not multi_ok:
        print(text, flush=True)
    check(rc == 0 and VERDICT in text and multi_ok,
          f"tpu_cnn_torch.apps.verify --variant {variant}: exit {rc}, "
          f"multi checks OK on every engine: {multi_ok}")
    phase("verify", f"tpu_cnn_torch.apps.verify --device cuda --variant "
                    f"{variant}: exit 0, {exact} backend pairs bit-exact, "
                    f"{heads} head checks OK (multi boxes, instances and "
                    f"multi scores on each engine); {VERDICT}")


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


def _queued_ms(fn, n: int = 50) -> float:
    """Device ms per call of ``fn`` for calls far shorter than their host
    cost: a device-side spin holds the stream while the host queues ``n``
    calls between two events, so the events time the device's work back
    to back and not the host's launches. The spin doubles until the start
    event is still pending when the last call is queued."""
    cycles = 1 << 22
    while True:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / n
        check(cycles < 1 << 32, "the device spin never outlasted the host")
        cycles *= 2


def _kernel_and_plain_ms(kernel, plain, n_kernel: int = 20,
                         n_plain: int = 5) -> tuple[float, float, int, int]:
    """Medians of CUDA-event times, in turns plain, kernel, kernel, plain,
    so both see the same card state."""
    for fn in (kernel, plain):  # warm-up
        fn()
    torch.cuda.synchronize()
    p_ms = _event_ms(plain, n_plain)
    k_ms = _event_ms(kernel, n_kernel) + _event_ms(kernel, n_kernel)
    p_ms += _event_ms(plain, n_plain)
    return statistics.median(k_ms), statistics.median(p_ms), len(k_ms), len(p_ms)


def _staged_pools(engine, rs) -> list:
    s = engine.model.config.img_size
    return [engine.stage_batch(rs.randint(0, 256, (BENCH_BATCH, s, s))
                               .astype(np.uint8)) for _ in range(4)]


def _pipelined_fps(dispatch, resolve, pools, rounds: int = 52) -> float:
    """bench.py's async pipeline: ``rounds`` batches over 4 staged pools,
    all dispatched, then all resolved."""
    resolve(dispatch(pools[0]))  # warm-up
    t0 = time.perf_counter()
    handles = [dispatch(pools[i % 4]) for i in range(rounds)]
    results = [resolve(h) for h in handles]
    dt = time.perf_counter() - t0
    check(len(results) == rounds and results[0].pred.shape == (BENCH_BATCH,),
          "pipelined detect returned the wrong shapes")
    return rounds * BENCH_BATCH / dt


def engine_fps(variant: str, backend: str, rs) -> list[float]:
    """bench.py's async pipeline: 52 rounds over 4 staged pools, 3 passes."""
    engine = CUDAEngine(load_model(ARTIFACTS[variant], variant), device="cuda",
                        backend=backend)
    pools = _staged_pools(engine, rs)
    return [_pipelined_fps(engine.detect_batch_async, engine.detect_resolve,
                           pools) for _ in range(3)]


def multi_times(card: str, rs, profile_out: str | None) -> None:
    """lyr3-std on mega at batch 1536: single-box, multi and multi with two
    instances, async-pipelined FPS in turns on one engine; then a profile
    of the instance head."""
    engine = CUDAEngine(load_model(ARTIFACTS["lyr3-std"], "lyr3-std"),
                        device="cuda")
    pools = _staged_pools(engine, rs)
    modes = {
        "single-box": (engine.detect_batch_async, engine.detect_resolve),
        "multi, instances 1": (
            lambda h: engine.detect_multi_batch_async(h, instances=1),
            engine.detect_multi_resolve),
        "multi, instances 2": (
            lambda h: engine.detect_multi_batch_async(h, instances=2),
            engine.detect_multi_resolve),
    }
    fps = {m: [] for m in modes}
    for _ in range(3):
        for m, (dispatch, resolve) in modes.items():
            fps[m].append(_pipelined_fps(dispatch, resolve, pools))
    for m, v in fps.items():
        phase("7 times", f"lyr3-std engine (mega) {m} detect async-pipelined "
                         f"batch {BENCH_BATCH} on {card}: best {max(v)!r} FPS "
                         f"of {v!r}")

    n_batches = 4
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handles = [engine.detect_multi_batch_async(pools[i % 4], instances=2)
                   for i in range(n_batches)]
        for h in handles:
            engine.detect_multi_resolve(h)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = ("multi_cam_stack", "connected_labels", "grow_labels",
             "component_stats")  # record_function spans of ops.detect_head

    def kernel_us(e) -> float:
        """Device time of the kernels a host op and its callees launched."""
        return (sum(k.duration for k in e.kernels)
                + sum(kernel_us(c) for c in e.cpu_children))

    def per_batch(*names) -> tuple[float, float, float]:
        """(kernel ms, host ms, calls) per batch of the host ops named."""
        sel = [e for e in events if e.device_type != cuda and e.name in names]
        return (sum(kernel_us(e) for e in sel) / 1e3 / n_batches,
                sum(e.cpu_time_total for e in sel) / 1e3 / n_batches,
                len(sel) / n_batches)

    def device_ms(pred) -> float:
        return sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == cuda and e.name not in spans
                   and pred(e.name)) / 1e3 / n_batches

    split = {
        **{f"span {r}": per_batch(r) for r in spans},
        "CAM bmm (aten::bmm)": per_batch("aten::bmm"),
        "topk (aten::topk)": per_batch("aten::topk"),
        "sort + cummax/cummin": per_batch("aten::sort", "aten::cummax",
                                          "aten::cummin"),
        "label-loop syncs (aten::equal)": per_batch("aten::equal"),
        "stream syncs (cudaStreamSynchronize)": per_batch("cudaStreamSynchronize"),
    }
    text = "; ".join(f"{k}: kernels {d:.3f} ms, host {c:.3f} ms, {n:g} calls"
                     for k, (d, c, n) in split.items())
    # each label loop syncs once (torch.equal) per block of LABEL_BLOCK steps
    steps = {r: sum(c.name == "aten::equal" for e in events if e.name == r
                    for c in e.cpu_children) * detect_head.LABEL_BLOCK / n_batches
             for r in ("connected_labels", "grow_labels")}
    phase("7 times", f"lyr3-std multi --instances 2 profile, {n_batches} "
                     f"batches of {BENCH_BATCH} on {card}, per batch: device "
                     f"kernels {device_ms(lambda n: True):.3f} ms (megakernel "
                     f"{device_ms(lambda n: 'mega_cnn_kernel' in n):.3f} ms) in "
                     f"a profiled host wall of {wall_ms:.3f} ms; {text}; label "
                     f"steps connected {steps['connected_labels']:g}, grow "
                     f"{steps['grow_labels']:g}")
    if profile_out is None:
        return
    rows = prof.key_averages()
    sort_key = ("self_device_time_total"
                if hasattr(rows[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(profile_out, "w") as f:
        f.write(rows.table(sort_by=sort_key, row_limit=60))
        f.write(rows.table(sort_by="cpu_time_total", row_limit=60))


def bitcast_times(dev: torch.device, card: str, rs) -> tuple[float, float]:
    """The bitcast kernel's three functions against their plain versions at
    (4096, 4096), 64 MiB of words in and 64 MiB out per call, so that the
    queued calls read and write HBM and not the 50 MB L2: device time per
    call, queued (each call takes tens of microseconds of device time and
    more on the host), medians of 10 runs each, in turns plain, kernel,
    plain. Returns the summed (kernel, plain) ms."""
    r, l = BITCAST_SHAPES[-1]
    x = torch.from_numpy(rs.randint(-2**31, 2**31, (r, l), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    x8 = torch.from_numpy(rs.randint(0, 256, (4 * r, l)).astype(np.uint8)).to(dev)
    total = [0.0, 0.0]
    for name, kernel, plain in (
            ("narrow", lambda: bitcast.narrow_i32_to_i8(x),
             lambda: bitcast.narrow_i32_to_i8_reference(x)),
            ("widen", lambda: bitcast.widen_u8_to_i32(x8),
             lambda: bitcast.widen_u8_to_i32_reference(x8)),
            ("roll 3", lambda: bitcast.packed_roll(x, 3),
             lambda: bitcast.packed_roll_reference(x, 3))):
        p_runs = [_queued_ms(plain) for _ in range(5)]
        k_runs = [_queued_ms(kernel) for _ in range(10)]
        p_runs += [_queued_ms(plain) for _ in range(5)]
        k_ms, p_ms = statistics.median(k_runs), statistics.median(p_runs)
        gbs = 2 * r * l * 4 / (k_ms * 1e-3) / 1e9
        phase("7 times", f"bitcast {name} ({r}, {l}) on {card}, device time "
                         f"per call, 50 calls queued: kernel median {k_ms!r} ms "
                         f"(n={len(k_runs)}, {gbs:.0f} GB/s in+out), plain "
                         f"median {p_ms!r} ms (n={len(p_runs)})")
        total[0] += k_ms
        total[1] += p_ms
    return total[0], total[1]


def pallas_profile(card: str, rs) -> None:
    """torch.profiler over the lyr3-std ``pallas`` pass (the features of
    ``CUDAEngine(backend="pallas")``) at batch 1536: the device kernels it
    launches, by name. It must launch the conv kernel once per layer and
    no torch pool (``quant.maxpool2x2``'s ``aten::amax`` reduction, whose
    kernel names are read from one profiled call of it first)."""
    engine = CUDAEngine(load_model(ARTIFACTS["lyr3-std"], "lyr3-std"),
                        device="cuda", backend="pallas")
    x = engine._to_device(rs.randint(0, 256, (BENCH_BATCH, 128, 128))
                          .astype(np.uint8))[0]
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    probe = torch.zeros((2, 16, 8, 8), dtype=torch.uint8, device=x.device)
    with torch.profiler.profile(activities=act) as prof:
        quant.maxpool2x2(probe)
        torch.cuda.synchronize()
    pool_kernels = {e.name for e in prof.events() if e.device_type == cuda}
    engine._features(x)  # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        engine._features(x)
        torch.cuda.synchronize()
    events = prof.events()
    names: dict[str, int] = {}
    for e in events:
        if e.device_type == cuda:
            names[e.name] = names.get(e.name, 0) + 1
    amax = sum(e.name == "aten::amax" for e in events if e.device_type != cuda)
    conv = sum(n for name, n in names.items() if "conv_layer_kernel" in name)
    check(pool_kernels and not pool_kernels & set(names) and amax == 0,
          f"the lyr3-std pallas pass ran a torch pool: {names}, aten::amax {amax}")
    check(conv == len(engine.net.kernels),
          f"the lyr3-std pallas pass launched {conv} conv kernels: {names}")
    phase("7 times", f"lyr3-std pallas pass (batch {BENCH_BATCH}) on {card}, "
                     f"torch.profiler: device kernels {names}; torch pool "
                     f"kernels {sorted(pool_kernels)} launched 0 times, "
                     f"aten::amax {amax}")


def times(dev: torch.device, card: str,
          profile_out: str | None) -> dict[str, tuple]:
    """Returns {kernel name: (kernel ms, plain ms, bound ms, bound by,
    library ms or None)} at batch 1536: the megakernel on lyr3-std's whole
    net, the layer kernel on lyr4-wide's L0, the conv kernel on lyr3-std's
    three layers summed (and under "conv_act pooled" its pooled entry on
    them), the bitcast kernel's three functions summed."""
    rs = np.random.RandomState(0)
    # lyr3-std: the whole net in the megakernel
    bundle = art.load_bundle(ARTIFACTS["lyr3-std"])
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 128, 128)).astype(np.uint8)).to(dev)
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    pk = mega.pack_plan(ks, 128)  # once, as CUDAEngine does
    shifts = torch.tensor((2, 4, 6), dtype=torch.int32, device=dev)
    kernel_ms, plain_ms, nk, np_ = _kernel_and_plain_ms(
        lambda: mega.cnn_forward_mega(imgs, ks, shifts, with_feats=False,
                                      with_bins=True, with_twin=True,
                                      packed=pk),
        lambda: mega.mega_reference(imgs, ks, shifts))
    cfgs3 = get_config("lyr3-std").layer_configs
    tops = macs_per_image(cfgs3) * BENCH_BATCH / (kernel_ms * 1e-3) / 1e12
    bound_ms, bound_by = layers_bound(cfgs3, BENCH_BATCH, detect_out_bytes(cfgs3))
    phase("7 times", f"lyr3-std batch {BENCH_BATCH} detect outputs on {card}: "
                     f"mega_cnn median {kernel_ms!r} ms (n={nk}, {tops:.2f} int "
                     f"TMAC/s; bound {bound_ms!r} ms by {bound_by}, "
                     f"{bound_ms / kernel_ms:.2%} of it), plain median "
                     f"{plain_ms!r} ms (n={np_})")
    out = {"mega_cnn": (kernel_ms, plain_ms, bound_ms, bound_by, None)}

    # the megakernel on the first layer alone: its one-channel input path
    def l0() -> torch.Tensor:
        return mega.cnn_forward_mega(imgs, ks[:1], shifts[:1], packed=pk[:1])

    l0()
    torch.cuda.synchronize()
    l0_runs = _event_ms(l0, 20) + _event_ms(l0, 20)
    l0_ms = statistics.median(l0_runs)
    l0_bound, l0_by = layers_bound(cfgs3[:1], BENCH_BATCH,
                                   cfgs3[0][1] * (cfgs3[0][2] // 2) ** 2)
    phase("7 times", f"lyr3-std L0 alone (1 -> 16 at 128^2, feats out) batch "
                     f"{BENCH_BATCH} on {card}: mega_cnn median {l0_ms!r} ms "
                     f"(n={len(l0_runs)}; bound {l0_bound!r} ms by {l0_by}, "
                     f"{l0_bound / l0_ms:.2%} of it)")
    del imgs

    # lyr4-wide: the layer kernel (L0), the megakernel (L1-L3), the chain
    cfgs = get_config("lyr4-wide").layer_configs
    bundle = bundle_of("lyr4-wide")
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 256, 256)).astype(np.uint8)).to(dev)
    x = imgs[:, None]
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    pk = mega.pack_plan(ks, 256)  # the layer kernel's L0, K1's L1-L3
    shifts = torch.tensor((3, 5, 5, 7), dtype=torch.int32, device=dev)
    x16 = conv_pool.conv_pool_layer(x, ks[0], shifts, 0, packed=pk[0])
    detect = dict(with_feats=False, with_bins=True, with_twin=True)
    stages = {
        "layer kernel L0": (
            lambda: conv_pool.conv_pool_layer(x, ks[0], shifts, 0, packed=pk[0]),
            lambda: conv_pool.conv_pool_reference(x, ks[0], shifts, 0),
            cfgs[:1]),
        "megakernel tail L1-L3": (
            lambda: mega.cnn_forward_mega(x16, ks[1:], shifts[1:],
                                          packed=pk[1:], **detect),
            lambda: mega.mega_reference(x16, ks[1:], shifts[1:]),
            cfgs[1:]),
        "chain": (
            lambda: mega.cnn_forward_mega(imgs, ks, shifts, packed=pk,
                                          **detect),
            lambda: mega.mega_reference(imgs, ks, shifts),
            cfgs),
    }
    for stage, (kernel, plain, stage_cfgs) in stages.items():
        k_ms, p_ms, nk, np_ = _kernel_and_plain_ms(kernel, plain, 5, 3)
        tops = macs_per_image(stage_cfgs) * BENCH_BATCH / (k_ms * 1e-3) / 1e12
        _, oc, s = stage_cfgs[-1]
        b_ms, b_by = layers_bound(
            stage_cfgs, BENCH_BATCH, oc * (s // 2) ** 2 if stage == "layer kernel L0"
            else detect_out_bytes(stage_cfgs))
        phase("7 times", f"lyr4-wide {stage} batch {BENCH_BATCH} on {card}: "
                         f"kernel median {k_ms!r} ms (n={nk}, {tops:.2f} int "
                         f"TMAC/s, {k_ms * 1e3 / BENCH_BATCH!r} us/image; bound "
                         f"{b_ms!r} ms by {b_by}, {b_ms / k_ms:.2%} of it), "
                         f"plain median {p_ms!r} ms (n={np_}, "
                         f"{p_ms * 1e3 / BENCH_BATCH!r} us/image)")
        if stage == "layer kernel L0":
            out["conv_pool_layer"] = (k_ms, p_ms, b_ms, b_by, None)
    del imgs, x, x16
    torch.cuda.empty_cache()

    # the conv kernel: each lyr3-std layer and lyr4-wide's L0, unpooled
    # (conv_act) and pooled (fused_conv_layer, what `pallas` and `hybrid`
    # run); the weights packed once, as CUDAEngine does
    act_ms, pool_ms = [0.0, 0.0], [0.0, 0.0]
    for variant, layers in (("lyr3-std", (0, 1, 2)), ("lyr4-wide", (0,))):
        model = load_model(ARTIFACTS[variant], variant)
        shifts = torch.from_numpy(model.shifts).to(dev)
        for li in layers:
            ic, oc, s = model.config.layer_configs[li]
            x = torch.from_numpy(rs.randint(
                0, 256, (BENCH_BATCH, ic, s, s)).astype(np.uint8)).to(dev)
            k = torch.from_numpy(model.kernels[li]).to(dev)
            pk = mega.pack_layer(k)
            for entry, kernel, plain, out_px in (
                    ("no pool", lambda: int8.conv_act(x, k, shifts, li, packed=pk),
                     lambda: int8.conv_act_reference(x, k, shifts, li), s * s),
                    ("pooled", lambda: int8.fused_conv_layer(x, k, shifts, li, packed=pk),
                     lambda: quant.maxpool2x2(int8.conv_act_reference(x, k, shifts, li)),
                     s * s // 4)):
                k_ms, p_ms, nk, np_ = _kernel_and_plain_ms(kernel, plain, 10, 3)
                tops = oc * ic * 9 * s * s * BENCH_BATCH / (k_ms * 1e-3) / 1e12
                gbs = (ic * s * s + oc * out_px) * BENCH_BATCH / (k_ms * 1e-3) / 1e9
                b_ms, _ = layers_bound(((ic, oc, s),), BENCH_BATCH, 0,
                                       calls="unpooled" if entry == "no pool" else "pooled")
                phase("7 times", f"{variant} conv_act L{li} ({ic}->{oc} at {s}^2, "
                                 f"{entry}) batch {BENCH_BATCH} on {card}: kernel "
                                 f"median {k_ms!r} ms (n={nk}, {tops:.2f} int "
                                 f"TMAC/s, {gbs:.0f} GB/s of u8 in+out; bound "
                                 f"{b_ms!r} ms, {b_ms / k_ms:.2%} of it), plain "
                                 f"median {p_ms!r} ms (n={np_})")
                if variant == "lyr3-std":
                    tot = act_ms if entry == "no pool" else pool_ms
                    tot[0] += k_ms
                    tot[1] += p_ms
            del x
    a_bound, a_by = layers_bound(cfgs3, BENCH_BATCH, 0, calls="unpooled")
    p_bound, p_by = layers_bound(cfgs3, BENCH_BATCH, 0, calls="pooled")
    out["conv_act"] = (*act_ms, a_bound, a_by, None)
    out["conv_act pooled"] = (*pool_ms, p_bound, p_by, None)
    phase("7 times", f"lyr3-std conv_act L0+L1+L2 on {card}: no pool: kernel "
                     f"{act_ms[0]!r} ms, plain {act_ms[1]!r} ms; bound "
                     f"{a_bound!r} ms by {a_by}, {a_bound / act_ms[0]:.2%} of it. "
                     f"Pooled: kernel {pool_ms[0]!r} ms, plain {pool_ms[1]!r} ms; "
                     f"bound {p_bound!r} ms by {p_by}, {p_bound / pool_ms[0]:.2%} "
                     f"of it")
    torch.cuda.empty_cache()

    for variant, backend in (("lyr4-wide", "mega"), ("lyr3-std", "pallas"),
                             ("lyr3-std", "hybrid")):
        fps = engine_fps(variant, backend, rs)
        phase("7 times", f"{variant} engine ({backend}) detect async-pipelined "
                         f"batch {BENCH_BATCH} on {card}: best {max(fps)!r} "
                         f"FPS of {fps!r}")
        torch.cuda.empty_cache()
    multi_times(card, rs, profile_out)  # lyr3-std on mega: single-box and multi
    torch.cuda.empty_cache()
    # after every host-bound FPS: a finished torch.profiler run leaves
    # CUPTI's launch overhead behind it
    pallas_profile(card, rs)
    torch.cuda.empty_cache()
    r, l = BITCAST_SHAPES[-1]
    k_ms, p_ms = bitcast_times(dev, card, rs)
    b_ms, b_by = bound(0, 3 * 2 * r * l * 4)  # three calls, in + out
    phase("7 times", f"bitcast narrow + widen + roll ({r}, {l}) on {card}: "
                     f"kernel {k_ms!r} ms; bound {b_ms!r} ms by {b_by}, "
                     f"{b_ms / k_ms:.2%} of it; plain {p_ms!r} ms")
    # each plain version is one PyTorch call (torch.roll, or the copy that
    # reshape makes of a permuted byte view): its time is the library's
    out["bitcast"] = (k_ms, p_ms, b_ms, b_by, p_ms)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile-out", default=None,
                   help="also write the instance head's torch.profiler "
                        "tables (phase 7) to this file")
    args = p.parse_args(argv)
    card = header()
    dev = torch.device("cuda", 0)
    build()
    max_err = kernel_vs_plain(dev)

    launches = dict.fromkeys(KERNELS, 0)

    def main_path(label: str, path_kernels, *steps) -> None:
        """Run one main path's steps between zeroed and read launch
        counters: its kernels and no others must launch."""
        for module in MODULES.values():
            module.launches = 0
        for step in steps:
            step()
        counts = {name: module.launches for name, module in MODULES.items()}
        for name, n in counts.items():
            check((n > 0) == (name in path_kernels),
                  f"{label} main path launched {name} {n} times")
            launches[name] += n
        phase("main path", f"{label} kernel launches: {counts}")

    for variant, backend, alt_shifts, path_kernels in PATHS:
        main_path(f"{variant}/{backend} (phases 4-6)", path_kernels,
                  lambda: engine_gate(variant, backend, alt_shifts),
                  lambda: cli(variant, backend),
                  lambda: server(variant, backend))
    main_path("probe_bitcast", ("bitcast",), probe_path)
    for variant, backend, instances, path_kernels in MULTI_PATHS:
        main_path(f"{variant}/{backend} --multi --instances {instances} "
                  f"(phases 4-6)", path_kernels,
                  lambda: multi_engine(variant, backend, instances),
                  lambda: multi_cli(variant, backend, instances),
                  lambda: multi_server(variant, backend, instances))

    for variant in ARTIFACTS:
        verify_cli(variant)

    ms = times(dev, card, args.profile_out)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "tpu_cnn")]
    check(not loaded, f"the JAX package or jax was imported: {loaded[:5]}")
    # no single PyTorch call computes a convolution kernel's function (no
    # u8 x s8 convolution with the shift, clip and pool; torch._int_mm is
    # s8 x s8 after an im2col): library_ms is null for those
    rows = [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": ms[name][0], "plain_ms": ms[name][1], "bound_ms": ms[name][2],
        "bound_by": ms[name][3], "library_ms": ms[name][4]}
        for name, (src, replaces) in KERNELS.items()]
    # the conv kernel's pooled entry, what the pallas and hybrid paths run
    act = next(r for r in rows if r["name"] == "conv_act")
    act["pooled_ms"], act["pooled_bound_ms"] = (ms["conv_act pooled"][0],
                                                ms["conv_act pooled"][2])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
