"""The kernel cases: each hand-written kernel against its plain PyTorch
version on the same tensors, at the shapes the main paths give it and at
its edges.

    python -m tpu_cnn_torch.apps.kernel_cases    # on the card

``chip_smoke.py`` runs these cases as its phase 3, and the sanitizer lane
(``apps.sanitize``) runs this module's ``main`` under NVIDIA's
``compute-sanitizer``, so both drive the kernels through the same cases.
A case fails (``RuntimeError``) when a kernel's output differs from its
plain version's: features, twins and layer outputs bit for bit, the
megakernel's bins within ``BINS_TOL``; the CAM head's predictions and
boxes as the plain version's (a box may instead be the float64 CAM's,
where the plain version's f32 order breaks a tie otherwise) and its
probabilities within ``CAM_PROBS_TOL`` of the float64 head's. ``main``
prints one JSON line: each kernel's launches (the wrappers' ``launches`` counters), the code
paths the launches reached (``REQUIRED_PATHS`` must all be among them),
each kernel's cases and largest absolute difference, and the seconds.

Which path a launch takes is decided by the launcher on the host, from
the geometry, the pointers and the card's occupancy; each library counts
the paths its launches took (``csrc/path_counts.cuh``), and ``run_all``
reports those its cases added to (``ops._build.path_counts``). On a CPU
tensor the wrappers run the plain versions: the cases then check nothing
of a kernel.
"""

from __future__ import annotations

import concurrent.futures
import glob
import hashlib
import itertools
import json
import math
import os
import time

import numpy as np
import torch

from tpu_cnn_torch import bench_gate
from tpu_cnn_torch.apps.common import load_model
from tpu_cnn_torch.engine.cpu_ref import numpy_cnn_forward
from tpu_cnn_torch.engine.cuda import region_routes
from tpu_cnn_torch.models.registry import default_shifts, get_config
from tpu_cnn_torch.ops import (_build, bitcast, cam_head, conv_pool, conv_stream,
                               detect_head, int8, mega, quant, region_head, region_layer,
                               yolo_head)
from tpu_cnn_torch.utils import artifacts as art

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = {"lyr3-std": os.path.join(_ROOT, "artifacts", "pretrained"),
             "lyr4-wide": os.path.join(_ROOT, "artifacts", "pretrained-lyr4")}
MODULES = {"mega_cnn": mega, "conv_pool_layer": conv_pool, "conv_act": int8,
           "bitcast": bitcast, "cam_head": cam_head, "conv_stream": conv_stream,
           "region_head": region_head, "region_layer": region_layer, "yolo_head": yolo_head}
# how a path of each library is named: the layer kernel's under "layer"
PATH_PREFIX = {"mega_cnn": "mega_cnn", "conv_pool_layer": "layer", "conv_act": "layer",
               "bitcast": "bitcast", "cam_head": "cam_head", "conv_stream": "stream",
               "region_head": "region_head", "region_layer": "region_layer",
               "yolo_head": "yolo_head"}
# the probe's; ragged; 16 MiB; 64 MiB of words, past the 50 MB L2 (timed)
BITCAST_SHAPES = ((8, 256), (5, 37), (1024, 4096), (4096, 4096))
BINS_TOL = 1e-6  # the kernel's bins vs the plain version's (1-ulp / order)
# the CAM head's probabilities vs the float64 head's (it sums the logits
# and takes the softmax in f64, then rounds once)
CAM_PROBS_TOL = 1e-6
# the CAM head's batches: the kernel cases' and each family's offline round
CAM_BATCHES = {"lyr3-std": 16384, "lyr4-wide": 4096}
# (C, P) of the CAM head's seeded cases: lyr2-small's, lyr3-tiny's and an
# 8x8 CAM (two pixels a bin column)
CAM_GEOMETRIES = ((32, 1024), (64, 16), (16, 64))
KERNEL_BATCH = 37  # the kernel cases' batch: not a multiple of any tile
COMBOS = [c for c in itertools.product((True, False), repeat=3) if any(c)]

# the code paths the cases must reach (``main`` fails without one): the
# megakernel's two ways of bringing a one-channel image and its banded
# multi-channel layer 0, its weights resident and copied per image, a
# second image of its persistent loop, its one-channel layers past 16
# channels and past layer 0, and every wgmma N chunk and the generic
# channel padding; the layer kernel's one-channel path with more than one
# output-group pass, its multi-channel path at every channel padding,
# pooled and unpooled, its byte-wise staging and stores, and a second item
# of its persistent loop (one buffer swap) on both paths; the bitcast
# kernel's one-word variants on misaligned views
REQUIRED_PATHS = (
    "mega_cnn: one-channel image by cp.async.bulk behind an mbarrier, prefetched",
    "mega_cnn: one-channel image by plain loads",
    "mega_cnn: multi-channel layer 0 in row bands",
    "mega_cnn: row bands staged byte by byte",
    "mega_cnn: all weights resident in shared memory",
    "mega_cnn: weights copied per image",
    "mega_cnn: persistent loop, a CTA's second image",
    "mega_cnn: one-channel layer of more than 16 channels",
    "mega_cnn: one-channel layer past layer 0",
    "mega_cnn: wgmma m64n16k32",
    "mega_cnn: wgmma m64n32k32",
    "mega_cnn: wgmma m64n64k32",
    "mega_cnn: wgmma layer past 64 input channels",
    "layer: one-channel, output-group pass g0 > 0",
    *(f"layer: multi-channel cp={cp} {p}" for cp in ("16", "32", "64", "generic")
      for p in ("pooled", "unpooled")),
    "layer: byte-wise staging (vec_in false)",
    "layer: byte-wise stores (vec_out false)",
    "layer: one-channel, persistent loop k >= 1",
    "layer: multi-channel, persistent loop k >= 1",
    "bitcast: narrow one-word, misaligned view",
    "bitcast: widen one-word, misaligned view",
    "cam_head: bins at least 4 pixels wide (two weights a chunk)",
    "cam_head: bins narrower than 4 pixels (a weight a pixel)",
    "cam_head: order statistics by a bitonic sort (at most 256 pixels)",
    "cam_head: order statistics by counting (more than 256 pixels)",
    "layer: multi-channel with a bias",
    *(f"stream: {p}" for p in (
        "A by TMA im2col from a channels-last map",
        "A gathered from an NCHW map by the producer warps",
        "A gathered from a channels-last map by the producer warps",
        "no pool", "pool 2x2 stride 2 across lanes", "pool 2x2 stride 1 in shared memory",
        "linear s32 out", "1x1 kernel", "a partial N tile", "a partial M tile",
        "a TMA im2col load across an image boundary",
        "tile 128x256, two consumer warpgroups of m64n256k32",
        "tile 128x128 (the linear layer), two consumer warpgroups of m64n128k32",
        "tile 192x128 (one image), three consumer warpgroups of m64n128k32",
        "persistent: a CTA's second tile", "persistent: CTAs with unequal work")),
    "region_head: launch at max_det below every box x class pair",
    *(f"region_layer: {p}" for p in (
        "staging: three NCHW planes by cp.async, interleaved to a word a pixel",
        "staging: a channels-last map by 16-byte cp.async",
        "staging: byte by byte (another layout, channel count or alignment)",
        "A: 3 channels recast, 27 of 32 K bytes in one k32 step",
        "A: 1-2 channels recast, one k32 step",
        "A: ldmatrix from 16-byte staged pixels", "A: ldmatrix from 32-byte staged pixels",
        "A: ldmatrix from 64-byte staged pixels", "A: ldmatrix from 128-byte staged pixels",
        "wgmma m64n16k32", "wgmma m64n32k32", "wgmma m64n64k32", "wgmma m64n128k32",
        "stores: a band's rows by bulk copy from shared memory (N 16, 32)",
        "stores: 16 bytes a lane (N 64, 128)", "stores: 2 bytes (oc not a multiple of 16)",
        "stores: bytes (odd oc)", "persistent: CTAs sharing an SM", "a band in column segments",
        "persistent: a CTA's second item", "a partial band (the last pooled rows)",
        "a partial tile (an item's last)")),
    # YOLOv3's (``yolo3_layers_vs_plain``, ``yolo_head_vs_plain``)
    *(f"stream: {p}" for p in (
        "stride 2: TMA im2col every 2 pixels", "a residual added after the clip",
        "upsampled 2x in the epilogue", "the output inside a wider map (a route's slice)",
        "the input inside a wider map (TMA strides)")),
    *(f"region_layer: {p}" for p in (
        "output: the unpooled map, 2 bytes a lane",
        "output: the stride-2 conv's map, 2 bytes a lane", "a residual added after the clip")),
    *(f"yolo_head: {p}" for p in (
        "launch: pages possible (more boxes x classes than a page holds)",)),
)
# yolov2-tiny-voc's layers (``registry.DETECTORS``): L0-L3 on the region
# route's layer kernel, L4-L8 on the streamed kernel; and its region head
YOLO = get_config("yolov2-tiny-voc")
YOLO_BATCH = 5  # L0-L3's cases: five 416x416x3 frames
# the region route's layer kernel past the engine's shapes: (batch, ic, oc,
# S, layout): one and two channels, odd counts (bytes and 2-byte stores),
# 48 channels (a padded chunk), 127 at 416 wide (column segments, 128-byte
# pixels), 16 channels from NCHW and from a strided view (byte staging),
# L0 at 64 frames (a CTA's second item)
REGION_LAYER_EDGES = ((3, 1, 8, 28, "nchw"), (3, 2, 16, 30, "nchw"), (3, 5, 7, 14, "nchw"),
                      (2, 5, 24, 22, "channels_last"), (2, 48, 48, 26, "channels_last"),
                      (1, 127, 128, 416, "channels_last"), (2, 16, 32, 30, "nchw"),
                      (2, 16, 32, 30, "strided"), (64, 3, 16, 416, "nchw"))
# the streamed layers' further batches: one frame (one or two M tiles), and
# 64 (more tiles than the card holds CTAs, shared unequally by the
# persistent CTAs)
STREAM_BATCHES = (1, 64)

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


# ── the cases ────────────────────────────────────────────────────────


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
    shared memory) and one-layer nets on every input path (one byte a
    pixel by bulk copies or, 30 wide, by plain loads; 16 channels in
    bands by words, and 3 channels 30 wide by bytes)."""
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
            ("one layer 3->16@30", 3, 30, (16,), (4,)),
            ("one layer 16->32@32", 16, 32, (32,), (6,))):
        shape = (b, s, s) if ic0 == 1 else (b, ic0, s, s)
        ics = (ic0,) + chans[:-1]
        ks = [rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
              for ic, oc in zip(ics, chans)]
        setups.append((name, rs.randint(0, 256, shape).astype(np.uint8), ks, sh))
    return setups


SMEM_PLAN_RANDOM = 2000  # seeded random geometries beside the fixed ones


def _plan_geometries() -> list[tuple]:
    """Layer configs for the shared-memory plan check: every registry net
    and each of its tails, the megakernel cases' edge geometries, one
    that does not fit, and seeded random nets of 1-4 layers (some of
    sizes the kernel refuses)."""
    geoms = []
    for name in ("lyr3-std", "lyr3-tiny", "lyr2-small", "lyr4-wide"):
        cfgs = get_config(name).layer_configs
        geoms += [cfgs[n:] for n in range(len(cfgs))]
    for ic0, s, chans in ((3, 32, (24, 8)), (16, 16, (128, 16)), (1, 32, (35, 13)),
                          (1, 24, (16, 24)), (1, 32, (1, 16)), (1, 64, (16,)),
                          (1, 30, (16,)), (3, 30, (16,)), (16, 32, (32,)),
                          (64, 64, (16,)), (1, 512, (64, 64))):
        ics = (ic0,) + chans[:-1]
        geoms.append(tuple((ic, oc, s >> i) for i, (ic, oc) in enumerate(zip(ics, chans))))
    rs = np.random.RandomState(11)
    for _ in range(SMEM_PLAN_RANDOM):
        n = rs.randint(1, 5)
        s = int(rs.choice((8, 12, 16, 24, 30, 32, 48, 64, 96, 128, 256)))
        chans = [int(rs.choice((1, 3, 16, 32, 64)))] + [
            int(rs.choice((1, 8, 13, 16, 24, 32, 35, 64, 128))) for _ in range(n)]
        geoms.append(tuple((chans[i], chans[i + 1], s >> i) for i in range(n)))
    return geoms


def smem_plans_vs_kernel() -> int:
    """``mega.mega_layout`` against the kernel library's own plan
    (``mega_cnn_smem_plan``) on every geometry of ``_plan_geometries``:
    the same geometries refused, and for the rest the same bytes, region
    and image-buffer offsets, band rows and weight placement. Needs the
    built library (the card). Returns the geometries checked."""
    import ctypes

    lib = mega._lib()
    fn = lib.mega_cnn_smem_plan
    ci = ctypes.c_int
    fn.argtypes = [ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci), ctypes.POINTER(ci)]
    fn.restype = ci
    geoms = _plan_geometries()
    for cfgs in geoms:
        n, size0 = len(cfgs), cfgs[0][2]
        ic = (ci * n)(*(c[0] for c in cfgs))
        oc = (ci * n)(*(c[1] for c in cfgs))
        plan = (ci * (5 + 3 * mega.MAX_LAYERS))()
        smem = fn(n, size0, ic, oc, plan)
        lay = mega.mega_layout(cfgs)
        check((lay is None) == (smem == 0),
              f"smem plan {cfgs}: kernel {smem} bytes, mega_layout {lay}")
        if lay is None:
            continue
        off1 = mega.ALIGN + mega._align(lay.region0)
        mirror = [mega.ALIGN, off1, off1 + mega._align(lay.region1),
                  mega.pitch1(size0) if cfgs[0][0] == 1 else 0, lay.band_rows]
        pad = [0] * (mega.MAX_LAYERS - n)
        mirror += list(lay.w_offsets) + pad + list(lay.weights) + pad
        mirror += [int(r) for r in lay.resident] + [1] * len(pad)
        check(smem == lay.smem and list(plan) == mirror,
              f"smem plan {cfgs}: kernel {smem} {list(plan)}, "
              f"mega_layout {lay.smem} {mirror}")
    return len(geoms)


def mega_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The megakernel against mega_reference on the same tensors: whole
    nets, and lyr4-wide's L1-L3 tail on a 4-D input. Returns (largest
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
    # the persistent grid: one image, and more images than CTAs (each CTA
    # of the grid takes a second one), on both input paths
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    setups.append(("lyr3-std/shipped/batch 1", gate[:1], bundle.kernels, (2, 4, 6)))
    setups.append((f"lyr3-std/seed7/batch {2 * sms + 5}",
                   rs.randint(0, 256, (2 * sms + 5, 128, 128)).astype(np.uint8),
                   _random_kernels(rs, get_config("lyr3-std").layer_configs), (2, 4, 6)))
    setups.append(("lyr4-wide-tail/shipped/batch 1", x16[:1],
                   bundle_of("lyr4-wide").kernels[1:], (5, 5, 7)))
    setups.append((f"lyr4-wide-tail/seed7/batch {sms + 3}",
                   rs.randint(0, 256, (sms + 3, 16, 128, 128)).astype(np.uint8),
                   _random_kernels(rs, tail_cfgs), (5, 5, 7)))
    setups += _mma_edge_setups(rs)
    max_err, n_cases = 0.0, 0
    for name, imgs_np, ks_np, sh in setups:
        imgs = torch.from_numpy(imgs_np).to(dev)
        ks = [torch.from_numpy(k).to(dev) for k in ks_np]
        shifts = torch.tensor(sh, dtype=torch.int32, device=dev)
        ref = mega.mega_reference(imgs, ks, shifts)
        int_feats = mega.mega_reference(imgs, ks, shifts, compute_dtype="int32")[0]
        _sync(dev)
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
            _sync(dev)
            tag = f"{name} feats={flags[0]} bins={flags[1]} twin={flags[2]}"
            max_err = max(max_err, _check_mega_outputs(tag, out, ref, flags))
            n_cases += 1
    return max_err, n_cases


def layer_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The layer kernel against conv_pool_reference on the same tensors.
    Returns (largest absolute difference, cases)."""
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
        _sync(dev)
        check(torch.equal(ref, ref_int),
              f"{name}: plain f32 and int32 paths disagree on the card")
        for packed in (None, mega.pack_layer(k)):
            got = conv_pool.conv_pool_layer(x, k, shifts, 1, packed=packed)
            _sync(dev)
            check(got.dtype == torch.uint8 and torch.equal(got, ref),
                  f"{name} packed={packed is not None}: layer kernel differs "
                  f"from its plain version")
            max_err = max(max_err, (got.int() - ref.int()).abs().max().item())
            n_cases += 1
    return max_err, n_cases


def act_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The conv kernel against conv_act_reference on the same tensors:
    every layer of lyr3-std and lyr4-wide, with the shipped weights on the
    plain chain's activations of the gate images at the model's shift and
    with seeded weights on noise at shifts 0 and 31; two rectangles and
    20->35 across the channel chunks. Then its pooled output against the
    layer kernel on lyr4-wide's L0. Returns (largest absolute difference,
    cases)."""
    rs = np.random.RandomState(9)
    setups = []  # (name, x on the device, kernel (numpy), shift)
    for variant in ARTIFACTS:
        model = load_model(ARTIFACTS[variant], variant)
        x = torch.from_numpy(bench_gate.load_gate_images(
            ARTIFACTS[variant], n_real=28, n_noise=9,
            img_size=model.config.img_size)[:, None]).to(dev)
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
        _sync(dev)
        check(torch.equal(ref, ref_int),
              f"{name}: plain f32 and int32 paths disagree on the card")
        err, n = _conv_entries(name, x, k, shifts, 1, ref)
        max_err, n_cases = max(max_err, err), n_cases + n

    # two hand-written kernels on one function: conv + pool, lyr4-wide L0
    model = load_model(ARTIFACTS["lyr4-wide"], "lyr4-wide")
    x = torch.from_numpy(bench_gate.load_gate_images(
        ARTIFACTS["lyr4-wide"], n_real=28, n_noise=9,
        img_size=256)[:, None]).to(dev)
    k = torch.from_numpy(model.kernels[0]).to(dev)
    shifts = torch.from_numpy(model.shifts).to(dev)
    pooled = int8.fused_conv_layer(x, k, shifts, 0)
    layer = conv_pool.conv_pool_layer(x, k, shifts, 0)
    _sync(dev)
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
            _sync(x.device)
            check(got.dtype == torch.uint8 and torch.equal(got, ref_out),
                  f"{name} {entry} packed={packed is not None}: conv kernel "
                  f"differs from its plain version")
            max_err = max(max_err, (got.int() - ref_out.int()).abs().max().item())
            n += 1
    return max_err, n


def _layer_cases(dev, setups) -> tuple[float, int, float, int]:
    """``setups`` of (name, x, kernel, shifts) through all three entries
    of the layer kernel (the conv kernel unpooled and pooled, and
    conv_pool_layer for a square even map), each with the weights packed
    per call and once. Returns (the conv kernel's largest absolute
    difference, its cases, the layer kernel's, its cases)."""
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
                    _sync(dev)
                    check(torch.equal(got, want), f"{name}/{sh} packed="
                          f"{packed is not None}: layer kernel differs")
                    layer_err = max(layer_err, (got.int() - want.int()).abs().max().item())
                    layer_n += 1
    return act_err, act_n, layer_err, layer_n


def layer_edges(dev: torch.device) -> tuple[float, int, float, int]:
    """The layer kernel's tensor-core edges through all three of its
    entries: all-255 inputs on all +127 and on all -128 weights and 0/255
    inputs on random +127/-128 weights, at shifts 0 and 31, on
    one-channel, 16-channel and 64-channel layers; then input channels 1,
    3, 20 and 64 (K padded) against output channels 5, 13, 35 and 128 (N
    tiles padded) on the rectangles 7x12 (unpooled) and 6x10 and on
    38x38, and lyr4-wide's L3 (64 -> 128 at 32^2). Returns (the conv
    kernel's largest absolute difference, its cases, the layer kernel's,
    its cases)."""
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
    return _layer_cases(dev, setups)


def layer_generic_channels(dev: torch.device) -> tuple[float, int, float, int]:
    """The layer kernel's multi-channel path past 64 input channels
    (channels padded to 128: the generic case of ``multi_tile``, which no
    shipped model's layer takes), through all three entries: 96 -> 13 at
    6x10 and 128 -> 35 at 20x20, at shifts 0 and 31. Returns as
    ``layer_edges``."""
    rs = np.random.RandomState(12)
    setups = [(f"{ic}->{oc}@{h}x{w}",
               rs.randint(0, 256, (KERNEL_BATCH, ic, h, w)).astype(np.uint8),
               rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8), (0, 31))
              for ic, oc, h, w in ((96, 13, 6, 10), (128, 35, 20, 20))]
    return _layer_cases(dev, setups)


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
    _sync(dev)
    _check_mega_outputs("lyr4-wide chain", out, ref, (True, True, True))
    check(np.array_equal(out[0].cpu().numpy(),
                         oracle_feats(imgs_np, bundle.kernels, sh)),
          "lyr4-wide chain disagrees with the numpy oracle")


def bitcast_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The bitcast kernel's three functions against their plain versions
    on the same tensors, bit for bit. Returns (largest absolute
    difference, cases)."""
    rs = np.random.RandomState(10)
    max_err, n_cases = 0, 0

    def same(tag, got, want):
        nonlocal max_err, n_cases
        _sync(dev)
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


def cam_head_f64(pooled, twin, fc_weight, fc_bias, pred, img_size: int):
    """The CAM head in float64 on the same inputs: (probs (B, K) float64,
    the (B, 4) box of ``pred``'s float64 CAM, its threshold and comparison
    in float64 too), in chunks of 1,024 images."""
    b, c, p = twin.shape
    s = math.isqrt(p)
    npx = s // 4
    probs = torch.softmax(pooled.double() @ fc_weight.double().T
                          + fc_bias.double(), dim=1)
    pix = torch.arange(p, device=twin.device)
    binof = (pix // s // npx) * 4 + (pix % s) // npx
    lo, hi, frac = cam_head.percentile_order(p)
    boxes = []
    for i in range(0, b, 1024):
        f = twin[i:i + 1024].double()
        valid = (f.mean(dim=2) <= 250.0).double()
        wk = (fc_weight.double()[pred[i:i + 1024].long()].reshape(-1, c, 16)
              * valid[:, :, None])
        cam = (wk[:, :, binof] * f).sum(dim=1).clamp_min(0.0)
        top = cam.amax(dim=1, keepdim=True)
        cam = torch.where(top > 0, cam / top.clamp_min(1e-300), cam)
        srt = cam.sort(dim=1).values
        thr = (srt[:, lo] + (srt[:, hi] - srt[:, lo]) * frac).clamp_min(0.25)
        boxes.append(detect_head._bbox_from_cam(cam.reshape(-1, s, s), img_size, thr))
    return probs, torch.cat(boxes)


def _cam_case(tag, pooled, twin, w, b, img_size, shipped):
    """One CAM head case: predictions equal to the plain version's,
    probabilities within ``CAM_PROBS_TOL`` of the float64 head's, boxes
    equal to the plain version's on the first ``shipped`` images (the
    shipped test frames) and elsewhere to the plain version's or the
    float64 CAM's (the plain ``bmm``'s f32 order can break a ``cam > thr``
    tie otherwise). Returns (the probabilities' largest difference, the
    boxes)."""
    got = cam_head.detect_pooled_fused(pooled, twin, w, b, img_size)
    want = detect_head.detect_with_pooled(None, pooled, w, b, img_size,
                                          features_twin=twin, box_mode="ref")
    _sync(twin.device)
    check(torch.equal(got[0], want[0]), f"cam_head {tag}: predictions differ")
    probs64, boxes64 = cam_head_f64(pooled, twin, w, b, want[0], img_size)
    err = float((got[2].double() - probs64).abs().max())
    conf_err = float((got[1].double() - probs64.gather(1, want[0][:, None].long())[:, 0])
                     .abs().max())
    # (on the CPU the wrapper is the plain version, whose f32 sums are not
    # held to the float64 head)
    check(max(err, conf_err) <= CAM_PROBS_TOL or not twin.is_cuda,
          f"cam_head {tag}: probabilities {err!r} from the float64 head's")
    same = (got[3] == want[3]).all(dim=1)
    check(bool(same[:shipped].all()),
          f"cam_head {tag}: boxes differ on shipped frames "
          f"{torch.nonzero(~same[:shipped])[:, 0].tolist()[:8]}")
    ok = same | (got[3] == boxes64).all(dim=1)
    check(bool(ok.all()), f"cam_head {tag}: boxes neither the plain version's "
                          f"nor the float64 CAM's: {torch.nonzero(~ok)[:, 0].tolist()[:8]}")
    return err, got[3]


def cam_head_vs_plain(dev: torch.device, offline: bool = False) -> tuple[float, int]:
    """The CAM head kernel against ``detect_with_pooled`` ("ref"): each
    family's bins and twin from the megakernel (or its plain version) on
    its shipped test frames and noise, at ``KERNEL_BATCH`` and batch 1 and,
    with ``offline``, at its offline round (``CAM_BATCHES``); then seeded
    twins with saturated channels at ``CAM_GEOMETRIES``, an all-zero twin
    (the full frame) and a flat CAM (every value ties at the threshold).
    Returns (the probabilities' largest difference from the float64
    head's, cases)."""
    max_err, n_cases = 0.0, 0
    rs = np.random.RandomState(11)
    for variant in ARTIFACTS:
        model = load_model(ARTIFACTS[variant], variant)
        size = model.config.img_size
        ks = [torch.from_numpy(np.asarray(k)).to(dev) for k in model.kernels]
        shifts = torch.tensor(model.shifts, dtype=torch.int32, device=dev)
        w = torch.from_numpy(np.ascontiguousarray(model.fc_weight, np.float32)).to(dev)
        b = torch.from_numpy(np.ascontiguousarray(model.fc_bias, np.float32)).to(dev)
        shipped = bench_gate.load_gate_images(ARTIFACTS[variant], n_real=10**6,
                                              n_noise=0, img_size=size)
        batches = [1, KERNEL_BATCH] + ([CAM_BATCHES[variant]] if offline else [])
        for batch in batches:
            n_ship = min(batch, len(shipped))
            imgs = np.concatenate([shipped[:n_ship], rs.randint(
                0, 256, (batch - n_ship, size, size)).astype(np.uint8)])
            pooled, twin = mega.cnn_forward_mega(
                torch.from_numpy(imgs).to(dev), ks, shifts, with_feats=False,
                with_bins=True, with_twin=True)
            err, _ = _cam_case(f"{variant} batch {batch}", pooled, twin, w, b,
                               size, n_ship)
            max_err, n_cases = max(max_err, err), n_cases + 1
    for c, p in CAM_GEOMETRIES:
        twin = rs.randint(0, 256, (KERNEL_BATCH, c, p)).astype(np.float32)
        twin[:, ::7] = 255.0  # saturated channels: masked out of the CAM
        t = [torch.from_numpy(a).to(dev) for a in (
            rs.rand(KERNEL_BATCH, 16 * c).astype(np.float32), twin,
            (rs.randn(6, 16 * c) * 0.05).astype(np.float32),
            (rs.randn(6) * 0.1).astype(np.float32))]
        t[1] = t[1].to(torch.bfloat16)
        err, _ = _cam_case(f"C={c} P={p}", *t, 8 * math.isqrt(p), 0)
        max_err, n_cases = max(max_err, err), n_cases + 1
    pooled = torch.full((KERNEL_BATCH, 1024), 7.0 / 255, device=dev)
    w, b = torch.ones((6, 1024), device=dev), torch.zeros(6, device=dev)
    for tag, fill in (("all-zero twin", 0.0), ("flat CAM", 7.0)):
        twin = torch.full((KERNEL_BATCH, 64, 256), fill, device=dev).to(torch.bfloat16)
        err, boxes = _cam_case(tag, pooled, twin, w, b, 128, KERNEL_BATCH)
        check(bool((boxes == torch.tensor([0, 0, 127, 127], device=dev)).all()),
              f"cam_head {tag}: not the full frame")
        max_err, n_cases = max(max_err, err), n_cases + 1
    return max_err, n_cases


def _region_weights(rs, ic, oc, k, x_rms=147.0):
    """A seeded (oc, ic, k, k) int8 kernel, (oc,) int32 bias and shift
    that put the sums of u8 noise around the middle of 0..255."""
    kernel = rs.randint(-8, 9, (oc, ic, k, k)).astype(np.int8)
    spread = math.sqrt(ic * k * k) * x_rms * 4.9
    shift = max(0, min(31, round(math.log2(spread / 64))))
    bias = rs.randint(-int(spread), int(spread) + 1, oc).astype(np.int32)
    return kernel, bias, shift


def _region_layer_case(tag, x, kernel, bias, shifts, layer, pool, last, route):
    """One layer's kernel against ``conv_stream.region_layer_reference`` on
    the same tensors, bit for bit."""
    ref = torch.cat([conv_stream.region_layer_reference(x[lo:lo + 16], kernel, bias, shifts,
                                                         layer, pool, last)
                     for lo in range(0, x.shape[0], 16)])
    if route == "layer":
        got = region_layer.region_layer(x, kernel, bias, shifts, layer)
        check(x.device.type == "cpu" or got.is_contiguous(memory_format=torch.channels_last),
              f"{tag}: the output is not channels-last")
    elif route == "bias":  # the layer kernel's bias instantiation (no route reaches it)
        got = int8.fused_conv_layer(x, kernel, shifts, layer, bias=bias)
    else:
        got = conv_stream.conv_stream(x, kernel, bias, shifts, layer, pool=pool, last=last)
    _sync(x.device)
    check(torch.equal(got, ref), f"{tag}: {int((got != ref).sum())} of {ref.numel()} differ")


def yolo_model(seed: int = 0):
    """yolov2-tiny-voc (``registry.DETECTORS``) with seeded weights,
    biases and shifts (``_region_weights`` per layer; the last shift 15):
    what the card's main path of the region family runs."""
    from tpu_cnn_torch.models.region import RegionModel

    rs = np.random.RandomState(seed)
    kernels, biases, shifts = [], [], []
    for ic, oc, _, k, _ in YOLO.specs:
        kernel, bias, shift = _region_weights(rs, ic, oc, k, x_rms=110.0)
        kernels.append(kernel)
        biases.append(bias)
        shifts.append(shift)
    shifts[-1] = 15
    return RegionModel(kernels, biases, shifts, YOLO)


def region_layers_vs_plain(dev: torch.device) -> tuple[float, int, float, int]:
    """yolov2-tiny-voc's layers, each on its kernel against the plain
    version, each on the kernel the engine routes it to
    (``engine.cuda.region_routes``): L0-L3 on the region route's layer
    kernel (``YOLO_BATCH`` frames; L1-L3 channels-last, as the engine hands
    them over, and NCHW; the ``REGION_LAYER_EDGES``; and the layer kernel's
    bias instantiation once, which no route reaches now), L4-L8 on the
    streamed kernel at
    ``KERNEL_BATCH`` and at ``STREAM_BATCHES`` (the map channels-last, as
    the engine hands it over, and NCHW; rows of a TMA im2col load crossing
    images, ragged last M tiles, L8's partial N tile, a persistent grid
    with a second tile and unequal work), and the streamed kernel's edges
    (all-255 maps by +127 / -128 weights at shifts 0 and 31, biases at the
    int32 range's eighth) -> (layer err, cases, stream err, cases)."""
    rs = np.random.RandomState(23)
    layer_n = stream_n = 0
    for i, ((ic, oc, s, k, pool), route) in enumerate(zip(YOLO.specs,
                                                          region_routes(YOLO.specs))):
        last = i == len(YOLO.specs) - 1
        batch = YOLO_BATCH if route == "layer" else KERNEL_BATCH
        kernel, bias, shift = _region_weights(rs, ic, oc, k)
        shifts = torch.tensor([0] * i + [shift], dtype=torch.int32, device=dev)
        x = torch.from_numpy(rs.randint(0, 256, (batch, ic, s, s)).astype(np.uint8)).to(dev)
        kt, bt = torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev)
        forms = [x] if route == "layer" and i == 0 else [
            x, x.contiguous(memory_format=torch.channels_last)]
        for form in forms:
            _region_layer_case(f"yolo L{i} {route} {tuple(x.shape)}", form, kt, bt, shifts,
                               i, pool, last, route)
            layer_n += route == "layer"
            stream_n += route == "stream"
    routes = region_routes(YOLO.specs)
    for i, batch in itertools.product(range(len(YOLO.specs)), STREAM_BATCHES):
        if routes[i] != "stream":
            continue
        ic, oc, s, k, pool = YOLO.specs[i]
        kernel, bias, shift = _region_weights(rs, ic, oc, k)
        shifts = torch.tensor([0] * i + [shift], dtype=torch.int32, device=dev)
        x = torch.from_numpy(rs.randint(0, 256, (batch, ic, s, s)).astype(np.uint8)).to(dev)
        kt, bt = torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev)
        for form in (x, x.contiguous(memory_format=torch.channels_last)):
            _region_layer_case(f"yolo L{i} stream {tuple(x.shape)}", form, kt, bt, shifts, i,
                               pool, i == len(YOLO.specs) - 1, "stream")
            stream_n += 1
    for pool, last in ((0, False), (1, False), (2, False), (0, True)):
        for w, shift in ((127, 0), (-128, 31), (127, 31), (-128, 0)):
            x = torch.full((3, 128, 26 if pool == 2 else 13, 26 if pool == 2 else 13), 255,
                           dtype=torch.uint8, device=dev)
            kt = torch.full((130, 128, 3, 3), w, dtype=torch.int8, device=dev)
            bt = torch.full((130,), (-1) ** shift * 2**28, dtype=torch.int32, device=dev)
            shifts = torch.tensor([shift], dtype=torch.int32, device=dev)
            _region_layer_case(f"stream edge pool {pool} last {last} w {w} shift {shift}",
                               x, kt, bt, shifts, 0, pool, last, "stream")
            stream_n += 1
    for batch, ic, oc, s, layout in REGION_LAYER_EDGES:
        kernel, bias, shift = _region_weights(rs, ic, oc, 3)
        h = 6 if ic == 127 else s  # 127 channels: a band of rows across the width
        x = torch.from_numpy(rs.randint(0, 256, (batch, ic + (layout == "strided"), h, s))
                             .astype(np.uint8)).to(dev)
        x = (x[:, 1:] if layout == "strided" else
             x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x)
        _region_layer_case(f"region_layer edge {(batch, ic, oc, h, s, layout)}", x,
                           torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev),
                           torch.tensor([shift], dtype=torch.int32, device=dev), 0, 2, False,
                           "layer")
        layer_n += 1
    # the layer kernel's bias instantiation, kept until ROADMAP S.3 removes it
    kernel, bias, shift = _region_weights(rs, 16, 32, 3)
    x = torch.from_numpy(rs.randint(0, 256, (3, 16, 26, 26)).astype(np.uint8)).to(dev)
    _region_layer_case("layer kernel with a bias", x, torch.from_numpy(kernel).to(dev),
                       torch.from_numpy(bias).to(dev),
                       torch.tensor([shift], dtype=torch.int32, device=dev), 0, 2, False, "bias")
    return 0.0, layer_n, 0.0, stream_n


# YOLOv3's new modes, one case each (batch, ic, oc, side, k, mode): the
# layer kernel's unpooled map (L0's recast, L2's 1x1 as its 3x3, L3 and L7
# with their residual) and stride-2 conv (L1, L5); the streamed kernel's
# stride 2 (L12; L62 reading layer 61's map inside L86's), residual (L14;
# L60 writing layer 61's map into L86's channels 256..767), upsample (L84
# into L86's channels 0..255, L96 into L98's) and linear 255 channels (L81,
# L105: two N tiles)
YOLO3_LAYER_CASES = ((2, 3, 32, 416, 3, "plain", False), (3, 32, 64, 416, 3, "stride2", False),
                     (3, 64, 32, 208, 1, "plain", False), (3, 32, 64, 208, 3, "plain", True),
                     (3, 64, 128, 208, 3, "stride2", False), (5, 64, 128, 104, 3, "plain", True))
YOLO3_STREAM_CASES = (  # (batch, ic, oc, side, k, stride, residual, upsample, in, out pitch)
    (KERNEL_BATCH, 128, 256, 104, 3, 2, False, False, 0, 0),
    (5, 512, 1024, 26, 3, 2, False, False, 768, 0),
    (KERNEL_BATCH, 128, 256, 52, 3, 1, True, False, 0, 0),
    (7, 256, 512, 26, 3, 1, True, False, 0, 768),
    (KERNEL_BATCH, 512, 256, 13, 1, 1, False, True, 0, 768),
    (9, 256, 128, 26, 1, 1, False, True, 0, 384),
    (KERNEL_BATCH, 1024, 255, 13, 1, 1, False, False, 0, 0),
    (5, 256, 255, 52, 1, 1, False, False, 0, 0))


def yolo3_layers_vs_plain(dev: torch.device) -> tuple[int, int]:
    """YOLOv3's new modes of both kernels (``YOLO3_LAYER_CASES``,
    ``YOLO3_STREAM_CASES``), each against ``conv_stream.graph_layer_reference``
    bit for bit: the residual a seeded map, a pitched input written inside a
    wider channels-last map, a pitched output written into one whose other
    channels must stay as they were -> (layer cases, stream cases)."""
    rs = np.random.RandomState(31)
    layer_n = stream_n = 0
    for b, ic, oc, s, k, mode, res in YOLO3_LAYER_CASES:
        kernel, bias, shift = _region_weights(rs, ic, oc, k)
        shifts = torch.tensor([shift], dtype=torch.int32, device=dev)
        x = torch.from_numpy(rs.randint(0, 256, (b, ic, s, s)).astype(np.uint8)).to(dev)
        if ic % 16 == 0:
            x = x.contiguous(memory_format=torch.channels_last)
        o = s if mode == "plain" else s // 2
        r = (torch.from_numpy(rs.randint(0, 256, (b, oc, o, o)).astype(np.uint8)).to(dev)
             .contiguous(memory_format=torch.channels_last) if res else None)
        kt, bt = torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev)
        got = region_layer.region_layer(x, kt, bt, shifts, 0, out_mode=mode, residual=r)
        want = conv_stream.graph_layer_reference(x, kt, bt, shifts, 0,
                                                 stride=2 if mode == "stride2" else 1,
                                                 residual=r)
        _sync(dev)
        check(torch.equal(got, want), f"yolov3 layer kernel {(b, ic, oc, s, k, mode, res)}: "
                                      f"{int((got != want).sum())} of {want.numel()} differ")
        layer_n += 1
    for b, ic, oc, s, k, stride, res, up, pin, pout in YOLO3_STREAM_CASES:
        kernel, bias, shift = _region_weights(rs, ic, oc, k)
        shifts = torch.tensor([shift], dtype=torch.int32, device=dev)
        last = oc == 255
        x = torch.from_numpy(rs.randint(0, 256, (b, ic, s, s)).astype(np.uint8)).to(dev)
        if pin:
            wide = torch.zeros((b, s, s, pin), dtype=torch.uint8, device=dev)
            wide[..., pin - ic:] = x.permute(0, 2, 3, 1)
            xin = wide.permute(0, 3, 1, 2)[:, pin - ic:]
        else:
            xin = x.contiguous(memory_format=torch.channels_last)
        o = s // stride
        r = (torch.from_numpy(rs.randint(0, 256, (b, oc, o, o)).astype(np.uint8)).to(dev)
             .contiguous(memory_format=torch.channels_last) if res else None)
        out, wide_out, at = None, None, 0
        if pout:
            side = 2 * o if up else o
            wide_out = torch.full((b, side, side, pout), 77, dtype=torch.uint8, device=dev)
            at = 0 if up else pout - oc
            out = wide_out.permute(0, 3, 1, 2)[:, at:at + oc]
        kt, bt = torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev)
        got = conv_stream.conv_stream(xin, kt, bt, shifts, 0, stride=stride, residual=r,
                                      out=out, upsample=up, last=last)
        want = conv_stream.graph_layer_reference(x, kt, bt, shifts, 0, stride=stride,
                                                 last=last, residual=r, upsample=up)
        _sync(dev)
        tag = f"yolov3 streamed kernel {(b, ic, oc, s, k, stride, res, up, pin, pout)}"
        check(torch.equal(got, want), f"{tag}: {int((got != want).sum())} of "
                                      f"{want.numel()} differ")
        if wide_out is not None:
            rest = torch.cat([wide_out[..., :at], wide_out[..., at + oc:]], dim=-1)
            check(bool((rest == 77).all()), f"{tag}: wrote outside its channels")
        stream_n += 1
    return layer_n, stream_n


# the [yolo] head's seeded sums: (batch, grids, classes, objectness mean):
# YOLOv3-416's three heads at few and at many candidates (past a page of
# keys: the pages' search), a small three-head net, and sums leaving none
YOLO3_HEAD_CASES = ((KERNEL_BATCH, (13, 26, 52), 80, -8.0), (5, (13, 26, 52), 80, -2.0),
                    (4, (2, 4, 8), 4, -3.0), (3, (13, 26, 52), 80, -40.0))


def yolo_head_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The [yolo] head's kernel against ``yolo_detect_reference`` on seeded
    sums of three heads (channels-last, as the streamed kernel leaves them;
    ``YOLO3_HEAD_CASES``): counts equal, and every pair matched within 1e-5
    where no near tie lets the two orders differ (``region_dets_agree``)."""
    from tpu_cnn_torch.models.region import COCO_ANCHORS, COCO_MASKS

    rs = np.random.RandomState(37)
    shift = 12
    shifts = torch.tensor([shift] * 3, dtype=torch.int32, device=dev)
    max_err, n = 0.0, 0
    for batch, grids, classes, obj_mean in YOLO3_HEAD_CASES:
        sums = []
        for g in grids:
            t = rs.standard_normal((batch, 3, 5 + classes, g, g)) * 2.0
            t[:, :, 4] += obj_mean
            t[:, :, 5:] += obj_mean / 3
            t = torch.from_numpy(np.round(t * 2**shift).astype(np.int32)).to(dev)
            sums.append(t.reshape(batch, -1, g, g).contiguous(memory_format=torch.channels_last))
        args = ([0, 1, 2], COCO_ANCHORS, COCO_MASKS, classes, 416, 0.005, 0.45, 100)
        got = yolo_head.yolo_detect(sums, shifts, *args)
        want = yolo_head.yolo_detect_reference([t.cpu() for t in sums], shifts.cpu(), *args)
        _sync(dev)
        want = tuple(w.to(dev) for w in want)
        _, _, err = region_dets_agree(got, want, 0.45)
        max_err, n = max(max_err, err), n + 1
    return max_err, n


def region_dets_agree(got, want, nms: float, tol: float = 1e-5) -> tuple[int, int, float]:
    """The region head's answer ``got`` (dets (B, M, 6), count (B,))
    against its plain version's ``want``, where float32 roundings may
    order two near-equal scores either way: counts equal, and every pair
    of each side matched by a pair of the other (same class; box and score
    within ``tol``) but where a near tie lets the two differ: a pair
    scoring within ``tol`` of the other side's last kept score (the cut),
    or one that a pair of the same class on the other side, scoring within
    ``tol`` of it, overlaps past ``nms - tol`` (NMS kept the other). ->
    (frames in another order, pairs let through by a tie, largest error of
    a matched pair); raises on anything else."""
    (gd, gc), (wd, wc) = got, want
    check(torch.equal(gc.long(), wc.long()),
          f"region_head: counts differ in {int((gc.long() != wc.long()).sum())} frames")
    b, m, _ = gd.shape
    slots = torch.arange(m, device=gd.device)
    valid = slots[None] < gc.long()[:, None]
    same = gd[:, :, None, 5] == wd[:, None, :, 5]
    diff = (gd[:, :, None, :5] - wd[:, None, :, :5]).abs().amax(dim=-1)
    both = valid[:, :, None] & valid[:, None, :]
    match = same & (diff <= tol) & both
    last = (gc.long() - 1).clamp_min(0)
    rows = torch.arange(b, device=gd.device)
    let_through = 0
    for d, other, hits in ((gd, wd, match.any(dim=2)), (wd, gd, match.any(dim=1))):
        cut = other[rows, last, 4]
        at_cut = (d[..., 4] - cut[:, None]).abs() <= tol
        ov = region_head._iou(d[:, :, None, :4], other[:, None, :, :4])
        swap = ((d[:, :, None, 5] == other[:, None, :, 5])
                & ((d[:, :, None, 4] - other[:, None, :, 4]).abs() <= tol)
                & (ov > nms - tol) & both).any(dim=2)
        loose = valid & ~hits
        bad = loose & ~(at_cut | swap)
        check(not bool(bad.any()),
              f"region_head: {int(bad.sum())} pairs in {int(bad.any(dim=1).sum())} frames "
              f"have no counterpart and no near tie")
        let_through += int(loose.sum())
    in_place = (match & (slots[:, None] == slots[None, :])[None]).any(dim=2) | ~valid
    err = float(torch.where(match, diff, torch.zeros_like(diff)).amax()) if b else 0.0
    return int((~in_place.all(dim=1)).sum()), let_through, err


def region_head_vs_plain(dev: torch.device) -> tuple[float, int]:
    """The region head's kernel against ``region_detect_reference`` on
    seeded sums of yolov2-tiny-voc's last layer (channels-last, as the
    streamed kernel leaves them), from few candidates a frame to
    thousands, and on sums that leave none: counts equal, and every
    detection within 1e-5 (the kernel's expf and fused multiply-adds
    against torch's float32)."""
    rs = np.random.RandomState(29)
    a, c = YOLO.num_anchors, YOLO.num_classes
    g, e = YOLO.grid, YOLO.entries
    shift = 15
    anchors = torch.tensor(YOLO.anchors, dtype=torch.float32, device=dev)
    shifts = torch.tensor([shift], dtype=torch.int32, device=dev)
    max_err, n = 0.0, 0
    for batch, obj_mean in ((KERNEL_BATCH, -6.0), (KERNEL_BATCH, -3.5), (4, 0.0),
                            (3, -40.0)):
        t = rs.standard_normal((batch, g, g, a, e))
        t[..., 4] += obj_mean
        t = torch.from_numpy(np.round(t * 2**shift).astype(np.int32)).to(dev)
        t = t.reshape(batch, g, g, a * e).permute(0, 3, 1, 2)
        got = region_head.region_detect(t, shifts, 0, anchors, c, YOLO.thresh, YOLO.nms,
                                        YOLO.max_det)
        want = region_head.region_detect_reference(t, shifts, 0, anchors, c, YOLO.thresh,
                                                   YOLO.nms, YOLO.max_det)
        _sync(dev)
        check(torch.equal(got[1], want[1]),
              f"region_head (B={batch}, objectness {obj_mean}): counts "
              f"{got[1].tolist()} != {want[1].tolist()}")
        err = float((got[0] - want[0]).abs().max())
        check(err <= 1e-5, f"region_head (B={batch}, objectness {obj_mean}): "
                           f"max_abs_err {err}")
        max_err, n = max(max_err, err), n + 1
    return max_err, n


def _path_counts() -> dict[str, dict[str, int]]:
    return {name: _build.path_counts(name) for name in MODULES}


def run_all(dev: torch.device) -> dict:
    """Every case on ``dev`` (the kernels' launch counters zeroed first).
    Returns the kernels' launches, the paths their launches took (on a
    CUDA device; none on the CPU), and each kernel's cases and largest
    absolute difference."""
    for module in MODULES.values():
        module.launches = 0
    before = _path_counts() if dev.type == "cuda" else {}
    mega_err, mega_n = mega_vs_plain(dev)
    layer_err, layer_n = layer_vs_plain(dev)
    act_err, act_n = act_vs_plain(dev)
    e_act, n_act, e_layer, n_layer = layer_edges(dev)
    g_act, gn_act, g_layer, gn_layer = layer_generic_channels(dev)
    chain_vs_oracle(dev)
    plans = smem_plans_vs_kernel() if dev.type == "cuda" else 0
    bit_err, bit_n = bitcast_vs_plain(dev)
    cam_err, cam_n = cam_head_vs_plain(dev)
    rl_err, rl_n, rs_err, rs_n = region_layers_vs_plain(dev)
    rh_err, rh_n = region_head_vs_plain(dev)
    y3l_n, y3s_n = yolo3_layers_vs_plain(dev)
    yh_err, yh_n = yolo_head_vs_plain(dev)
    after = _path_counts() if dev.type == "cuda" else {}
    return {
        "launches": {name: m.launches for name, m in MODULES.items()},
        "paths": sorted({f"{PATH_PREFIX[name]}: {path}" for name, counts in after.items()
                         for path, n in counts.items() if n > before[name][path]}),
        "smem_plans": plans,
        "cases": {"mega_cnn": mega_n, "conv_pool_layer": layer_n + n_layer + gn_layer,
                  "conv_act": act_n + n_act + gn_act + 1,  # + the bias instantiation's
                  "bitcast": bit_n,
                  "cam_head": cam_n, "conv_stream": rs_n + y3s_n, "region_head": rh_n,
                  "region_layer": rl_n + y3l_n, "yolo_head": yh_n},
        "max_abs_err": {"mega_cnn": mega_err,
                        "conv_pool_layer": max(layer_err, e_layer, g_layer),
                        "conv_act": max(act_err, e_act, g_act),
                        "bitcast": bit_err, "cam_head": cam_err,
                        "conv_stream": rs_err, "region_head": rh_err,
                        "region_layer": rl_err, "yolo_head": yh_err}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_cases: torch finds no CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = run_all(dev)
    missing = [p for p in REQUIRED_PATHS if p not in out["paths"]]
    out.update(batch=KERNEL_BATCH, device=str(dev), missing_paths=missing,
               seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    if missing:
        raise SystemExit(f"kernel_cases: paths not reached: {missing}")


if __name__ == "__main__":
    main()
