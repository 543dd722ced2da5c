#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_cnn_torch``) end to end on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (CUDA toolkit), ``g++`` (the native
oracle of the verify phase) and the repository around this file; it fails
with a non-zero exit code otherwise. Two model families run: lyr3-std
(128x128) and lyr4-wide (256x256), on four main paths: each family on the
default ``mega`` backend (lyr3-std: the whole net in the megakernel;
lyr4-wide: the chained plan, the layer kernel for L0, then the megakernel
for L1-L3), lyr4-wide on ``pallas`` (every layer on the conv kernel) and
lyr3-std on ``hybrid`` (L0 on the conv kernel, L1-L2 plain). Phases, one
line each, in order; any failure raises:

  1. header   — the card (nvidia-smi name and power limit), torch, CUDA
  2. build    — nvcc builds csrc/mega_cnn.cu, csrc/conv_pool_layer.cu and
                csrc/conv_act.cu for sm_90a, in parallel
  3. kernel   — each kernel against its plain PyTorch version on the card,
                B=37. The megakernel: lyr3-std (shipped and seeded random
                weights, shifts 2/4/6 and 1/3/5, every with_feats/bins/twin
                combination), lyr3-tiny, lyr2-small, and lyr4-wide's L1-L3
                tail from a (B, 16, 128, 128) input. The layer kernel:
                lyr4-wide's L0 (shipped and seeded weights, shifts 3 and
                0), 16->32 at 128^2 and two small odd geometries. The conv
                kernel: every layer of lyr3-std and lyr4-wide (shipped
                weights on the plain chain's activations at the model's
                shift, seeded weights at shifts 0 and 31), the rectangles
                6x10 and 7x12 and 20->35 across the channel chunks; then
                its pooled output against the layer kernel on lyr4-wide's
                L0. Then the lyr4-wide chain against the numpy oracle on 4
                images. Features and twin bit-equal, bins within 1e-6; the
                plain f32 and int32 versions bit-equal to each other.
  4. engine   — CUDAEngine(device="cuda", backend=...) through the bench's
                parity gate on 28 shipped test images + 4 noise images,
                per path, and set_shifts against the oracle
  5. cli      — tpu_cnn_torch.apps.infer --mode ... over the shipped test
                images, per path; accuracy equal to the numpy oracle's
  6. server   — tpu_cnn_torch.apps.serve --mode ... behind HTTP on
                127.0.0.1, per path: 8 raw image POSTs, each answer equal
                to the host oracle's
  verify      — tpu_cnn_torch.apps.verify --device cuda for lyr3-std
                (shipped weights) and lyr4-wide (seeded weights): all seven
                backends bit-exact and every engine head equal to the host
                twins; exit 0 and the verdict line
  7. times    — at batch 1536, CUDA events, median: lyr3-std's megakernel
                and its plain version; lyr4-wide's layer kernel, tail and
                chain and their plain versions; the conv kernel on each
                lyr3-std layer and lyr4-wide's L0 and its plain version;
                the async-pipelined engine detect FPS of each family on
                mega and of lyr3-std on pallas and hybrid

Phases 4-6 are the main paths, once per path: every kernel launch counter
is set to 0 before a path's phases 4-6 and read after them, and each
kernel of that path must have launched there and no other kernel
(lyr3-std/mega: the megakernel; lyr4-wide/mega: the megakernel and the
layer kernel; lyr4-wide/pallas and lyr3-std/hybrid: the conv kernel). The
line before the last is a JSON object with each kernel's launches (summed
over the paths), error and times; the last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

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

from tpu_cnn.apps.common import load_model  # noqa: E402
from tpu_cnn.apps.serve import ServiceHTTPServer, make_handler  # noqa: E402
from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.head.cam import cam_bbox_fast  # noqa: E402
from tpu_cnn.head.classify import classify_np  # noqa: E402
from tpu_cnn.models.registry import default_shifts, get_config  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.artifacts import label_from_filename  # noqa: E402
from tpu_cnn_torch import bench_gate  # noqa: E402
from tpu_cnn_torch.apps import infer, serve, verify  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.ops import _build, conv_pool, int8, mega  # noqa: E402

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
}
# the main paths: (family, engine backend, the shifts set_shifts tries, the
# kernels the path must launch; it must launch no other)
PATHS = [("lyr3-std", "mega", (1, 3, 5), ("mega_cnn",)),
         ("lyr4-wide", "mega", (2, 4, 6, 8), ("mega_cnn", "conv_pool_layer")),
         ("lyr4-wide", "pallas", (2, 4, 6, 8), ("conv_act",)),
         ("lyr3-std", "hybrid", (1, 3, 5), ("conv_act",))]
MODULES = {"mega_cnn": mega, "conv_pool_layer": conv_pool, "conv_act": int8}
VERDICT = "VERDICT: DESIGN IS BIT-ACCURATE across all backends"
BINS_TOL = 1e-6  # the kernel's bins vs the plain version's (1-ulp / order)
BENCH_BATCH = 1536  # bench.py's batch
KERNEL_BATCH = 37  # the kernel cases' batch: not a multiple of any tile
COMBOS = [c for c in itertools.product((True, False), repeat=3) if any(c)]


def macs_per_image(layer_configs) -> int:
    return sum(oc * ic * 9 * s * s for ic, oc, s in layer_configs)


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
        for flags in COMBOS:
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
    max_err = 0.0
    for name, x_np, k_np, sh in setups:
        x = torch.from_numpy(x_np).to(dev)
        k = torch.from_numpy(k_np).to(dev)
        shifts = torch.tensor([7, sh], dtype=torch.int32, device=dev)  # layer 1
        ref = conv_pool.conv_pool_reference(x, k, shifts, 1)
        ref_int = conv_pool.conv_pool_reference(x, k, shifts, 1,
                                                compute_dtype="int32")
        got = conv_pool.conv_pool_layer(x, k, shifts, 1)
        torch.cuda.synchronize()
        check(torch.equal(ref, ref_int),
              f"{name}: plain f32 and int32 paths disagree on the card")
        check(got.dtype == torch.uint8 and torch.equal(got, ref),
              f"{name}: layer kernel differs from its plain version")
        max_err = max(max_err, (got.int() - ref.int()).abs().max().item())
    return max_err, len(setups)


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
    max_err = 0.0
    for name, x, k_np, sh in setups:
        k = torch.from_numpy(k_np).to(dev)
        shifts = torch.tensor([7, sh], dtype=torch.int32, device=dev)  # layer 1
        ref = int8.conv_act_reference(x, k, shifts, 1)
        ref_int = int8.conv_act_reference(x, k, shifts, 1, compute_dtype="int32")
        got = int8.conv_act(x, k, shifts, 1)
        torch.cuda.synchronize()
        check(torch.equal(ref, ref_int),
              f"{name}: plain f32 and int32 paths disagree on the card")
        check(got.dtype == torch.uint8 and torch.equal(got, ref),
              f"{name}: conv kernel differs from its plain version")
        max_err = max(max_err, (got.int() - ref.int()).abs().max().item())

    # two hand-written kernels on one function: conv + pool, lyr4-wide L0
    model = load_model(ARTIFACTS["lyr4-wide"], "lyr4-wide")
    x = torch.from_numpy(bench_gate.load_gate_images(
        ARTIFACTS["lyr4-wide"], n_real=28, n_noise=9, img_size=256)[:, None]).to(dev)
    k = torch.from_numpy(model.kernels[0]).to(dev)
    shifts = torch.from_numpy(model.shifts).to(dev)
    pooled = int8.fused_conv_layer(x, k, shifts, 0)
    layer = conv_pool.conv_pool_layer(x, k, shifts, 0)
    torch.cuda.synchronize()
    check(torch.equal(pooled, layer), "lyr4-wide L0: conv kernel + pool "
                                      "differs from the layer kernel")
    return max_err, len(setups)


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


def kernel_vs_plain(dev: torch.device) -> dict[str, float]:
    mega_err, mega_cases = mega_vs_plain(dev)
    phase("3 kernel", f"mega_cnn: {mega_cases} cases (B={KERNEL_BATCH}) "
                      f"bit-equal feats/twin, bins within {BINS_TOL}; "
                      f"max_abs_err={mega_err!r}")
    layer_err, layer_cases = layer_vs_plain(dev)
    phase("3 kernel", f"conv_pool_layer: {layer_cases} cases (B={KERNEL_BATCH}) "
                      f"bit-equal; max_abs_err={layer_err!r}")
    act_err, act_cases = act_vs_plain(dev)
    phase("3 kernel", f"conv_act: {act_cases} cases (B={KERNEL_BATCH}) "
                      f"bit-equal; max_abs_err={act_err!r}; pooled, bit-equal "
                      f"to conv_pool_layer on lyr4-wide's L0")
    chain_vs_oracle(dev)
    phase("3 kernel", "lyr4-wide chain on 4 shipped images: bit-equal to the "
                      "numpy oracle and the plain chain")
    return {"mega_cnn": mega_err, "conv_pool_layer": layer_err,
            "conv_act": act_err}


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


def server(variant: str, mode: str) -> None:
    bundle = bundle_of(variant)
    model = load_model(ARTIFACTS[variant], variant)
    size = model.config.img_size
    paths = shipped_images(variant)[:8]
    batcher, backend = serve.build_service(ARTIFACTS[variant], device="cuda",
                                           max_batch=8, variant=variant,
                                           mode=mode)
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
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        th.join(timeout=10)
    phase("6 server", f"{variant} ({backend}): {len(paths)} POST /detect of "
                      f"{size * size} "
                      f"bytes equal to the host oracle; /healthz {health}; "
                      f"batches={stats['batches']} requests={stats['requests']}")


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
    if rc != 0 or VERDICT not in text:
        print(text, flush=True)
    check(rc == 0 and VERDICT in text,
          f"tpu_cnn_torch.apps.verify --variant {variant}: exit {rc}")
    phase("verify", f"tpu_cnn_torch.apps.verify --device cuda --variant "
                    f"{variant}: exit 0, {exact} backend pairs bit-exact, "
                    f"{heads} head checks OK; {VERDICT}")


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


def engine_fps(variant: str, backend: str, rs) -> list[float]:
    """bench.py's async pipeline: 52 rounds over 4 staged pools, 3 passes."""
    model = load_model(ARTIFACTS[variant], variant)
    s = model.config.img_size
    engine = CUDAEngine(model, device="cuda", backend=backend)
    pools = [engine.stage_batch(rs.randint(0, 256, (BENCH_BATCH, s, s))
                                .astype(np.uint8)) for _ in range(4)]
    engine.detect_resolve(engine.detect_batch_async(pools[0]))
    rounds = 52

    def measure():
        t0 = time.perf_counter()
        handles = [engine.detect_batch_async(pools[i % 4]) for i in range(rounds)]
        results = [engine.detect_resolve(h) for h in handles]
        dt = time.perf_counter() - t0
        check(len(results) == rounds and results[0].pred.shape == (BENCH_BATCH,),
              "pipelined detect returned the wrong shapes")
        return rounds * BENCH_BATCH / dt

    return [measure() for _ in range(3)]


def times(dev: torch.device, card: str) -> dict[str, tuple[float, float]]:
    """Returns {kernel name: (kernel ms, plain ms)} at batch 1536: the
    megakernel on lyr3-std's whole net, the layer kernel on lyr4-wide's L0,
    the conv kernel on lyr3-std's three layers summed."""
    rs = np.random.RandomState(0)
    # lyr3-std: the whole net in the megakernel
    bundle = art.load_bundle(ARTIFACTS["lyr3-std"])
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 128, 128)).astype(np.uint8)).to(dev)
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    shifts = torch.tensor((2, 4, 6), dtype=torch.int32, device=dev)
    kernel_ms, plain_ms, nk, np_ = _kernel_and_plain_ms(
        lambda: mega.cnn_forward_mega(imgs, ks, shifts, with_feats=False,
                                      with_bins=True, with_twin=True),
        lambda: mega.mega_reference(imgs, ks, shifts))
    tops = (macs_per_image(get_config("lyr3-std").layer_configs) * BENCH_BATCH
            / (kernel_ms * 1e-3) / 1e12)
    phase("7 times", f"lyr3-std batch {BENCH_BATCH} detect outputs on {card}: "
                     f"mega_cnn median {kernel_ms!r} ms (n={nk}, {tops:.2f} int "
                     f"TMAC/s), plain median {plain_ms!r} ms (n={np_})")
    out = {"mega_cnn": (kernel_ms, plain_ms)}
    del imgs

    # lyr4-wide: the layer kernel (L0), the megakernel (L1-L3), the chain
    cfgs = get_config("lyr4-wide").layer_configs
    bundle = bundle_of("lyr4-wide")
    imgs = torch.from_numpy(
        rs.randint(0, 256, (BENCH_BATCH, 256, 256)).astype(np.uint8)).to(dev)
    x = imgs[:, None]
    ks = [torch.from_numpy(k).to(dev) for k in bundle.kernels]
    shifts = torch.tensor((3, 5, 5, 7), dtype=torch.int32, device=dev)
    x16 = conv_pool.conv_pool_layer(x, ks[0], shifts, 0)
    detect = dict(with_feats=False, with_bins=True, with_twin=True)
    stages = {
        "layer kernel L0": (
            lambda: conv_pool.conv_pool_layer(x, ks[0], shifts, 0),
            lambda: conv_pool.conv_pool_reference(x, ks[0], shifts, 0),
            cfgs[:1]),
        "megakernel tail L1-L3": (
            lambda: mega.cnn_forward_mega(x16, ks[1:], shifts[1:], **detect),
            lambda: mega.mega_reference(x16, ks[1:], shifts[1:]),
            cfgs[1:]),
        "chain": (
            lambda: mega.cnn_forward_mega(imgs, ks, shifts, **detect),
            lambda: mega.mega_reference(imgs, ks, shifts),
            cfgs),
    }
    for stage, (kernel, plain, stage_cfgs) in stages.items():
        k_ms, p_ms, nk, np_ = _kernel_and_plain_ms(kernel, plain, 5, 3)
        tops = macs_per_image(stage_cfgs) * BENCH_BATCH / (k_ms * 1e-3) / 1e12
        phase("7 times", f"lyr4-wide {stage} batch {BENCH_BATCH} on {card}: "
                         f"kernel median {k_ms!r} ms (n={nk}, {tops:.2f} int "
                         f"TMAC/s, {k_ms * 1e3 / BENCH_BATCH!r} us/image), plain "
                         f"median {p_ms!r} ms (n={np_}, "
                         f"{p_ms * 1e3 / BENCH_BATCH!r} us/image)")
        if stage == "layer kernel L0":
            out["conv_pool_layer"] = (k_ms, p_ms)
    del imgs, x, x16
    torch.cuda.empty_cache()

    # the conv kernel: each lyr3-std layer, and lyr4-wide's L0 (no pool)
    act_ms = [0.0, 0.0]
    for variant, layers in (("lyr3-std", (0, 1, 2)), ("lyr4-wide", (0,))):
        model = load_model(ARTIFACTS[variant], variant)
        shifts = torch.from_numpy(model.shifts).to(dev)
        for li in layers:
            ic, oc, s = model.config.layer_configs[li]
            x = torch.from_numpy(rs.randint(
                0, 256, (BENCH_BATCH, ic, s, s)).astype(np.uint8)).to(dev)
            k = torch.from_numpy(model.kernels[li]).to(dev)
            k_ms, p_ms, nk, np_ = _kernel_and_plain_ms(
                lambda: int8.conv_act(x, k, shifts, li),
                lambda: int8.conv_act_reference(x, k, shifts, li), 10, 3)
            tops = oc * ic * 9 * s * s * BENCH_BATCH / (k_ms * 1e-3) / 1e12
            gbs = (ic + oc) * s * s * BENCH_BATCH / (k_ms * 1e-3) / 1e9
            phase("7 times", f"{variant} conv_act L{li} ({ic}->{oc} at {s}^2, "
                             f"no pool) batch {BENCH_BATCH} on {card}: kernel "
                             f"median {k_ms!r} ms (n={nk}, {tops:.2f} int "
                             f"TMAC/s, {gbs:.0f} GB/s of u8 in+out), plain "
                             f"median {p_ms!r} ms (n={np_})")
            if variant == "lyr3-std":
                act_ms[0] += k_ms
                act_ms[1] += p_ms
            del x
    out["conv_act"] = tuple(act_ms)
    phase("7 times", f"lyr3-std conv_act L0+L1+L2 on {card}: kernel "
                     f"{act_ms[0]!r} ms, plain {act_ms[1]!r} ms")
    torch.cuda.empty_cache()

    for variant, backend in (("lyr3-std", "mega"), ("lyr4-wide", "mega"),
                             ("lyr3-std", "pallas"), ("lyr3-std", "hybrid")):
        fps = engine_fps(variant, backend, rs)
        phase("7 times", f"{variant} engine ({backend}) detect async-pipelined "
                         f"batch {BENCH_BATCH} on {card}: best {max(fps)!r} "
                         f"FPS of {fps!r}")
        torch.cuda.empty_cache()
    return out


def main() -> None:
    card = header()
    dev = torch.device("cuda", 0)
    build()
    max_err = kernel_vs_plain(dev)

    launches = dict.fromkeys(KERNELS, 0)
    for variant, backend, alt_shifts, path_kernels in PATHS:
        for module in MODULES.values():  # this main path starts here
            module.launches = 0
        engine_gate(variant, backend, alt_shifts)
        cli(variant, backend)
        server(variant, backend)
        counts = {name: module.launches for name, module in MODULES.items()}
        for name, n in counts.items():
            check((n > 0) == (name in path_kernels),
                  f"{variant}/{backend} main path launched {name} {n} times")
            launches[name] += n
        phase("4-6 main path", f"{variant}/{backend} (phases 4-6) kernel "
                               f"launches: {counts}")

    for variant in ARTIFACTS:
        verify_cli(variant)

    ms = times(dev, card)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "max_abs_err": max_err[name],
        "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, (src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
