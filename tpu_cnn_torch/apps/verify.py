"""Cross-implementation parity verifier on the port — the golden-model test.

Port of ``tpu_cnn.apps.verify``. The reference's most important test
compares every value of every channel against a golden model and ends in a
"DESIGN IS BIT-ACCURATE" verdict; this CLI does the same across

    numpy oracle  vs  native C++ oracle  vs  the port's plain contract
    (f32, int32)  vs  pallas  vs  hybrid  vs  mega

over controlled stimuli (the testbench ramp, all-zero, all-255), random
images and, at 128x128, the test images of ``--image-dir``, with a
per-channel mismatch report for every failing pair. Every backend but the
two oracles runs through ``CUDAEngine`` on ``--device`` (``cuda``: the
hand-written kernels; ``cpu``: their plain versions). Then the detect head
of each of those engines (``cnn_forward_mega`` for ``mega``, else the
features then ``detect``) is held against the host twins: bins,
predictions, probabilities and the CAM box; and its multi-object detect
(``detect_multi_batch`` with two instances): every class's box, the
instance boxes and counts, and the presence scores (the bundle's
``multi_head.npz``, else a seeded head).

A backend named in ``--backends`` that cannot run (no card, no compiler,
no plan for the geometry) ends the run with exit code 2: nothing is
skipped. The exit code is 0 on the verdict, 1 on a mismatch.

Usage:
  python -m tpu_cnn_torch.apps.verify --device cpu --variant lyr3-tiny
  python -m tpu_cnn_torch.apps.verify --device cuda
  python -m tpu_cnn_torch.apps.verify --device cuda --variant lyr4-wide
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from tpu_cnn.apps.verify import compare, make_stimuli
from tpu_cnn.head.cam import cam_bbox_fast, cam_bbox_multi
from tpu_cnn.head.classify import bin_pool_np, classify_np, multi_scores_np
from tpu_cnn.models.cnn import DEFAULT_SHIFTS, FpgaCNN
from tpu_cnn.models.registry import default_shifts, get_config
from tpu_cnn.utils import artifacts as art
from tpu_cnn.utils import weights as wc
from tpu_cnn.utils.paths import default_artifacts
from tpu_cnn_torch.engine.cuda import CUDAEngine
from tpu_cnn_torch.ops import quant
from tpu_cnn_torch.utils.host_twins import cam_instances

# verify backend -> (CUDAEngine backend, compute_dtype)
ENGINE_BACKENDS = {
    "xla-f32": ("xla", "float32"),
    "xla-int32": ("xla", "int32"),
    "pallas": ("pallas", "float32"),
    "hybrid": ("hybrid", "float32"),
    "mega": ("mega", "float32"),
}
BACKENDS = ("numpy", "native", *ENGINE_BACKENDS)
INSTANCES = 2  # the host twin cam_instances' default


class BackendUnavailable(RuntimeError):
    """A backend named on the command line cannot run."""


def build_backends(model: FpgaCNN, names, device: str):
    """Map backend name -> fn(images (B, S, S) u8) -> (B, C, S'*S') u8,
    and the engines of the device backends. Raises BackendUnavailable for a
    backend that cannot run."""
    kernels, shifts = model.kernels, model.shifts
    backends, engines = {}, {}
    for name in names:
        try:
            if name == "numpy":
                from tpu_cnn.engine.cpu_ref import numpy_cnn_forward

                backends[name] = lambda imgs: np.stack(
                    [numpy_cnn_forward(im, kernels, shifts) for im in imgs])
            elif name == "native":
                from tpu_cnn.native.oracle import NativeOracle

                oracle = NativeOracle()
                backends[name] = lambda imgs: oracle.infer_batch(
                    imgs, kernels, shifts)
            else:
                backend, dtype = ENGINE_BACKENDS[name]
                engine = CUDAEngine(model, device=device, backend=backend,
                                    compute_dtype=dtype)
                engines[name] = engine
                backends[name] = engine.run_batch
        except (OSError, RuntimeError, ValueError) as e:
            # no card, no compiler, no plan for the geometry
            raise BackendUnavailable(f"{name}: {type(e).__name__}: {e}") from e
    return backends, engines


def verify_head(engine: CUDAEngine, label: str, batch, stim_names,
                want_feats, fc_weight, fc_bias, img_size,
                multi_head) -> bool:
    """The engine's detect head and multi-object detect against the host
    numpy twins."""
    _, pooled, pred, _conf, probs, bbox = engine.detect_with_features(batch)
    multi = engine.detect_multi_batch(batch, instances=INSTANCES)
    widx, _, wprobs = classify_np(want_feats, fc_weight, fc_bias)
    want_bbox = np.stack([
        cam_bbox_fast(want_feats[i], int(widx[i]), fc_weight, img_size)
        for i in range(len(batch))])
    want_mboxes = np.stack([cam_bbox_multi(f, fc_weight, img_size=img_size)
                            for f in want_feats])
    want_inst = [cam_instances(f, fc_weight, img_size=img_size,
                               max_instances=INSTANCES) for f in want_feats]
    want_iboxes = np.stack([w[0] for w in want_inst])
    want_icounts = np.stack([w[1] for w in want_inst])
    want_scores = multi_scores_np(bin_pool_np(want_feats), *multi_head)
    # fused bin sums are exact integers; /16/255 folding may differ by 1
    # ulp. Probabilities and presence scores: the 1024-term logit dot sums
    # in another order (the JAX verify's tolerances).
    inst_bad = ((multi.inst_boxes != want_iboxes).any(axis=(1, 2, 3))
                | (multi.inst_counts != want_icounts).any(axis=(1, 2)))
    checks = [
        ("bin pooling", np.allclose(pooled, bin_pool_np(want_feats),
                                    atol=1e-5), []),
        ("predictions", np.array_equal(pred, widx.astype(pred.dtype)),
         np.nonzero(pred != widx)[0]),
        ("probabilities", np.allclose(probs, wprobs, atol=1e-4), []),
        ("CAM bbox", np.array_equal(bbox, want_bbox.astype(bbox.dtype)),
         np.nonzero((bbox != want_bbox).any(axis=1))[0]),
        ("multi boxes", np.array_equal(multi.boxes, want_mboxes),
         np.nonzero((multi.boxes != want_mboxes).any(axis=(1, 2)))[0]),
        ("instances", not inst_bad.any(), np.nonzero(inst_bad)[0]),
        ("multi scores", np.allclose(multi.scores, want_scores, atol=1e-4),
         []),
    ]
    ok = True
    for name, good, bad in checks:
        if good:
            print(f"  head[{label}] vs host twin {name:13s}: OK")
            continue
        ok = False
        where = [stim_names[i] for i in bad[:6]]
        print(f"  head[{label}] vs host twin {name:13s}: MISMATCH "
              f"{('on ' + ', '.join(where)) if where else ''}")
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Cross-implementation parity "
                                            "verifier on the CUDA port")
    p.add_argument("--weights", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--images", type=int, default=4, help="random stimuli count")
    p.add_argument("--backends", default=",".join(BACKENDS),
                   help=f"comma list of {','.join(BACKENDS)} (default: all)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions")
    p.add_argument("--no-head", action="store_true",
                   help="skip the detect-head stage (classify + CAM vs the "
                        "host twins)")
    p.add_argument("--shifts", default=None)
    p.add_argument("--variant", default="lyr3-std",
                   help="model geometry from models.registry; non-stock "
                        "variants verify with seeded random weights")
    args = p.parse_args(argv)

    names = [b.strip() for b in args.backends.split(",")]
    unknown = [n for n in names if n not in BACKENDS]
    if unknown:
        p.error(f"unknown backends {unknown}: choose from {list(BACKENDS)}")
    config = get_config(args.variant)
    if args.shifts is None:
        shifts = (list(DEFAULT_SHIFTS) if args.variant == "lyr3-std"
                  else default_shifts(config))
    else:
        shifts = [int(s) for s in args.shifts.split(",")]
    if len(shifts) != len(config.layer_configs):
        p.error(f"--shifts: one per layer ({len(config.layer_configs)})")
    try:
        quant.check_shifts(shifts)
    except ValueError as e:
        p.error(f"--shifts: {e}")

    if args.weights is not None:
        kernels = wc.load_weights_bin(args.weights, config.layer_configs)
    elif args.variant == "lyr3-std":
        kernels = wc.load_weights_bin(os.path.join(default_artifacts(),
                                                   "weights.bin"))
    else:
        # Parity is about arithmetic, not trained weights: seeded random
        # int8 kernels exercise the full accumulation range.
        rs = np.random.RandomState(0)
        kernels = [rs.randint(-127, 128, size=(oc, ic, 3, 3)).astype(np.int8)
                   for ic, oc, _ in config.layer_configs]
    # the head: the shipped bundle's bins head where its feature dim fits
    # this geometry, else a seeded random bins head (head arithmetic parity)
    d = kernels[-1].shape[0] * 16
    fcw = fcb = multi_head = None
    if args.variant == "lyr3-std":
        bundle = art.load_bundle(default_artifacts())
        if bundle.fc_weight.shape[1] == d:
            fcw, fcb = bundle.fc_weight, bundle.fc_bias
            multi_head = bundle.multi_head
    if fcw is None:
        rs = np.random.RandomState(7)
        fcw = (rs.randn(6, d) * 0.05).astype(np.float32)
        fcb = np.zeros(6, np.float32)
    if multi_head is None:
        # seeded presence head (the JAX verify's): the sigmoid-score
        # arithmetic is verified without a shipped head
        rs = np.random.RandomState(11)
        multi_head = ((rs.randn(*fcw.shape) * 0.05).astype(np.float32),
                      np.zeros(fcw.shape[0], np.float32))
    model = FpgaCNN(kernels, fcw, fcb, shifts=shifts, config=config,
                    multi_head=multi_head)

    print("=" * 64)
    print(f"  CROSS-IMPLEMENTATION PARITY VERIFICATION [{args.variant}, "
          f"port on {args.device}]")
    print("=" * 64)
    stims = make_stimuli(args.images, args.image_dir, size=config.img_size)
    batch = np.stack(list(stims.values()))
    stim_names = list(stims)
    print(f"  {len(stims)} stimuli x {len(names)} backends (shifts {shifts})")

    try:
        backends, engines = build_backends(model, names, args.device)
    except BackendUnavailable as e:
        print(f"  backend cannot run: {e}")
        print("  VERDICT: NOT VERIFIED — a named backend cannot run")
        return 2
    outputs = {}
    for name, fn in backends.items():
        outputs[name] = fn(batch)
        on = f" on {engines[name].backend}" if name in engines else ""
        print(f"  {name:10s}: computed {outputs[name].shape}{on}")

    print("-" * 64)
    ref = "numpy" if "numpy" in outputs else next(iter(outputs))
    ok = compare(ref, outputs, stim_names)

    if not args.no_head and engines:
        print("-" * 64)
        for name, engine in engines.items():
            ok = verify_head(engine, name, batch, stim_names, outputs[ref],
                             fcw, fcb, config.img_size, multi_head) and ok
    print("=" * 64)
    if ok:
        print("  VERDICT: DESIGN IS BIT-ACCURATE across all backends")
    else:
        print("  VERDICT: MISMATCHES FOUND — see report above")
    print("=" * 64)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
