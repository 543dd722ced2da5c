"""Feature dumper — the ``dump_fpga_features.py`` / ``dump_arm_features.py``
pair, unified behind the engine swap: the port's
``tpu_cnn.apps.dump_features``.

Runs every ``test_image_*.bin`` through the selected engine
(``apps.infer.make_engine``: a ``CUDAEngine`` backend on ``--device``, or
the host oracle with ``--mode cpu``) and writes the reference-schema .npz
(features (N, 64, 256) uint8, labels, names, shifts —
``software/dump_fpga_features.py:116-120``, ``utils.artifacts.
save_feature_dump``) consumed by ``retrain_classifier``. A device engine
runs the set in batches of ``--batch-size`` instead of the reference's
per-image MMIO loop.

Usage:
  python -m tpu_cnn_torch.apps.dump_features --image-dir <dir> --output features.npz
  python -m tpu_cnn_torch.apps.dump_features --mode cpu --output cpu_features.npz
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from tpu_cnn_torch.models.cnn import DEFAULT_SHIFTS, FpgaCNN
from tpu_cnn_torch.utils import artifacts as art


def dump_features(
    model: FpgaCNN,
    image_paths: list[str],
    mode: str = "auto",
    batch_size: int = 256,
    verbose: bool = True,
    device: str = "cuda",
):
    """Returns (features (N, 64, 256) u8, labels (N,), names)."""
    from tpu_cnn_torch.apps.infer import make_engine

    engine = make_engine(model, mode, device)
    s = model.config.img_size
    names = [os.path.basename(p) for p in image_paths]
    labels = np.asarray([art.label_from_filename(p) for p in image_paths])

    imgs, kept, skipped = [], [], 0
    for i, p in enumerate(image_paths):
        try:
            imgs.append(art.load_image_any(p, s).reshape(s, s))
            kept.append(i)
        except (OSError, ValueError) as e:
            # per-image skip-and-continue (dump_fpga_features.py:103-106)
            skipped += 1
            if verbose:
                print(f"  SKIP {names[i]}: {e}")
    if skipped and verbose:
        print(f"  Skipped {skipped} files due to I/O errors")
    images = np.stack(imgs) if imgs else np.zeros((0, s, s), np.uint8)
    labels = labels[kept]
    names = [names[i] for i in kept]

    feats = []
    t0 = time.time()
    for start in range(0, len(images), batch_size):
        feats.append(engine.run_batch(images[start : start + batch_size]))
        if verbose:
            done = min(start + batch_size, len(images))
            print(f"  [{done:4d}/{len(images)}] "
                  f"{(time.time() - t0) / max(done, 1) * 1e3:.2f} ms/image")
    c, fs = model.config.out_channels, model.config.out_spatial
    features = (
        np.concatenate(feats) if feats else np.zeros((0, c, fs * fs), np.uint8)
    )
    return features, labels, names


def main(argv=None):
    """The JAX CLI's flags plus ``--device``."""
    from tpu_cnn_torch.apps.common import add_variant_arg, load_model
    from tpu_cnn_torch.apps.infer import MODES
    from tpu_cnn_torch.utils.paths import default_artifacts

    p = argparse.ArgumentParser(description="Dump CNN features to .npz")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output", default="tpu_features.npz")
    p.add_argument("--mode", default="auto", choices=MODES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions (--mode cpu ignores it)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--shifts", default=None,
                   help="comma list, one per layer (default: variant ladder)")
    p.add_argument("--s0", type=int, default=None, help="legacy per-layer shift")
    p.add_argument("--s1", type=int, default=None)
    p.add_argument("--s2", type=int, default=None)
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    shifts = None
    if args.shifts is not None:
        shifts = [int(v) for v in args.shifts.split(",")]
    elif args.s0 is not None:
        shifts = [args.s0, args.s1 if args.s1 is not None else DEFAULT_SHIFTS[1],
                  args.s2 if args.s2 is not None else DEFAULT_SHIFTS[2]]

    print("=" * 60)
    print("  FEATURE DUMP")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant, shifts=shifts)
    shifts = tuple(int(s) for s in model.shifts)

    image_dir = args.image_dir or args.artifacts
    paths = sorted(glob.glob(os.path.join(image_dir, "test_image_*.bin")))
    if not paths:
        print(f"No test images found in {image_dir}")
        return
    print(f"Found {len(paths)} test images")

    features, labels, names = dump_features(
        model, paths, mode=args.mode, batch_size=args.batch_size,
        device=args.device)
    art.save_feature_dump(args.output, features, labels, names, shifts)

    print(f"\n  Saved {len(features)} feature maps to: {args.output}")
    print(f"  Shape: {features.shape}")
    print(f"  Labels: {np.unique(labels)}")
    print(f"  Feature range: [{features.min()}, {features.max()}]")
    print(f"  Mean: {features.astype(float).mean():.2f}")
    print(f"  Nonzero: {(features > 0).mean() * 100:.1f}%")


if __name__ == "__main__":
    main()
