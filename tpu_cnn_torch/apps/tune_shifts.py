"""Automatic ReLU-shift tuning, the one runtime "silicon" knob: the port of
``tpu_cnn.apps.tune_shifts``.

The reference hand-picks per-layer shifts 2/4/6 and bakes them into
training and every script (``training/train_cnn.py:39``). Shifts are a
runtime register here (no rebuild when they change), so the whole grid
runs on one engine: for each candidate, extract features on a labelled
sample (``engine.run_batch``; on ``--mode mega`` the megakernel), quick-fit
a linear head (``retrain_classifier.train_linear_classifier`` on
``--device``) and keep the best validation accuracy. Also reports each
candidate's saturated and dead feature fractions.

Usage:
  python -m tpu_cnn_torch.apps.tune_shifts [--radius 1] [--n-per-class 40]
  python -m tpu_cnn_torch.apps.tune_shifts --mode mega --device cuda \\
      --artifacts artifacts/realphoto/bundle-qat \\
      --image-dir artifacts/realphoto/train_bins --n-per-class 120
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np

from tpu_cnn_torch.head.classify import bin_pool_np
from tpu_cnn_torch.models.cnn import DEFAULT_SHIFTS, FpgaCNN
from tpu_cnn_torch.utils import artifacts as art


def candidate_grid(center=DEFAULT_SHIFTS, radius=1, lo=0, hi=12):
    axes = [
        [s for s in range(c - radius, c + radius + 1) if lo <= s <= hi]
        for c in center
    ]
    return list(itertools.product(*axes))


def score_shifts(engine, images_u8, labels, shifts,
                 head_epochs=300, seed=0, device="cuda"):
    """Accuracy of a quick-fit head on features produced with ``shifts``,
    set through ``engine.set_shifts`` (the runtime shift register, the
    reference's AXI register ``pynq_inference.py:226-229``)."""
    from tpu_cnn_torch.apps.retrain_classifier import train_linear_classifier

    engine.set_shifts(*shifts)
    feats = engine.run_batch(images_u8)
    pooled = bin_pool_np(feats)

    n = len(pooled)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    n_val = max(1, n // 5)
    vi, ti = idx[:n_val], idx[n_val:]
    W, b = train_linear_classifier(pooled[ti], labels[ti],
                                   int(labels.max()) + 1,
                                   epochs=head_epochs, verbose=False,
                                   device=device)
    val_acc = float(((pooled[vi] @ W.T + b).argmax(1) == labels[vi]).mean())
    stats = {
        "saturated": float((feats == 255).mean()),
        "dead": float((feats == 0).mean()),
    }
    return val_acc, stats


def tune(model: FpgaCNN, mode: str = "cpu", n_per_class: int = 40,
         radius: int = 1, head_epochs: int = 300, verbose: bool = True,
         image_dir: str | None = None, device="cuda"):
    """Sweep the shift grid. ``image_dir`` points at a ``*_class<C>.bin``
    folder to tune on real data; default is the synthetic-shapes set.
    ``device`` holds the engine (a ``CUDAEngine`` mode) and the head fits.
    Returns (best shifts, [(shifts, val accuracy, stats), ...] best
    first)."""
    from tpu_cnn_torch.apps.infer import make_engine

    if image_dir:
        from tpu_cnn_torch.train.data import BinFolderDataset

        ds = BinFolderDataset(image_dir, img_size=model.config.img_size,
                              max_per_class=n_per_class)
    else:
        from tpu_cnn_torch.train.data import SyntheticShapes

        ds = SyntheticShapes(n_per_class=n_per_class, seed=31,
                             img_size=model.config.img_size)
    imgs, labels = ds.arrays()
    u8 = np.round(imgs * 255).astype(np.uint8)

    engine = make_engine(model, mode, device)
    results = []
    for cand in candidate_grid(tuple(model.shifts.tolist()), radius):
        acc, stats = score_shifts(engine, u8, labels, cand,
                                  head_epochs=head_epochs, device=device)
        results.append((cand, acc, stats))
        if verbose:
            print(f"  shifts {cand}: val acc {acc * 100:5.1f}%  "
                  f"sat {stats['saturated'] * 100:4.1f}%  "
                  f"dead {stats['dead'] * 100:4.1f}%", flush=True)
    results.sort(key=lambda r: -r[1])
    best = results[0]
    # leave the engine (and the model's shift register, which set_shifts
    # mutates) at the best candidate: callers reuse them after tuning
    engine.set_shifts(*best[0])
    if verbose:
        print(f"\n  BEST: shifts {best[0]} at {best[1] * 100:.1f}% val accuracy")
    return best[0], results


def main(argv=None):
    """The JAX CLI's flags plus ``--device``; returns (best shifts,
    results)."""
    from tpu_cnn_torch.apps.common import add_variant_arg, load_model
    from tpu_cnn_torch.apps.infer import MODES
    from tpu_cnn_torch.utils.paths import default_artifacts

    p = argparse.ArgumentParser(description="Auto-tune per-layer ReLU shifts")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--mode", default="cpu", choices=MODES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine (its --mode's kernels) and the "
                        "head fits run (cpu only when asked; --mode cpu's "
                        "host oracle ignores it)")
    p.add_argument("--radius", type=int, default=1)
    p.add_argument("--n-per-class", type=int, default=40)
    p.add_argument("--head-epochs", type=int, default=300)
    p.add_argument("--image-dir", default=None,
                   help="tune on a *_class<C>.bin folder (e.g. the "
                        "real-photo set artifacts/realphoto/train_bins) "
                        "instead of synthetic shapes")
    p.add_argument("--save", action="store_true",
                   help="persist the best shifts to <artifacts>/shifts.json "
                        "— every CLI then defaults to them. Re-run the "
                        "dump->retrain loop at these shifts so the shipped "
                        "head matches.")
    p.add_argument("--head-prefix", default="",
                   help="head-artifact prefix (e.g. arm_); --save writes "
                        "<prefix>shifts.json so the tuned shifts stay scoped "
                        "to the head they were tuned for")
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)

    print("=" * 60)
    print("  RELU SHIFT AUTO-TUNING")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant, args.head_prefix)
    best, results = tune(model, mode=args.mode, n_per_class=args.n_per_class,
                         radius=args.radius, head_epochs=args.head_epochs,
                         image_dir=args.image_dir, device=args.device)
    if args.save:
        import json
        import os

        path = os.path.join(args.artifacts, args.head_prefix + art.SHIFTS_JSON)
        with open(path, "w") as f:
            json.dump([int(s) for s in best], f)
        print(f"\n  saved {path} — re-run dump_features + "
              f"retrain_classifier at these shifts so the bundle head "
              f"matches")
    return best, results


if __name__ == "__main__":
    main()
